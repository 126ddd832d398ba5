"""Round programs.  So far: the round engine (``engine``); Algorithm 2,
local-update rounds and the communication strategies follow."""
