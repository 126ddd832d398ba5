"""Round programs: the round engine (``engine``, with the scheduled
driver), attack resolution (``comm``) and the local-SGD round body
(``distributed``).  Algorithm 2, local-update rounds and the
communication strategies follow."""
