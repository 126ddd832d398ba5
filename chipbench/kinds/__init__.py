"""Cell drivers, one module a kind of traffic (a traffic file's ``kind``):
``run(cell, seed, seconds, trace, device, t_start)`` returns the parts of
the result line."""
