"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py`` and, for the numbers that
decide ``correct``, ``limits/<cell>.json``.  The yardstick (the traffic
generator, the plain reference in ``reference/``, the FLOP and byte
counts and the peaks in ``yardstick.py``) lives here and imports nothing
of the port.
"""
