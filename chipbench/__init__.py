"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name in
``BENCHMARK.json``, so a new one is added as new files and entries only:

- a configuration: ``configs/<name>.json``, its source's keys, a
  ``port`` group (the port's ``ModelConfig`` fields, nested groups such
  as ``moe`` and ``ssm`` as dicts, tuples as lists), a ``smoke`` group
  for the CPU tests and, where ``reference/model.py`` (the dense and MoE
  decoder) is not its model, ``"reference": "<module>"`` and its plain
  model ``reference/<module>.py`` with the interface that
  ``reference/__init__.py`` documents;
- a cell: its ``workloads`` entry and ``limits/<cell>.json``, the
  numbers that decide ``correct``;
- a traffic mix: ``traffic/<name>.json``, read by the driver of its
  ``kind`` (``kinds/<kind>.py``);
- a per-layer metric: ``metrics/<name>.py``, a reader of the traced
  run's profile, spans or counters, among them the program's own spans
  (``spans.read_metric``).

The yardstick (the traffic generator, the plain references in
``reference/``, the FLOP counts there and the peaks and byte counts in
``yardstick.py``) lives here and imports nothing of the port.
"""
