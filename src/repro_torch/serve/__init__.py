"""Robust serving: continuous-batching inference whose traffic stream feeds
Byzantine-robust continual fine-tuning (the reference's ``repro.serve``).

- :mod:`repro_torch.serve.engine`  — fixed-slot continuous-batching decode
  pool (prefill-on-admit, retire on EOS/length, slot reuse, hot-swappable
  params), its caches allocated once on the device;
- :mod:`repro_torch.serve.traffic` — seeded virtual user population mapped
  onto gradient shards; a Byzantine sub-population emits poisoned feedback
  through the attacks registry's ``feedback`` access class;
- :mod:`repro_torch.serve.adapt`   — robust continual fine-tuning: feedback
  shards -> score-weighted local gradients -> (m, D) rows -> robust
  aggregate -> update, one round-engine round per cadence window,
  hot-swapped into the running engine;
- ``python -m repro_torch.serve.run`` — the command-line entry point.
"""
from repro_torch.serve.engine import Completed, Request, ServeConfig, ServeEngine, serve_stream  # noqa: F401
from repro_torch.serve.traffic import TrafficConfig, VirtualUsers  # noqa: F401
from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter  # noqa: F401
