"""Roofline of a rank's step on an H100 SXM (the reference's
``repro.launch.roofline``, with the card's data-sheet peaks in place of
the TPU's).

Three terms per (arch × shape × mesh), from one rank's counts
(:mod:`repro_torch.launch.cost_analysis`):

  compute    = Σ_dtype FLOPs_dtype / peak_dtype
               (989 TFLOP/s bf16 / f16 matmuls; 67 TFLOP/s f32, since the
               port turns TF32 off; dense, no sparsity)
  memory     = bytes / 3.35 TB/s HBM3
  collective = Σ_axis wire bytes_axis / link_axis
               (450 GB/s each way over NVLink inside a host of 8 cards;
               50 GB/s a card across hosts, one 400 Gb/s NIC a card, the
               DGX H100 layout)

Wire bytes weight an all-reduce's output 2x (reduce-scatter and
all-gather phases), the other collectives' 1x.  Ranks lie row-major over
the mesh axes, 8 consecutive ranks a host, as
:func:`repro_torch.launch.mesh.make_production_mesh` orders them, so an
axis whose group stays inside one host runs at NVLink's rate and any
other at the network's.  Every figure here is computed from the data
sheet at 700 W, not measured.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Union

#: dense matmul peaks of an H100 SXM at 700 W (FLOP/s) by operand dtype
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "float64": 67e12,
              "int8": 1979e12, "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12}
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 450e9  # B/s each way, a card, inside a host
NET_BW = 50e9  # B/s a card across hosts (400 Gb/s)
HOST_CARDS = 8  # cards a host

Number = Union[int, float]


def compute_seconds(flops: Union[Number, Mapping[str, Number]]) -> float:
    """FLOPs over their peak: a number is taken as bf16 matmul FLOPs, a
    mapping as FLOPs by dtype name (an unknown dtype at the f32 peak)."""
    if not isinstance(flops, Mapping):
        flops = {"bfloat16": flops}
    return sum(f / PEAK_FLOPS.get(d, PEAK_FLOPS["float32"]) for d, f in flops.items())


def axis_ranks(shape: Mapping[str, int], axes, rank: int = 0):
    """The ranks of ``rank``'s group over ``axes`` (names) of a mesh of
    ``shape`` (axis name -> size, in rank-major order)."""
    names = list(shape)
    coords, r = {}, rank
    for a in reversed(names):
        r, coords[a] = divmod(r, shape[a])
    out = []
    for i in range(math.prod(shape[a] for a in axes)):
        c, k = dict(coords), i
        for a in reversed(list(axes)):
            k, c[a] = divmod(k, shape[a])
        lin = 0
        for a in names:
            lin = lin * shape[a] + c[a]
        out.append(lin)
    return sorted(out)


def axis_bandwidth(shape: Mapping[str, int], axes) -> float:
    """The link a group over ``axes`` runs at: NVLink where its ranks share
    a host (8 consecutive ranks), else the network."""
    ranks = axis_ranks(shape, axes)
    return NVLINK_BW if len({r // HOST_CARDS for r in ranks}) == 1 else NET_BW


def axis_links(shape: Mapping[str, int]) -> Dict[str, float]:
    """``{axes label: B/s}`` for every run of consecutive axes of a mesh
    (the labels of :func:`repro_torch.launch.cost_analysis.group_axes`)."""
    names = list(shape)
    return {"+".join(names[i:j]): axis_bandwidth(shape, names[i:j])
            for i in range(len(names)) for j in range(i + 1, len(names) + 1)}


def collective_seconds(coll_bytes: Union[Number, Mapping[str, Number]],
                       links: Mapping[str, float] = None) -> float:
    """Wire bytes over their links: a number at the network's rate, a
    mapping as wire bytes by axes label, each at ``links[label]`` (the
    network's rate where the label is missing)."""
    if not isinstance(coll_bytes, Mapping):
        return coll_bytes / NET_BW
    links = links or {}
    return sum(b / links.get(a, NET_BW) for a, b in coll_bytes.items())


def roofline_terms(flops, hbm_bytes: Number, coll_bytes, chips: int = 1,
                   links: Mapping[str, float] = None) -> Dict[str, float]:
    """The three terms and the bound of one rank's counts (``chips`` divides
    global counts; the counts here are a rank's, so keep 1)."""
    compute = compute_seconds(flops) / chips
    memory = hbm_bytes / (chips * HBM_BW)
    collective = collective_seconds(coll_bytes, links) / chips
    dominant = max(("compute", compute), ("memory", memory), ("collective", collective),
                   key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dominant, "bound_s": max(compute, memory, collective)}


def roofline_tokens_per_s(flops, hbm_bytes: Number, coll_bytes, tokens: int, chips: int = 1,
                          links: Mapping[str, float] = None) -> float:
    """Roofline-bound throughput: the tokens of the analysed program over its
    bound time."""
    bound = roofline_terms(flops, hbm_bytes, coll_bytes, chips, links)["bound_s"]
    return tokens / bound if bound > 0 else 0.0


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for an inference forward."""
    return (6.0 if kind == "train" else 2.0) * n_active_params * tokens


def format_seconds(s: float) -> str:
    if s <= 0:
        return "0"
    if s < 1e-3:
        return f"{s*1e6:.1f}us"
    if s < 1:
        return f"{s*1e3:.2f}ms"
    return f"{s:.3f}s"
