"""The reference of a training cell's first steps, for the model of any
reference module (``chipbench.reference``'s interface): every worker's
loss and gradient on its rows, the attack on the stacked rows, the coordinate-wise
aggregate and AdamW, in float32 with TF32 off.  Parameters are kept at
the values the configuration's dtype holds (each update rounded to it),
as the configuration stores them; moments in float32.

It runs once the program's state is freed, and keeps at most the
parameters, the moments and one step's stacked float32 gradients: the
attack and the aggregate run a block of columns at a time.
"""
from __future__ import annotations

import contextlib
import math
import statistics
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from chipbench.reference import robust

#: columns of the stacked rows attacked and aggregated at a time
COLUMNS = 1 << 24


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def num_byzantine(alpha: float, m: int) -> int:
    """ceil(alpha·m) capped at m - 1: workers 0 .. q-1 are Byzantine."""
    return min(m - 1, math.ceil(alpha * m)) if alpha > 0 else 0


def _split(params: Dict[str, torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
    """Each leaf as a list of autograd leaves: one a layer for the stacked
    ``blocks`` leaves, so each layer's gradient comes out at its size."""
    return {p: [t.detach().requires_grad_()
                for t in (v.unbind(0) if p.startswith("blocks/") else (v,))]
            for p, v in params.items()}


def attack_and_aggregate(rows: torch.Tensor, traffic: Dict) -> torch.Tensor:
    """The aggregate (n,) of stacked rows (m, n), the gradient attack applied
    first, a block of columns at a time; ``rows`` is overwritten."""
    m = rows.shape[0]
    atk = traffic.get("attack") or {}
    agg = traffic["agg"]
    q = num_byzantine(atk.get("alpha", 0.0), m) if atk.get("name") == "alie" else 0
    if atk.get("name") not in (None, "none", "alie", "label_flip"):
        raise ValueError(f"the reference has no attack {atk.get('name')!r}")
    out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
    for a in range(0, rows.shape[1], COLUMNS):
        block = rows[:, a:a + COLUMNS]
        robust.alie(block, q, atk.get("shift", 1.0))
        out[a:a + COLUMNS] = robust.aggregate(block, agg["method"], agg.get("beta", 0.0))
    return out


def run(ref: ModuleType, model: Dict, traffic: Dict, weights: Callable[[str], torch.Tensor],
        batches: List[Dict[str, torch.Tensor]], steps: int,
        mm: Optional[Callable] = None) -> Dict:
    """``steps`` training steps of the reference module ``ref``'s model
    from the weights ``weights(path)`` on ``batches[0 .. steps-1]``, its
    products ``mm`` (``ref.matmul`` by default): {"losses": the workers'
    mean loss a step, "agg1": each leaf's norm of the first step's
    aggregate, "delta": each leaf's norm of the parameters' change over
    the steps}."""
    m, b = traffic["workers"], traffic["batch_per_worker"]
    opt = traffic["optimizer"]
    dtype = getattr(torch, model["dtype"])
    mm = mm or ref.matmul
    paths = list(ref.param_specs(model))
    with no_tf32():
        params = {p: weights(p).float() for p in paths}
        dev = params[paths[0]].device
        mom = {p: torch.zeros_like(v) for p, v in params.items()}
        vel = {p: torch.zeros_like(v) for p, v in params.items()}
        losses: List[float] = []
        agg1: Dict[str, float] = {}
        for step in range(steps):
            tokens, labels = batches[step]["tokens"], batches[step]["labels"]
            rows = {p: torch.empty((m,) + v.shape, dtype=torch.float32, device=dev)
                    for p, v in params.items()}
            worker_losses = []
            for w in range(m):
                leaves = _split(params)
                loss = ref.loss(leaves, tokens[w * b:(w + 1) * b], labels[w * b:(w + 1) * b],
                              model, mm)
                flat = [t for p in paths for t in leaves[p]]
                grads = iter(torch.autograd.grad(loss, flat))
                for p in paths:
                    for i in range(len(leaves[p])):
                        g = next(grads)
                        (rows[p][w, i] if p.startswith("blocks/") else rows[p][w]).copy_(g)
                worker_losses.append(float(loss.detach()))
                del leaves, loss, flat, grads
            losses.append(sum(worker_losses) / m)
            for p in paths:
                agg = attack_and_aggregate(rows.pop(p).reshape(m, -1), traffic)
                agg = agg.view(params[p].shape)
                if step == 0:
                    agg1[p] = float(agg.norm())
                robust.adamw(params[p], agg, mom[p], vel[p], step, opt)
                params[p].copy_(params[p].to(dtype))
                del agg
        del mom, vel
        delta = {p: float((params[p] - weights(p).float()).norm()) for p in paths}
    return {"losses": losses, "agg1": agg1, "delta": delta}


# ---------------------------------------------------------------------------
# the numbers compared
# ---------------------------------------------------------------------------


def gaps(got: Dict, ref: Dict, exclude: float = 1e-3) -> Dict[str, float]:
    """The numbers that decide ``correct``, of a reading ``got`` (the
    program's, or the control's) against the reference ``ref``:

    - ``loss``: the largest relative gap of a step's loss;
    - ``grad1``: over the leaves, the largest gap between the norms of the
      first step's aggregate, over the reference's norm of that leaf or of
      the median leaf, whichever is larger;
    - ``delta``: the same of the parameters' change over the steps, leaving
      out the leaves whose first reference gradient is under ``exclude``
      times the median leaf's (they move by round-off alone)."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(got["losses"], ref["losses"]))
    med = statistics.median(ref["agg1"].values())
    grad1 = max(abs(got["agg1"][p] - r) / max(r, med) for p, r in ref["agg1"].items())
    movers = [p for p, r in ref["agg1"].items() if r >= exclude * med]
    med_d = statistics.median(ref["delta"][p] for p in movers)
    delta = max(abs(got["delta"][p] - ref["delta"][p]) / max(ref["delta"][p], med_d)
                for p in movers)
    return {"loss": loss, "grad1": grad1, "delta": delta}
