"""The device-steps training window (the reference's ``repro.launch.trainer``).

The reference keeps a window of ``device_steps`` optimizer steps on the
device: one jitted, donated ``lax.scan`` over a stacked batch block, with
the metrics kept as running sums in the carry, so the host reads nothing
until the window ends.  The port's window is a loop of ``device_steps``
micro-steps of :func:`repro_torch.launch.steps.make_step_body`'s body with
the same contract: the step index, the attack and codec keys and the
Byzantine cut are host integers, the metric sums stay on the device, and
no micro-step waits for the card; the host reads the sums only at window
boundaries (:func:`window_metrics`).  ``device_steps=1`` is a hand-rolled
step loop over the same body, bit for bit (tests/test_torch_trainer.py).
CUDA graphs of the window are later work.

State: ``{"params", "opt_state", "comp" (error-feedback residuals or ()),
"step" and "key" (int64 scalars on the CPU: the host knows them),
"metrics" (running sums on the params' device)}``.  Under
``param_mode='fsdp'``, and under a model axis > 1 (tensor parallelism), a
rank of a process group holds its shards of the params and of the
optimizer state (:func:`init_state`), and the window and
:func:`train_loop` run unchanged; :func:`abstract_state` gives the
state's shapes on the meta device and :func:`abstract_window_batches`
the window's batch block.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.core.attacks import AttackConfig
from repro_torch.data.pipeline import DataConfig, make_lm_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import Optimizer, get_optimizer
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds import engine as round_engine

State = Dict[str, Any]


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, mesh: mesh_lib.Mesh, opt: Optimizer, seed: int = 0,
               pcfg: Optional[ParallelConfig] = None) -> State:
    """Fresh training state on the mesh's device: params from ``seed``,
    optimizer state, the error-feedback residuals, step 0, the attack-key
    base ``seed`` and zeroed metric sums.  Under ``param_mode='fsdp'`` on a
    process group the seeded full params are built once and this rank
    keeps its shards (:func:`steps.fsdp_rank_shard`: under a model axis its
    worker's chunk of its model chunk), and the optimizer state is
    initialised on them; under a model axis a rank keeps its model shards
    (:func:`steps.tp_shard`); the in-process mesh keeps the global view.
    The error-feedback residual is a worker's whole (D,) row, on each of
    its model ranks alike."""
    params = T.init_params(cfg, seed=seed, device=mesh.device)
    if pcfg is not None and pcfg.param_mode == "fsdp" and mesh.per_rank:
        params = steps.fsdp_rank_shard(params, cfg, mesh)
    elif mesh.per_rank:
        params = steps.tp_shard(params, steps.param_shardings(cfg, mesh),
                                mesh_lib.model_rank(mesh), mesh_lib.model_size(mesh))
    return {
        "params": params,
        "opt_state": opt.init(params),
        "comp": steps.init_comp_state(cfg, pcfg, mesh) if pcfg is not None else (),
        "step": torch.tensor(0, dtype=torch.int64),
        "key": torch.tensor(seed, dtype=torch.int64),
        "metrics": zero_metrics(mesh.device),
    }


def abstract_state(cfg: ModelConfig, mesh: mesh_lib.Mesh, opt: Optimizer,
                   pcfg: Optional[ParallelConfig] = None) -> State:
    """:func:`init_state`'s entries as tensors on the meta device, nothing
    allocated: under fsdp the params and optimizer state of
    :func:`steps.abstract_params_fsdp` (a rank's shard shapes under a
    process group, the global ones in process)."""
    fsdp = pcfg is not None and pcfg.param_mode == "fsdp"
    if fsdp:
        params = steps.abstract_params_fsdp(cfg, mesh)
        opt_state = steps.abstract_opt_state_fsdp(opt, cfg, mesh)
    else:
        params = steps.abstract_params(cfg, mesh)
        opt_state = steps.abstract_opt_state(opt, cfg, mesh)
    comp = ()
    if pcfg is not None and comp_lib.get_compression(pcfg.compression).error_feedback:
        vs = mesh.axes.vshape(mesh_lib.worker_axes(mesh))
        comp = torch.empty(vs + (steps.comp_state_size(cfg),), dtype=torch.float32,
                           device="meta")

    def scalar(dtype):
        return torch.empty((), dtype=dtype, device="meta")

    return {"params": params, "opt_state": opt_state, "comp": comp,
            "step": scalar(torch.int64), "key": scalar(torch.int64),
            "metrics": {"loss_sum": scalar(torch.float32),
                        "grad_norm_sum": scalar(torch.float32),
                        "micro_steps": scalar(torch.int32)}}


def abstract_window_batches(cfg: ModelConfig, shape: ShapeConfig, mesh: mesh_lib.Mesh,
                            device_steps: int) -> Dict[str, steps.InputSpec]:
    """The window's stacked batch block as stand-ins: each of
    :func:`steps.input_specs`' train inputs with ``device_steps`` in
    front, split over the worker axes on its batch dim."""
    if shape.kind != "train":
        raise ValueError(f"trainer windows need a train shape, got {shape.kind!r}")
    waxes = mesh_lib.worker_axes(mesh)
    entry = waxes if len(waxes) > 1 else waxes[0]
    return {k: steps.InputSpec(torch.empty((device_steps,) + tuple(v.meta.shape),
                                           dtype=v.meta.dtype, device="meta"), (None, entry))
            for k, v in steps.input_specs(cfg, shape, mesh).items()}


def zero_metrics(device="cpu") -> Dict[str, torch.Tensor]:
    return {"loss_sum": torch.zeros((), dtype=torch.float32, device=device),
            "grad_norm_sum": torch.zeros((), dtype=torch.float32, device=device),
            "micro_steps": torch.zeros((), dtype=torch.int32, device=device)}


def window_metrics(before: Dict[str, float], state: State) -> Dict[str, float]:
    """This window's mean loss / grad norm, from the running sums against
    the snapshot taken at the previous boundary.  The loop's only reads of
    the card happen here."""
    after = {k: float(v) for k, v in state["metrics"].items()}
    n = after["micro_steps"] - before["micro_steps"]
    return {
        "loss": (after["loss_sum"] - before["loss_sum"]) / max(n, 1),
        "grad_norm": (after["grad_norm_sum"] - before["grad_norm_sum"]) / max(n, 1),
        "micro_steps": n,
        "_snapshot": after,
    }


# ---------------------------------------------------------------------------
# the window step
# ---------------------------------------------------------------------------


def make_window_step(cfg: ModelConfig, pcfg: ParallelConfig, mesh: mesh_lib.Mesh,
                     opt: Optimizer, attack: Optional[AttackConfig] = None,
                     device_steps: int = 1) -> Callable[[State, Dict[str, torch.Tensor]], State]:
    """``window(state, batches) -> state``: ``device_steps`` micro-steps of
    the validated step body over ``batches`` (leaves (device_steps, B,
    ...)), one robust aggregation each, randomized attacks keyed by the
    GLOBAL step index.  ``state`` is donated: its entries are replaced as
    the window goes, so the old iterate is freed step by step."""
    if device_steps < 1:
        raise ValueError(f"device_steps must be >= 1, got {device_steps}")
    sb = steps.make_step_body(cfg, pcfg, mesh, opt, attack)

    def window(state: State, batches: Dict[str, torch.Tensor]) -> State:
        lead = {v.shape[0] for v in batches.values()}
        if lead != {device_steps}:
            raise ValueError(f"batch block of {sorted(lead)} steps, want {device_steps}")
        atk_base, step0 = int(state["key"]), int(state["step"])
        met = state["metrics"]
        for i in range(device_steps):
            batch = {k: v[i] for k, v in batches.items()}
            if sb.comp_body is not None:
                # error-feedback compression: the residuals ride the state
                # like the optimizer state
                state["params"], state["opt_state"], state["comp"], m = sb.comp_body(
                    state["params"], state["opt_state"], state["comp"], batch, step0 + i,
                    atk_base)
            else:
                state["params"], state["opt_state"], m = sb.body(
                    state["params"], state["opt_state"], batch, step0 + i, atk_base)
            met = {"loss_sum": met["loss_sum"] + m["loss"].float(),
                   "grad_norm_sum": met["grad_norm_sum"] + m["grad_norm"].float(),
                   "micro_steps": met["micro_steps"] + 1}
        state["metrics"] = met
        state["step"] = torch.tensor(step0 + device_steps, dtype=torch.int64)
        return state

    return window


# ---------------------------------------------------------------------------
# host-side batch staging
# ---------------------------------------------------------------------------


def frontend_batch(dcfg: DataConfig, step: int, cfg: ModelConfig) -> torch.Tensor:
    """The stub frontend of step ``step``: (B, n_frontend_tokens, d_model)
    float32 standard normals from the generator of (seed, step), cast to the
    model's dtype (the reference draws its own from threefry)."""
    x = torch.randn((dcfg.global_batch, cfg.n_frontend_tokens, cfg.d_model),
                    generator=rng.generator(dcfg.seed, step), dtype=torch.float32)
    return x.to(getattr(torch, cfg.dtype))


def stack_window_batches(dcfg: DataConfig, start_step: int, device_steps: int,
                         mesh: mesh_lib.Mesh, attack: Optional[AttackConfig] = None,
                         cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """The (device_steps, B, S) batch block of the window starting at
    ``start_step``, built on the host and moved to the mesh's device: each
    micro-step's batch is ``make_lm_batch`` at its step index (per-worker
    provenance and label corruption included), with
    :func:`frontend_batch`'s ``frontend`` (device_steps, B, T, D) for a
    frontend configuration."""
    per_step = [make_lm_batch(dcfg, start_step + i, attack, device="cpu")
                for i in range(device_steps)]
    if cfg is not None and cfg.frontend != "none":
        for i, b in enumerate(per_step):
            b["frontend"] = frontend_batch(dcfg, start_step + i, cfg)
    return {k: torch.stack([b[k] for b in per_step]).to(mesh.device)
            for k in per_step[0]}


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainResult:
    state: State
    history: List[Dict[str, float]]  # one entry per logged window
    steps: int
    device_steps: int
    compile_s: float  # wall time of the first window (the reference's compile)
    train_s: float  # wall time of the windows after the first
    steps_per_s: float
    tokens_per_s: float
    # per steady window wall times; the MIN is the noise-robust step time
    window_times_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def min_step_time_s(self) -> float:
        if not self.window_times_s:
            return 0.0
        return min(self.window_times_s) / self.device_steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(
    cfg: ModelConfig,
    pcfg: ParallelConfig,
    tcfg: TrainConfig,
    mesh: mesh_lib.Mesh,
    dcfg: Optional[DataConfig] = None,
    attack: Optional[AttackConfig] = None,
    log_every: int = 1,  # in windows
    on_window: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ckpt_every: int = 0,  # in windows
    ckpt_dir: Optional[str] = None,
    resume=False,
) -> TrainResult:
    """Run ``tcfg.steps`` optimizer steps in windows of
    ``tcfg.device_steps``: stage a batch block, run the window, read the
    metric deltas at the boundary.  The first window's wall time is
    reported as ``compile_s`` so ``steps_per_s`` / ``tokens_per_s`` are the
    steady state.

    ``ckpt_every`` / ``ckpt_dir`` write a rounds.engine snapshot of the
    whole state every ``ckpt_every`` windows; ``resume=True`` (or a step
    index) restores one and continues bit for bit (batch blocks are pure
    functions of the step index).  The snapshots go to
    ``mesh.snapshot_dir(ckpt_dir)``: ``ckpt_dir/rank{r}`` under a process
    group.
    """
    ds = tcfg.device_steps
    if tcfg.steps % ds != 0:
        raise ValueError(f"steps ({tcfg.steps}) must be a multiple of device_steps ({ds})")
    m = mesh_lib.num_workers(mesh)
    if ckpt_dir is not None:
        ckpt_dir = mesh.snapshot_dir(ckpt_dir)
    if dcfg is None:
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=4 * m,
                          num_workers=m, seed=tcfg.seed)
    opt = get_optimizer(tcfg.optimizer, tcfg.lr, tcfg.weight_decay, tcfg.momentum)
    window = make_window_step(cfg, pcfg, mesh, opt, attack, device_steps=ds)
    state = init_state(cfg, mesh, opt, seed=tcfg.seed, pcfg=pcfg)

    history: List[Dict[str, float]] = []
    start_w = 0
    if resume is not False and resume is not None:
        if ckpt_dir is None:
            raise ValueError("resume=True needs ckpt_dir")
        rnd = None if resume is True else int(resume)
        if rnd is not None or round_engine.latest_round(ckpt_dir) is not None:
            snap, host = round_engine.load_snapshot(
                ckpt_dir, dict(state, round=torch.tensor(0, dtype=torch.int64)), rnd)
            snap.pop("round")
            state = snap
            history = list(host.get("history", []))
            start_w = int(state["step"]) // ds
    snapshot = {k: float(v) for k, v in state["metrics"].items()}
    n_windows = tcfg.steps // ds
    compile_s = train_s = 0.0
    window_times: List[float] = []
    t_train = time.perf_counter()
    for w in range(start_w, n_windows):
        batches = stack_window_batches(dcfg, w * ds, ds, mesh, attack, cfg)
        t0 = time.perf_counter()
        state = window(state, batches)
        _sync(mesh.device)  # the boundary: the window's interior never waits
        if w == start_w:
            compile_s = time.perf_counter() - t0
        else:
            window_times.append(time.perf_counter() - t0)
        if w % log_every == 0 or w == n_windows - 1:
            met = window_metrics(snapshot, state)
            snapshot = met.pop("_snapshot")
            met["step"] = (w + 1) * ds
            history.append(met)
            if on_window is not None:
                on_window(w, met)
        if ckpt_every and ckpt_dir and (w + 1) % ckpt_every == 0:
            round_engine.save_snapshot(ckpt_dir, dict(state, round=state["step"]),
                                       host={"history": history})
        if w == start_w:
            t_train = time.perf_counter()  # restart the clock after the first window
    _sync(mesh.device)
    train_s = time.perf_counter() - t_train if n_windows - start_w > 1 else 0.0
    steady_steps = max((n_windows - start_w) * ds - ds, 0)
    steps_per_s = steady_steps / train_s if train_s > 0 else 0.0
    return TrainResult(
        state=state, history=history, steps=tcfg.steps, device_steps=ds,
        compile_s=compile_s, train_s=train_s, steps_per_s=steps_per_s,
        tokens_per_s=steps_per_s * dcfg.global_batch * dcfg.seq_len,
        window_times_s=window_times)
