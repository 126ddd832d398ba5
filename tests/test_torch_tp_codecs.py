"""The payload codecs and randomized attacks on the model axis in the port:
a worker's codec message is its whole raveled gradient (a rank holding
model shards gathers its leaves, compresses the whole tree and keeps its
chunks: ``rounds/distributed.compress_workers``; the error-feedback
residual a worker's whole (D,) row on each of its model ranks), and a
randomized payload (``gauss``) is drawn over the whole leaf and cut
(``Collectives.whole_rows``, ``AttackContext.whole``); the adapter's rounds
do both on the (m, D) rows (``serve/adapt.py``, ``ModelShards.gather_flat``
/ ``cut_flat``).

Held at (data 2, model 2), in process and on 4 gloo ranks (spawned once
for the module, a ``file://`` rendezvous, every join with a timeout; they
run :func:`jobs` while the in-process tests run), f32 smoke configs:
- the train step's codecs (int8 and count_sketch through
  ``make_train_step``, topk with its residual through the trainer's
  window), 2 steps, gather median under alie: every ``compress_workers``
  call's output is the model-1 codec's (``compress_workers`` over a
  model-1 mesh) on the same rows and key, and each rank's output is its
  chunks of the in-process call's;
- gauss alpha 0.5 with the gather, bucketed and chunked strategies: each
  payload (gather) is the model-1 draw on the same key and rows, the
  ranks' payloads and params their chunks of the in-process run's;
- the adapter's ``RoundFn``, one round with int8 and one with gauss: the
  decoded / attacked rows are the model-1 functions' on the round's rows,
  the ranks' their columns;
- the reference's int8 draw injected (``draw=``): at model 2 each worker's
  decoded tree is the reference's ``compress_tree`` output on that
  worker's whole tree.
Every comparison is bitwise.  About 40 s serially.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.attacks import engine as atk_engine
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, trainer
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.rounds import compression as comp_lib
from repro_torch.rounds import distributed as rounds_dist
from repro_torch.serve.adapt import AdaptConfig, RoundFn, init_adapt_state
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # (data 2, model 2)
STEPS = 2
ARCH = "llama3.2-3b"
DATA = dict(seq_len=16, global_batch=4, num_workers=2, seed=0)
CODECS = ("int8", "count_sketch", "topk")
GAUSS = ("gather", "bucketed", "chunked")
ADAPT = {"int8": dict(compression="int8"), "gauss": dict(grad_attack="gauss", grad_alpha=0.5)}
REF_KEY = 5  # the reference's int8 keys: fold_in(PRNGKey(REF_KEY), worker)

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_tp_codecs as T
T.run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
"""


def _cfg():
    return dataclasses.replace(configs.get_smoke_config(ARCH), dtype="float32")


def _np(t):
    return t.detach().numpy().copy()


def _clone(tree):
    return tree_unflatten_like(tree, [t.detach().clone() for t in tree_leaves(tree)])


@contextlib.contextmanager
def _patched(module, name, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _codec_calls(calls):
    """Record every ``compress_workers`` call: its inputs (copied first, as
    the error-feedback path writes over them) and outputs."""
    def wrap(real):
        def rec(ax, names, g, name, comp_key=None, draw=None, residual=None, model_dims=None,
                out=None):
            g_in = _clone(g)
            res_in = None if residual is None else residual.detach().clone()
            got = real(ax, names, g, name, comp_key, draw, residual, model_dims, out)
            hat, new = got if residual is not None else (got, None)
            calls.append({"g": g_in, "res": res_in, "key": comp_key, "name": name,
                          "hat": _clone(hat), "new": None if new is None else new.clone()})
            return got
        return rec
    return _patched(rounds_dist, "compress_workers", wrap)


def _payloads(calls):
    """Record every gathered-rows payload: the rows in, the generator's state
    before the draw, the rows out."""
    def wrap(real):
        def rec(cfg, stacked, mask, *, generator=None, **kw):
            state = None if generator is None else generator.get_state()
            out = real(cfg, stacked, mask, generator=generator, **kw)
            calls.append({"rows": stacked.detach().clone(), "mask": mask, "state": state,
                          "out": out.detach().clone(), "cfg": cfg})
            return out
        return rec
    return _patched(D, "apply_gradient_attack", wrap)


def _train(mesh, name=None, strategy="gather", attack=("alie", 0.25)):
    cfg = _cfg()
    pcfg = ParallelConfig(agg_method="median", agg_strategy=strategy, agg_beta=0.25,
                          attn_chunk=0, compression=name or "none")
    r = trainer.train_loop(cfg, pcfg, TrainConfig(optimizer="adamw", lr=1e-2, steps=STEPS,
                                                  device_steps=STEPS if name == "topk" else 1),
                           mesh, dcfg=pipeline.DataConfig(vocab=cfg.vocab, **DATA),
                           attack=AttackConfig(*attack))
    return {"params": {p: _np(t) for p, t in tree_leaves_with_path(r.state["params"])},
            "loss": np.array([h["loss"] for h in r.history])}


def _step_codec(mesh, name):
    """``make_train_step`` with the codec, STEPS steps."""
    cfg = _cfg()
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          attn_chunk=0, compression=name)
    opt = get_optimizer("adamw", 1e-2)
    step = steps.make_train_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25))
    params = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)["params"]
    state = opt.init(params)
    dcfg = pipeline.DataConfig(vocab=cfg.vocab, **DATA)
    for i in range(STEPS):
        params, state, _ = step(params, state, pipeline.make_lm_batch(dcfg, i, None,
                                                                      device="cpu"), i)
    return {p: _np(t) for p, t in tree_leaves_with_path(params)}


def _round_batch(cfg, m=2, b=1, length=12):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (m, b, length))
    weights = rng.uniform(-1, 1, (m, b, length)).astype(np.float32)
    weights[..., :length // 2] = 0.0  # the prompt
    return {"tokens": torch.from_numpy(tokens).int(),
            "labels": torch.from_numpy(np.roll(tokens, -1, axis=-1)).int(),
            "weights": torch.from_numpy(weights)}


def _adapt(mesh, kw):
    """One adaptation round at ``mesh``: the codec's / attack's rows in and
    out (global rows in process and for the codec; a rank's columns for
    the attack under a process group) and the round's aggregate."""
    cfg = _cfg()
    acfg = AdaptConfig(method="median", batch_per_shard=1, **kw)
    fn = RoundFn(cfg, acfg, mesh)
    params = T.init_params(cfg, 0, "cpu")
    held = fn.shards.cut(params) if fn.shards.per_rank else params
    state = init_adapt_state(held, acfg, 2)
    calls = []

    def wrap_c(real):
        def rec(name, rows, **k):
            state_ = k["generator"].get_state()
            out = real(name, rows, **k)
            calls.append({"in": rows.clone(), "out": out[0].clone(), "state": state_})
            return out
        return rec

    def wrap_a(real):
        def rec(attack, stacked, mask, **k):
            state_ = k["generator"].get_state()
            out = real(attack, stacked, mask, **k)
            calls.append({"in": stacked.clone(), "out": out.clone(), "state": state_,
                          "mask": mask, "attack": attack, "alpha": k["alpha"]})
            return out
        return rec

    with _patched(comp_lib, "compress_rows", wrap_c), \
            _patched(atk_engine, "apply_to_rows", wrap_a):
        state, _ = fn(state, _round_batch(cfg))
    return calls, state["prev_agg"].clone(), fn.shards


def _reference_draws(d):
    import jax

    key = jax.random.PRNGKey(REF_KEY)
    return [torch.from_numpy(np.array(jax.random.uniform(jax.random.fold_in(key, w),
                                                         comp_lib.int8_draw_shape(d))))
            for w in range(2)]


def _worker_trees(cfg):
    """Two workers' whole gradient trees (seeded normal), worker-stacked."""
    rng = np.random.default_rng(11)
    return tree_unflatten_like(T.meta_params(cfg), [
        torch.from_numpy(rng.standard_normal((2,) + tuple(t.shape)).astype(np.float32))
        for t in tree_leaves(T.meta_params(cfg))])


def jobs(mesh):
    """Everything the ranks run, and the in-process run repeats."""
    cfg = _cfg()
    out = {}
    for name in CODECS:
        calls = []
        with _codec_calls(calls):
            out[f"codec/{name}/params"] = (_train(mesh, name) if name == "topk"
                                           else _step_codec(mesh, name))
        out[f"codec/{name}/calls"] = calls
    for strategy in GAUSS:
        calls = []
        with _payloads(calls):
            out[f"gauss/{strategy}"] = _train(mesh, strategy=strategy, attack=("gauss", 0.5))
        out[f"gauss/{strategy}/calls"] = calls
    for run, kw in ADAPT.items():
        out[f"adapt/{run}"] = _adapt(mesh, kw)
    # the reference's int8 draw injected into compress_workers
    full = _worker_trees(cfg)
    if mesh.per_rank:
        k = mesh_lib.model_rank(mesh)
        g = steps.tp_shard(tree_unflatten_like(full, [t[mesh_lib.worker_index(mesh)]
                                                      for t in tree_leaves(full)]),
                           steps.param_shardings(cfg, mesh), k, 2)
    else:
        g = full
    draws = _reference_draws(T.count_params(cfg))
    out["ref_int8"] = rounds_dist.compress_workers(
        mesh.axes, ("data",), g, "int8", draw=lambda w: draws[w],
        model_dims=tree_leaves(sharding.tp_dims(cfg, 2)))
    return out


def _save(out):
    """The rank's outputs as a flat dict of arrays."""
    flat = {}
    for key, v in out.items():
        if key.startswith("codec/") and key.endswith("/calls"):
            for i, c in enumerate(v):
                for p, t in tree_leaves_with_path(c["hat"]):
                    flat[f"{key}/{i}/hat/{p}"] = _np(t)
                if c["new"] is not None:
                    flat[f"{key}/{i}/new"] = _np(c["new"])
        elif key.startswith("gauss/") and key.endswith("/calls"):
            for i, c in enumerate(v):
                flat[f"{key}/{i}/out"] = _np(c["out"])
        elif key.startswith("adapt/"):
            calls, agg, _ = v
            for i, c in enumerate(calls):
                flat[f"{key}/{i}/out"] = _np(c["out"])
            flat[f"{key}/agg"] = _np(agg)
        elif key == "ref_int8":
            for p, t in tree_leaves_with_path(v):
                flat[f"{key}/{p}"] = _np(t)
        elif isinstance(v, dict) and "params" in v:
            flat[f"{key}/loss"] = v["loss"]
            for p, t in v["params"].items():
                flat[f"{key}/params/{p}"] = t
        else:  # a params dict
            for p, t in v.items():
                flat[f"{key}/{p}"] = t
    return flat


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    np.savez(f"{outdir}/rank{rank}.npz", **_save(jobs(mesh)))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_codecs")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                               str(r), str(d / "rendezvous"), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    done = {}

    def wait():
        if not done:
            for r, p in enumerate(procs):
                log = p.communicate(timeout=300)[0]
                assert p.returncode == 0, f"rank {r}: {log[-4000:]}"
            done["outs"] = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
        return done["outs"]

    yield wait
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def in_process(ranks):
    return jobs(mesh_lib.make_debug_mesh(2, 2, device="cpu"))


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def _tp_dims():
    return dict(tree_leaves_with_path(sharding.tp_dims(_cfg(), 2)))


def _chunk(v, d, k):
    return v if d < 0 else np.split(v, 2, axis=d)[k]


# ---------------------------------------------------------------------------
# (a) the train step's codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CODECS)
def test_codec_at_model_two_is_the_model_one_codec(in_process, name):
    """Every in-process (2, 2) ``compress_workers`` call's decoded rows (and
    topk's new residual) are the model-1 codec's on the same rows, key and
    residual, bitwise."""
    calls = in_process[f"codec/{name}/calls"]
    assert len(calls) == STEPS
    one = D.InProcessAxes({"data": 2}, "cpu")
    for c in calls:
        want = rounds_dist.compress_workers(one, ("data",), c["g"], name, c["key"],
                                            residual=None if c["res"] is None
                                            else c["res"].clone())
        hat, new = want if c["res"] is not None else (want, None)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c["hat"]), tree_leaves(hat)))
        if new is not None:
            assert torch.equal(c["new"], new)
    assert (calls[0]["new"] is not None) == (name == "topk")


@pytest.mark.parametrize("name", CODECS)
def test_codec_on_the_ranks_is_their_chunks_of_the_in_process_codec(ranks, in_process, name):
    """Rank (w, k)'s decoded leaves are chunk k of worker w's in-process
    decoded leaves, its residual worker w's whole row, and its params its
    chunks of the in-process run's, bitwise."""
    dims = _tp_dims()
    calls = in_process[f"codec/{name}/calls"]
    params = in_process[f"codec/{name}/params"]
    params = params["params"] if "params" in params else params
    for r, out in enumerate(ranks()):
        w, k = divmod(r, 2)
        for i, c in enumerate(calls):
            for p, t in tree_leaves_with_path(c["hat"]):
                assert _bits_equal(out[f"codec/{name}/calls/{i}/hat/{p}"],
                                   _chunk(_np(t[w]), dims[p], k)), (r, i, p)
            if c["new"] is not None:
                assert _bits_equal(out[f"codec/{name}/calls/{i}/new"], _np(c["new"][w]))
        prefix = f"codec/{name}/params/params/" if name == "topk" else f"codec/{name}/params/"
        for p, v in params.items():
            assert _bits_equal(out[prefix + p], _chunk(v, dims[p], k)), (r, p)


def test_int8_with_the_reference_draw_is_the_reference_compress_tree(ranks, in_process):
    """Fed the reference's int8 draws (``draw=``), ``compress_workers`` at
    model 2 gives each worker the reference's ``compress_tree`` output on
    its whole tree: in process the worker's decoded tree, on rank (w, k)
    chunk k of it."""
    import jax

    from repro.rounds import compression as ref_comp

    cfg = _cfg()
    full = _worker_trees(cfg)
    dims = _tp_dims()
    key = jax.random.PRNGKey(REF_KEY)
    want = {}
    for w in range(2):
        tree = {p: jax.numpy.asarray(_np(t[w])) for p, t in tree_leaves_with_path(full)}
        nested = {}
        for p, v in tree.items():
            node = nested
            parts = p.split("/")
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = v
        hat, _ = ref_comp.compress_tree("int8", nested, key=jax.random.fold_in(key, w))
        for path, leaf in jax.tree_util.tree_flatten_with_path(hat)[0]:
            want[(w, "/".join(str(getattr(x, "key", x)) for x in path))] = np.asarray(leaf)
    got = in_process["ref_int8"]
    for p, t in tree_leaves_with_path(got):
        for w in range(2):
            assert _bits_equal(_np(t[w]), want[(w, p)]), (w, p)
    for r, out in enumerate(ranks()):
        w, k = divmod(r, 2)
        for p, _ in tree_leaves_with_path(got):
            assert _bits_equal(out[f"ref_int8/{p}"], _chunk(want[(w, p)], dims[p], k)), (r, p)


# ---------------------------------------------------------------------------
# (b) randomized attacks
# ---------------------------------------------------------------------------


def test_gauss_payloads_are_the_model_one_draw(in_process):
    """Each in-process gather payload at (2, 2) is the model-1 draw: the same
    attack on the same rows with a generator in the same state."""
    calls = in_process["gauss/gather/calls"]
    assert calls
    for c in calls:
        gen = torch.Generator().manual_seed(0)
        gen.set_state(c["state"])
        from repro_torch.core.attacks import apply_gradient_attack

        assert torch.equal(apply_gradient_attack(c["cfg"], c["rows"], c["mask"], generator=gen),
                           c["out"])


@pytest.mark.parametrize("strategy", GAUSS)
def test_gauss_on_the_ranks_is_their_chunks_of_the_in_process_run(ranks, in_process,
                                                                   strategy):
    """Under gauss each rank's params are its chunks of the in-process
    run's and its losses the same, bitwise; with the gather strategy each
    payload is its chunk of the in-process payload (the whole leaf drawn
    and cut)."""
    dims = _tp_dims()
    glob = in_process[f"gauss/{strategy}"]
    paths = list(glob["params"])
    calls = in_process[f"gauss/{strategy}/calls"]
    for r, out in enumerate(ranks()):
        w, k = divmod(r, 2)
        assert _bits_equal(out[f"gauss/{strategy}/loss"], glob["loss"])
        for p, v in glob["params"].items():
            assert _bits_equal(out[f"gauss/{strategy}/params/{p}"], _chunk(v, dims[p], k)), p
        if strategy == "gather":
            for i, c in enumerate(calls):
                d = dims[paths[i % len(paths)]]
                want = _chunk(_np(c["out"]), d + 1 if d >= 0 else -1, k)
                assert _bits_equal(out[f"gauss/{strategy}/calls/{i}/out"], want), (r, i)


# ---------------------------------------------------------------------------
# (c) the adapter's rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(ADAPT))
def test_adapter_round_is_the_model_one_function(in_process, run):
    """The in-process (2, 2) round's decoded / attacked rows are the model-1
    function on the round's rows (a generator in the same state)."""
    calls, agg, _ = in_process[f"adapt/{run}"]
    assert len(calls) == 1
    c = calls[0]
    gen = torch.Generator().manual_seed(0)
    gen.set_state(c["state"])
    if run == "int8":
        want, _ = comp_lib.compress_rows("int8", c["in"], generator=gen)
    else:
        want = atk_engine.apply_to_rows(c["attack"], c["in"], c["mask"], alpha=c["alpha"],
                                        generator=gen)
    assert torch.equal(c["out"], want)
    assert bool(torch.isfinite(agg).all())


@pytest.mark.parametrize("run", list(ADAPT))
def test_adapter_round_on_the_ranks(ranks, in_process, run):
    """On rank (w, k): the codec compresses the gathered global rows (the
    in-process rows' output, bitwise) and the attack's payload is its
    columns of the in-process attacked rows; the aggregate its columns."""
    calls, agg, _ = in_process[f"adapt/{run}"]
    for r, out in enumerate(ranks()):
        mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
        from repro_torch.serve.engine import ModelShards

        shards = ModelShards(_cfg(), mesh)
        shards.per_rank, shards.k = True, r % 2
        shards.specs = steps.param_shardings(_cfg(), mesh)
        shards.dim_tree = sharding.tp_dims(_cfg(), 2)
        shards.dims = tree_leaves(shards.dim_tree)
        shards.meta = T.meta_params(_cfg())
        shards.sizes = [t.numel() for t in tree_leaves(shards.meta)]
        got = out[f"adapt/{run}/0/out"]
        want = calls[0]["out"] if run == "int8" else shards.cut_flat(calls[0]["out"])
        assert _bits_equal(got, _np(want)), r
        assert _bits_equal(out[f"adapt/{run}/agg"], _np(shards.cut_flat(agg))), r


@pytest.mark.parametrize("block", [7, 64, 1 << 26])
def test_the_cards_sketch_accumulation_is_index_add(block):
    """The count sketch's accumulation on the card (``_put_accumulate``:
    index_put_ with accumulate, a block of coordinates at a time, which the
    card runs in a fixed order where index_add_ uses atomics) adds every
    bucket's terms in coordinate order: at a size where the CPU's
    index_put_ runs serially it is bitwise index_add_, the CPU's
    accumulation, for one row and for (m, d) rows."""
    g = torch.Generator().manual_seed(block)
    d, w = 200, 37
    h = torch.randint(0, w, (d,), generator=g)
    for shape in ((d,), (3, d)):
        vals = torch.randn(shape, generator=g)
        want = torch.zeros(shape[:-1] + (w,)).index_add_(len(shape) - 1, h, vals)
        got = comp_lib._put_accumulate(torch.zeros(shape[:-1] + (w,)), h, vals, block)
        assert torch.equal(got, want), shape


def test_the_cpus_sketch_accumulation_is_serial_at_any_size():
    """On the CPU ``sketch_accumulate`` is index_add_: bitwise the serial
    sum in coordinate order (numpy's ``add.at``) at a size where the CPU's
    index_put_ accumulates in parallel, on every call; a worker's codec
    call must give the same bits on every model rank."""
    g = torch.Generator().manual_seed(1)
    d = 1 << 20
    w = d // 2
    h = torch.randint(0, w, (d,), generator=g)
    for shape in ((d,), (2, d)):  # a worker's one row, as compress_tree gives it
        vals = torch.randn(shape, generator=g)
        got = [comp_lib.sketch_accumulate(torch.zeros(shape[:-1] + (w,)), h, vals)
               for _ in range(2)]
        assert torch.equal(got[0], got[1]), shape
        for r, row in enumerate(vals.reshape(-1, d)):
            want = np.zeros(w, np.float32)
            np.add.at(want, h.numpy(), row.numpy())
            assert _bits_equal(got[0].reshape(-1, w)[r].numpy(), want), (shape, r)
