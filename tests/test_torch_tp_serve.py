"""Serving under tensor parallelism in the port (a mesh's ``model`` axis > 1):
the prefill and decode on the model shards, the slot pool on each rank's kv
heads, the engine, the feedback adapter's rounds, snapshots across model
sizes and the two serve CLIs, over ``make_debug_mesh(data, model)`` and 4
gloo ranks at (data 2, model 2).

The reference's serving under a model axis does not run in this jax (its
embedding gather raises ``ShardingTypeError`` once the params carry
model-axis shardings), so the port's model-2 serving is held against the
reference's slot steps at model 1 (``make_debug_mesh(1, 1)``, unsharded
params, as tests/test_torch_serve.py runs them: the same function), against
the port's own model-1 run and across processes, and the assertions of the
reference's failing serve tests (tests/test_serve.py) are rerun on the port
at (2, 2).  The 4 gloo ranks are spawned once for the module (a ``file://``
rendezvous, every join with a timeout) and run :func:`run_rank` while the
in-process tests run.

Tolerances, stated where used:
- logits at model 2 against the reference's (and the port's) model 1, f32:
  1e-5 absolute (tests/test_torch_serve.py's; magnitudes below 1);
- greedy tokens: equal wherever the model-1 top-2 logit gap exceeds twice
  that tolerance; at a smaller gap a flip is allowed and the request's
  comparison ends there;
- the adapter's (m, D) rows at model 2 against model 1: 1e-5 times
  max(1, the rows' largest magnitude) (row-parallel partials are summed
  in another order); the aggregate is bitwise the plain version's on the
  rows it was given;
- gloo ranks against the in-process (2, 2) run: bitwise (a sum of two
  partials is the same in either order): tokens, each rank's rows and
  aggregate against its columns of the global ones, snapshots and the
  ``final iterate sha256`` lines.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import steps as RS
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.fed.population import ArrivalConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.rounds import engine as rounds_engine
from repro_torch.serve import run as serve_run
from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter, RoundFn, init_adapt_state
from repro_torch.serve.engine import ModelShards, ServeConfig, ServeEngine, serve_stream
from repro_torch.serve.traffic import TrafficConfig, VirtualUsers
from repro_torch.tree import ravel, tree_leaves, tree_map

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # the gloo ranks: (data 2, model 2)
LOGIT_TOL = 1e-5
ROWS_RTOL = 1e-5
SCFG = ServeConfig(slots=3, prompt_len=8, max_new=6, window=16)
# (name, config, overrides of both packages' smoke configs): every attention
# mode of the model axis at model 2 — whole kv heads (llama), expert-parallel
# MoE with the lm head split on V (granite) or, at an odd vocab, on d_model
# (its partial logits summed), one kv head split over two ranks, rank 1
# holding none (qwen3-smoke's ``padded`` attention, the key's name older
# than the mode) and the ring cache of a sliding window (h2o-danube-smoke's 16,
# crossed by a 12-token prompt and 10 new tokens); the SSD mixer (mamba2)
# and the RG-LRU hybrid (recurrentgemma) whole on every rank from gathered
# in-projections, their out-projections row-parallel
REF_CASES = {
    "llama": ("llama3.2-3b", {}),
    "granite": ("granite-moe-1b-a400m", {}),
    "granite_odd_vocab": ("granite-moe-1b-a400m", {"vocab": 257}),
    "qwen3_gathered": ("qwen3-14b", {}),
    "danube_ring": ("h2o-danube-1.8b", {}),
    "mamba2_ssm": ("mamba2-2.7b", {}),
    "recurrentgemma_rec": ("recurrentgemma-2b", {}),
}
REF_PROMPT, REF_NEW = {"danube_ring": (12, 10)}, (8, 6)
SERVE_CI = ["--device", "cpu", "--smoke", "--arch", "llama3_2_3b", "--workers", "2",
            "--model-par", "2", "--requests", "24", "--alpha", "0.25", "--attack",
            "feedback_flip"]
# the reference's test_cli_end_to_end_two_workers flags, at (2, 2)
CLI_E2E = ["--device", "cpu", "--smoke", "--arch", "llama3_2_3b", "--workers", "2",
           "--model-par", "2", "--requests", "12", "--slots", "2", "--shards", "2",
           "--num-users", "200", "--alpha", "0.5", "--attack", "feedback_flip",
           "--adapt-every", "6", "--batch-per-shard", "1", "--method", "median",
           "--latency", "zero"]
ADAPT = AdaptConfig(adapt_every=3, batch_per_shard=1)
STREAM = 16  # requests of the adapter streams

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_tp_serve as T
T.run_rank(int(sys.argv[2]), *sys.argv[3:])
"""


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _cfg(arch="llama3.2-3b", **over):
    return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32", **over)


def _params(cfg):
    return T.init_params(cfg, 0, "cpu")


def _tcfg(cfg, alpha=0.5, shards=2, latency="zero"):
    return TrafficConfig(num_users=64, num_shards=shards, alpha=alpha, attack="feedback_flip",
                         prompt_len=SCFG.prompt_len, min_gen=1, max_gen=SCFG.max_new,
                         vocab=cfg.vocab, arrival=ArrivalConfig(latency=latency, scale=2.0))


def _mesh(data, model):
    return mesh_lib.make_debug_mesh(data, model, device="cpu")


class _RecordingUsers(VirtualUsers):
    """VirtualUsers that records every round batch it builds."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.batches = []

    def build_round(self, per_shard, rnd):
        batch = super().build_round(per_shard, rnd)
        self.batches.append(batch)
        return batch


def _assert_trees_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and tuple(x.shape) == tuple(y.shape)
        assert torch.equal(x, y)


def _responses(done):
    return {c.request.rid: c.response.tolist() for c in done}


def _teacher_forced(prefill, decode, prompt, toks):
    """Logits (len(toks), V) of every generation step, fed ``toks``."""
    logits, cache = prefill(prompt)
    out = [logits[0, -1]]
    for j, t in enumerate(toks[:-1]):
        logits, cache = decode(t, cache, len(prompt) + j)
        out.append(logits[0, 0])
    return np.stack([np.asarray(x, np.float32) for x in out])


def _port_teacher_forced(cfg, params, mesh, cache_len, prompt, toks):
    prefill = steps.make_prefill_step(cfg, kv_block=0, cache_len=cache_len, mesh=mesh)
    decode = steps.make_decode_step(cfg, mesh)
    return _teacher_forced(
        lambda p: prefill(params, torch.as_tensor(p, dtype=torch.int64)[None]),
        lambda t, cache, pos: decode(params, torch.tensor([[int(t)]]), cache, pos),
        prompt, toks)


def _flips_allowed(got_tokens, want_tokens, want_logits):
    """Tokens equal wherever the top-2 gap of ``want_logits`` exceeds twice
    the logit tolerance; returns 1 at a flip (the comparison ends)."""
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    for j, (a, b) in enumerate(zip(got_tokens, want_tokens)):
        if a != b:
            assert gap[j] <= 2 * LOGIT_TOL, (j, gap[j])
            return 1
    return 0


def _index_columns(cfg, model, k):
    """Model rank ``k``'s columns of the global ravel, in its own ravel
    order: the ravel of an index tree cut by ``steps.tp_shard`` (the
    training path's shard cut, independent of the adapter's)."""
    meta = T.meta_params(cfg)
    sizes = [t.numel() for t in tree_leaves(meta)]
    idx = iter(torch.split(torch.arange(sum(sizes), dtype=torch.int64), sizes))
    tree = tree_map(lambda t: next(idx).reshape(t.shape), meta)
    mesh = mesh_lib.Mesh(("data", "model"), (2, model), torch.device("cpu"), None)
    return ravel(steps.tp_shard(tree, steps.param_shardings(cfg, mesh), k, model))[0]


# ---------------------------------------------------------------------------
# the gloo ranks
# ---------------------------------------------------------------------------


def _stream_reqs(cfg, n=8):
    return VirtualUsers(_tcfg(cfg, alpha=0.0)).sample_requests(n)


def _round_batch(cfg, shards=4):
    """A fixed round batch of ``shards`` shards (one Byzantine of four,
    ``feedback_flip``): a completion a shard of a model-1 engine run."""
    users = VirtualUsers(_tcfg(cfg, alpha=0.25, shards=shards))
    done = serve_stream(ServeEngine(cfg, SCFG, _params(cfg)), users.sample_requests(24))
    per_shard = [[c for c in done if c.request.shard == s][:1] for s in range(shards)]
    assert all(per_shard)
    return users.build_round(per_shard, 0)


def _adapter_run(cfg, mesh, ckpt_dir=None):
    """The recorded adaptation stream at ``mesh``: (final iterate digest,
    the round batches, the adapter)."""
    params = _params(cfg)
    users = _RecordingUsers(_tcfg(cfg))
    adapter = FeedbackAdapter(cfg, ADAPT, users, params, ckpt_dir=ckpt_dir, mesh=mesh)
    engine = ServeEngine(cfg, SCFG, params, mesh)
    serve_stream(engine, users.sample_requests(STREAM), adapter=adapter)
    return serve_run.iterate_digest(adapter.global_iterate()), users.batches, adapter


def _replay(cfg, mesh, ckpt_dir, batches, rnd=1):
    """A fresh adapter at ``mesh`` restored from ``ckpt_dir``'s round ``rnd``
    snapshot, the batches from there replayed: the final iterate digest."""
    adapter = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg), mesh=mesh)
    adapter.restore(ckpt_dir, rnd)
    for batch in batches[rnd:]:
        adapter.run_round(batch)
    return serve_run.iterate_digest(adapter.global_iterate())


def _batches_np(batches):
    return {f"batch/{i}/{k}": v.numpy() for i, b in enumerate(batches) for k, v in b.items()}


def _batches_from(out):
    n = 1 + max(int(k.split("/")[1]) for k in out if k.startswith("batch/"))
    return [{k.split("/")[2]: torch.from_numpy(v) for k, v in out.items()
             if k.startswith(f"batch/{i}/")} for i in range(n)]


def jobs(mesh, outdir, tag):
    """The jobs both the gloo ranks and the in-process (2, 2) mesh run:
    engine tokens, one round's rows and aggregate, the adapter stream with
    snapshots and its restart, and a model-1 snapshot restored here."""
    cfg = _cfg()
    out = {}
    # the batch steps: a global batch of 4 rows, cut over the workers under
    # the process group (the rank's rows and kv heads, as cache_shardings
    # names them), whole in process
    held = ModelShards(cfg, mesh).cut(_params(cfg))  # the rank's shards under the group
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (4, 8)))
    logits, cache = steps.make_prefill_step(cfg, cache_len=12, mesh=mesh)(held, tokens)
    tok = torch.argmax(logits[:, -1], -1, keepdim=True)
    out["decode_logits"] = steps.make_decode_step(cfg, mesh)(held, tok, cache, 8)[0].numpy()
    out["cache_k"] = cache["blocks"]["p0_attn"]["k"].numpy()
    done = serve_stream(ServeEngine(cfg, SCFG, _params(cfg), mesh), _stream_reqs(cfg))
    for rid, toks in _responses(done).items():
        out[f"tokens/{rid}"] = np.asarray(toks)
    mamba = _cfg("mamba2-2.7b")  # a row-parallel w_out after the whole SSD mixer
    done = serve_stream(ServeEngine(mamba, SCFG, _params(mamba), mesh), _stream_reqs(mamba))
    for rid, toks in _responses(done).items():
        out[f"mamba_tokens/{rid}"] = np.asarray(toks)
    fn = RoundFn(cfg, AdaptConfig(method="median", batch_per_shard=1), mesh)
    state = init_adapt_state(fn.shards.cut(_params(cfg)) if fn.shards.per_rank
                             else _params(cfg), fn.acfg, 4)
    state, norm = fn(state, _round_batch(cfg))
    out["rows"], out["agg"], out["norm"] = fn.rows.numpy(), state["prev_agg"].numpy(), \
        np.asarray(float(norm))
    ck = os.path.join(outdir, f"ck_{tag}")
    digest, batches, _ = _adapter_run(cfg, mesh, ck)
    if mesh.per_rank:
        import torch.distributed as dist

        dist.barrier()  # rank 0 wrote the snapshots
    out["digest"] = np.asarray(digest)
    out["replayed"] = np.asarray(_replay(cfg, mesh, ck, batches))
    restored = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg), mesh=mesh)
    restored.restore(ck, 1)
    out["restored_prev_agg"] = restored.state["prev_agg"].numpy()
    out["restored_embed"] = restored.state["w"]["embed"].numpy()
    out.update(_batches_np(batches))
    # a model-1 snapshot (this process's own, no mesh) restored at ``mesh``
    m1 = os.path.join(outdir, f"m1_{tag}{mesh.rank}")
    one = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg), ckpt_dir=m1)
    one.run_round(batches[0])
    out["from_model_one"] = np.asarray(_replay(cfg, mesh, m1, batches))
    return out


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    """One rank of the module's process group at (data 2, model 2): the
    jobs on this rank's shards and the serve CLI under ``--mesh single``."""
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    out = jobs(mesh, outdir, "pg")
    out["cli"] = np.asarray(_cli(serve_run.main, SERVE_CI + ["--mesh", "single"]))
    out["model_rank"] = np.asarray(mesh_lib.model_rank(mesh))
    out["data_rank"] = np.asarray(mesh.axes.coords["data"])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The 4 gloo ranks, started once for the module (the in-process tests
    run while they do)."""
    d = tmp_path_factory.mktemp("tp_serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    started = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, os.path.join(ROOT, "tests"),
                                 str(r), str(d / "rendezvous"), str(d)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for r in range(WORLD)]
    results = {}

    def wait():
        if not results:
            for r, p in enumerate(started):
                log = p.communicate(timeout=300)[0]
                assert p.returncode == 0, f"rank {r}: {log[-4000:]}"
                results[r] = dict(np.load(d / f"rank{r}.npz"))
        return results, d

    yield wait
    for p in started:
        p.kill()


@pytest.fixture(scope="module")
def in_process(procs, tmp_path_factory):
    """The ranks' jobs over the in-process (2, 2) mesh (run while they do)."""
    d = tmp_path_factory.mktemp("tp_serve_in_process")
    return jobs(_mesh(2, 2), str(d), "ip"), d


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _digests(text):
    return [ln for ln in str(text).splitlines() if ln.startswith("final iterate sha256")]


# ---------------------------------------------------------------------------
# (a) against the reference at model 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(REF_CASES))
def ref_case(request):
    """One configuration in f32: the reference's params (PRNGKey 0) carried
    to the port, the reference's greedy tokens through its slot steps on
    make_debug_mesh(1, 1) and its teacher-forced logits at model 1."""
    arch, over = REF_CASES[request.param]
    rc = dataclasses.replace(ref_get_smoke_config(arch), dtype="float32", **over)
    pc = _cfg(arch, **over)
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    plen, new = REF_PROMPT.get(request.param, REF_NEW)
    cache_len = plen + new
    mesh = ref_debug_mesh(1, 1)
    prefill = RS.make_slot_prefill_step(rc, mesh, cache_len)
    tick = RS.make_decode_pool_step(rc, mesh)
    admit = RS.make_slot_admit_step()
    prompts = np.random.default_rng(7).integers(0, pc.vocab, (2, plen)).astype(np.int32)
    ref_prefill = jax.jit(lambda t: RT.prefill(rp, t, rc, kv_block=0, cache_len=cache_len))
    ref_decode = jax.jit(lambda t, cache, pos: RT.decode_step(rp, t, cache, pos, rc))
    want = []
    for prompt in prompts:
        logits, cache = prefill(rp, jnp.asarray(prompt)[None])
        toks = [int(jnp.argmax(logits[0, -1].astype(jnp.float32)))]
        pool = admit(RS.init_slot_pool(rc, 1, cache_len), cache, jnp.int32(0))
        pos = plen
        while len(toks) < new:
            nxt, pool = tick(rp, jnp.asarray([[[toks[-1]]]], jnp.int32), pool,
                             jnp.asarray([pos], jnp.int32))
            toks.append(int(nxt[0]))
            pool = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), pool)
            pos += 1
        logits = _teacher_forced(
            lambda p: ref_prefill(jnp.asarray(p, jnp.int32)[None]),
            lambda t, cache, pos: ref_decode(jnp.asarray([[t]], jnp.int32), cache,
                                             jnp.int32(pos)),
            prompt, toks)
        want.append((prompt, toks, logits))
    return request.param, pc, pp, cache_len, want


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_prefill_and_decode_at_model_two_match_the_reference(ref_case, mesh_shape):
    """Prefill and every decode step's logits on the model shards within
    1e-5 of the reference's model-1 logits (teacher-forced on the
    reference's greedy tokens through its slot steps); the port's greedy
    tokens through its slot pool at this mesh equal the reference's
    wherever the top-2 gap allows."""
    name, pc, pp, cache_len, want = ref_case
    mesh = _mesh(*mesh_shape)
    prefill = steps.make_slot_prefill_step(pc, cache_len, mesh)
    tick = steps.make_decode_pool_step(pc, mesh)
    admit = steps.make_slot_admit_step()
    flips = 0
    for prompt, toks, logits in want:
        got = _port_teacher_forced(pc, pp, mesh, cache_len, prompt, toks)
        np.testing.assert_allclose(got, logits, atol=LOGIT_TOL, rtol=0, err_msg=name)
        first, cache = prefill(pp, torch.as_tensor(prompt, dtype=torch.int64)[None])
        mine = [int(torch.argmax(first[0, -1]))]
        pool = admit(steps.init_slot_pool(pc, 1, cache_len, "cpu", mesh), cache, 0)
        while len(mine) < len(toks):
            nxt, pool = tick(pp, torch.tensor([mine[-1]]), pool,
                             torch.tensor([len(prompt) + len(mine) - 1]))
            mine.append(int(nxt[0]))
        flips += _flips_allowed(mine, toks, logits)
    assert flips <= 1


def test_model_two_cache_holds_each_rank_s_kv_heads():
    """The prefill cache at (2, 2) is model 1's cache (in process the ranks'
    heads side by side), and a rank's slice (``cache_dims`` /
    ``shard_cache``) is its kv heads: half of llama-smoke's two, and of
    qwen3-smoke's one kv head (``padded``) rank 0's all and rank 1's none;
    the slot pool under a process group is a rank's heads."""
    from repro_torch.models import sharding

    for arch in ("llama3.2-3b", "qwen3-14b"):
        cfg = _cfg(arch)
        params = _params(cfg)
        tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(1))
        _, cache = T.prefill(params, tokens, cfg, cache_len=12,
                             ctx=sharding.model_ctx(_mesh(2, 2)))
        _, want = T.prefill(params, tokens, cfg, cache_len=12)
        for a, b in zip(tree_leaves(cache), tree_leaves(want)):
            torch.testing.assert_close(a, b, atol=LOGIT_TOL, rtol=0)
        mesh = _mesh(2, 2)
        dims = sharding.cache_dims(cfg, 2, cache, steps.cache_shardings(cfg, mesh, cache))
        kv = cfg.n_kv_heads
        for path_dim, leaf in zip(tree_leaves(dims), tree_leaves(cache)):
            assert path_dim == (leaf.dim() - 2 if leaf.dim() >= 4 else -1)
        for k in range(2):
            part = sharding.shard_cache(cache, dims, k, 2)
            k_leaf = part["blocks"]["p0_attn"]["k"]
            a, b = sharding.kv_heads(kv, 2, k)
            assert k_leaf.shape[-2] == b - a == (kv // 2 if kv % 2 == 0 else 1 - k)
            assert torch.equal(k_leaf, cache["blocks"]["p0_attn"]["k"][..., a:b, :])
            assert torch.equal(part["blocks"]["p0_attn"]["kpos"],
                               cache["blocks"]["p0_attn"]["kpos"])
        per_rank = mesh_lib.Mesh(("data", "model"), (2, 2), torch.device("cpu"),
                                 SimpleNamespace(coords={"data": 0, "model": 1}), rank=1,
                                 per_rank=True)
        pool = steps.init_slot_pool(cfg, 3, 12, "cpu", mesh=per_rank)  # model rank 1
        a, b = sharding.kv_heads(kv, 2, 1)
        assert pool["blocks"]["p0_attn"]["k"].shape[-2] == b - a
        assert pool["blocks"]["p0_attn"]["kpos"].shape == (cfg.n_layers, 3, 12)


# ---------------------------------------------------------------------------
# (b) against the port's own model-1 run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_engine_tokens_and_slot_count_invariance_at_model_two(arch):
    """The engine at (2, 2) serves model 1's tokens (f32, the top-2 rule
    against model 1's teacher-forced logits), the same bitwise on 1 and 3
    slots, and a single-token budget completes at admit."""
    cfg = _cfg(arch)
    params = _params(cfg)
    reqs = _stream_reqs(cfg, 10)
    one = _responses(serve_stream(ServeEngine(cfg, SCFG, params, _mesh(2, 1)), reqs))
    two = {slots: _responses(serve_stream(ServeEngine(
        cfg, dataclasses.replace(SCFG, slots=slots), params, _mesh(2, 2)), reqs))
        for slots in (1, 3)}
    assert two[1] == two[3] and len(two[3]) == len(reqs)
    flips = 0
    for req in reqs:
        want = _port_teacher_forced(cfg, params, None, SCFG.cache_len, req.prompt,
                                    one[req.rid])
        flips += _flips_allowed(two[3][req.rid], one[req.rid], want)
    assert flips <= 1
    engine = ServeEngine(cfg, SCFG, params, _mesh(2, 2))
    req = dataclasses.replace(reqs[0], gen_len=1)
    done = engine.admit(0, req)
    assert done is not None and done.response.shape == (1,) and engine.num_active() == 0


@pytest.mark.parametrize("method", ["median", "trimmed_mean"])
def test_round_rows_and_aggregate_at_model_two(method):
    """One adaptation round at (2, 2) over four shards: the (m, D) rows
    within 1e-5 relative of model 1's, the aggregate bitwise the plain
    version's (B1 / B2's selection network) on those rows — one call over
    the global rows, as at model 1 — and the norm that of the aggregate."""
    from repro_torch.kernels import selection_network as SN

    cfg = _cfg()
    batch = _round_batch(cfg)
    acfg = AdaptConfig(method=method, beta=0.25, batch_per_shard=1)
    got = {}
    for model in (1, 2):
        fn = RoundFn(cfg, acfg, _mesh(2, model))
        state, norm = fn(init_adapt_state(_params(cfg), acfg, 4), batch)
        got[model] = (fn.rows.clone(), state["prev_agg"], float(norm))
    rows, agg, norm = got[2]
    assert rows.shape == (4, T.count_params(cfg))
    scale = max(1.0, float(got[1][0].abs().max()))
    torch.testing.assert_close(rows, got[1][0], atol=ROWS_RTOL * scale, rtol=0)
    want = SN.median_select(rows) if method == "median" else SN.trimmed_mean_select(rows, 1)
    assert torch.equal(agg, want)
    assert norm == pytest.approx(float(torch.linalg.vector_norm(agg)), rel=1e-6)


def test_storage_kept_across_swaps_at_model_two():
    """At (2, 2) the served tensors and the pool keep their storage across
    admits, retires, slot reuse and hot swaps, and a swap of the global
    iterate serves it."""
    cfg = _cfg()
    params = _params(cfg)
    engine = ServeEngine(cfg, SCFG, params, _mesh(2, 2))
    users = VirtualUsers(_tcfg(cfg, latency="exponential"))
    assert len(serve_stream(engine, users.sample_requests(10))) == 10
    bumped = tree_map(lambda w: w + torch.ones((), dtype=w.dtype), engine.params)
    assert engine.swap_params(bumped) == 1
    _assert_trees_bitwise(engine.params, bumped)
    assert len(serve_stream(engine, users.sample_requests(6, stream=1))) == 6
    assert engine.storage_kept() == {"params": True, "pool": True}


# ---------------------------------------------------------------------------
# (c) the reference's serve tests (tests/test_serve.py:187-338) at (2, 2)
# ---------------------------------------------------------------------------


def test_hot_swap_and_snapshot_bit_equality(tmp_path):
    """After serving with adaptation at (2, 2): the engine's params ARE the
    adapter's iterate, every round swapped once, and the snapshot restores
    the RoundState bit for bit — at (2, 2) and at model 1."""
    cfg = _cfg()
    params = _params(cfg)
    users = VirtualUsers(_tcfg(cfg))
    acfg = AdaptConfig(adapt_every=4, batch_per_shard=1)
    mesh = _mesh(2, 2)
    adapter = FeedbackAdapter(cfg, acfg, users, params, ckpt_dir=str(tmp_path), mesh=mesh)
    engine = ServeEngine(cfg, SCFG, params, mesh)
    serve_stream(engine, users.sample_requests(16), adapter=adapter)
    assert adapter.rounds_done >= 1
    assert engine.params_version == adapter.rounds_done
    _assert_trees_bitwise(engine.params, adapter.state["w"])
    assert engine.storage_kept() == {"params": True, "pool": True}
    assert rounds_engine.latest_round(str(tmp_path)) == adapter.rounds_done
    for restore_mesh in (mesh, None):  # model 2 and model 1
        again = FeedbackAdapter(cfg, acfg, VirtualUsers(_tcfg(cfg)), params, mesh=restore_mesh)
        again.restore(str(tmp_path))
        assert again.rounds_done == adapter.rounds_done
        _assert_trees_bitwise(again.state, adapter.state)


def test_serving_round_equals_offline_round():
    """The rounds fired inside serve_stream at (2, 2) reproduce bit for bit
    when the identical batches drive the identical round function without
    an engine."""
    cfg = _cfg()
    params = _params(cfg)
    users = _RecordingUsers(_tcfg(cfg))
    acfg = AdaptConfig(adapt_every=4, batch_per_shard=1)
    online = FeedbackAdapter(cfg, acfg, users, params, mesh=_mesh(2, 2))
    serve_stream(ServeEngine(cfg, SCFG, params, _mesh(2, 2)), users.sample_requests(16),
                 adapter=online)
    assert len(users.batches) == online.rounds_done >= 1
    offline = FeedbackAdapter(cfg, acfg, VirtualUsers(_tcfg(cfg)), params, mesh=_mesh(2, 2))
    for batch in users.batches:
        offline.run_round(batch)
    _assert_trees_bitwise(online.state, offline.state)
    assert [h["grad_norm"] for h in online.history] == [h["grad_norm"] for h in offline.history]


def test_restart_from_snapshot_replays_bit_for_bit(tmp_path):
    """Kill and resume at (2, 2): the round-1 snapshot restored, the rest
    of the batches replayed, lands on the uninterrupted run's digest; a
    model-2 snapshot restored at model 1 and replayed there lands on model
    1's own restart from a model-1 snapshot of the same state."""
    cfg = _cfg()
    mesh = _mesh(2, 2)
    digest, batches, full = _adapter_run(cfg, mesh, str(tmp_path / "ck"))
    assert full.rounds_done >= 2
    assert _replay(cfg, mesh, str(tmp_path / "ck"), batches) == digest
    one = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg),
                          ckpt_dir=str(tmp_path / "m1"))
    one.state = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg),
                                mesh=mesh).state
    one.restore(str(tmp_path / "ck"), 1)
    rounds_engine.save_snapshot(str(tmp_path / "m1"), one.state)
    assert _replay(cfg, None, str(tmp_path / "ck"), batches) == \
        _replay(cfg, None, str(tmp_path / "m1"), batches)


def test_cli_end_to_end_two_workers(tmp_path):
    """The serve CLI at (2, 2) with the reference's two-worker flags: every
    request served, robust rounds fired, the storage kept, snapshots
    written and the digest line printed."""
    text = _cli(serve_run.main, CLI_E2E + ["--ckpt-dir", str(tmp_path / "ck")])
    assert "served 12/12 requests" in text
    assert "mesh={'data': 2, 'model': 2}" in text
    assert "storage kept: {'params': True, 'pool': True}" in text
    assert "adaptation rounds: 0" not in text
    assert rounds_engine.latest_round(str(tmp_path / "ck")) >= 1
    assert len(_digests(text)) == 1


# ---------------------------------------------------------------------------
# (d) the shim, and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_shim_serves_at_data_four_model_two(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke`` with the
    reference's defaults (the debug mesh, 4 workers, model 2) serves every
    request."""
    args = launch_serve.build_parser().parse_args(["--arch", arch])
    assert (args.mesh, args.workers, args.model_par, args.device) == ("debug", 4, 2, "cuda")
    text = _cli(launch_serve.main, ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                                    "8", "--gen", "4", "--device", "cpu"])
    assert "mesh debug workers=4 model_par=2; device cpu; mesh={'data': 4, 'model': 2}" in text
    assert "served 2/2 requests" in text


def test_the_serving_refusals():
    """mamba2 and recurrentgemma at model 2 build every serving piece (the
    steps, the engine, the round function; both CLIs serve them: the shim
    in test_shim_serves_at_data_four_model_two); codecs and randomized
    gradient attacks run there (step 7): a round at (2, 2) with
    ``compression='int8'`` and one with ``grad_attack='gauss'`` build and
    run, their aggregates finite; whisper and internvl2 keep their
    ValueError in the engine and the round function, while their prefill /
    decode steps build at model 2 (step 8)."""
    mesh = _mesh(2, 2)
    for arch in ("mamba2-2.7b", "recurrentgemma-2b"):
        cfg = configs.get_smoke_config(arch)
        steps.make_slot_prefill_step(cfg, 16, mesh)
        steps.make_decode_pool_step(cfg, mesh)
        ServeEngine(cfg, SCFG, _params(cfg), mesh)
        RoundFn(cfg, AdaptConfig(), mesh)
    cfg = _cfg()
    batch = _round_batch(cfg)
    for acfg in (AdaptConfig(compression="int8", batch_per_shard=1),
                 AdaptConfig(grad_attack="gauss", grad_alpha=0.5, batch_per_shard=1)):
        state, norm = RoundFn(cfg, acfg, mesh)(init_adapt_state(_params(cfg), acfg, 2), batch)
        assert bool(torch.isfinite(state["prev_agg"]).all()) and bool(torch.isfinite(norm))
    RoundFn(cfg, AdaptConfig(grad_attack="gauss", grad_alpha=0.5), _mesh(2, 1))
    RoundFn(cfg, AdaptConfig(grad_attack="mimic", grad_alpha=0.5), mesh)
    for arch in ("whisper-small", "internvl2-1b"):
        cfg = configs.get_smoke_config(arch)
        with pytest.raises(ValueError, match="frontend cannot be served"):
            ServeEngine(cfg, SCFG, _params(cfg), mesh)
        with pytest.raises(ValueError, match="frontend cannot be served"):
            RoundFn(cfg, AdaptConfig(), mesh)
        # step 8: the serving steps themselves build at model 2
        steps.make_slot_prefill_step(cfg, 16, mesh)
        steps.make_decode_pool_step(cfg, mesh)
        steps.make_prefill_step(cfg, mesh=mesh)


def test_leaf_global_attack_at_model_two():
    """mimic (a leaf-global attack) at (2, 2) picks the row model 1 picks:
    the round's aggregate within the rows' tolerance of model 1's."""
    cfg = _cfg()
    batch = _round_batch(cfg)
    acfg = AdaptConfig(method="median", batch_per_shard=1, grad_attack="mimic", grad_alpha=0.5)
    aggs = []
    for model in (1, 2):
        fn = RoundFn(cfg, acfg, _mesh(2, model))
        state, _ = fn(init_adapt_state(_params(cfg), acfg, 2), batch)
        aggs.append(state["prev_agg"])
    scale = max(1.0, float(aggs[0].abs().max()))
    torch.testing.assert_close(aggs[1], aggs[0], atol=ROWS_RTOL * scale, rtol=0)


# ---------------------------------------------------------------------------
# (e) 4 gloo ranks at (data 2, model 2) against the in-process run
# ---------------------------------------------------------------------------


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                                         b.view(np.uint8))


def test_gloo_ranks_serve_the_in_process_tokens(procs, in_process):
    """Every rank serves the in-process (2, 2) engine's tokens, llama's and
    mamba2's; the batch prefill and decode steps give a rank its block of
    rows (whole logits) and its kv heads of the cache, bitwise the
    in-process run's."""
    outs, _ = procs()
    ip, _ = in_process
    for out in outs.values():
        for prefix in ("tokens/", "mamba_tokens/"):
            keys = [k for k in ip if k.startswith(prefix)]
            assert keys and all(np.array_equal(out[k], ip[k]) for k in keys), prefix
        w, k = int(out["data_rank"]), int(out["model_rank"])
        assert _bits_equal(out["decode_logits"], ip["decode_logits"][2 * w:2 * w + 2])
        kv = ip["cache_k"].shape[-2] // 2
        assert _bits_equal(out["cache_k"], np.ascontiguousarray(
            ip["cache_k"][:, 2 * w:2 * w + 2, :, k * kv:(k + 1) * kv]))


def test_gloo_rank_rows_are_its_columns_of_the_global_rows(procs, in_process):
    """Each rank's (m, D_rank) rows and its aggregate are bitwise its columns
    of the in-process (2, 2) round's global rows and aggregate (the columns
    from ``steps.tp_shard`` of an index tree); the norm psums the split
    columns' squares over the model axis."""
    outs, _ = procs()
    ip, _ = in_process
    cfg = _cfg()
    for out in outs.values():
        cols = _index_columns(cfg, 2, int(out["model_rank"])).numpy()
        assert out["rows"].shape == (4, len(cols)) and len(cols) < ip["rows"].shape[1]
        assert _bits_equal(out["rows"], ip["rows"][:, cols])
        assert _bits_equal(out["agg"], ip["agg"][cols])
        # the psummed norm against the global aggregate's, summed in f64 (the
        # in-process round's is model 1's torch.linalg.vector_norm, whose f32
        # CPU reduction over 10^6 squares reads 7e-5 low here)
        exact = float(np.sqrt(np.sum(ip["agg"].astype(np.float64) ** 2)))
        assert float(out["norm"]) == pytest.approx(exact, rel=1e-6)


def test_gloo_ranks_snapshots_and_restarts(procs, in_process):
    """Under the process group: the adapter stream's digest is the
    in-process run's on every rank; a restart from the round-1 snapshot
    (written once, by rank 0, as the global state) replays it bit for bit;
    a model-1 snapshot restored on the ranks replays to the in-process
    (2, 2) restore's digest; the ranks' snapshot restores at model 1 as the
    in-process (2, 2) run's does."""
    outs, d = procs()
    ip, ipd = in_process
    cfg = _cfg()
    for out in outs.values():
        assert str(out["digest"]) == str(ip["digest"]) == str(out["replayed"])
        assert str(out["from_model_one"]) == str(ip["from_model_one"])
        # a restore cuts the rank's part of the global state
        k = int(out["model_rank"])
        cols = _index_columns(cfg, 2, k).numpy()
        assert _bits_equal(out["restored_prev_agg"], ip["restored_prev_agg"][cols])
        assert _bits_equal(out["restored_embed"],
                           np.array_split(ip["restored_embed"], 2, axis=0)[k])
    assert sorted(os.listdir(d / "ck_pg")) == sorted(os.listdir(ipd / "ck_ip"))
    pg = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg))
    pg.restore(str(d / "ck_pg"), 1)
    local = FeedbackAdapter(cfg, ADAPT, VirtualUsers(_tcfg(cfg)), _params(cfg))
    local.restore(str(ipd / "ck_ip"), 1)
    _assert_trees_bitwise(pg.state, local.state)
    batches = _batches_from(outs[0])
    assert _replay(cfg, None, str(d / "ck_pg"), batches) == \
        _replay(cfg, None, str(ipd / "ck_ip"), batches)


def test_gloo_ranks_serve_cli_prints_the_debug_digest(procs):
    """``serve.run --mesh single --model-par 2`` with the reference's CI
    flags on the 4 ranks: rank 0 prints the header and the debug (2, 2)
    mesh's sha256, the other ranks nothing."""
    outs, _ = procs()
    want = _digests(_cli(serve_run.main, SERVE_CI))
    got = str(outs[0]["cli"])
    assert "mesh single workers=2 model_par=2; device cpu; mesh={'data': 2, 'model': 2}" in got
    assert "served 24/24 requests" in got
    assert len(want) == 1 and _digests(got) == want
    assert all(str(o["cli"]) == "" for r, o in outs.items() if r)
