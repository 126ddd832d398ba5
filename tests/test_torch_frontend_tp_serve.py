"""Serving a frontend configuration on the model axis in the port: the
prefill and decode of whisper-small (audio, the encoder's cross keys and
values in the cache) and the prefill of internvl2-1b (vision, the patch
prefix in the attention caches) at model 2, in process at (4, 2) and on 4
gloo ranks at (data 2, model 2), held against the reference's
single-device ``prefill`` / ``decode_step`` on the same params and inputs
(numpy draws from fixed seeds) and against the port's own model-1 run.

internvl2-1b's decode of a vision prefill's cache raises at every model
size, as the reference's does (ROADMAP queue C); a decode from
``init_cache`` (the dry-run's cache) runs at model 2 for both.  The engine
and both serve CLIs still refuse a frontend configuration (the reference's
engine prefills with no frontend).

Tolerances, stated where used:
- float32 logits: relative error max|port - reference| / max|reference|
  at most 1e-5 (model 2 sums the ranks' partial outputs, the reference
  one product);
- bfloat16 logits: 1e-2 absolute, tests/test_torch_transformer.py's limit
  (every matmul rounds its output to bf16, not always the same way);
- gloo ranks against the in-process (2, 2) run: bitwise (a sum of two
  partials is the same in either order).

Serial time about 35 s: the 4 gloo ranks (about 25 s) run while the
in-process tests do.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import steps
from repro_torch.models import convert, sharding
from repro_torch.models import transformer as T
from repro_torch.serve import run as serve_run
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4  # the gloo ranks: (data 2, model 2)
F32_RTOL = 1e-5
BF16_ATOL = 1e-2
ARCHS = ("whisper-small", "internvl2-1b")
DTYPES = ("float32", "bfloat16")
B, PROMPT, NEW = 2, 6, 8  # decode steps (whisper); the cache holds them all

RANK_SCRIPT = """
import sys
sys.path.insert(0, sys.argv[1])
import test_torch_frontend_tp_serve as T
T.run_rank(int(sys.argv[2]), *sys.argv[3:])
"""


def _cfgs(arch, dtype, **over):
    rc = dataclasses.replace(ref_get_smoke_config(arch), dtype=dtype, **over)
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype, **over)
    return rc, pc


def _inputs(cfg):
    """Prompt tokens (B, PROMPT), the frontend embeddings (B, T, D) in f32
    and the teacher-forced decode tokens (NEW,) per row, from fixed seeds."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    fe = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    forced = rng.integers(0, cfg.vocab, (NEW, B, 1)).astype(np.int32)
    return tokens, fe, forced


def _decodes(arch) -> int:
    return NEW if arch == "whisper-small" else 0


def _port_params(arch, dtype):
    """The reference's params (PRNGKey 0) carried to the port."""
    rc, pc = _cfgs(arch, dtype)
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    return rc, pc, rp, convert.transformer_from_reference(
        pc, jax.tree.map(np.asarray, rp), device="cpu")


def _port_run(pc, params, mesh, tokens, fe, forced, decodes, rows=slice(None)):
    """(prefill logits, then each decode step's) (1 + decodes, b, V) f32 of
    the port's serving steps on ``mesh``; ``rows`` the rows this process
    serves (under a process group its worker's block)."""
    dt = getattr(torch, pc.dtype)
    prefill = steps.make_prefill_step(pc, kv_block=0, cache_len=PROMPT + NEW, mesh=mesh)
    decode = steps.make_decode_step(pc, mesh)
    logits, cache = prefill(params, torch.as_tensor(tokens, dtype=torch.int64),
                            torch.as_tensor(fe).to(dt))
    out = [logits[:, 0]]
    for j in range(decodes):
        logits, cache = decode(params, torch.as_tensor(forced[j][rows], dtype=torch.int64),
                               cache, PROMPT + j)
        out.append(logits[:, 0])
    return torch.stack(out).float().numpy(), cache


def _check(got, want, dtype, what):
    if dtype == "float32":
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= F32_RTOL, (what, err)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The 4 gloo ranks, started once for the module (the in-process tests
    run while they do)."""
    d = tmp_path_factory.mktemp("frontend_tp_serve")
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
        return results

    yield wait
    for p in started:
        p.kill()


def run_rank(rank: int, rendezvous: str, outdir: str) -> None:
    """One rank at (data 2, model 2): both configurations in f32, each on
    the rank's parameter shards, its row of the batch and its kv heads."""
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    mesh = mesh_lib.make_production_mesh(model=2, device="cpu")
    w, k = mesh_lib.worker_index(mesh), mesh_lib.model_rank(mesh)
    out = {"worker": np.asarray(w), "model_rank": np.asarray(k)}
    for arch in ARCHS:
        _, pc, _, params = _port_params(arch, "float32")
        shards = steps.tp_shard(params, steps.param_shardings(pc, mesh), k, 2)
        tokens, fe, forced = _inputs(pc)
        logits, cache = _port_run(pc, shards, mesh, tokens, fe, forced, _decodes(arch),
                                  rows=slice(w, w + 1))
        out[arch] = logits
        out[arch + "/k0"] = cache["blocks"]["p0_attn"]["k"].numpy()
        if "cross" in cache:
            out[arch + "/cross_k"] = cache["cross"]["k"].numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def ref_case(request):
    """The reference's single-device prefill (and, for whisper, 8
    teacher-forced decode steps) logits on the case's inputs."""
    arch, dtype = request.param
    rc, pc, rp, pp = _port_params(arch, dtype)
    tokens, fe, forced = _inputs(pc)
    rdt = jnp.dtype(dtype)
    logits, cache = jax.jit(lambda t, f: RT.prefill(rp, t, rc, frontend=f, kv_block=0,
                                                    cache_len=PROMPT + NEW))(
        jnp.asarray(tokens), jnp.asarray(fe).astype(rdt))
    want = [np.asarray(logits[:, 0], np.float32)]
    decode = jax.jit(lambda t, c, pos: RT.decode_step(rp, t, c, pos, rc))
    for j in range(_decodes(arch)):
        logits, cache = decode(jnp.asarray(forced[j]), cache, jnp.int32(PROMPT + j))
        want.append(np.asarray(logits[:, 0], np.float32))
    return arch, dtype, pc, pp, (tokens, fe, forced), np.stack(want)


@pytest.mark.parametrize("shape", [(4, 2), (4, 1)], ids=["4x2", "4x1"])
def test_in_process_serving_matches_the_reference(ref_case, shape):
    """Prefill (and whisper's decode steps) at (4, 2) and (4, 1) within the
    stated tolerance of the reference's single-device logits."""
    arch, dtype, pc, pp, (tokens, fe, forced), want = ref_case
    mesh = mesh_lib.make_debug_mesh(*shape, device="cpu")
    got, _ = _port_run(pc, pp, mesh, tokens, fe, forced, _decodes(arch))
    _check(got, want, dtype, f"{arch} {dtype} {shape}")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_two_matches_model_one(arch):
    """The port at (4, 2) against its own (4, 1) run, f32: logits within
    the relative tolerance, the caches (cross caches included) too."""
    _, pc, _, pp = _port_params(arch, "float32")
    tokens, fe, forced = _inputs(pc)
    runs = [_port_run(pc, pp, mesh_lib.make_debug_mesh(4, m, device="cpu"), tokens, fe, forced,
                      _decodes(arch)) for m in (1, 2)]
    _check(runs[1][0], runs[0][0], "float32", arch)
    for a, b in zip(tree_leaves(runs[1][1]), tree_leaves(runs[0][1])):
        assert a.shape == b.shape
        if a.is_floating_point():
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kv,heads,model", [(4, True, 2), (1, False, 4)],
                         ids=["heads", "gathered"])
def test_cross_cache_split_on_kv_heads_in_heads_mode(kv, heads, model):
    """whisper's cross cache: ``cache_dims`` names its kv-head dim in
    ``heads`` mode (4 kv heads at model 2) and nothing in ``gathered`` mode
    (one kv head at model 4, which the reference replicates: 2·kv < M); a
    rank's slice is its kv heads of the whole cache, and a process-group
    rank's prefill writes exactly those heads."""
    _, pc = _cfgs("whisper-small", "float32", n_kv_heads=kv)
    params = T.init_params(pc, 0, "cpu")
    tokens, fe, _ = _inputs(pc)
    mesh = mesh_lib.make_debug_mesh(4 // model, model, device="cpu")
    assert sharding.tp_modes(pc, model).attn == ("heads" if heads else "gathered")
    _, cache = T.prefill(params, torch.as_tensor(tokens, dtype=torch.int64), pc,
                         frontend=torch.as_tensor(fe), ctx=sharding.model_ctx(mesh))
    dims = sharding.cache_dims(pc, model, cache, steps.cache_shardings(pc, mesh, cache))
    assert dims["cross"] == {"k": 3 if heads else -1, "v": 3 if heads else -1}
    for k in range(model):
        part = sharding.shard_cache(cache, dims, k, model)["cross"]
        assert part["k"].shape[3] == (kv // model if heads else kv)
        if heads:
            assert torch.equal(part["v"], cache["cross"]["v"][:, :, :, k * kv // model:
                                                                (k + 1) * kv // model])
        else:
            assert torch.equal(part["v"], cache["cross"]["v"])
    # the dry-run's cache: init_cache cut by the same dims, decoded at this model size
    empty = T.init_cache(pc, B, 12, device="cpu")
    assert sharding.cache_dims(pc, model, empty, steps.cache_shardings(pc, mesh, empty)) == dims


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_init_cache_runs_at_model_two(arch):
    """A decode from ``init_cache`` (the dry-run's cache) at (4, 2) gives
    model 1's logits for both families (f32, the relative tolerance)."""
    _, pc = _cfgs(arch, "float32")
    params = T.init_params(pc, 0, "cpu")
    tok = torch.as_tensor(_inputs(pc)[2][0], dtype=torch.int64)
    outs = []
    for m in (1, 2):
        cache = T.init_cache(pc, B, 12, device="cpu")
        logits, _ = steps.make_decode_step(pc, mesh_lib.make_debug_mesh(4, m, device="cpu"))(
            params, tok, cache, 3)
        assert bool(torch.isfinite(logits).all())
        outs.append(logits.numpy())
    _check(outs[1], outs[0], "float32", arch)


def test_vision_prefill_cache_decode_still_raises_at_model_two():
    """internvl2's decode of its own prefill's cache raises the reference's
    ValueError at model 2, as at model 1."""
    _, pc, _, pp = _port_params("internvl2-1b", "float32")
    tokens, fe, forced = _inputs(pc)
    for m in (1, 2):
        mesh = mesh_lib.make_debug_mesh(4, m, device="cpu")
        _, cache = steps.make_prefill_step(pc, mesh=mesh)(
            pp, torch.as_tensor(tokens, dtype=torch.int64), torch.as_tensor(fe))
        with pytest.raises(ValueError, match="vision prefill"):
            steps.make_decode_step(pc, mesh)(pp, torch.as_tensor(forced[0], dtype=torch.int64),
                                             cache, PROMPT)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_clis_refuse_a_frontend(arch):
    """The engine and both serve CLIs refuse a frontend configuration at
    model 1 and 2 (the reference's engine prefills with no frontend)."""
    pc = configs.get_smoke_config(arch)
    for m in (1, 2):
        with pytest.raises(ValueError, match="frontend cannot be served"):
            ServeEngine(pc, ServeConfig(slots=2, prompt_len=4, max_new=2, window=8),
                        T.init_params(pc, 0, "cpu"), mesh_lib.make_debug_mesh(2, m, device="cpu"))
    flag = arch.replace("-", "_").replace(".", "_")
    with pytest.raises(ValueError, match="frontend cannot be served"):
        serve_run.main(["--device", "cpu", "--smoke", "--arch", flag, "--requests", "2",
                        "--model-par", "2", "--workers", "2"])
    with pytest.raises(ValueError, match="frontend cannot be served"):
        launch_serve.main(["--arch", arch, "--smoke", "--batch", "2", "--device", "cpu"])


def test_gloo_ranks_match_the_in_process_run_and_the_reference(procs):
    """Each gloo rank's logits are bitwise the in-process (2, 2) run on its
    row of the batch, and within the f32 tolerance of the reference's; its
    self and cross caches are its kv heads of that run's caches."""
    results = procs()
    mesh = mesh_lib.make_debug_mesh(2, 2, device="cpu")
    for arch in ARCHS:
        rc, pc, rp, pp = _port_params(arch, "float32")
        tokens, fe, forced = _inputs(pc)
        logits, _ = RT.prefill(rp, jnp.asarray(tokens), rc, frontend=jnp.asarray(fe),
                               kv_block=0, cache_len=PROMPT + NEW)
        for r in range(WORLD):
            out = results[r]
            w, k = int(out["worker"]), int(out["model_rank"])
            row = slice(w, w + 1)
            whole, cache = _port_run(pc, pp, mesh, tokens[row], fe[row], forced[:, row],
                                     _decodes(arch))
            got = out[arch]
            assert np.array_equal(got, whole), (arch, r)
            _check(got[0], np.asarray(logits[w:w + 1, 0], np.float32), "float32", arch)
            kv = pc.n_kv_heads // 2
            heads = slice(k * kv, (k + 1) * kv)
            assert np.array_equal(out[arch + "/k0"],
                                  cache["blocks"]["p0_attn"]["k"][..., heads, :].numpy())
            if arch == "whisper-small":
                assert np.array_equal(out[arch + "/cross_k"],
                                      cache["cross"]["k"][..., heads, :].numpy())
