"""The port's audio and vision frontends, the whisper encoder and its
cross-attention (repro_torch.models.transformer) and their training path
(launch.steps / trainer / train) against the reference's, on the CPU.

whisper-smoke (2 encoder + 2 decoder layers, 32 stub frames) and
internvl2-smoke (2 layers, GQA kv 2, 8 stub patches) run in float32 and
bfloat16 from the reference's parameters (``models.convert``) and one
frontend array drawn with numpy and given to both packages.  Tolerances
are the existing ones:
- forward, prefill and decode logits and cache leaves:
  tests/test_torch_transformer.py's ``TOL`` (1e-5 float32, 1e-2
  bfloat16, absolute); gradients the same, on gradients of magnitude < 1
  (the reference's ``jax.grad`` against the port's per-layer autograd);
- the training window against the reference's ``make_window_step``
  (tests/test_torch_families_train.py's subprocess harness, float32):
  losses and grad norms 1e-6 relative, params 1e-5 absolute;
- cache positions, the cross FFN's zero gradients and the ravel order:
  exact.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.core import aggregators
from repro_torch.core.attacks import AttackConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train, trainer
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.serve import adapt, engine
from repro_torch.serve import run as serve_run
from repro_torch.tree import ravel, tree_leaves_with_path

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ARCHS = ("whisper-small", "internvl2-1b")
CASES = [(a, d) for a in ARCHS for d in ("float32", "bfloat16")]
CROSS_FFN = ("ln2", "wd", "wg", "wu")  # cross blocks' leaves no computation reads


def _models(arch, dtype, seed=0):
    rc = dataclasses.replace(ref_get_smoke_config(arch), dtype=dtype)
    pc = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    rp = RT.init_params(rc, jax.random.PRNGKey(seed))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    return rc, pc, rp, pp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _frontend(cfg, b, seed):
    """(b, T, D) standard normals in the model's dtype, for both packages."""
    x = np.random.default_rng(seed).standard_normal((b, cfg.n_frontend_tokens, cfg.d_model))
    ref = jnp.asarray(x.astype(np.float32)).astype(jnp.dtype(cfg.dtype))
    return ref, torch.from_numpy(x.astype(np.float32)).to(getattr(torch, cfg.dtype))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (lists by index)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_loss_and_grads_match_reference(arch, dtype):
    """Logits (vision: the prefix stripped), loss and every gradient leaf
    through the trainer's per-layer pieces (steps._pieces: the encoder's
    and the cross blocks' stacked leaves unbound); kv_block 16 puts the
    encoder's and the cross-attention's 32 frames on the chunked path.  The
    cross blocks' FFN gradients are exactly 0 in both packages."""
    rc, pc, rp, pp = _models(arch, dtype)
    tok, lab = _tokens((2, 12), rc.vocab, 1), _tokens((2, 12), rc.vocab, 2)
    rfe, pfe = _frontend(rc, 2, 3)
    want, _ = RT.forward(rp, jnp.asarray(tok), rc, frontend=rfe, remat=False, kv_block=16)
    got, aux = T.forward(pp, torch.from_numpy(tok), pc, frontend=pfe, kv_block=16)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, 12, rc.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    assert float(aux) == 0.0
    rbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab), "frontend": rfe}
    want_loss, want_g = jax.value_and_grad(
        lambda p: RT.loss_fn(p, rbatch, rc, remat=False, kv_block=16))(rp)
    pbatch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab), "frontend": pfe}
    loss, pieces = steps._value_and_grad(pc, 16)(steps._pieces(pp), pbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=TOL[dtype], rtol=0)
    # the stacked groups' gradients come as per-layer tuples: stack them
    got_g = {p: torch.stack(g) if isinstance(g, tuple) else g for p, g in _flat(pieces).items()}
    want_flat = _flat(want_g)
    assert sorted(got_g) == sorted(want_flat)
    for path, w in want_flat.items():
        g = got_g[path]
        assert tuple(g.shape) == np.shape(w) and g.dtype == getattr(torch, dtype), path
        np.testing.assert_allclose(_np(g), _np(w), atol=TOL[dtype], rtol=0, err_msg=path)
    if arch == "whisper-small":
        for leaf in CROSS_FFN:
            assert not bool(got_g[f"cross_blocks/{leaf}"].any()), leaf
            assert not np.any(np.asarray(want_g["cross_blocks"][leaf])), leaf
        assert bool(got_g["cross_blocks/wq"].any()) and bool(got_g["enc_blocks/wq"].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    """_encoder_fwd alone: the sinusoidal table, the non-causal layers with
    RoPE at the default positions, enc_norm; plain and chunked attention."""
    rc, pc, rp, pp = _models("whisper-small", dtype)
    rfe, pfe = _frontend(rc, 2, 5)
    from repro.models.sharding import NULL_CTX

    for kv_block in (0, 16):
        want = RT._encoder_fwd(rp, rfe, rc, NULL_CTX, False, kv_block)
        got = T._encoder_fwd(pp, pfe, pc, kv_block)
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_prefill_and_decode_chain_match_reference(dtype):
    """prefill at cache_len = prompt + 6 (the cross k/v of every block in
    ``cache["cross"]``), then 6 decode steps; logits at every step and every
    cache leaf after the chain, kpos exactly."""
    rc, pc, rp, pp = _models("whisper-small", dtype)
    tok, nxt = _tokens((2, 10), rc.vocab, 3), _tokens((6, 2, 1), rc.vocab, 4)
    rfe, pfe = _frontend(rc, 2, 6)
    rl, rcache = RT.prefill(rp, jnp.asarray(tok), rc, frontend=rfe, kv_block=0, cache_len=16)
    pl, pcache = T.prefill(pp, torch.from_numpy(tok), pc, frontend=pfe, kv_block=0,
                           cache_len=16)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    assert list(pcache) == ["blocks", "cross"]
    for i in range(6):
        rl, rcache = RT.decode_step(rp, jnp.asarray(nxt[i]), rcache, jnp.int32(10 + i), rc)
        pl, pcache = T.decode_step(pp, torch.from_numpy(nxt[i]), pcache, 10 + i, pc)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    want, got = _flat(rcache), _flat(pcache)
    assert sorted(got) == sorted(want)
    assert tuple(got["cross/k"].shape) == (2, 2, rc.n_frontend_tokens, rc.n_kv_heads, rc.hd)
    for path, w in want.items():
        assert tuple(got[path].shape) == np.shape(w), path
        if path.endswith("kpos"):
            np.testing.assert_array_equal(got[path].numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(_np(got[path]), _np(w), atol=TOL[dtype], rtol=0,
                                       err_msg=path)
    empty, ref_empty = T.init_cache(pc, 3, 20, device="cpu"), RT.init_cache(rc, 3, 20)
    assert {p: tuple(v.shape) for p, v in _flat(empty).items()} == {
        p: np.shape(v) for p, v in _flat(ref_empty).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_internvl2_prefill_matches_reference(dtype):
    """The vision prefill: the last logits, and the reference's cache shapes
    (the patch prefix in k/v, kpos sized by the text)."""
    rc, pc, rp, pp = _models("internvl2-1b", dtype)
    tok = _tokens((2, 6), rc.vocab, 7)
    rfe, pfe = _frontend(rc, 2, 8)
    rl, rcache = RT.prefill(rp, jnp.asarray(tok), rc, frontend=rfe, kv_block=0, cache_len=10)
    pl, pcache = T.prefill(pp, torch.from_numpy(tok), pc, frontend=pfe, kv_block=0,
                           cache_len=10)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=TOL[dtype], rtol=0)
    shapes = {p: tuple(v.shape) for p, v in _flat(pcache).items()}
    assert shapes == {p: np.shape(v) for p, v in _flat(rcache).items()}
    assert shapes["blocks/p0_attn/k"] == (2, 2, 18, 2, rc.hd)  # 8 patches + cache_len 10
    assert shapes["blocks/p0_attn/kpos"] == (2, 10)
    np.testing.assert_array_equal(pcache["blocks"]["p0_attn"]["kpos"].numpy(),
                                  np.asarray(rcache["blocks"]["p0_attn"]["kpos"]))


def test_decode_after_vision_prefill_raises_in_both_packages():
    """A reference property: its vision prefill builds a cache its own
    decode_step cannot read (k/v rows prefix + cache_len, kpos cache_len);
    the port refuses the same cache with a ValueError naming the mismatch."""
    rc, pc, rp, pp = _models("internvl2-1b", "float32")
    tok = _tokens((2, 6), rc.vocab, 9)
    rfe, pfe = _frontend(rc, 2, 10)
    _, rcache = RT.prefill(rp, jnp.asarray(tok), rc, frontend=rfe, kv_block=0, cache_len=10)
    _, pcache = T.prefill(pp, torch.from_numpy(tok), pc, frontend=pfe, kv_block=0, cache_len=10)
    nxt = _tokens((2, 1), rc.vocab, 11)
    with pytest.raises((ValueError, TypeError)):
        RT.decode_step(rp, jnp.asarray(nxt), rcache, jnp.int32(6), rc)
    with pytest.raises(ValueError, match="18 key rows a layer but 10 positions"):
        T.decode_step(pp, torch.from_numpy(nxt), pcache, 6, pc)


@pytest.mark.parametrize("arch", ARCHS)
def test_missing_frontend_raises(arch):
    """An audio or vision configuration without its frontend raises, as the
    reference's asserts do; so do whisper frames in another dtype."""
    _, pc, _, pp = _models(arch, "float32")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="frontend needs its embeddings"):
        T.loss_fn(pp, {"tokens": tok, "labels": tok}, pc)
    with pytest.raises(ValueError, match="frontend needs its embeddings"):
        T.prefill(pp, tok, pc)
    if arch == "whisper-small":
        fe = torch.zeros((1, pc.n_frontend_tokens, pc.d_model), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="frame embeddings in torch.bfloat16"):
            T.forward(pp, tok, pc, frontend=fe)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_ravel_order_and_convert_round_trip(arch, dtype):
    """The three new groups carried by convert: the port's ravel is bitwise
    ravel_pytree's, and to_reference gives the reference's arrays back."""
    rc, pc, rp, pp = _models(arch, dtype)
    want = jax.flatten_util.ravel_pytree(rp)[0]
    got = ravel(pp)[0]
    assert got.dtype == getattr(torch, dtype) and got.numel() == want.size == T.count_params(pc)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert list(pp) == sorted(pp)
    back = convert.transformer_to_reference(pp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), back,
        jax.tree.map(np.asarray, rp))


STEPS, LR = 2, 0.5
DATA = dict(seq_len=16, global_batch=4, num_workers=4, seed=0)

REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ParallelConfig, TrainConfig
from repro.core.attacks import AttackConfig
from repro.data.pipeline import DataConfig
from repro.launch import mesh as mesh_lib, steps, trainer
from repro.optim.optimizers import get_optimizer
from jax.sharding import NamedSharding, PartitionSpec as P

# replicated params (tests/test_torch_trainer.py's reason)
steps.param_shardings = lambda cfg, mesh: jax.tree.map(
    lambda _: NamedSharding(mesh, P()), steps.T.param_shapes(cfg),
    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))

spec = json.loads(sys.argv[1])
mesh = mesh_lib.make_debug_mesh(4, 1)
out = {}

def dump(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = (
            np.asarray(leaf))

for arch in spec["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, **spec["data"])
    opt = get_optimizer("sgd", spec["lr"])
    dump(f"{arch}/init/", trainer.init_state(cfg, mesh, opt, seed=0)["params"])
    for i in range(spec["steps"]):
        b = trainer.stack_window_batches(dcfg, i, 1, mesh, None, cfg)
        for k in ("tokens", "labels", "frontend"):
            out[f"{arch}/batch/{i}/{k}"] = np.asarray(b[k][0])
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          remat=False)
    tcfg = TrainConfig(optimizer="sgd", lr=spec["lr"], steps=spec["steps"], device_steps=1)
    r = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=AttackConfig("alie", 0.25))
    out[f"{arch}/loss"] = np.array([h["loss"] for h in r.history])
    out[f"{arch}/grad_norm"] = np.array([h["grad_norm"] for h in r.history])
    dump(f"{arch}/params/", r.state["params"])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _nested(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_frontends_train")
    spec = {"archs": list(ARCHS), "data": DATA, "lr": LR, "steps": STEPS}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(spec), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_window_ds1_matches_the_reference(ref, arch):
    """The reference's window (4 devices, replicated params, its own
    threefry frontend) against the port's 4 in-process workers on the same
    params, tokens, labels and frontend arrays: 2 steps of SGD 0.5, gather
    median under ALIE alpha 0.25, float32; the batch's frontend is split on
    its batch dim like the tokens."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    mesh = mesh_lib.make_debug_mesh(4, 1, device="cpu")
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=0.25,
                          remat=False)
    opt = get_optimizer("sgd", LR)
    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
    state["params"] = convert.transformer_from_reference(cfg, _nested(ref, f"{arch}/init/"),
                                                         "cpu")
    state["opt_state"] = opt.init(state["params"])
    window = trainer.make_window_step(cfg, pcfg, mesh, opt, AttackConfig("alie", 0.25), 1)
    losses, norms = [], []
    for i in range(STEPS):
        before = {k: float(v) for k, v in state["metrics"].items()}
        batch = {k: torch.from_numpy(ref[f"{arch}/batch/{i}/{k}"])[None]
                 for k in ("tokens", "labels", "frontend")}
        state = window(state, batch)
        met = trainer.window_metrics(before, state)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    np.testing.assert_allclose(losses, ref[f"{arch}/loss"], rtol=1e-6)
    np.testing.assert_allclose(norms, ref[f"{arch}/grad_norm"], rtol=1e-6)
    want = _nested(ref, f"{arch}/params/")
    for path, t in tree_leaves_with_path(state["params"]):
        w = want
        for p in path.split("/"):
            w = w[p]
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-5, err_msg=path)
    init = _nested(ref, f"{arch}/init/")
    if arch == "whisper-small":  # the cross FFN never moves; the encoder does
        for leaf in CROSS_FFN:
            np.testing.assert_array_equal(state["params"]["cross_blocks"][leaf].numpy(),
                                          init["cross_blocks"][leaf])
        assert not np.array_equal(state["params"]["enc_blocks"]["wq"].numpy(),
                                  init["enc_blocks"]["wq"])


def test_frontend_batches_are_seeded_and_in_the_model_dtype():
    """trainer.frontend_batch: (B, T, D) in the model's dtype, a function of
    (seed, step); stack_window_batches adds it only for frontend configs."""
    cfg = configs.get_smoke_config("whisper-small")
    from repro_torch.data.pipeline import DataConfig

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=4, num_workers=4, seed=3)
    mesh = mesh_lib.make_debug_mesh(4, device="cpu")
    block = trainer.stack_window_batches(dcfg, 5, 2, mesh, None, cfg)
    assert tuple(block["frontend"].shape) == (2, 4, cfg.n_frontend_tokens, cfg.d_model)
    assert block["frontend"].dtype == torch.bfloat16
    assert torch.equal(block["frontend"][1], trainer.frontend_batch(dcfg, 6, cfg))
    assert not torch.equal(block["frontend"][0], block["frontend"][1])
    assert abs(float(block["frontend"].float().std()) - 1.0) < 0.05
    llama = configs.get_smoke_config("llama3.2-3b")
    assert "frontend" not in trainer.stack_window_batches(dcfg, 5, 1, mesh, None, llama)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_in_bf16(monkeypatch, arch):
    """python -m repro_torch.launch.train --smoke --config <arch> on the
    CPU in bf16: the startup line names the frontend, one aggregation call
    a step over every leaf (31 for whisper, 12 for internvl2)."""
    calls = []
    real = aggregators.aggregate_leaves

    def wrapped(leaves, method, beta=0.1):
        calls.append((len(leaves), sorted({str(x.dtype) for x in leaves})))
        return real(leaves, method, beta)

    monkeypatch.setattr(aggregators, "aggregate_leaves", wrapped)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = train.main(["--device", "cpu", "--config", arch, "--smoke", "--steps", "2",
                         "--device-steps", "1", "--workers", "4", "--seq-len", "16",
                         "--global-batch", "4", "--strategy", "gather", "--agg", "median",
                         "--attack", "alie", "--attack-alpha", "0.25", "--lr", "1e-3"])
    out = buf.getvalue()
    cfg = configs.get_smoke_config(arch)
    assert rc == 0 and "done: 2 steps" in out
    assert f"frontend={cfg.frontend}:{cfg.n_frontend_tokens}" in out.splitlines()[0]
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    n_leaves = len(_flat(T.param_shapes(cfg)))
    assert n_leaves == {"whisper-small": 31, "internvl2-1b": 12}[arch]
    assert calls == [(n_leaves, ["torch.bfloat16"])] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_refuses_frontend_configs(arch):
    """The reference's engine prefills with no frontend and its adapter's
    loss takes none: the port's engine, adapter and serve CLI refuse."""
    cfg = configs.get_smoke_config(arch)
    with pytest.raises(ValueError, match="cannot be served"):
        engine.ServeEngine(cfg, engine.ServeConfig(slots=2, prompt_len=4, max_new=4), {})
    with pytest.raises(ValueError, match="cannot be served"):
        adapt.make_round_fn(cfg, adapt.AdaptConfig())
    with pytest.raises(ValueError, match="cannot be served"):
        serve_run.main(["--device", "cpu", "--smoke", "--arch", arch])
