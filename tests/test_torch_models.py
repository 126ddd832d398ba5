"""Parity of the port's paper models and data with the JAX reference (CPU).

The same numpy parameters (carried by models/convert.py) and batches go
through both packages.  Losses and per-worker gradients are held to
rtol 1e-5, plus an absolute 1e-5 of each leaf's largest entry (XLA and
oneDNN sum convolutions and products in different orders, so entries
near zero carry an error of the leaf's scale, not their own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.models import paper_models as JM
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.models import convert
from repro_torch.models import paper_models as M

torch.set_num_threads(2)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


def _batch(m, n, d=784, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, n, d)).astype(np.float32),
            rng.integers(0, 10, (m, n)).astype(np.int32))


def _grads(name, params_np, x, y):
    """(port per-worker grads as numpy, reference per-worker grads)."""
    jloss = {"logreg": JM.logreg_loss, "cnn": JM.cnn_loss, "linreg": JM.linreg_loss}[name]
    tloss = {"logreg": M.logreg_loss, "cnn": M.cnn_loss, "linreg": M.linreg_loss}[name]
    jparams = jax.tree.map(jnp.asarray, params_np)
    want = jax.jit(jax.vmap(jax.grad(jloss), in_axes=(None, 0)))(jparams, {"x": x, "y": y})
    params = convert.from_reference(name, params_np, device="cpu")
    ty = torch.from_numpy(y)
    batch = {"x": torch.from_numpy(x), "y": ty if ty.is_floating_point() else ty.long()}
    got = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))(params, batch)
    return convert.to_reference(got), want


def test_cnn_loss_and_per_worker_grads_match():
    params_np = jax.tree.map(np.asarray, JM.init_cnn(jax.random.PRNGKey(1), width=4))
    x, y = _batch(3, 6)
    params = convert.from_reference("cnn", params_np, device="cpu")
    _close(M.cnn_logits(params, torch.from_numpy(x[0])).detach(),
           jax.jit(JM.cnn_logits)(params_np, jnp.asarray(x[0])))
    got, want = _grads("cnn", params_np, x, y)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])


def test_logreg_and_linreg_match():
    rng = np.random.default_rng(2)
    params_np = {"w": rng.standard_normal((784, 10)).astype(np.float32) * 0.01,
                 "b": rng.standard_normal(10).astype(np.float32) * 0.1}
    x, y = _batch(4, 8, seed=3)
    batch = {"x": torch.from_numpy(x[0]), "y": torch.from_numpy(y[0]).long()}
    params = convert.from_reference("logreg", params_np, device="cpu")
    _close(M.logreg_loss(params, batch).detach(),
           jax.jit(JM.logreg_loss)(params_np, {"x": x[0], "y": y[0]}))
    got, want = _grads("logreg", params_np, x, y)
    for k in want:
        _close(got[k], want[k])
    w = rng.standard_normal(20).astype(np.float32)
    xl = rng.standard_normal((3, 16, 20)).astype(np.float32)
    yl = rng.standard_normal((3, 16)).astype(np.float32)
    got, want = _grads("linreg", w, xl, yl)
    _close(got, want)


def test_convert_checks_layout_and_round_trips():
    params_np = jax.tree.map(np.asarray, JM.init_cnn(jax.random.PRNGKey(0)))
    params = convert.from_reference("cnn", params_np, device="cpu")
    back = convert.to_reference(params)
    for k in params_np:
        assert np.array_equal(back[k], params_np[k])
    bad = dict(params_np, fc1=params_np["fc1"].reshape(64, -1))
    with pytest.raises(ValueError, match="fc1"):
        convert.from_reference("cnn", bad, device="cpu")
    with pytest.raises(KeyError):
        convert.from_reference("cnn", {"w": params_np["fc2"]}, device="cpu")
    with pytest.raises(TypeError):
        convert.from_reference("logreg", {"w": np.zeros((3, 2)), "b": np.zeros(2)}, device="cpu")
    port_init = M.init_cnn(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in port_init.items()} == \
        {k: v.shape for k, v in params_np.items()}
    assert sum(v.numel() for v in port_init.values()) == 53370


def test_mnist_analog_structure():
    data = synthetic.mnist_analog(torch.Generator().manual_seed(0), 200, noise=0.0,
                                  device="cpu")
    mus = synthetic._class_means(10, 784, 424242)
    assert torch.allclose(torch.linalg.vector_norm(mus, dim=1), torch.full((10,), 3.0))
    blocks = mus.reshape(10, 7, 4, 7, 4)  # constant over each 4x4 block
    assert torch.equal(blocks, blocks[:, :, :1, :, :1].expand_as(blocks))
    assert torch.equal(data["x"], mus[data["y"]])
    assert data["y"].min() >= 0 and data["y"].max() <= 9
    jdata = jpipeline.make_classification_shards(jpipeline.DataConfig(
        kind="mnist", global_batch=40, num_workers=4))
    shards = pipeline.make_classification_shards(
        pipeline.DataConfig(global_batch=40, num_workers=4), device="cpu")
    assert shards["x"].shape == jdata["x"].shape and shards["y"].shape == jdata["y"].shape


def test_label_flip_shards_corrupt_only_byzantine_workers():
    cfg = pipeline.DataConfig(global_batch=50, num_workers=5, seed=3)
    clean = pipeline.make_classification_shards(cfg, device="cpu")
    flipped = pipeline.make_classification_shards(
        cfg, AttackConfig("label_flip", alpha=0.4), device="cpu")
    assert torch.equal(flipped["x"], clean["x"])
    assert torch.equal(flipped["y"][:2], 9 - clean["y"][:2])
    assert torch.equal(flipped["y"][2:], clean["y"][2:])


def test_linreg_data():
    data, w_star = synthetic.linreg(torch.Generator().manual_seed(0), 64, 8, 0.0,
                                    device="cpu")
    assert set(data["x"].unique().tolist()) == {-1.0, 1.0}
    torch.testing.assert_close(data["y"], data["x"] @ w_star)
