"""The port's checkpoint (``repro_torch.checkpoint``) rerun on the
assertions of tests/test_checkpoint.py, its float8 round trips, and the
public names this slice added beside it: ``kernels.ops.median`` /
``ops.trimmed_mean``, ``data.pipeline.lm_iterator`` and
``DataConfig.kind`` / ``sigma``.

The reference's typed-PRNG-key tests have no counterpart (torch has no key
dtype; the port's generators are seeded from integers).  Its restored-leaf
type test reads as: a restored leaf is a tensor on the template's device.

Tolerances: none.  Every round trip is bitwise (NaN payloads matched by
their bits), the aliases are bitwise the reference's on the same numpy
input (its median always; its trimmed mean where the divisor m − 2·trim
is a power of two, where jit's multiply by the reciprocal is exact; the
parity contract in ROADMAP.md), and the iterator yields ``make_lm_batch``
bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_extra, restore, save
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import DataConfig, pipeline
from repro_torch.kernels import ops

torch.set_num_threads(2)

FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _patterns(dtype):
    """All 256 bit patterns of a one-byte float."""
    return torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# ---------------------------------- tests/test_checkpoint.py::TestNonNativeDtypes


class TestNonNativeDtypes:
    def test_bf16_restores_to_bf16(self, tmp_path):
        x = torch.linspace(-3, 3, 16).to(torch.bfloat16)
        save(str(tmp_path), {"x": x})
        restored, _ = restore(str(tmp_path), {"x": torch.zeros(16, dtype=torch.bfloat16)})
        assert restored["x"].dtype == torch.bfloat16
        assert torch.equal(restored["x"].float(), x.float())

    def test_bf16_wins_over_f32_template(self, tmp_path):
        # the recorded dtype, not the template's, decides
        x = torch.tensor([1.5, -2.25, 1e4]).to(torch.bfloat16)
        save(str(tmp_path), {"x": x})
        restored, _ = restore(str(tmp_path), {"x": torch.zeros(3)})
        assert restored["x"].dtype == torch.bfloat16

    def test_every_finite_bf16_pattern_is_bit_transparent(self, tmp_path):
        raw = torch.arange(256, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        x = raw[torch.isfinite(raw.float())]
        save(str(tmp_path), {"x": x})
        restored, _ = restore(str(tmp_path), {"x": torch.zeros_like(x)})
        assert _same_bits(restored["x"], x)

    def test_mixed_tree_roundtrip(self, tmp_path):
        tree = {"w": torch.tensor([1.0, 2.0]),
                "h": torch.tensor([0.5, 0.25]).to(torch.bfloat16),
                "n": torch.tensor([3], dtype=torch.int32),
                "e": torch.tensor([0.5, -448.0]).to(torch.float8_e4m3fn)}
        save(str(tmp_path), tree, step=4)
        like = {k: torch.zeros_like(v) for k, v in tree.items()}
        restored, step = restore(str(tmp_path), like)
        assert step == 4
        for k in tree:
            assert _same_bits(restored[k], tree[k]), k

    def test_restored_leaves_are_tensors_on_the_template_device(self, tmp_path):
        save(str(tmp_path), {"res": torch.zeros(4, 3)})
        restored, _ = restore(str(tmp_path), {"res": torch.zeros(4, 3)})
        assert isinstance(restored["res"], torch.Tensor)
        assert restored["res"].device == torch.device("cpu")
        restored["res"][0] = 1.0  # writable, as a resumed engine state is


# ---------------------------------------------------------------- float8


@pytest.mark.parametrize("dtype", FLOAT8, ids=["e4m3fn", "e5m2"])
def test_float8_every_pattern_round_trips_bitwise(tmp_path, dtype):
    """All 256 patterns of each float8 format, NaNs and infinities
    included, restored at the recorded dtype with the same bits."""
    x = _patterns(dtype).reshape(16, 16)
    save(str(tmp_path), {"x": x, "nested": [x[3]]})
    restored, _ = restore(str(tmp_path), {"x": torch.zeros(16, 16, dtype=dtype),
                                          "nested": [torch.zeros(16, dtype=dtype)]})
    assert _same_bits(restored["x"], x)
    assert _same_bits(restored["nested"][0], x[3])


@pytest.mark.parametrize("dtype", FLOAT8, ids=["e4m3fn", "e5m2"])
def test_float8_recorded_dtype_wins_over_f32_template(tmp_path, dtype):
    x = _patterns(dtype)
    save(str(tmp_path), {"x": x})
    restored, _ = restore(str(tmp_path), {"x": torch.zeros(256)})
    assert _same_bits(restored["x"], x)


# ------------------------------------ tests/test_checkpoint.py::TestExtraMetadata


class TestExtraMetadata:
    def test_extra_roundtrip_exact_floats(self, tmp_path):
        extra = {"host": {
            "history": [{"round": 0, "err": 0.123456789012345}],
            "scheduler": {"damage": [float("-inf"), 1.5e-8], "picked": {"0": 2}},
        }}
        save(str(tmp_path), {"w": torch.zeros(2)}, step=1, extra=extra)
        assert load_extra(str(tmp_path)) == extra

    def test_missing_leaf_raises(self, tmp_path):
        save(str(tmp_path), {"a": torch.zeros(2)})
        with pytest.raises(KeyError, match="missing leaf"):
            restore(str(tmp_path), {"a": torch.zeros(2), "b": torch.zeros(2)})


# ------------------------------------------------ ops.median / ops.trimmed_mean


@pytest.mark.parametrize("m,beta", [(10, 0.1), (8, 0.25), (5, 0.2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_aliases_are_the_reference_s(m, beta, dtype):
    """``ops.median`` and ``ops.trimmed_mean`` against the reference's on
    the same (m, 3, 17) input: the median bitwise, the trimmed mean bitwise
    (divisors 8, 4 and 3: the odd one within 1 ulp, as jit multiplies by
    the reciprocal), and ``trimmed_mean`` without ``method`` the median, as
    in the reference, where it is ``robust_aggregate`` itself."""
    import jax.numpy as jnp

    from repro.kernels import ops as rops

    x = np.random.default_rng(m).standard_normal((m, 3, 17)).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(dtype)

    def np_(a):
        return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))

    assert np.array_equal(np_(ops.median(t)), np_(rops.median(j)))
    assert np.array_equal(np_(ops.trimmed_mean(t)), np_(rops.median(j)))
    got = np_(ops.trimmed_mean(t, method="trimmed_mean", beta=beta))
    want = np_(rops.trimmed_mean(j, method="trimmed_mean", beta=beta))
    divisor = m - 2 * int(beta * m)
    if divisor & (divisor - 1) == 0:
        assert np.array_equal(got, want)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32 if dtype == "float32" else np.float32))
        scale = 1.0 if dtype == "float32" else 2.0 ** 16
        assert (np.abs(got - want) <= ulp * scale).all()
    assert ops.median(t).dtype == t.dtype and ops.median(t).shape == (3, 17)


# --------------------------------------------------- lm_iterator and DataConfig


def test_lm_iterator_yields_make_lm_batch_from_start_step():
    cfg = DataConfig(kind="lm", vocab=64, seq_len=8, global_batch=4, num_workers=2)
    attack = AttackConfig("label_flip", 0.5)
    it = pipeline.lm_iterator(cfg, attack, start_step=5, device="cpu")
    for step in (5, 6, 7):
        got, want = next(it), pipeline.make_lm_batch(cfg, step, attack, device="cpu")
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_data_config_has_the_reference_s_fields_and_defaults():
    """``DataConfig(kind="lm", ...)`` builds, as the reference's callers
    build it, and every field and default is the reference's."""
    from repro.data.pipeline import DataConfig as RDataConfig

    ours = {f.name: f.default for f in dataclasses.fields(DataConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RDataConfig)}
    assert ours == theirs
    assert DataConfig(kind="mnist", sigma=0.1).kind == "mnist"
