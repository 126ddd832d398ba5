"""The MoE combine's kernels (kernels/moe_combine.py, csrc/moe_combine.cu)
against their plain versions on the card.  These tests need an NVIDIA
card and nvcc and skip elsewhere; the file imports no JAX, so on the card
it runs without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_moe_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import moe_combine as MC
from repro_torch.models import moe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the combine's kernels run only there")
    return torch.device("cuda", 0)


def _inputs(dev, b, s, e, top_k, d, dtype, hot, seed):
    """Rows, routing and a cotangent as ``_experts`` builds them, the
    routing skewed to the first ``hot`` experts."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(b, s, e, device=dev, generator=g)
    logits[..., :hot] += 3.0
    cap = moe.capacity(s, e, top_k)
    r = moe.route(torch.softmax(logits, dim=-1), top_k, cap)
    rows = (r.expert * b + torch.arange(b, device=dev)[:, None, None]) * cap + r.slot
    ye = torch.randn(e * b * cap, d, device=dev, generator=g).to(dtype)
    dy = torch.randn(b, s, d, device=dev, generator=g)
    return ye, rows, r.keep, r.weight, dy


def _run(fn_fwd, fn_bwd, ye, rows, keep, weight, dy):
    y = fn_fwd(ye, rows, keep, weight)
    d_ye, d_weight = fn_bwd(dy, ye, rows, keep, weight)
    return y, d_ye, d_weight


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_kernels_match_the_plain_versions(dev, dtype):
    """At granite-moe's full shapes (cap 640, most pairs dropped): y within
    f32 rounding, d_ye bitwise, d_weight within 1e-6 of the dot's scale
    Σ_d |ye·dy|; the launch counters advance."""
    ye, rows, keep, weight, dy = _inputs(dev, 4, 2048, 32, 8, 1024, dtype, 8, seed=7)
    assert moe.capacity(2048, 32, 8) == 640
    assert 1 - keep.float().mean().item() > 0.5
    before = dict(MC.LAUNCHES)
    ye_l = ye.clone().requires_grad_(True)
    w_l = weight.clone().requires_grad_(True)
    y = MC.moe_combine(ye_l, rows, keep, w_l)
    y.backward(dy)
    torch.cuda.synchronize()
    assert MC.LAUNCHES["forward"] == before["forward"] + 1
    assert MC.LAUNCHES["backward"] == before["backward"] + 1
    y_p = MC.combine_plain(ye, rows, keep, weight)
    d_ye_p, d_w_p = MC.combine_backward_plain(dy, ye, rows, keep, weight)
    torch.testing.assert_close(y.detach(), y_p, rtol=1e-6,
                               atol=1e-6 * float(y_p.abs().max()))
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(ye_l.grad.view(bits), d_ye_p.view(bits))
    picked = ye[torch.where(keep, rows, torch.zeros_like(rows))].float()
    scale = torch.sum((picked * dy[..., None, :]).abs(), dim=-1)
    assert bool(torch.all((w_l.grad - d_w_p).abs() <= 1e-6 * scale))
    assert bool(torch.all(w_l.grad[~keep] == 0))


def test_kernels_repeat_bit_for_bit(dev):
    """Two calls on the same inputs give the same bits (no atomics)."""
    ye, rows, keep, weight, dy = _inputs(dev, 4, 2048, 32, 8, 1024, torch.bfloat16, 8, seed=11)
    runs = [_run(MC._COMBINE, MC._COMBINE_BACKWARD, ye, rows, keep, weight, dy)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_kernels_refuse_rows_not_of_16_byte_columns(dev, dtype):
    """D not a multiple of 16 bytes, or a row buffer off 16-byte alignment:
    the op raises and launches nothing (no fallback)."""
    ye, rows, keep, weight, dy = _inputs(dev, 2, 64, 8, 2, 102, dtype, 1, seed=3)
    before = dict(MC.LAUNCHES)
    with pytest.raises(ValueError):
        MC.moe_combine(ye, rows, keep, weight)
    ye, rows, keep, weight, dy = _inputs(dev, 2, 64, 8, 2, 64, dtype, 1, seed=3)
    shifted = torch.empty(ye.numel() + 1, dtype=dtype, device=dev)[1:].view(ye.shape)
    with pytest.raises(ValueError):
        MC.moe_combine(shifted.copy_(ye), rows, keep, weight)
    assert MC.LAUNCHES == before
