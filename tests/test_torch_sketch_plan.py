"""The redesigned sketch kernels' premises and launch plans (CPU).

The CUDA kernels of ``src/repro_torch/kernels/csrc/histogram_agg.cu`` run
only on the card, where ``chip_smoke.py`` holds them bitwise against their
plain versions.  What can be checked here is held here:

- B4 (min/max) splits each column tile's rows across W warps (warp w takes
  rows w, w + W, ... from +inf / -inf) and combines the warps in order
  0..W-1.  Emulated in torch with the plain version's ``ieee_minimum`` /
  ``ieee_maximum``, this must equal :func:`minmax_plain` bitwise (NaN
  matching NaN) on adversarial chunks, for any W.
- B5 (histogram) counts in int (exact in any order) and walks each
  column's staged rows 8 at a time for the sums, chaining rows of one bin
  in registers and storing back in row order.  Emulated in numpy float32
  (round to nearest, as ``__fadd_rn``), the counts and sums must equal
  :func:`histogram_plain` bitwise.
- The launch plans chosen in Python, which the kernels take as they are.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import histogram_agg as H
from repro_torch.kernels import selection_network as SN

torch.set_num_threads(2)


def _adversarial(rows, n, seed, dtype=torch.float32):
    """3 * N(0,1) with ±1e30 rows, a NaN, mixed ±0, a constant column and
    ±inf rows, as in chip_smoke's sketch sweep."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((rows, n))).astype(np.float32)
    x[: max(1, rows // 4), 0] = 1e30
    x[rows // 2:, 0] = -1e30
    x[rows // 2, 1] = np.nan
    x[:, 2] = np.where(rng.random(rows) < 0.5, -0.0, 0.0)
    x[:, 3] = 1.25
    x[0, 4] = np.inf
    x[-1, 5] = -np.inf
    return torch.from_numpy(x).to(dtype)


def _bitequal(got: torch.Tensor, want: torch.Tensor) -> bool:
    g, w = got.float(), want.float()
    gn, wn = torch.isnan(g), torch.isnan(w)
    same = torch.where(gn | wn, gn & wn, g.view(torch.int32) == w.view(torch.int32))
    return bool(same.all())


# ------------------------------------------------------- B4: the warp split


def _minmax_split(x: torch.Tensor, warps: int):
    xf = x.float()
    rows, n = xf.shape
    parts = []
    for w in range(warps):
        a = torch.full((n,), float("inf"))
        b = torch.full((n,), float("-inf"))
        for r in range(w, rows, warps):
            a, b = SN.ieee_minimum(a, xf[r]), SN.ieee_maximum(b, xf[r])
        parts.append((a, b))
    lo, hi = parts[0]
    for a, b in parts[1:]:  # the kernel's fixed combine order
        lo, hi = SN.ieee_minimum(lo, a), SN.ieee_maximum(hi, b)
    return lo, hi


@pytest.mark.parametrize("rows", [1, 7, 33, 512])
@pytest.mark.parametrize("warps", [1, 2, 7, 32])
def test_minmax_warp_split_is_bitwise_the_plain_version(warps, rows):
    for dtype in (torch.float32, torch.bfloat16):
        x = _adversarial(rows, 12, seed=rows * 5 + warps, dtype=dtype)
        lo, hi = _minmax_split(x, warps)
        plo, phi = H.minmax_plain(x)
        assert _bitequal(lo, plo) and _bitequal(hi, phi)
        if rows > 1:  # mixed ±0: -0 < +0 whatever the split
            assert torch.signbit(lo[2]) and not torch.signbit(hi[2])


# ------------------------------------------------ B5: the grouped row walk


def _histogram_walk(x: torch.Tensor, lo, width, nbins: int, stage: int, group: int = 8):
    """The shared kernel: integer counts (any order), and per column and
    staged batch a walker that takes ``group`` rows at a time, loads their
    bins' running sums at once, chains rows of one bin in registers and
    stores back in row order."""
    idx = H.bin_index(x, lo, width, nbins).numpy()
    v = x.float().numpy()
    rows, n = v.shape
    counts = np.zeros((nbins, n), np.int64)
    np.add.at(counts, (idx, np.broadcast_to(np.arange(n), idx.shape)), 1)
    sums = np.zeros((nbins, n), np.float32)
    for c in range(n):
        for base in range(0, rows, stage):
            nr = min(stage, rows - base)
            r = 0
            while r + group <= nr:
                b = idx[base + r:base + r + group, c]
                vv = v[base + r:base + r + group, c]
                ps = sums[b, c].copy()  # loaded at once
                for k in range(group):
                    s = ps[k]
                    for i in range(k):  # the latest earlier row of the same bin
                        if b[i] == b[k]:
                            s = ps[i]
                    ps[k] = s + vv[k]  # float32 + float32: round to nearest
                for k in range(group):  # stored in row order
                    sums[b[k], c] = ps[k]
                r += group
            for r in range(r, nr):
                sums[idx[base + r, c], c] += v[base + r, c]
    return torch.from_numpy(counts.astype(np.float32)), torch.from_numpy(sums)


@pytest.mark.parametrize("stage", [8, 16, 512])
@pytest.mark.parametrize("nbins", [2, 5, 64])
def test_histogram_grouped_walk_is_bitwise_the_plain_version(nbins, stage):
    x = _adversarial(45, 9, seed=nbins + stage)
    lo, width = H.edges(*H.minmax_plain(x), nbins)
    with np.errstate(invalid="ignore", over="ignore"):
        counts, sums = _histogram_walk(x, lo, width, nbins, stage)
    pc, ps = H.histogram_plain(x, lo, width, nbins)
    assert _bitequal(counts, pc) and _bitequal(sums, ps)


# ------------------------------------------------------------ launch plans

PLAN_ROWS = (1, 7, 33, 256, 512, 1000)
PLAN_N = (1, 32, 33, 64, 4097, 50176, 1 << 20)
PLAN_NBINS = (2, 128, 512, 4096, 1 << 14, 29048, 29049, 1 << 15, 58112, 58113, 1 << 16)


@pytest.mark.parametrize("with_sums", [True, False])
@pytest.mark.parametrize("nbins", PLAN_NBINS)
def test_histogram_plan_fits_shared_memory(nbins, with_sums):
    one_column = H.histogram_smem_bytes(nbins, with_sums, 1, H.MIN_STAGE_ROWS)
    for rows in PLAN_ROWS:
        for n in PLAN_N:
            p = H.histogram_plan(rows, n, nbins, with_sums)
            # global iff one column cannot fit (rows here are all <= 2^24)
            assert p.shared == (one_column <= H.SMEM_LIMIT)
            if not p.shared:
                continue
            assert p.smem_bytes == H.histogram_smem_bytes(nbins, with_sums, p.tile,
                                                          p.stage_rows) <= H.SMEM_LIMIT
            assert p.tile & (p.tile - 1) == 0 and p.tile <= 32
            assert p.threads % p.tile == 0 and 32 <= p.threads <= 512
            if -(-n // p.tile) >= H.NUM_SMS:  # many blocks: small ones
                assert p.threads <= 128
            assert 1 <= p.stage_rows <= 512 and p.stage_rows & (p.stage_rows - 1) == 0
            assert p.stage_rows * p.tile <= p.threads * H.LOADS_PER_THREAD
            assert p.stage_rows >= min(rows, H.MIN_STAGE_ROWS)


def test_histogram_plan_edges_of_the_budget():
    # counts only: 4 * nbins bytes a column; with sums 8 * (nbins + 8)
    assert H.histogram_plan(33, 33, 58112, False).shared
    assert not H.histogram_plan(33, 33, 58113, False).shared
    assert H.histogram_plan(33, 33, 29048, True).shared
    assert not H.histogram_plan(33, 33, 29049, True).shared
    p = H.histogram_plan(33, 33, 1 << 15, False)  # 128 KB a column: one column a block
    assert (p.tile, p.shared) == (1, True)
    assert not H.histogram_plan(33, 33, 1 << 15, True).shared
    # int counts equal the f32 +1 chain only up to 2^24 rows
    assert H.histogram_plan(1 << 24, 32, 512, False).shared
    assert not H.histogram_plan((1 << 24) + 1, 32, 512, False).shared


def test_histogram_plan_at_the_timed_shapes():
    # the federated chunk: 4 blocks of 8 columns, the whole chunk staged at once
    assert H.histogram_plan(512, 32, 512, True) == H.HistogramPlan(8, 512, 512, 65536)
    assert H.histogram_plan(512, 32, 512, False) == H.HistogramPlan(8, 512, 512, 16384)
    # 2^20 columns: tiles of 32 columns, blocks of 128 threads, 8 rows a thread
    for sums in (True, False):
        p = H.histogram_plan(256, 1 << 20, 128, sums)
        assert (p.tile, p.threads, p.stage_rows) == (32, 128, 32)
        assert 4 * p.smem_bytes <= H.SMEM_LIMIT


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4), (torch.bfloat16, 8)])
def test_minmax_plan_vector_loads_only_when_aligned(dtype, vec):
    wide = 32 * vec * H.NUM_SMS
    base = torch.zeros(2 * wide + 16, dtype=dtype)
    aligned = base[:2 * wide].view(2, wide)
    assert aligned.data_ptr() % 16 == 0
    assert H.minmax_plan_for(aligned).vec == vec
    shifted = base[1:2 * wide + 1].view(2, wide)  # pointer off by one element
    assert H.minmax_plan_for(shifted).vec == 1
    odd = base[:2 * (wide + 1)].view(2, wide + 1)  # rows start misaligned
    assert H.minmax_plan_for(odd).vec == 1
    rows = torch.zeros(34, 33, dtype=dtype)[1:]  # a row slice, as the chunked sketch passes
    assert rows.is_contiguous() and H.minmax_plan_for(rows).vec == 1
    assert H.minmax_plan_for(torch.zeros(2, 32, dtype=dtype)).vec == 1  # too few tiles


@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_minmax_plan_warps_and_shared_memory(rows):
    for elem in (4, 2):
        for n in PLAN_N:
            for aligned in (True, False):
                p = H.minmax_plan(rows, n, elem, aligned)
                assert p.vec in (1, 16 // elem)
                assert 1 <= p.warps <= (16 if p.vec == 8 else 32)
                assert p.smem_bytes <= 48 * 1024  # no attribute needed
                assert p.warps <= max(1, rows // 16)  # about 16 rows a warp or more
    assert H.minmax_plan(512, 32, 4, True) == H.MinmaxPlan(1, 32)  # the fed chunk
    assert H.minmax_plan(256, 64, 4, True) == H.MinmaxPlan(1, 16)  # the CLI default
    assert H.minmax_plan(256, 1 << 20, 4, True) == H.MinmaxPlan(4, 16)
    assert H.minmax_plan(256, 1 << 20, 2, True) == H.MinmaxPlan(8, 16)
