"""The compiled-in order-statistic kernels B1 (median), B2 (trimmed mean)
and B3 (both from one read) on the CPU: their generated programs, launch
plans and arithmetic, and the leaf grouping of ``tree_aggregate``.

The kernels themselves run only on the card (chip_smoke.py holds them
bitwise against the plain versions there).  Here:

- the generator emits each program's comparators in order, for every m in
  1..64 and every legal trim; the fused program is the trimmed program
  (comparators and ranks), so B3's median comes from B2's keys;
- the premise of the kernels' NaN rule holds: in every program every input
  wire reaches every requested rank wire, so one NaN in a column makes every
  requested rank NaN under jnp.minimum/maximum;
- a torch emulation of the kernels' arithmetic (int32 keys for f32, int16
  keys for bf16 and f16, integer min/max through the program, the NaN flag,
  decoding, the f32 midpoint, the rank-order band sum with true division,
  one rounding to bf16 / f16) equals
  ``SN.median_select`` / ``SN.trimmed_mean_select`` bitwise, and B3's two
  outputs from one set of keys equal ``SN.median_and_trimmed_select``
  bitwise (NaN matched by position), on rows with NaN, ±0, ±inf, ±1e30 and
  subnormals (f16's own: ±65504, its subnormals and its smallest normal);
- the launch plan and the kernels' block-to-leaf mapping are pinned;
- the grouped ``tree_aggregate`` equals the per-leaf one and the
  reference's ``repro.core.aggregators.tree_aggregate`` bitwise.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JA
from repro_torch.core import aggregators as A
from repro_torch.kernels import robust_agg
from repro_torch.kernels import select_codegen as G
from repro_torch.kernels import selection_network as SN

torch.set_num_threads(2)

ALL_M = list(range(1, SN.NETWORK_MAX_M + 1))
EMULATED_M = [1, 2, 3, 5, 8, 10, 16, 17, 31, 32, 40, 63, 64]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
DTYPE_IDS = ["f32", "bf16", "f16"]


def _programs(m):
    """(kind, trim) of every kernel program for m: the median, and each band
    alone and fused with the median."""
    return [("median", 0)] + [(k, t) for t in range((m + 1) // 2)
                              for k in ("trimmed_mean", "fused_median_trimmed")]


# ------------------------------------------------------------- generator


@pytest.mark.parametrize("m", ALL_M)
def test_emitted_program_is_the_comparator_list_in_order(m):
    for kind, trim in _programs(m):
        text = G.emit_program(kind, m, trim)
        assert f"static constexpr int kM = {m};" in text
        emitted = [(int(i), int(j)) for i, j in re.findall(r"CX\((\d+), (\d+)\);", text)]
        assert emitted == list(G.program(kind, m, trim).comparators), (kind, m, trim)


@pytest.mark.parametrize("m", ALL_M)
def test_fused_program_is_the_trimmed_program(m):
    """B3 runs the trimmed program's comparators and reads the median from
    the same keys: the band [trim, m - trim) holds the median ranks."""
    for t in range((m + 1) // 2):
        fused, band = SN.fused_program(m, t), SN.trimmed_program(m, t)
        assert fused.comparators == band.comparators, (m, t)
        assert fused.ranks == band.ranks == tuple(range(t, m - t)), (m, t)
        assert set(SN.median_ranks(m)) <= set(band.ranks), (m, t)
        assert G.program("fused_median_trimmed", m, t) == fused


@pytest.mark.parametrize("m", ALL_M)
def test_every_input_wire_reaches_every_requested_rank(m):
    """The NaN rule's premise, for the median, every band and every fused
    program: a NaN spreads to both outputs of each comparator it touches,
    so it reaches exactly the wires its input wire reaches."""
    progs = [SN.median_program(m)]
    for t in range((m + 1) // 2):
        progs += [SN.trimmed_program(m, t), SN.fused_program(m, t)]
    everyone = (1 << m) - 1
    for prog in progs:
        reach = [1 << w for w in range(m)]  # input wires reaching each wire
        for i, j in prog.comparators:
            reach[i] = reach[j] = reach[i] | reach[j]
        assert all(reach[r] == everyone for r in prog.ranks), (m, prog.ranks)


def test_source_names_every_entry_and_the_header():
    specs = [G.spec("median", 10, 5, torch.float32), G.spec("trimmed_mean", 10, 1, torch.bfloat16),
             G.spec("median", 1, 0, torch.bfloat16)]
    src = G.emit_source(specs)
    assert specs[0].trim == 0
    assert '#include "select_program.cuh"' in src
    assert "select_program.cuh sha256 " in src
    for s in specs:
        assert f'extern "C" int {G.symbol(s)}(' in src
    assert "sel::launch<float, med_m10, 4, sel::kMedian, 0>" in src
    assert "sel::launch<__nv_bfloat16, tm_m10_t1, 8, sel::kTrimmed, 1>" in src
    assert src == G.emit_source(list(reversed(specs)))  # order-free: one hash per set
    with pytest.raises(ValueError):
        G.spec("trimmed_mean", 4, 2, torch.float32)
    with pytest.raises(ValueError):
        G.spec("fused_median_trimmed", 4, 2, torch.float32)
    with pytest.raises(ValueError, match="unknown kind"):
        G.spec("mean", 4, 0, torch.float32)
    with pytest.raises(ValueError):
        G.spec("median", 65, 0, torch.float32)
    with pytest.raises(TypeError):
        G.spec("median", 4, 0, torch.float64)


def test_fused_spec_symbol_and_entry():
    s = G.spec("fused_median_trimmed", 32, 3, torch.bfloat16)
    assert s == G.Spec("fused_median_trimmed", 32, 3, torch.bfloat16)  # trim kept
    assert G.symbol(s) == "ra_sel_fu_m32_t3_bf16"
    assert G.program_name("fused_median_trimmed", 32, 3) == "fu_m32_t3"
    src = G.emit_source([s])
    assert f'extern "C" int ra_sel_fu_m32_t3_bf16(' in src
    assert "sel::launch<__nv_bfloat16, fu_m32_t3, 4, sel::kFused, 3>" in src
    assert "// median and trim-3 band of m=32" in src
    h = G.spec("fused_median_trimmed", 32, 3, torch.float16)
    assert G.symbol(h) == "ra_sel_fu_m32_t3_f16"
    assert "sel::launch<__half, fu_m32_t3, 4, sel::kFused, 3>" in G.emit_source([h])
    assert G.cost(s) == G.cost(G.spec("trimmed_mean", 32, 3, torch.bfloat16))


def test_source_defines_each_struct_once_across_kinds_and_dtypes():
    """A library holding the trimmed and the fused kernel of one (m, trim),
    each in both dtypes, defines each program struct once."""
    specs = [G.spec(k, 10, 1, d) for k in ("trimmed_mean", "fused_median_trimmed")
             for d in DTYPES] + [G.spec("median", 10, 0, torch.float32)]
    src = G.emit_source(specs)
    structs = re.findall(r"^struct (\w+) \{", src, flags=re.M)
    assert sorted(structs) == ["fu_m10_t1", "med_m10", "tm_m10_t1"]
    entries = re.findall(r'^extern "C" int (ra_sel_\w+)\(', src, flags=re.M)
    assert sorted(entries) == sorted(G.symbol(s) for s in specs)
    for d, v in (("float", 4), ("__nv_bfloat16", 8), ("__half", 8)):
        assert f"sel::launch<{d}, fu_m10_t1, {v}, sel::kFused, 1>" in src
        assert f"sel::launch<{d}, tm_m10_t1, {v}, sel::kTrimmed, 1>" in src


def test_partition_covers_each_spec_once_and_balances():
    specs = [G.spec(k, m, t, d) for m in ALL_M for k, t in _programs(m) for d in DTYPES]
    groups = G.partition(specs, 8)
    assert len(groups) == 8
    flat = [s for g in groups for s in g]
    assert sorted(flat, key=G.spec_key) == sorted(set(specs), key=G.spec_key)
    loads = [sum(G.cost(s) for s in g) for g in groups]
    assert max(loads) <= 1.05 * min(loads)
    assert {s.kind for s in flat} == set(G.KINDS)
    assert G.partition(specs, 8) == groups
    assert G.partition(specs[:3], 8) == [[s] for s in sorted(specs[:3], key=G.spec_key)]


# ------------------------------------------------------------------ plan


def test_coords_per_thread_keeps_the_keys_in_budget():
    for m in ALL_M:
        for dtype, widest, per_register in ((torch.float32, 4, 1), (torch.bfloat16, 8, 2),
                                            (torch.float16, 8, 2)):
            v = G.coords_per_thread(m, dtype)
            registers = m * v // per_register
            assert v in (1, 2, 4, 8) and v <= widest and v >= per_register
            assert registers <= G.KEY_BUDGET
            assert v == widest or 2 * registers > G.KEY_BUDGET
    assert [G.coords_per_thread(m, torch.float32) for m in (1, 16, 17, 32, 33, 64)] == \
        [4, 4, 2, 2, 1, 1]
    for dtype in (torch.bfloat16, torch.float16):
        assert [G.coords_per_thread(m, dtype) for m in (1, 16, 17, 32, 33, 64)] == \
            [8, 8, 4, 4, 2, 2]


@pytest.mark.parametrize("m,n,dtype,aligned,plan", [
    (10, 50176, torch.float32, True, G.SelectPlan(4, 16, 128, False)),  # fc1: 16-byte loads
    (10, 10, torch.float32, True, G.SelectPlan(4, 4, 128, True)),  # bf2: n % 4 != 0
    (10, 50176, torch.float32, False, G.SelectPlan(4, 4, 128, True)),  # misaligned view
    (32, 1 << 24, torch.float32, True, G.SelectPlan(2, 8, 128, False)),
    (31, 1 << 24, torch.float32, True, G.SelectPlan(2, 8, 128, False)),
    (40, 7840, torch.float32, True, G.SelectPlan(1, 4, 128, False)),
    (64, 3, torch.float32, True, G.SelectPlan(1, 4, 128, False)),
    (8, 4096, torch.bfloat16, True, G.SelectPlan(8, 16, 128, False)),
    (16, 4096, torch.bfloat16, True, G.SelectPlan(8, 16, 128, False)),
    (32, 1 << 24, torch.bfloat16, True, G.SelectPlan(4, 8, 128, False)),
    (64, 1 << 20, torch.bfloat16, True, G.SelectPlan(2, 4, 128, False)),
    (16, 4097, torch.bfloat16, True, G.SelectPlan(8, 2, 128, True)),
    (32, 1 << 24, torch.float16, True, G.SelectPlan(4, 8, 128, False)),
    (10, 50176, torch.float16, False, G.SelectPlan(8, 2, 128, True)),
])
def test_select_plan_pinned(m, n, dtype, aligned, plan):
    assert G.select_plan(m, n, dtype, aligned) == plan


def _blocks(ns, vecs, coords):
    """The coordinates each block's threads own, as leaf_select_kernel maps
    them: the block's leaf from the prefix of tile counts, then V
    neighbouring coordinates a thread (vector path) or t + v * THREADS
    (scalar path)."""
    first, tiles = [], 0
    for n in ns:
        first.append(tiles)
        tiles += -(-n // (G.THREADS * coords))  # a block covers THREADS * V
    first += [float("inf")] * (G.MAX_LEAVES - len(ns))
    owned = [[] for _ in ns]
    for b in range(tiles):
        leaf = sum(b >= first[j] for j in range(1, G.MAX_LEAVES))
        tile = b - first[leaf]
        for t in range(G.THREADS):
            if vecs[leaf]:
                c0 = (tile * G.THREADS + t) * coords
                cs = [c0 + v for v in range(coords)]
            else:
                c0 = tile * G.THREADS * coords + t
                cs = [c0 + v * G.THREADS for v in range(coords)]
            if c0 < ns[leaf]:
                owned[leaf] += [c for c in cs if c < ns[leaf]]
    return owned


@pytest.mark.parametrize("coords", [1, 2, 4, 8])
def test_blocks_cover_every_coordinate_of_every_leaf_once(coords):
    ns = [144, 16, 2304, 16, 50176 // 8, 64, 640, 10, 1, 513]
    vecs = [n % coords == 0 and i % 3 != 1 for i, n in enumerate(ns)]
    for leaf, cs in enumerate(_blocks(ns, vecs, coords)):
        assert sorted(cs) == list(range(ns[leaf])), (leaf, ns[leaf], vecs[leaf])


# ------------------------------------------------------------ arithmetic


def _keys(x):
    """Signed keys (held in int64) and |bits| of each value: int32 keys of
    f32 bits, int16 keys of bf16 and f16 bits."""
    width = 32 if x.dtype == torch.float32 else 16
    ints = x.view(torch.int16 if width == 16 else torch.int32).to(torch.int64)
    mask = (1 << (width - 1)) - 1  # 0x7fff or 0x7fffffff
    return ints ^ ((ints >> (width - 1)) & mask), ints & mask


def _value(key, dtype):
    """The f32 value of a key (a bf16 or f16 value widened exactly)."""
    if dtype == torch.bfloat16:
        bits = (key ^ ((key >> 15) & 0x7FFF)) & 0xFFFF
        return (bits << 16).to(torch.int32).view(torch.float32)  # wraps like a shift
    if dtype == torch.float16:
        bits = key ^ ((key >> 15) & 0x7FFF)  # the int16 bits, sign included
        return bits.to(torch.int16).view(torch.float16).float()
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).to(torch.int32).view(torch.float32)


def emulate(x, kind, trim):
    """The kernel's arithmetic on an (m, n) tensor, in torch on the CPU; the
    fused kernel gives (median, trimmed mean) from one set of keys."""
    m = x.shape[0]
    key, mag = _keys(x)
    inf = {torch.float32: 0x7F800000, torch.bfloat16: 0x7F80, torch.float16: 0x7C00}[x.dtype]
    nan = (mag > inf).any(0)
    k = list(key.unbind(0))
    for i, j in G.program(kind, m, trim).comparators:
        k[i], k[j] = torch.minimum(k[i], k[j]), torch.maximum(k[i], k[j])
    value = lambda i: _value(k[i], x.dtype)

    def median():
        return value(m // 2) if m % 2 else (value(m // 2 - 1) + value(m // 2)) * 0.5

    def band_mean():
        r = value(trim)
        for i in range(trim + 1, m - trim):
            r = r + value(i)
        return r / torch.full_like(r, m - 2 * trim)

    def out(r):
        return torch.where(nan, torch.full_like(r, float("nan")), r).to(x.dtype)

    if kind == "median":
        return out(median())
    if kind == "trimmed_mean":
        return out(band_mean())
    return out(median()), out(band_mean())


SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
                     1.1754944e-38, -3e-39, 1e-45], dtype=np.float32)
# the same roles in f16: its largest finite value, its subnormals (down to
# 2^-24) and its smallest normal 2^-14
HALF_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, 65504.0, -65504.0, 3e-5, -3e-5, 2 ** -24,
                          -(2 ** -24), 2 ** -14, -4e-6, 1e-7], dtype=np.float32)


def special_rows(m, n, seed, dtype):
    """N(0,1) rows; a quarter of the values drawn from ±0, ±inf, ±1e30 and
    f32 subnormals (for f16: ±65504 and f16 subnormals); one NaN column, one
    all-±0 column, one column of subnormals only and one of ±inf only."""
    specials = HALF_SPECIALS if dtype == torch.float16 else SPECIALS
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    pick = rng.random((m, n)) < 0.25
    x[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    x[m // 2, 0] = np.nan
    x[:, 1] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
    x[:, 2] = rng.choice(specials[6:], m)
    x[:, 3] = rng.choice(specials[2:4], m)
    return torch.from_numpy(x).to(dtype)


def assert_bitwise(got, want, msg=""):
    g, w = got.float(), want.float()
    gn, wn = torch.isnan(g), torch.isnan(w)
    assert torch.equal(gn, wn), f"{msg}: NaN positions differ"
    gb = torch.where(gn, 0, g.view(torch.int32))
    wb = torch.where(wn, 0, w.view(torch.int32))
    bad = (gb != wb).nonzero().flatten()
    assert bad.numel() == 0, f"{msg}: {bad.numel()} mismatches, first at {bad[:5].tolist()}"


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("m", EMULATED_M)
def test_emulated_kernel_arithmetic_is_the_plain_version_bitwise(m, dtype):
    x = special_rows(m, 97, seed=m, dtype=dtype)
    assert_bitwise(emulate(x, "median", 0), SN.median_select(x), f"median m={m}")
    for trim in sorted({0, min(1, (m - 1) // 2), m // 10, (m - 1) // 2}):
        assert_bitwise(emulate(x, "trimmed_mean", trim), SN.trimmed_mean_select(x, trim),
                       f"trimmed m={m} trim={trim}")


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("m", EMULATED_M)
def test_emulated_fused_kernel_is_the_plain_version_bitwise(m, dtype):
    x = special_rows(m, 97, seed=100 + m, dtype=dtype)
    for trim in sorted({0, min(1, (m - 1) // 2), m // 10, (m - 1) // 2}):
        med, tm = emulate(x, "fused_median_trimmed", trim)
        want_med, want_tm = SN.median_and_trimmed_select(x, trim)
        assert_bitwise(med, want_med, f"fused median m={m} trim={trim}")
        assert_bitwise(tm, want_tm, f"fused trimmed m={m} trim={trim}")
        # and each output is B1's / B2's
        assert_bitwise(med, emulate(x, "median", 0), f"fused vs median m={m}")
        assert_bitwise(tm, emulate(x, "trimmed_mean", trim), f"fused vs trimmed m={m}")


def test_key_order_is_jnp_order_on_special_values():
    vals = torch.tensor([-np.inf, -1e30, -65504.0, -1.0, -2 ** -14, -3e-5, -(2 ** -24),
                         -1.1754944e-38, -1e-40, -1.4e-45, -0.0, 0.0, 1.4e-45, 1e-40,
                         1.1754944e-38, 2 ** -24, 3e-5, 2 ** -14, 1.0, 65504.0, 1e30, np.inf])
    for dtype in DTYPES:
        v = vals.to(dtype)
        keep = torch.cat([torch.tensor([True]), v[1:].float() != v[:-1].float()])
        keep |= torch.signbit(v.float()) != torch.signbit(torch.roll(v.float(), 1))
        v = v[keep]  # distinct in this dtype (some subnormals round together)
        key, _ = _keys(v)
        assert torch.equal(torch.sort(key).values, key) and len(set(key.tolist())) == len(key)
        assert torch.equal(_value(key, dtype).view(torch.int32), v.float().view(torch.int32))


# -------------------------------------------------- grouped aggregation


def _leaves(m, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (3, 4), "b1": (5,), "w2": (2, 2, 2), "b2": (1,), "fc": (37,)}
    out = {}
    for i, (k, shape) in enumerate(shapes.items()):
        x = rng.standard_normal((m,) + shape).astype(np.float32)
        flat = x.reshape(m, -1)
        flat[: max(1, m // 5), 0] = 1e30
        if flat.shape[1] > 2:
            flat[m // 2, 1] = np.nan
            flat[:, 2] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
        out[k] = torch.from_numpy(x).to(dtype)
    return out


def _to_jax(t):
    return jnp.asarray(t.float().numpy(), dtype={torch.bfloat16: jnp.bfloat16,
                                                 torch.float16: jnp.float16}.get(t.dtype,
                                                                                 jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("method,beta", [("median", 0.1), ("trimmed_mean", 0.1),
                                         ("trimmed_mean", 0.25)])
def test_grouped_tree_aggregate_equals_per_leaf_and_reference(method, beta, dtype):
    tree = _leaves(10, dtype, seed=7)
    got = A.tree_aggregate(tree, method, beta)
    agg = A.get_aggregator(method, beta)
    want = JA.tree_aggregate({k: _to_jax(v) for k, v in tree.items()}, method, beta)
    assert list(got) == list(tree)
    for k, x in tree.items():
        assert got[k].shape == x.shape[1:] and got[k].dtype == dtype
        assert_bitwise(got[k], agg(x), f"{method} leaf {k} vs per leaf")
        ref = torch.from_numpy(np.array(jnp.asarray(want[k], jnp.float32)))
        assert_bitwise(got[k].float(), ref, f"{method} leaf {k} vs the reference")


def test_tree_aggregate_groups_by_m_dtype_and_method(monkeypatch):
    calls = []
    for name in ("median_many", "trimmed_mean_many"):
        real = getattr(robust_agg, name)

        def spy(xs, *args, _real=real, _name=name):
            calls.append((_name, tuple(x.shape for x in xs), xs[0].dtype) + args)
            return _real(xs, *args)

        monkeypatch.setattr(robust_agg, name, spy)
    rng = np.random.default_rng(0)
    mk = lambda *shape, dtype=torch.float32: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)
    tree = {"a": mk(10, 3, 4), "b": (mk(10, 5), mk(7, 6)), "c": [mk(10, 2, dtype=torch.bfloat16),
            mk(10, 9)], "d": mk(1, 4), "e": mk(70, 3), "f": mk(10, 4).double()}
    for method, beta in (("median", 0.1), ("trimmed_mean", 0.1), ("trimmed_mean", 0.15)):
        calls.clear()
        got = A.tree_aggregate(tree, method, beta)
        agg = A.get_aggregator(method, beta)
        expect = {"median": [("median_many", ((10, 12), (10, 5), (10, 9)), torch.float32),
                             ("median_many", ((7, 6),), torch.float32),
                             ("median_many", ((10, 2),), torch.bfloat16)],
                  "trimmed_mean": [("trimmed_mean_many", ((10, 12), (10, 5), (10, 9)),
                                    torch.float32, 1),
                                   ("trimmed_mean_many", ((10, 2),), torch.bfloat16, 1)]}
        want_calls = expect[method]
        if beta == 0.15:  # trim 1 for m=7 too
            want_calls = [want_calls[0], ("trimmed_mean_many", ((7, 6),), torch.float32, 1),
                          want_calls[1]]
        assert calls == want_calls, method
        leaves = [tree["a"], *tree["b"], *tree["c"], tree["d"], tree["e"], tree["f"]]
        outs = [got["a"], *got["b"], *got["c"], got["d"], got["e"], got["f"]]
        assert isinstance(got["b"], tuple) and isinstance(got["c"], list)
        for x, o in zip(leaves, outs):
            assert_bitwise(o, agg(x), f"{method} {tuple(x.shape)}")


def test_many_wrappers_on_the_cpu():
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((9, n)).astype(np.float32)) for n in (1, 8, 33)]
    for got, x in zip(robust_agg.median_many(xs), xs):
        assert_bitwise(got, SN.median_select(x))
    for got, x in zip(robust_agg.trimmed_mean_many(xs, 2), xs):
        assert_bitwise(got, SN.trimmed_mean_select(x, 2))
    assert robust_agg.median_many([]) == []
    with pytest.raises(ValueError, match="one m"):
        robust_agg.median_many([xs[0], torch.zeros(8, 3)])
    with pytest.raises(ValueError, match="one m"):
        robust_agg.median_many([xs[0], xs[1].to(torch.bfloat16)])
    with pytest.raises(ValueError, match="invalid trim"):
        robust_agg.trimmed_mean_many(xs, 5)


def test_fused_many_wrapper_on_the_cpu():
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal((9, n)).astype(np.float32)) for n in (1, 8, 33)]
    meds, tms = robust_agg.fused_median_trimmed_many(xs, 2)
    assert len(meds) == len(tms) == len(xs)
    for med, tm, x in zip(meds, tms, xs):
        want_med, want_tm = SN.median_and_trimmed_select(x, 2)
        assert_bitwise(med, want_med)
        assert_bitwise(tm, want_tm)
        one_med, one_tm = robust_agg.fused_median_trimmed(x, 2)
        assert_bitwise(one_med, med)
        assert_bitwise(one_tm, tm)
    x1 = special_rows(1, 5, seed=3, dtype=torch.bfloat16)  # m = 1: both outputs are the row
    (med,), (tm,) = robust_agg.fused_median_trimmed_many([x1], 0)
    assert_bitwise(med, x1[0])
    assert_bitwise(tm, x1[0])
    assert robust_agg.fused_median_trimmed_many([], 1) == ([], [])
    with pytest.raises(ValueError, match="one m"):
        robust_agg.fused_median_trimmed_many([xs[0], torch.zeros(8, 3)], 1)
    with pytest.raises(ValueError, match="one m"):
        robust_agg.fused_median_trimmed_many([xs[0], xs[1].to(torch.bfloat16)], 1)
    with pytest.raises(ValueError, match="invalid trim"):
        robust_agg.fused_median_trimmed_many(xs, 5)
    with pytest.raises(ValueError, match="contiguous"):
        robust_agg.fused_median_trimmed_many([xs[2], torch.zeros(3, 9).T], 1)


def test_prepare_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        robust_agg.prepare([("median", 10, 0, torch.float32)])
    with pytest.raises(RuntimeError, match="CUDA"):
        robust_agg.prepare([("fused_median_trimmed", 10, 1, torch.bfloat16)])
