"""The port's worker-axis strategies (repro_torch.core.distributed,
rounds.distributed.aggregate_by_strategy) against the reference's under
``shard_map`` on 8 forced CPU devices.

The reference runs once, in one subprocess (its own tests' harness:
``XLA_FLAGS=--xla_force_host_platform_device_count=8``), on seeded numpy
rows, and dumps every output; the port runs the same strategy bodies over
``InProcessAxes`` (the m workers stacked in one process) on the same rows.

Tolerances, stated where used:
- median: bitwise;
- trimmed mean: within 1 ulp of the reference (its jit multiplies by the
  reciprocal of m - 2·trim), and bitwise the port's plain selection
  network ``SN.trimmed_mean_select`` on the gathered rows;
- means (psum, chunked mean): 1e-6 relative + 1e-7 absolute (the
  packages add the workers in different orders);
- attacks: bitwise on the gathered / bucket rows, except where the payload
  is a sum over rows (ALIE's honest mean and variance) and under the
  row-free psum / chunked strategies: 1e-5 relative + 1e-6 absolute;
- chunked sketch: counts equal to the reference's ``hist_update`` of the
  same rows, the median within 2 ulp of the larger end of each
  coordinate's range of the reference's (the same bins; XLA contracts the
  bin centre to an FMA), the trimmed mean within one bin
  width of it, and both within one bin of the exact estimators.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import histogram_agg as RH
from repro_torch.core import distributed as D
from repro_torch.core.attacks import AttackConfig
from repro_torch.kernels import selection_network as SN
from repro_torch.rounds import distributed as RD
from repro_torch.rounds import compression as C

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 8
LEAF_SHAPES = [(37,), (3, 5)]
COALESCE_SHAPES = [(40,)] * 6 + [(300,), (30, 10)]
ATTACK_SHAPES = [(11,), (11,), (4, 3), (64,)]
MEAN_RTOL, MEAN_ATOL = 1e-6, 1e-7
COMP_KEY = 5

REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import distributed
from repro.core.attacks import AttackConfig
from repro.rounds import distributed as rd

data = dict(np.load(sys.argv[1]))
leaf = ["leaf_a", "leaf_b"]
coal = [f"coal_{i}" for i in range(8)]
atk_keys = [f"atk_{i}" for i in range(4)]

def one_mesh(jobs, keys, shape, axes):
    # every job of a mesh in ONE shard_map body: one compile
    def body(*args):
        local = {k: a[0] for k, a in zip(keys, args)}
        return {name: fn({k: local[k] for k in ks}) for name, ks, fn in jobs}
    mesh = jax.make_mesh(shape, axes)
    f = jax.shard_map(body, mesh=mesh, in_specs=tuple(P(axes) for _ in keys), out_specs=P(),
                      axis_names=set(axes), check_vma=False)
    res = jax.jit(f)(*[jnp.asarray(data[k]) for k in keys])
    return {f"{n}/{k}": np.asarray(v) for n, t in res.items() for k, v in t.items()}

jobs = []
for method in ("median", "trimmed_mean", "mean"):
    jobs.append((f"gather_{method}", leaf, lambda t, m=method: distributed.robust_gather_agg(
        t, ("data",), m, beta=0.25)))
    for gran in ("leaf", "flat"):
        jobs.append((f"bucketed_{gran}_{method}", leaf,
                     lambda t, m=method, g=gran: distributed.robust_bucketed_agg(
                         t, ("data",), m, beta=0.25, granularity=g)))
    jobs.append((f"chunked_{method}", ["g3"], lambda t, m=method: distributed.robust_chunked_agg(
        t, ("data",), m, beta=0.25, nbins=512, coord_chunk=16)))
jobs.append(("coalesced", coal, lambda t: distributed.robust_bucketed_agg(t, ("data",),
                                                                          "median")))
jobs.append(("psum", leaf, lambda t: distributed.robust_psum_agg(t, ("data",), "mean")))
jobs.append(("rs", ["leaf_a"], lambda t: {"leaf_a": jax.lax.all_gather(
    distributed.robust_reduce_scatter(t["leaf_a"], ("data",), "median"), "data")}))
for aname, kw in (("large_value", dict(scale=1e6)), ("sign_flip", dict(scale=5.0)),
                  ("alie", {}), ("mimic", {}), ("local_sign_flip", {})):
    atk = AttackConfig(aname, alpha=0.25, **kw)
    for strat in ("gather", "bucketed", "psum", "chunked"):
        if aname == "mimic" and strat in ("psum", "chunked"):
            continue
        method = "mean" if strat == "psum" else "median"
        jobs.append((f"attack_{aname}_{strat}", atk_keys,
                     lambda t, s=strat, a=atk, me=method: rd.aggregate_by_strategy(
                         t, ("data",), s, me, 0.25, a, attack_key=jax.random.PRNGKey(3))))
    jobs.append((f"attack_{aname}_gather_mean", atk_keys,
                 lambda t, a=atk: distributed.robust_gather_agg(t, ("data",), "mean",
                                                                attack=a)))
for comp in ("int8", "count_sketch"):
    for strat in ("gather", "bucketed"):
        jobs.append((f"comp_{comp}_{strat}", leaf,
                     lambda t, c=comp, s=strat: rd.aggregate_by_strategy(
                         t, ("data",), s, "median", compression=c,
                         comp_key=jax.random.PRNGKey(5))))
out = one_mesh(jobs, leaf + coal + atk_keys + ["g3"], (8,), ("data",))
out.update(one_mesh(
    [("multi_axis", ["g2"], lambda t: distributed.robust_bucketed_agg(t, ("pod", "data"),
                                                                      "median")),
     ("hierarchical", ["g2"], lambda t: distributed.robust_hierarchical_agg(
         t, "data", "pod", "median"))], ["g2"], (2, 4), ("pod", "data")))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _rows(seed, shape):
    return np.random.default_rng(seed).standard_normal((M,) + shape).astype(np.float32)


def _inputs():
    data = {"leaf_a": _rows(1, LEAF_SHAPES[0]), "leaf_b": _rows(2, LEAF_SHAPES[1]),
            "g2": _rows(3, (26,)), "g3": _rows(4, (100,))}
    for i, s in enumerate(COALESCE_SHAPES):
        data[f"coal_{i}"] = _rows(10 + i, s)
    for i, s in enumerate(ATTACK_SHAPES):
        data[f"atk_{i}"] = _rows(20 + i, s)
    return data


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, the reference's outputs), one subprocess for the module."""
    d = tmp_path_factory.mktemp("ref_distributed")
    data = _inputs()
    np.savez(d / "in.npz", **data)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return data, dict(np.load(d / "out.npz"))


def _ax():
    return D.InProcessAxes({"data": M}, "cpu")


def _tree(data, keys):
    return {k: torch.from_numpy(data[k]) for k in keys}


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32).ravel(), np.asarray(b, np.float32).ravel()
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _hold(got, want, method):
    if method == "median":
        assert _bits_equal(got, want)
    elif method == "trimmed_mean":
        assert _ulps(got, want) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=MEAN_RTOL, atol=MEAN_ATOL)


LEAF = ["leaf_a", "leaf_b"]


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "mean"])
@pytest.mark.parametrize("strategy", ["gather", "bucketed_leaf", "bucketed_flat"])
def test_exact_strategies_match_the_reference(ref, strategy, method):
    data, out = ref
    g = _tree(data, LEAF)
    if strategy == "gather":
        got = D.robust_gather_agg(g, _ax(), ("data",), method, beta=0.25)
    else:
        got = D.robust_bucketed_agg(g, _ax(), ("data",), method, beta=0.25,
                                    granularity=strategy.split("_")[1])
    for k in LEAF:
        assert got[k].shape == data[k].shape[1:]
        _hold(got[k].numpy(), out[f"{strategy}_{method}/{k}"], method)
        if method == "trimmed_mean":  # bitwise the plain selection network
            want = SN.trimmed_mean_select(torch.from_numpy(data[k]).reshape(M, -1), 2)
            assert _bits_equal(got[k].reshape(-1).numpy(), want.numpy())


def test_bucketed_leaf_coalescing_collective_count(ref):
    """8 leaves in 2 size bins: 2 all_to_all + 2 all_gather on the
    in-process axis (the reference counts them in the jaxpr), each leaf the
    reference's exact median."""
    data, out = ref
    ax = _ax()
    keys = [f"coal_{i}" for i in range(8)]
    got = D.robust_bucketed_agg(_tree(data, keys), ax, ("data",), "median")
    assert ax.calls["all_to_all"] == 2 and ax.calls["all_gather"] == 2, ax.calls
    for k in keys:
        assert _bits_equal(got[k].numpy(), out[f"coalesced/{k}"])
        np.testing.assert_allclose(got[k].numpy(), np.median(data[k], axis=0), rtol=1e-6)


def test_bucketed_leaf_coalescing_respects_size_cap():
    groups = D._coalesce_groups([torch.zeros(1000) for _ in range(5)], max_elems=2100)
    assert [len(g) for g in groups] == [2, 2, 1], groups
    assert sorted(i for g in groups for i in g) == list(range(5))
    mixed = [torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16)]
    assert len(D._coalesce_groups(mixed)) == 2


def test_bucketed_is_one_aggregation_of_the_stacked_rows(monkeypatch):
    """In-process, the all_to_all is a view: every group's buckets reach the
    aggregator in ONE aggregate_leaves call, as the worker-stacked (m, G)
    buffer itself (no copy)."""
    from repro_torch.core import aggregators

    seen = []
    real = aggregators.aggregate_leaves

    def spy(leaves, method, beta=0.1):
        seen.append([(x.shape, x.is_contiguous(), x.data_ptr()) for x in leaves])
        return real(leaves, method, beta)

    monkeypatch.setattr(aggregators, "aggregate_leaves", spy)
    g = {"w": torch.randn(M, 4096), "v": torch.randn(M, 40)}
    D.robust_bucketed_agg(g, _ax(), ("data",), "median")
    assert len(seen) == 1 and len(seen[0]) == 2
    big = [s for s in seen[0] if s[0][1:] == (M, 4096 // M)][0]
    assert big[1] and big[2] == g["w"].data_ptr()


def test_multi_axis_bucketed_is_the_global_median(ref):
    data, out = ref
    ax = D.InProcessAxes({"pod": 2, "data": 4}, "cpu")
    got = D.robust_bucketed_agg({"g2": torch.from_numpy(data["g2"]).reshape(2, 4, 26)}, ax,
                                ("pod", "data"), "median")["g2"]
    assert _bits_equal(got.numpy(), out["multi_axis/g2"])
    np.testing.assert_allclose(got.numpy(), np.median(data["g2"], axis=0), rtol=1e-6)


def test_hierarchical_median_of_medians(ref):
    data, out = ref
    ax = D.InProcessAxes({"pod": 2, "data": 4}, "cpu")
    got = D.robust_hierarchical_agg({"g2": torch.from_numpy(data["g2"]).reshape(2, 4, 26)}, ax,
                                    "data", "pod", "median")["g2"]
    assert _bits_equal(got.numpy(), out["hierarchical/g2"])
    g = data["g2"]
    want = np.median(np.stack([np.median(g[:4], 0), np.median(g[4:], 0)]), 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_reduce_scatter_leaves_each_worker_its_bucket(ref):
    data, out = ref
    got = D.robust_reduce_scatter(torch.from_numpy(data["leaf_a"]), _ax(), ("data",), "median")
    assert got.shape == (M, 5)  # ceil(37 / 8) a worker, varying
    assert _bits_equal(got.reshape(-1).numpy(), out["rs/leaf_a"].reshape(-1))


@pytest.mark.parametrize("method", ["median", "trimmed_mean", "mean"])
def test_chunked_sketch(ref, method):
    data, out = ref
    g = data["g3"]
    ax = _ax()
    got = D.robust_chunked_agg({"g3": torch.from_numpy(g)}, ax, ("data",), method, beta=0.25,
                               nbins=512, coord_chunk=16)["g3"].numpy()
    want_ref = out[f"chunked_{method}/g3"]
    if method == "mean":
        np.testing.assert_allclose(got, want_ref, rtol=MEAN_RTOL, atol=MEAN_ATOL)
        return
    assert ax.calls["psum"] == 7  # one per chunk of 16 of the 100 coordinates
    width = (g.max(0) - g.min(0)) / 512
    exact = np.median(g, 0) if method == "median" else np.sort(g, 0)[2:6].mean(0)
    assert (np.abs(got - exact) <= width + 1e-6).all()
    if method == "median":  # XLA contracts the bin centre lo + (b + 1/2)·w to an FMA
        end = np.maximum(np.abs(g.min(0)), np.abs(g.max(0)))
        assert (np.abs(got - want_ref) <= 2 * np.spacing(end)).all()
    else:
        assert (np.abs(got - want_ref) <= width).all()


def test_chunked_counts_equal_the_reference_sketch(ref):
    """One psum_histogram over the 8 stacked rows == the reference's
    hist_update of the same rows (its psum of per-worker one-hots)."""
    data, _ = ref
    g = data["g3"]
    ax = _ax()
    x = torch.from_numpy(g)
    lo, hi = ax.pminmax(x, ("data",))
    assert _bits_equal(lo.numpy(), g.min(0)) and _bits_equal(hi.numpy(), g.max(0))
    lo_, width = lo, (hi - lo) / 256
    counts, sums = ax.psum_histogram(x, lo_, width, 256, True, ("data",))
    rc, rs = RH.hist_update(*RH.hist_init(100, 256, with_sums=True), jnp.asarray(g),
                            jnp.asarray(lo_.numpy()), jnp.asarray(width.numpy()))
    assert np.array_equal(counts.numpy(), np.asarray(rc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(rs), rtol=MEAN_RTOL, atol=1e-6)


def test_psum_mean_and_its_rejection_of_order_statistics(ref):
    data, out = ref
    got = D.robust_psum_agg(_tree(data, LEAF), _ax(), ("data",), "mean")
    for k in LEAF:
        np.testing.assert_allclose(got[k].numpy(), out[f"psum/{k}"], rtol=MEAN_RTOL,
                                   atol=MEAN_ATOL)
        np.testing.assert_allclose(got[k].numpy(), data[k].mean(0), rtol=1e-6, atol=1e-7)
    for method in ("median", "trimmed_mean"):
        with pytest.raises(ValueError, match="plain data-parallel mean"):
            D.robust_psum_agg(_tree(data, LEAF), _ax(), ("data",), method)
        with pytest.raises(ValueError, match="plain data-parallel mean"):
            RD.aggregate_by_strategy(_tree(data, LEAF), _ax(), ("data",), "psum", method)


ATTACKS = (("large_value", dict(scale=1e6)), ("sign_flip", dict(scale=5.0)), ("alie", {}),
           ("mimic", {}), ("local_sign_flip", {}))


@pytest.mark.parametrize("strategy", ["gather", "bucketed", "psum", "chunked"])
@pytest.mark.parametrize("attack", [a for a, _ in ATTACKS])
def test_attack_applied_at_aggregation(ref, attack, strategy):
    """Each attack where the reference applies it: on the gathered rows
    (gather), on each worker's bucket rows (bucketed) or on the Byzantine
    workers' own rows before the psum (psum, chunked)."""
    data, out = ref
    if attack == "mimic" and strategy in ("psum", "chunked"):
        with pytest.raises(ValueError, match="omniscient"):
            from repro_torch.rounds import comm
            comm.validate_attack_strategy(AttackConfig("mimic", 0.25), strategy)
        return
    keys = [f"atk_{i}" for i in range(4)]
    atk = AttackConfig(attack, alpha=0.25, **dict(ATTACKS)[attack])
    method = "mean" if strategy == "psum" else "median"
    got = RD.aggregate_by_strategy(_tree(data, keys), _ax(), ("data",), strategy, method, 0.25,
                                   atk, attack_key=3)
    for k in keys:
        want = out[f"attack_{attack}_{strategy}/{k}"]
        if strategy in ("psum", "chunked") or attack == "alie":
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-5, atol=1e-6)
        else:
            assert _bits_equal(got[k].numpy(), want), (attack, strategy, k)


@pytest.mark.parametrize("attack", ["large_value", "sign_flip", "alie"])
def test_attack_breaks_the_gathered_mean_not_the_median(ref, attack):
    data, out = ref
    keys = [f"atk_{i}" for i in range(4)]
    atk = AttackConfig(attack, alpha=0.25, **dict(ATTACKS)[attack])
    got = D.robust_gather_agg(_tree(data, keys), _ax(), ("data",), "mean", attack=atk)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), out[f"attack_{attack}_gather_mean/{k}"],
                                   rtol=1e-5, atol=1e-6)
    ones = {"w": torch.ones(M, 16)}
    lv = AttackConfig("large_value", alpha=0.25, scale=1e6)
    assert torch.all((D.robust_gather_agg(ones, _ax(), ("data",), "median", attack=lv)["w"]
                      - 1).abs() < 1e-5)
    assert torch.all(D.robust_gather_agg(ones, _ax(), ("data",), "mean", attack=lv)["w"] > 1e4)


def _int8_draw(key, d):
    return torch.from_numpy(np.array(jax.random.uniform(key, C.int8_draw_shape(d))))


def _sketch_draw(key, d):
    kh, ks = jax.random.split(key)
    w = C._sketch_w(d, 0.5)
    return (torch.from_numpy(np.array(jax.random.randint(kh, (d,), 0, w))),
            torch.from_numpy(np.array(jax.random.bernoulli(ks, 0.5, (d,))
                                      .astype(jnp.float32) * 2 - 1)))


@pytest.mark.parametrize("strategy", ["gather", "bucketed"])
@pytest.mark.parametrize("codec", ["int8", "count_sketch"])
def test_aggregate_by_strategy_with_codecs(ref, codec, strategy):
    """Each worker's tree through the codec as one message, the reference's
    draws injected: int8 per worker (the key folded with the worker index),
    count_sketch one shared map; then the strategy's median, bitwise."""
    data, out = ref
    d = sum(int(np.prod(s)) for s in LEAF_SHAPES)
    key = jax.random.PRNGKey(COMP_KEY)
    if codec == "int8":
        draw = lambda w: _int8_draw(jax.random.fold_in(key, w), d)  # noqa: E731
    else:
        draw = lambda w: _sketch_draw(key, d)  # noqa: E731
    got = RD.aggregate_by_strategy(_tree(data, LEAF), _ax(), ("data",), strategy, "median",
                                   compression=codec, comp_draw=draw)
    for k in LEAF:
        assert _bits_equal(got[k].numpy(), out[f"comp_{codec}_{strategy}/{k}"]), (codec, k)


def test_stateless_dispatch_rejects_error_feedback_and_unknown_strategies(ref):
    data, _ = ref
    with pytest.raises(ValueError, match="error-feedback"):
        RD.aggregate_by_strategy(_tree(data, LEAF), _ax(), ("data",), "gather",
                                 compression="topk")
    with pytest.raises(ValueError, match="unknown agg strategy"):
        RD.aggregate_by_strategy(_tree(data, LEAF), _ax(), ("data",), "rs")
    with pytest.raises(ValueError, match="two worker axes"):
        RD.aggregate_by_strategy(_tree(data, LEAF), _ax(), ("data",), "hierarchical")


def test_in_process_collectives_are_views_and_transposes():
    ax = D.InProcessAxes({"pod": 2, "data": 3}, "cpu")
    x = torch.arange(2 * 3 * 6 * 4, dtype=torch.float32).reshape(2, 3, 6, 4)
    g = ax.all_gather(x, ("pod", "data"))
    assert g.shape == (6, 6, 4) and g.data_ptr() == x.data_ptr()
    inner = ax.all_gather(x, ("data",))  # still varying over pod
    assert inner.shape == (2, 3, 6, 4) and ax.outer(("data",)) == ("pod",)
    y = ax.all_to_all(x, "data", 0, ("pod", "data"))  # local dim 0: 6 = 3 chunks of 2
    for p, j, i in np.ndindex(2, 3, 3):
        assert torch.equal(y[p, j, 2 * i:2 * i + 2], x[p, i, 2 * j:2 * j + 2])
    assert torch.equal(ax.index(("pod", "data")), torch.arange(6).reshape(2, 3))
    assert torch.equal(ax.index(("data",)), torch.arange(3).expand(2, 3))
    assert torch.equal(ax.psum(x, ("pod", "data")), x.reshape(6, 6, 4).sum(0))
    with pytest.raises(ValueError, match="does not vary"):
        ax.psum(torch.zeros(3, 4), ("pod", "data"))
