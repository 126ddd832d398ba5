"""The port's cost analysis (``repro_torch.launch.cost_analysis``) and H100
roofline (``repro_torch.launch.roofline``) against programs of known cost:
the counterparts of tests/test_hlo_analysis.py, and the smoke llama3.2-3b
forward's FLOPs against the reference's ``hlo_analysis.analyze`` of its
jitted single-device forward.

Tolerances: counts of hand-built programs exact; the smoke forward's
FLOPs within 1 % of the reference's (both count 2·M·N·K per matmul; the
reference's HLO may fuse or drop a product XLA folds away).

Serial time about 20 s (one subprocess under a fake group of 8 ranks,
one jit of the reference's smoke forward).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import hlo_analysis
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.kernels import robust_agg
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import roofline
from repro_torch.models import convert
from repro_torch.models import transformer as T

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layers(L, n=128, remat=False, grad=False):
    """tanh(x @ w_l) over L layers, summed; its FLOPs counted."""
    w = torch.zeros((L, n, n), requires_grad=grad)
    x = torch.ones((4, n), requires_grad=grad)

    def run():
        h = x
        for layer in range(L):
            def body(h, wl=w[layer]):
                return torch.tanh(h @ wl)

            h = checkpoint(body, h, use_reentrant=False) if remat else body(h)
        loss = (h ** 2).sum()
        if grad:
            loss.backward()
        return loss

    return CA.analyze(run)


def test_plain_matmul_flops_exact():
    r = CA.analyze(lambda: torch.ones((8, 64)) @ torch.ones((64, 32)))
    assert r["flops"] == 2 * 8 * 64 * 32
    assert r["flops_by_dtype"] == {"float32": 2 * 8 * 64 * 32}


@pytest.mark.parametrize("L", [2, 8, 126])
def test_flops_scale_linearly_with_layers(L):
    assert _layers(L)["flops"] == 2 * 4 * 128 * 128 * L


def test_remat_counts_the_recomputed_forward():
    """A backward counts dgrad and wgrad; under checkpointing the forward is
    recomputed too: 4 matmuls a layer against 3."""
    L, n = 8, 64
    one = 2 * 4 * n * n
    assert _layers(L, n, grad=True)["flops"] == 3 * one * L
    assert _layers(L, n, remat=True, grad=True)["flops"] == 4 * one * L


def test_views_move_no_bytes_and_peak_tracks_frees():
    """A view counts nothing; an op its operands and result; a freed result
    leaves the live bytes (each storage rounded up to 512 bytes)."""
    x = torch.ones(1024)
    with CA.CostMode() as mode:
        v = x.view(32, 32).t()
        assert mode.bytes == 0
        y = x * 2  # 4 KB read, 4 KB written
        assert mode.bytes == 2 * 4096 and mode.live == 4096
        del y
        z = torch.empty(100)  # 400 B -> 512
    assert mode.live == 512 and mode.peak == 4096
    del v, z


def test_kernel_op_counts_its_bytes_and_launch_on_fake_tensors():
    """A B1 launch on an (m, n) leaf counts (m + 1)·n·itemsize bytes and one
    launch (fake CUDA tensors and meta stand-ins alike); nothing is built."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    m, n = 16, 1000
    libs = robust_agg.select_libraries()
    for make in (lambda: torch.empty(m, n, dtype=torch.bfloat16, device="meta"),):
        with CA.CostMode() as mode:
            out = robust_agg.median_many([make()])
        assert out[0].shape == (n,) and out[0].dtype == torch.bfloat16
        assert mode.bytes == (m + 1) * n * 2
        assert dict(mode.kernel_launches) == {"median": 1}
    with FakeTensorMode():
        x = torch.empty(m, n, device="cuda")
        with CA.CostMode() as mode:
            (med,), (tm,) = robust_agg.fused_median_trimmed_many([x], 2)
    assert med.shape == tm.shape == (n,)
    assert dict(mode.kernel_launches) == {"fused_median_trimmed": 1}
    assert robust_agg.select_libraries() == libs and robust_agg.LAUNCHES["median"] == 0


ALL_GATHER = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import cost_analysis as CA
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.new_group(list(range(8)))
with CA.CostMode({g.group_name: "data"}) as mode:
    x = torch.ones(4, 128, device="meta")
    out = torch.empty(8 * 512, device="meta")
    dist.all_gather_into_tensor(out, x.reshape(-1), group=g)
    dist.all_reduce(x, group=g)
r = mode.result()
assert r["collectives"]["all-gather"] == 8 * 4 * 128 * 4, r
assert r["collectives_by_axis"] == {"data": {"all-gather": 8 * 4 * 128 * 4,
                                             "all-reduce": 4 * 128 * 4}}, r
assert r["collective_bytes"] == 8 * 4 * 128 * 4 + 2 * 4 * 128 * 4, r
print("OK")
"""


def test_known_all_gather_bytes_under_a_fake_group():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(ALL_GATHER)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_roofline_terms():
    t = roofline.roofline_terms(flops=989e12, hbm_bytes=0, coll_bytes=0)
    assert t["compute_s"] == pytest.approx(1.0) and t["dominant"] == "compute"
    t = roofline.roofline_terms(flops={"float32": 67e12, "bfloat16": 989e12}, hbm_bytes=0,
                                coll_bytes=0)
    assert t["compute_s"] == pytest.approx(2.0)
    t = roofline.roofline_terms(flops=0, hbm_bytes=3.35e12, coll_bytes=0)
    assert t["memory_s"] == pytest.approx(1.0) and t["dominant"] == "memory"
    t = roofline.roofline_terms(flops=0, hbm_bytes=0, coll_bytes=50e9)
    assert t["collective_s"] == pytest.approx(1.0) and t["dominant"] == "collective"
    t = roofline.roofline_terms(0, 0, {"model": 450e9, "data": 50e9},
                                links={"model": 450e9, "data": 50e9})
    assert t["collective_s"] == pytest.approx(2.0) and t["bound_s"] == t["collective_s"]


def test_axis_links_follow_the_hosts():
    """8 consecutive ranks a host: a model axis of 2 (or data 4 × model 2)
    stays inside one; the production meshes' axes of 16 cross hosts."""
    assert roofline.axis_links({"data": 4, "model": 2}) == {
        "data": 450e9, "model": 450e9, "data+model": 450e9}
    links = roofline.axis_links({"data": 16, "model": 16})
    assert links == {"data": 50e9, "model": 50e9, "data+model": 50e9}
    assert roofline.axis_links({"data": 16, "model": 4})["model"] == 450e9
    assert roofline.axis_ranks({"data": 4, "model": 2}, ("data",), 1) == [1, 3, 5, 7]


def test_model_flops():
    assert roofline.model_flops(1e9, 1000, "train") == 6e12
    assert roofline.model_flops(1e9, 1000, "decode") == 2e12
    assert roofline.format_seconds(2e-6) == "2.0us"


def test_smoke_llama_forward_flops_match_hlo_analysis():
    """The smoke llama3.2-3b forward at B = 2, S = 16 (S <= kv_block, plain
    attention in both): the port's counted FLOPs within 1 % of the
    reference's hlo_analysis of the jitted single-device forward."""
    rc, pc = ref_get_smoke_config("llama3.2-3b"), configs.get_smoke_config("llama3.2-3b")
    rp = RT.init_params(rc, jax.random.PRNGKey(0))
    pp = convert.transformer_from_reference(pc, jax.tree.map(np.asarray, rp), device="cpu")
    tokens = np.random.default_rng(0).integers(0, pc.vocab, (2, 16)).astype(np.int32)
    compiled = jax.jit(lambda p, t: RT.forward(p, t, rc)[0]).lower(
        rp, jnp.asarray(tokens)).compile()
    want = hlo_analysis.analyze(compiled.as_text())["flops"]
    with torch.no_grad():
        got = CA.analyze(T.forward, pp, torch.as_tensor(tokens, dtype=torch.int64), pc)["flops"]
    assert want > 0 and abs(got - want) <= 0.01 * want, (got, want)
