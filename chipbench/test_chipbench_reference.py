"""The benchmark's yardstick on the CPU at smoke sizes: each
configuration's plain reference module against the port (model loss and
gradients, the attack, the aggregators, AdamW), the FLOP and byte counts
against a hand count, and the token generator against the rule it
copies."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from chipbench import bench, generate, yardstick
from chipbench.kinds import port_config
from chipbench.reference import model as M
from chipbench.reference import robust
from chipbench.reference import train as reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "chipbench" / "configs").glob("*.json"))


def smoke_model(path: Path) -> tuple:
    """(the configuration's reference module, its port group at its smoke
    sizes in float32)."""
    cfg = json.loads(path.read_text())
    ref = bench.reference_module(ROOT, cfg.get("reference", bench.DEFAULT_REFERENCE))
    return ref, dict(cfg["port"], **cfg["smoke"], dtype="float32")


def nested(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return out


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.stem)
def test_reference_loss_and_gradients_match_the_port(config):
    from repro_torch.models import transformer as T

    ref, model = smoke_model(config)
    cfg = port_config(model)
    weights = {p: generate.make_leaf(ref, model, 11, p, "cpu") for p in ref.param_specs(model)}
    tokens = torch.randint(0, model["vocab"], (2, 24), generator=torch.Generator().manual_seed(1))
    labels = torch.roll(tokens, -1, 1)
    port = {p: t.clone().requires_grad_() for p, t in weights.items()}
    want = T.loss_fn(nested(port), {"tokens": tokens, "labels": labels}, cfg, remat=False)
    want_g = torch.autograd.grad(want, list(port.values()))
    leaves = reference._split(weights)
    got = ref.loss(leaves, tokens, labels, model, ref.matmul)
    flat = [t for p in weights for t in leaves[p]]
    got_g = iter(torch.autograd.grad(got, flat))
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    for (p, t), g in zip(weights.items(), want_g):
        mine = torch.stack([next(got_g) for _ in leaves[p]]) if p.startswith("blocks/") \
            else next(got_g)
        assert mine.shape == t.shape
        assert float((mine - g).norm()) <= 1e-4 * float(g.norm()) + 1e-7, p


def test_attack_and_aggregators_match_the_port():
    from repro_torch.attacks import engine
    from repro_torch.core import aggregators
    from repro_torch.core.attacks import AttackConfig

    rows = torch.randn(8, 1000, generator=torch.Generator().manual_seed(3))
    atk = AttackConfig(name="alie", alpha=0.25, shift=1.0)
    spec, strength = atk.resolve()
    want = engine.apply_to_rows(spec, rows, atk.byzantine_mask(8, device="cpu"),
                                strength=strength)
    got = robust.alie(rows.clone(), reference.num_byzantine(0.25, 8), 1.0)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(robust.median(got), aggregators.aggregate_leaves([got], "median")[0])
    tm = aggregators.aggregate_leaves([got], "trimmed_mean", 0.25)[0]
    assert torch.allclose(robust.trimmed_mean(got, 2), tm, rtol=1e-6, atol=1e-7)


def test_adamw_matches_the_port():
    from repro_torch.optim.optimizers import adamw

    gen = torch.Generator().manual_seed(4)
    p, opt = torch.randn(500, generator=gen), adamw(1e-2, weight_decay=0.1)
    state, mine = opt.init(p), p.clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    cfg = {"lr": 1e-2, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.1}
    for step in range(3):
        g = torch.randn(500, generator=gen)
        p, state = opt.update(g, state, p, step)
        robust.adamw(mine, g, m, v, step, cfg)
    assert torch.allclose(mine, p, rtol=1e-6, atol=1e-6)  # a few ulps of the O(1) values


def test_flop_and_byte_counts_by_hand():
    dense = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
             "d_ff": 16, "vocab": 10, "dtype": "bfloat16", "sliding_window": 3}
    traffic = {"workers": 3, "batch_per_worker": 2, "seq_len": 5}
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; ffn 3*8*16 = 384; head 8x10
    assert M.matmul_params_per_token(dense) == 2 * (192 + 384) + 80
    # causal pairs within a window of 3 over 5 tokens: 1 + 2 + 3 + 3 + 3
    assert M.attention_pairs(5, 3) == 12 and M.attention_pairs(5, 0) == 15
    flops = 6 * (6.0 * 1232 * 5 + 12 * 12 * 4 * 2 * 2)
    assert M.model_flops_per_step(dense, traffic) == flops
    moe = dict(dense, family="moe", moe={"num_experts": 4, "top_k": 2, "d_expert": 6})
    # router 8x4 and 2 of 4 experts of 3*8*6 each, in place of the ffn
    assert M.matmul_params_per_token(moe) == 2 * (192 + 32 + 288) + 80
    # params: layers (ln1, ln2 8 each, attention 192, ffn 384), embed and head 80 each, norm 8
    assert yardstick.param_count(M, dense) == 2 * (16 + 192 + 384) + 80 + 80 + 8
    assert yardstick.aggregate_bytes_per_step(M, dense, traffic) == 4 * 1352 * 2


def test_token_streams_follow_the_rule():
    data = {"mult": 5, "add": 7, "keep": 0.9}
    s = generate.token_streams(2 ** 31 + 9, 6, 400, 97, data, "cpu")
    assert s.shape == (6, 401) and int(s.min()) >= 0 and int(s.max()) < 97
    follows = (s[:, 1:] == (5 * s[:, :-1] + 7) % 97).float().mean()
    assert 0.85 < float(follows) < 0.95
    again = generate.token_streams(2 ** 31 + 9, 6, 400, 97, data, "cpu")
    assert torch.equal(s, again)


def test_weights_are_the_seeds():
    ref, model = smoke_model(CONFIGS[0])
    a = generate.make_leaf(ref, model, 7, "embed", "cpu")
    assert torch.equal(a, generate.make_leaf(ref, model, 7, "embed", "cpu"))
    assert not torch.equal(a, generate.make_leaf(ref, model, 8, "embed", "cpu"))
    assert math.isclose(float(a.std()), 0.02, rel_tol=0.1)
