"""The port's communication accounting (``rounds.comm``), the nearest-rank
coordinate quantile and the attack-schedule helper against the JAX
reference, on the same inputs (CPU).

Tolerances: byte counts, registry fields, reports and schedules are
equal; the quantile is a sorted value, so it is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.attacks import schedule as jschedule
from repro.core import aggregators as JA
from repro.core.attacks import AttackConfig as JAttackConfig
from repro.rounds import comm as jcomm
from repro_torch.attacks import schedule
from repro_torch.core import aggregators as A
from repro_torch.core.attacks import AttackConfig
from repro_torch.rounds import CommBudget, comm

torch.set_num_threads(2)

COMPRESSIONS = ("none", "int8", "topk", "count_sketch")


def test_registry_order_and_fields_match():
    assert comm.registered_strategies() == jcomm.registered_strategies()
    for name in jcomm.registered_strategies():
        a, j = comm.get_strategy_spec(name), jcomm.get_strategy_spec(name)
        assert (a.exact, a.max_access, a.bytes_formula, a.summary) == \
            (j.exact, j.max_access, j.bytes_formula, j.summary)
    with pytest.raises(ValueError, match="unknown strategy"):
        comm.get_strategy_spec("nope")
    with pytest.raises(ValueError, match="already registered"):
        comm.register_strategy(comm.get_strategy_spec("gather"))


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("d,m,b,nbins", [(1000, 16, 4, 256), (53370, 10, 2, 512),
                                         (7, 100_000, 4, 64), (256, 12, 8, 2)])
def test_byte_formulas_match_reference(d, m, b, nbins, compression):
    for name in jcomm.registered_strategies():
        got = comm.get_strategy_spec(name).bytes_per_round(d, m, b, nbins, compression)
        want = jcomm.get_strategy_spec(name).bytes_per_round(d, m, b, nbins, compression)
        assert got == want, (name, got, want)


def test_byte_formulas_closed_forms():
    d, m, b = 1000, 16, 4
    per = {s: comm.get_strategy_spec(s).bytes_per_round(d, m, b)
           for s in comm.registered_strategies()}
    assert per["gather"] == m * d * b
    assert per["bucketed"] == 2 * d * b
    assert per["rs"] == d * b
    assert per["chunked"] == (2 + 2 * 256) * d * b
    spec = comm.get_strategy_spec("chunked")
    assert spec.bytes_per_round(1000, 8, 4) == spec.bytes_per_round(1000, 10 ** 5, 4)
    for m in (1, 2, 12, 16, 17, 64, 100, 10 ** 5):
        assert comm._hier_split(m) == jcomm._hier_split(m)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_budget_matches_reference(compression):
    kw = dict(strategy="hierarchical", num_params=4096, m=12, dtype_bytes=2, nbins=128,
              compression=compression)
    got, want = CommBudget(**kw), jcomm.CommBudget(**kw)
    for b in (got, want):
        b.charge(10)
        b.charge()
    assert got.rounds == 11 and got.total_bytes == 11 * got.bytes_per_round
    assert got.report() == want.report()
    with pytest.raises(ValueError):
        got.charge(-1)


def test_attack_strategy_validation_matches_reference():
    cases = [(AttackConfig("mimic", alpha=0.1), JAttackConfig("mimic", alpha=0.1), "chunked"),
             (AttackConfig("max_damage_tm", alpha=0.1),
              JAttackConfig("max_damage_tm", alpha=0.1), "psum"),
             (AttackConfig("alie", alpha=0.1), JAttackConfig("alie", alpha=0.1), "chunked"),
             (AttackConfig("label_flip", alpha=0.1), JAttackConfig("label_flip", alpha=0.1),
              "chunked"),
             (AttackConfig("mimic", alpha=0.1), JAttackConfig("mimic", alpha=0.1), "gather"),
             (None, None, "chunked"), (AttackConfig("none"), JAttackConfig("none"), "chunked"),
             ("mimic", "mimic", "psum")]
    for ours, theirs, strategy in cases:
        try:
            jcomm.validate_attack_strategy(theirs, strategy)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            comm.validate_attack_strategy(ours, strategy)
        else:
            with pytest.raises(ValueError) as err:
                comm.validate_attack_strategy(ours, strategy)
            assert str(err.value) == want
    spec, alpha, strength = comm.resolve_attack(AttackConfig("sign_flip", alpha=0.25, scale=7.0))
    assert spec.name == "sign_flip" and alpha == 0.25 and strength == 7.0


@pytest.mark.parametrize("m", [1, 2, 7, 10, 64, 65, 200])
def test_coordinate_quantile_bitwise(m):
    x = np.random.default_rng(m).standard_normal((m, 5, 3)).astype(np.float32)
    for q in (0.0, 0.1, 0.25, 0.5, 0.625, 0.9, 1.0):
        got = A.coordinate_quantile(torch.from_numpy(x), q).numpy()
        want = np.asarray(JA.coordinate_quantile(jnp.asarray(x), q))
        assert got.shape == want.shape == (5, 3)
        assert np.array_equal(got, want), (m, q)
    with pytest.raises(ValueError):
        A.coordinate_quantile(torch.from_numpy(x), 1.5)


@pytest.mark.parametrize("schedule_name", ["fixed", "cycle", "greedy"])
@pytest.mark.parametrize("damages", [None, [0.0, 2.0, 1.0], [5.0, -1.0, 5.0]])
def test_schedule_indices_match_reference(schedule_name, damages):
    for rounds in (1, 7, 40):
        assert schedule.schedule_indices(schedule_name, 3, rounds, damages) == \
            jschedule.schedule_indices(schedule_name, 3, rounds, damages)
    with pytest.raises(ValueError):
        schedule.schedule_indices("nope", 3, 4)
