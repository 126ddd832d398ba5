"""Staleness policies of the port (repro_torch.fed.staleness) against the
reference (repro.fed.staleness).

Both are host numpy, so every policy is held bitwise
(``np.array_equal`` on keep-masks and weights, ``==`` on beta_eff) on
seeded staleness vectors, with the registry's contract tests mirrored from
tests/test_async_rounds.py."""
import numpy as np
import pytest
import torch

from repro.fed import staleness as J
from repro_torch.fed import staleness as S

torch.set_num_threads(2)


def _vectors():
    rng = np.random.default_rng(0)
    return {
        "all_fresh": np.zeros(24, np.int64),
        "all_late": rng.integers(1, 6, 24),
        "mixed": rng.integers(0, 6, 40),
        "one_row": np.asarray([3]),
        "beyond_cap": np.asarray([5, 6, 7]),
    }


OVERRIDES = [dict(), dict(knob=1.0), dict(knob=0.25, cap=1), dict(cap=4, beta=0.3),
             dict(beta=0.0)]


def test_registry_order_matches_reference():
    assert S.registered_policies() == J.registered_policies() == (
        "none", "damped", "trim_late", "drop")
    for name in S.registered_policies():
        a, b = S.get_policy(name), J.get_policy(name)
        assert (a.extra_trim, a.drops_late, a.knob, a.cap, a.summary) == \
            (b.extra_trim, b.drops_late, b.knob, b.cap, b.summary)


@pytest.mark.parametrize("name", J.registered_policies())
@pytest.mark.parametrize("vec", list(_vectors()))
@pytest.mark.parametrize("kw", OVERRIDES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()) or "defaults")
def test_apply_policy_bitwise_reference(name, vec, kw):
    s = _vectors()[vec]
    keep, w, beta = S.apply_policy(name, s, **kw)
    jkeep, jw, jbeta = J.apply_policy(name, s, **kw)
    assert np.array_equal(keep, jkeep)
    assert w.dtype == jw.dtype and np.array_equal(w, jw)
    assert beta == jbeta


@pytest.mark.parametrize("name", S.registered_policies())
def test_identity_at_zero_staleness(name):
    keep, w, beta_eff = S.apply_policy(name, np.zeros(16, np.int64), beta=0.1)
    assert keep.all()
    np.testing.assert_array_equal(w, np.ones(16))
    assert beta_eff == 0.1


@pytest.mark.parametrize("name", S.registered_policies())
def test_weights_monotone_in_unit_interval(name):
    w = S.get_policy(name).weight(np.arange(0, 10))
    assert (w >= 0).all() and (w <= 1).all() and w[0] == 1.0
    assert (np.diff(w) <= 1e-12).all()


def test_policy_semantics():
    np.testing.assert_allclose(S.get_policy("damped").weight([3], knob=0.5), [0.5])
    assert S.apply_policy("drop", np.asarray([5, 6, 7]), cap=2)[0].tolist() == [
        True, False, False]  # the freshest survives
    assert S.apply_policy("drop", np.arange(5), cap=2)[0].tolist() == [
        True, True, True, False, False]
    assert S.apply_policy("trim_late", np.asarray([0, 0, 1, 1]), beta=0.1)[2] == 0.45
    assert S.apply_policy("trim_late", np.asarray([0, 0, 0, 1]), beta=0.1)[2] == \
        pytest.approx(0.35)


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        S.register_policy(S.get_policy("none"))
    with pytest.raises(ValueError, match="unknown staleness policy"):
        S.get_policy("no_such_policy")
