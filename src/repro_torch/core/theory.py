"""Statistical-rate formulas from the paper, used to validate experiments.

A copy of the reference's pure-``math`` module (the port imports nothing
of the reference); tests hold the two equal value for value.

Implements:
- ``c_eps``      — C_ε of eq. (4);
- ``delta_median``   — Δ of eq. (3) (median GD, Theorem 1);
- ``delta_trimmed``  — Δ' of eq. (5) (trimmed-mean GD, Theorem 4);
- ``lower_bound``    — Observation 1's Ω(α/√n + √(d/nm));
- ``median_condition`` — feasibility condition eq. (2);
- helpers for fitting empirical error curves against the predicted
  scalings (log-log slope fits used by the rate benchmarks).
"""
from __future__ import annotations

import math


def _phi_inv(p: float) -> float:
    """Inverse standard normal CDF (Acklam's rational approximation).

    Acklam's approximation: |relative error| < 1.15e-9, far below anything
    the rate checks need, with no dependency beyond ``math``.
    """
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def c_eps(eps: float) -> float:
    """C_ε = √(2π) · exp(Φ⁻¹(1-ε)² / 2)  (paper eq. 4). C_{1/6} ≈ 4."""
    z = _phi_inv(1.0 - eps)
    return math.sqrt(2.0 * math.pi) * math.exp(0.5 * z * z)


BERRY_ESSEEN = 0.4748  # Shevtsova (2014) constant used throughout the paper


def median_condition(alpha: float, n: int, m: int, d: int, S: float,
                     LhatD: float = 1.0) -> float:
    """LHS of eq. (2): α + √(d·log(1+nm·L̂D)/(m(1-α))) + 0.4748·S/√n.

    Feasible (for some ε>0) iff the returned value < 1/2.
    """
    log_term = math.log(1.0 + n * m * LhatD)
    return alpha + math.sqrt(d * log_term / (m * (1.0 - alpha))) + BERRY_ESSEEN * S / math.sqrt(n)


def delta_median(alpha: float, n: int, m: int, d: int, V: float, S: float,
                 eps: float = 1.0 / 6.0, LhatD: float = 1.0) -> float:
    """Δ of eq. (3) for median GD (up to the hidden universal constant):

        C_ε · V · ( α/√n + √(d·log(nm·L̂D)/(nm)) + S/n )
    """
    log_term = math.log(max(math.e, n * m * LhatD))
    return c_eps(eps) * V * (
        alpha / math.sqrt(n)
        + math.sqrt(d * log_term / (n * m))
        + S / n
    )


def delta_trimmed(beta: float, n: int, m: int, d: int, v: float,
                  eps: float = 1.0 / 6.0, LhatD: float = 1.0) -> float:
    """Δ' of eq. (5) for trimmed-mean GD (up to universal constants):

        (v·d/ε) · ( β/√n + 1/√(nm) ) · √log(nm·L̂D)
    """
    log_term = math.log(max(math.e, n * m * LhatD))
    return (v * d / eps) * (beta / math.sqrt(n) + 1.0 / math.sqrt(n * m)) * math.sqrt(log_term)


def lower_bound(alpha: float, n: int, m: int, d: int, sigma: float = 1.0) -> float:
    """Observation 1: Ω(α/√n + √(d/(nm))) for mean estimation."""
    return sigma * (alpha / math.sqrt(n) + math.sqrt(d / (n * m)))


def optimal_rate(alpha: float, n: int, m: int) -> float:
    """The target order-optimal rate α/√n + 1/√(nm) (constants dropped)."""
    return alpha / math.sqrt(n) + 1.0 / math.sqrt(n * m)


def median_rate(alpha: float, n: int, m: int) -> float:
    """Median-GD rate α/√n + 1/√(nm) + 1/n (constants dropped)."""
    return optimal_rate(alpha, n, m) + 1.0 / n


def one_round_rate(alpha: float, n: int, m: int) -> float:
    """Theorem 7: the one-round algorithm's Õ(α/√n + 1/√(nm) + 1/n) rate
    for strongly convex quadratic losses (constants and log factors
    dropped) — the same order as median GD (eq. 3), achieved with ONE
    communication round.  Gates the one-round cells of the comm-
    efficiency grid (benchmarks/comm_efficiency.py) and the Theorem 7
    rate checks in tests/test_rounds.py."""
    return median_rate(alpha, n, m)  # same order; distinct name for callers


# --------------------------------------------------- buffered async rounds
#
# A buffered round (fed/async_rounds.py) aggregates only the first k of
# m arrivals.  An adversary that controls arrival TIMING (the paper's
# arbitrary-behaviour model extended to the timing channel) packs every
# Byzantine report it can into the buffer, so the k aggregated rows see
# a CONCENTRATED Byzantine fraction alpha_eff = q_buf/k >= alpha, while
# the statistical averaging only benefits from the honest rows that made
# it in.  The async rates are therefore the synchronous formulas
# evaluated at (alpha_eff, m_eff = honest-in-buffer count) — the
# "effective-m correction" the async matrix cells and the throughput
# benchmark gate against.


def buffer_byzantine(alpha: float, m: int, k: int) -> int:
    """Worst-case Byzantine arrivals inside a k-of-m buffer.

    With q = ceil(alpha*m) Byzantine clients in the cohort all timing
    their reports to land first, min(k, q) of the k buffered rows are
    Byzantine (q is capped at m-1 exactly like engine.num_byzantine)."""
    if not 1 <= k <= m:
        raise ValueError(f"need 1 <= k <= m, got k={k}, m={m}")
    q = min(m - 1, math.ceil(alpha * m)) if alpha > 0 else 0
    return min(k, q)


def effective_buffer(alpha: float, m: int, k: int,
                     dropout: float = 0.0) -> tuple:
    """(k_actual, alpha_eff) of a k-of-m buffer under adversarial timing.

    ``dropout`` is the honest dropout rate: of the m - q honest clients,
    round((m-q)*(1-dropout)) are available; the buffer fills with all
    q_buf Byzantine rows plus however many honest rows remain, so it may
    close UNDER-FULL (k_actual < k) — the timeout path of the engine.
    alpha_eff = q_buf / k_actual is the Byzantine fraction the robust
    aggregator actually faces."""
    q = min(m - 1, math.ceil(alpha * m)) if alpha > 0 else 0
    q_buf = min(k, q)
    h_avail = int(round((m - q) * (1.0 - dropout)))
    h_buf = min(k - q_buf, h_avail)
    k_actual = max(1, q_buf + h_buf)
    return k_actual, q_buf / k_actual


def delta_median_async(alpha: float, n: int, m: int, k: int, d: int,
                       V: float, S: float, dropout: float = 0.0,
                       eps: float = 1.0 / 6.0, LhatD: float = 1.0) -> float:
    """Eq. (3)'s Δ at the buffer's effective (alpha_eff, m_eff).

    m_eff = k_actual - q_buf is the honest-in-buffer count: only those
    rows contribute to the coordinate-wise medians' concentration, so
    they take the place of m in the synchronous formula."""
    k_actual, alpha_eff = effective_buffer(alpha, m, k, dropout)
    q_buf = round(alpha_eff * k_actual)
    m_eff = max(1, k_actual - q_buf)
    return delta_median(alpha_eff, n, m_eff, d, V, S, eps=eps, LhatD=LhatD)


def delta_trimmed_async(beta: float, alpha: float, n: int, m: int, k: int,
                        d: int, v: float, dropout: float = 0.0,
                        eps: float = 1.0 / 6.0, LhatD: float = 1.0) -> float:
    """Eq. (5)'s Δ' at the buffer's effective (beta, m_eff); the trim
    level beta is a defence knob and does not concentrate, but the
    averaging population shrinks to the honest-in-buffer count."""
    k_actual, alpha_eff = effective_buffer(alpha, m, k, dropout)
    q_buf = round(alpha_eff * k_actual)
    m_eff = max(1, k_actual - q_buf)
    return delta_trimmed(beta, n, m_eff, d, v, eps=eps, LhatD=LhatD)


def async_optimal_rate(alpha: float, n: int, m: int, k: int,
                       dropout: float = 0.0) -> float:
    """alpha_eff/√n + 1/√(n·m_eff): the order-optimal target the buffered
    engine is held to (constants dropped), mirroring optimal_rate."""
    k_actual, alpha_eff = effective_buffer(alpha, m, k, dropout)
    q_buf = round(alpha_eff * k_actual)
    m_eff = max(1, k_actual - q_buf)
    return alpha_eff / math.sqrt(n) + 1.0 / math.sqrt(n * m_eff)


# ------------------------------------------------------ compressed rounds
#
# A lossy codec between the workers and the robust aggregator (see
# rounds/compression.py) adds codec distortion on top of the statistical
# error: quantization noise (int8), sparsification bias absorbed by
# error feedback (top-k), or hash-collision noise (count sketch).  The
# related papers ("Communication-efficient Byzantine-robust distributed
# learning with statistical guarantee", "Securing Distributed Gradient
# Descent in High Dimensional Statistical Learning") show the compressed
# estimators keep the SAME rate ORDER with a constant-factor penalty and
# a (possibly) reduced breakdown point.  We model both as declared
# per-scheme multipliers — ``rate_penalty`` on the Δ bounds and
# ``breakdown_scale`` on the usable Byzantine-fraction ceiling — and the
# compressed benchmark / robustness-matrix cells gate against these
# compressed bounds, so a scheme whose real distortion exceeds its
# declaration fails CI.


def delta_median_compressed(alpha: float, n: int, m: int, d: int, V: float,
                            S: float, rate_penalty: float,
                            eps: float = 1.0 / 6.0,
                            LhatD: float = 1.0) -> float:
    """Eq. (3)'s Δ times the compression scheme's declared rate penalty —
    the bound the compressed median cells gate against."""
    if rate_penalty < 1.0:
        raise ValueError(f"rate_penalty must be >= 1, got {rate_penalty}")
    return rate_penalty * delta_median(alpha, n, m, d, V, S, eps=eps,
                                       LhatD=LhatD)


def delta_trimmed_compressed(beta: float, n: int, m: int, d: int, v: float,
                             rate_penalty: float, eps: float = 1.0 / 6.0,
                             LhatD: float = 1.0) -> float:
    """Eq. (5)'s Δ' times the compression scheme's declared rate penalty."""
    if rate_penalty < 1.0:
        raise ValueError(f"rate_penalty must be >= 1, got {rate_penalty}")
    return rate_penalty * delta_trimmed(beta, n, m, d, v, eps=eps, LhatD=LhatD)


def one_round_rate_compressed(alpha: float, n: int, m: int,
                              rate_penalty: float) -> float:
    """Theorem 7's one-round rate times the declared compression penalty
    (the τ=∞ cells of the compressed comm-efficiency grid)."""
    if rate_penalty < 1.0:
        raise ValueError(f"rate_penalty must be >= 1, got {rate_penalty}")
    return rate_penalty * one_round_rate(alpha, n, m)


def compressed_breakdown(alpha_max: float, breakdown_scale: float) -> float:
    """Usable Byzantine-fraction ceiling under compression: the
    aggregator's own ceiling (1/2 for median, β for trimmed mean) times
    the scheme's declared breakdown scale.  Cells with alpha at or above
    this are reported ungated by the compressed matrix — the analogue of
    the breakdown regime in the uncompressed grid."""
    if not 0.0 < breakdown_scale <= 1.0:
        raise ValueError(
            f"breakdown_scale must be in (0, 1], got {breakdown_scale}")
    return alpha_max * breakdown_scale


def loglog_slope(xs, ys) -> float:
    """OLS slope of log(y) on log(x) — used to check empirical scalings."""
    lx = [math.log(x) for x in xs]
    ly = [math.log(max(y, 1e-30)) for y in ys]
    n = len(lx)
    mx = sum(lx) / n
    my = sum(ly) / n
    num = sum((a - mx) * (b - my) for a, b in zip(lx, ly))
    den = sum((a - mx) ** 2 for a in lx)
    return num / den


def gd_iterations_strongly_convex(L_F: float, lam_F: float, delta: float,
                                  w0_dist: float) -> int:
    """T ≥ ((L_F+λ_F)/λ_F)·log(λ_F·‖w0−w*‖ / (2Δ)) (after Theorem 1)."""
    if delta <= 0:
        return 1
    t = (L_F + lam_F) / lam_F * math.log(max(math.e, lam_F * w0_dist / (2 * delta)))
    return max(1, int(math.ceil(t)))
