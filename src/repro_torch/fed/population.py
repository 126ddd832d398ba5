"""Virtual client population for federated-scale simulation.

Clients are *virtual*: nothing per-client is stored.  Client ``i``'s data
shard is regenerated on demand from :func:`repro_torch.rng.normal` keyed
by (population seed, client id), so a population of 10^6 clients costs
no memory until a cohort chunk touches it, and the two-pass streaming
sketch can regenerate a chunk instead of caching it (regeneration is a
pure function of the ids, on every device and for every chunk size).

Statistical model (the paper's Proposition 1 setting, extended with
cross-client heterogeneity for the federated regime):

    client i:  w*_i = w* + heterogeneity * delta_i / sqrt(d),   delta_i ~ N(0, I_d)
               x ~ N(0, I_d) or Rademacher,  y = x.w*_i + noise * xi

Each client's counter stream holds its ``n*d`` feature draws, then the
``d`` draws of delta_i, then the ``n`` label-noise draws (Rademacher
features take the sign of their normal draw).

Byzantine sub-population: clients ``0 .. ceil(alpha*num_clients)-1`` are
Byzantine (which ids is immaterial to permutation-invariant
aggregators); the round loop (:mod:`repro_torch.fed.rounds`) replaces
their gradients.

Arrival model of buffered async rounds (:class:`ArrivalConfig`,
:meth:`ClientPopulation.arrival_times`): a client's report time is a
fresh latency draw times a persistent per-client speed, with honest
no-shows at ``inf``.  Every draw is a counter-based :mod:`repro_torch.rng`
draw keyed by (seed, stream tag, round, client id), so a client's time
does not depend on its position in the cohort or on chunking, and it is
drawn on the CPU: arrival times are host scheduling state, and drawing
them there makes the buffer composition the same bits on the card and on
the CPU (as ``w*`` is).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import rng
from repro_torch.device import resolve

_TAG_W_STAR = 0x57A2  # counter-stream tags of the population's draws
_TAG_CLIENT = 0x5EED
_TAG_SPEED = 0x510  # persistent client speed, keyed by client id alone
_TAG_LATENCY = 0x1A7E  # per-round latency and dropout draws
_TAG_DROPOUT = 0xD809
#: stream tag of the arrival draws, folded with the run seed and the round
#: (the reference's ``async_rounds._ARRIVAL_STREAM``); streams 0 (the
#: cohort's times), 1 (churn joiners' ids) and 2 (their times) under it
ARRIVAL_STREAM = 0xA54C
LATENCIES = ("zero", "uniform", "exponential", "lognormal")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Arrival-time model for buffered async rounds.

    A client's report time is ``latency_draw * client_speed``: the draw
    is fresh every round, from ``latency`` scaled by ``scale``/``spread``;
    ``client_speed`` is a PERSISTENT per-client lognormal multiplier
    (``client_spread`` > 0 makes some clients chronically slow).
    ``dropout`` is the per-round probability that an HONEST client never
    reports (Byzantine clients always report).  ``churn`` is the fraction
    of the cohort size that joins mid-round as fresh clients.

    ``latency``: zero | uniform | exponential | lognormal.  ``zero`` (the
    default) makes every arrival instantaneous — the synchronous pin.
    ``lognormal`` is the heavy-tailed straggler regime (sigma = spread).
    """

    latency: str = "zero"
    scale: float = 1.0  # latency scale (time units are arbitrary)
    spread: float = 1.0  # distribution shape: lognormal sigma, uniform width
    dropout: float = 0.0  # per-round honest no-show probability
    churn: float = 0.0  # mid-round joiners as a fraction of cohort size
    client_spread: float = 0.0  # persistent per-client slowness (lognormal sigma)

    def __post_init__(self):
        if self.latency not in LATENCIES:
            raise ValueError(f"unknown latency model {self.latency!r}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if self.churn < 0.0:
            raise ValueError(f"churn must be >= 0, got {self.churn}")


def sample_latencies(seed: int, ids: torch.Tensor, acfg: ArrivalConfig) -> torch.Tensor:
    """One fresh float32 latency draw per id, keyed by (seed, id), on the
    ids' device: ``scale * U[0, spread)``, ``scale * Exp(1)`` (as
    ``-log1p(-u)``) or ``scale * exp(spread * N(0, 1))``."""
    if acfg.latency == "zero":
        return torch.zeros(ids.shape[0], dtype=torch.float32, device=ids.device)
    if acfg.latency == "lognormal":
        z = rng.normal(seed, _TAG_LATENCY, ids, 1)[:, 0]
        return acfg.scale * torch.exp(acfg.spread * z)
    u = rng.uniform(seed, _TAG_LATENCY, ids, 1)[:, 0]
    if acfg.latency == "uniform":
        return acfg.scale * (u * acfg.spread)
    return acfg.scale * -torch.log1p(-u)


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    num_clients: int = 100_000
    samples_per_client: int = 32  # n: local shard size
    dim: int = 64  # d
    alpha: float = 0.0  # Byzantine fraction of the population
    heterogeneity: float = 0.0  # per-client optimum shift scale (0 = iid)
    noise: float = 1.0  # label noise sigma
    features: str = "gaussian"  # gaussian|rademacher
    seed: int = 0

    def num_byzantine(self) -> int:
        if self.alpha <= 0:
            return 0
        return min(self.num_clients - 1, math.ceil(self.alpha * self.num_clients))


def _true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    # a full-size divisor: an IEEE division on every device (CUDA divides
    # by a host scalar with a reciprocal multiply)
    return x / torch.full_like(x, s)


class ClientPopulation:
    """Lazily generated linear-regression client population on ``device``."""

    def __init__(self, cfg: PopulationConfig, *, device="cuda"):
        if cfg.features not in ("gaussian", "rademacher"):
            raise ValueError(f"unknown features {cfg.features!r}")
        self.cfg = cfg
        self.device = resolve(device)
        # drawn on the CPU, so w* is the same bits on every device
        z = rng.normal(cfg.seed, _TAG_W_STAR, torch.zeros(1, dtype=torch.int64), cfg.dim)[0]
        self.w_star = _true_div(z, math.sqrt(cfg.dim)).to(self.device)

    # ---------------------------------------------------------------- data

    def client_batch(self, client_ids: torch.Tensor):
        """Shards of a chunk of clients: x (k, n, d), y (k, n)."""
        cfg = self.cfg
        n, d = cfg.samples_per_client, cfg.dim
        ids = client_ids.to(self.device)
        z = rng.normal(cfg.seed, _TAG_CLIENT, ids, n * d + d + n)
        x = z[:, :n * d].reshape(-1, n, d)
        if cfg.features == "rademacher":
            x = torch.where(x < 0, -1.0, 1.0)
        delta = _true_div(z[:, n * d:n * d + d], math.sqrt(d))
        w_i = self.w_star + cfg.heterogeneity * delta  # (k, d)
        y = torch.einsum("knd,kd->kn", x, w_i) + cfg.noise * z[:, n * d + d:]
        return x, y

    # ------------------------------------------------------------ gradients

    @staticmethod
    def _loss_grad(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
        """(loss, grad) of ½‖y − Xw‖²/n per client for per-client iterates
        ``w`` (k, d) or one shared (d,) iterate."""
        n = x.shape[1]
        pred = (torch.einsum("knd,d->kn", x, w) if w.dim() == 1
                else torch.einsum("knd,kd->kn", x, w))
        r = pred - y
        g = _true_div(torch.einsum("knd,kn->kd", x, r), n)
        return 0.5 * (r * r).mean(dim=1), g

    def client_grads(self, w: torch.Tensor, client_ids: torch.Tensor) -> torch.Tensor:
        """Local full-batch gradients of ½‖y − Xw‖²/n: (k, d), one batched
        product over the chunk; only (chunk, n, d) data ever exists."""
        x, y = self.client_batch(client_ids)
        return self._loss_grad(x, y, w)[1]

    def client_deltas(self, w: torch.Tensor, client_ids: torch.Tensor,
                      local_steps: int, local_lr: float) -> torch.Tensor:
        """Accumulated local gradients after ``local_steps`` local SGD steps
        from the broadcast iterate ``w``: (k, d).  Every client of the chunk
        descends on its own shard at ``local_lr`` and transmits
        Δ_i = Σ_k ∇f_i(w_i^k)."""
        from repro_torch.rounds.distributed import scan_local_sgd

        x, y = self.client_batch(client_ids)
        w0 = w.expand(x.shape[0], -1)
        delta, _ = scan_local_sgd(lambda wi: self._loss_grad(x, y, wi), w0,
                                  local_steps, local_lr)
        return delta

    # ------------------------------------------------------------ byzantine

    def is_byzantine(self, client_ids: torch.Tensor) -> torch.Tensor:
        """Bool mask over a chunk of client ids (ids below the cut are bad)."""
        return client_ids < self.cfg.num_byzantine()

    # -------------------------------------------------------------- cohorts

    def sample_cohort(self, seed: int, rnd: int, cohort_size: int) -> torch.Tensor:
        """Uniform without-replacement cohort of client ids for round
        ``rnd``: (cohort,) int64 on the population's device.  A permutation
        on a CPU generator seeded from (seed, rnd), the same on every
        device."""
        if cohort_size > self.cfg.num_clients:
            raise ValueError(
                f"cohort {cohort_size} > population {self.cfg.num_clients}")
        perm = torch.randperm(self.cfg.num_clients, generator=rng.generator(seed, rnd))
        return perm[:cohort_size].to(self.device)

    def sample_joiners(self, seed: int, rnd: int, n: int) -> torch.Tensor:
        """Round ``rnd``'s ``n`` churn joiners: (n,) int64 ids on the
        population's device, drawn as a cohort is but from the arrival
        stream, so they are not the cohort's own first ids."""
        if n > self.cfg.num_clients:
            raise ValueError(f"cohort {n} > population {self.cfg.num_clients}")
        gen = rng.generator(seed, ARRIVAL_STREAM, rnd, 1)
        return torch.randperm(self.cfg.num_clients, generator=gen)[:n].to(self.device)

    # -------------------------------------------------------------- arrivals

    def client_speed(self, client_ids: torch.Tensor, acfg: ArrivalConfig) -> torch.Tensor:
        """Persistent per-client slowness multiplier, (k,) float32 on the
        CPU: lognormal with sigma ``client_spread``, keyed by the
        population seed and the client id alone, so the same client is
        slow in every round."""
        ids = client_ids.detach().to("cpu", torch.int64)
        if acfg.client_spread <= 0.0:
            return torch.ones(ids.shape[0], dtype=torch.float32)
        z = rng.normal(self.cfg.seed, _TAG_SPEED, ids, 1)[:, 0]
        return torch.exp(acfg.client_spread * z)

    def arrival_times(self, seed: int, rnd: int, stream: int, client_ids: torch.Tensor,
                      acfg: ArrivalConfig) -> torch.Tensor:
        """Report times of round ``rnd``'s clients, (k,) float32 on the CPU;
        ``inf`` = dropped.  ``seed`` is the run's seed and ``stream`` the
        arrival stream (0: the cohort, 2: churn joiners); the draws are
        keyed by (seed, ARRIVAL_STREAM, rnd, stream) and the client id, a
        stream apart from the cohort and attack draws.  Honest clients
        no-show with probability ``dropout`` (``u < dropout``)."""
        ids = client_ids.detach().to("cpu", torch.int64)
        key = rng.fold(seed, ARRIVAL_STREAM, rnd, stream)
        t = sample_latencies(key, ids, acfg) * self.client_speed(ids, acfg)
        if acfg.dropout > 0.0:
            drop = rng.uniform(key, _TAG_DROPOUT, ids, 1)[:, 0] < acfg.dropout
            t = torch.where(drop & ~self.is_byzantine(ids), torch.inf, t)
        return t
