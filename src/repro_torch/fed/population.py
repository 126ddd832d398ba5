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

The reference's arrival model (``ArrivalConfig``, ``arrival_times``) is
part of its buffered async rounds and is not ported here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import rng
from repro_torch.device import resolve

_TAG_W_STAR = 0x57A2  # counter-stream tags of the population's draws
_TAG_CLIENT = 0x5EED


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
