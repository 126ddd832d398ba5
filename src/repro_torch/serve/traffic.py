"""Seeded virtual user population driving the serving engine (the
reference's ``repro.serve.traffic``).

Users are *virtual*: nothing per user is stored — a user's topic is
regenerated on demand from (seed, uid), so a population of millions costs
nothing until a request samples it.  Heterogeneity: each user has a
persistent topic center in token space and draws prompts in a narrow band
around it.

Threat-model mapping (the paper's worker pool): users map onto
``num_shards`` gradient shards CONTIGUOUSLY — ``shard_of(uid) = uid *
num_shards // num_users`` — and the Byzantine sub-population is the users
of the first ``ceil(alpha * num_shards)`` shards (at most all but one), so
an alpha fraction of *shards* is fully Byzantine.

Feedback: after a request completes, its user scores the response in
[-1, 1]: seeded per-request noise minus a penalty for immediately
repeated tokens.  Byzantine shards' score vectors pass through the
registered ``feedback``-access attack
(:func:`repro_torch.attacks.engine.corrupt_feedback`) when the round batch
is built.

Randomness: the reference draws from threefry; here every draw comes from
torch on the CPU, keyed through :mod:`repro_torch.rng` — a request batch
by (seed, stream), a user's topic by (seed, uid), a score by (seed, rid),
a corruption by (seed, round, shard) — so the traffic is the same on every
device and the draws are held to the reference's in distribution.  The
inter-arrival gaps come from :func:`repro_torch.fed.population.sample_latencies`,
the federated simulator's latency vocabulary, keyed by request id.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.attacks import base as atk_base
from repro_torch.attacks import engine as atk_engine
from repro_torch.fed.population import ArrivalConfig, sample_latencies
from repro_torch.serve.engine import Completed, Request

_REQ_STREAM = 0x5E21E  # request-sampling stream tag
_USER_STREAM = 0x0522  # per-user topic stream tag
_SCORE_STREAM = 0xFEED  # feedback-noise stream tag
_ATTACK_STREAM = 0xBAD5C02E  # feedback-corruption stream tag


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """The virtual population and its poisoned sub-population."""

    num_users: int = 1_000_000
    num_shards: int = 8
    alpha: float = 0.0  # Byzantine fraction (of shards, via contiguous uids)
    attack: str = "feedback_flip"  # registered feedback-access attack
    strength: Optional[float] = None  # None = the attack's default
    prompt_len: int = 16
    min_gen: int = 4
    max_gen: int = 16
    vocab: int = 512
    topic_spread: int = 32  # prompt band width around the user's center
    arrival: ArrivalConfig = ArrivalConfig(latency="exponential", scale=2.0)
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.alpha < 1.0:
            raise ValueError(f"alpha must be in [0, 1), got {self.alpha}")
        if self.num_shards < 1 or self.num_users < self.num_shards:
            raise ValueError(
                f"need num_users >= num_shards >= 1, got "
                f"{self.num_users} users / {self.num_shards} shards")
        if not 1 <= self.min_gen <= self.max_gen:
            raise ValueError(
                f"need 1 <= min_gen <= max_gen, got [{self.min_gen}, {self.max_gen}]")
        if self.alpha > 0.0:
            spec = atk_engine.as_attack(self.attack)  # raises on unknown name
            if spec.access != atk_base.FEEDBACK:
                raise ValueError(
                    f"traffic attack {spec.name!r} has access {spec.access!r}; "
                    "the serving stream only carries feedback-access attacks "
                    "(gradient-space attacks plug into AdaptConfig.grad_attack instead)")

    @property
    def num_byz_shards(self) -> int:
        if self.alpha <= 0:
            return 0
        return min(self.num_shards - 1, math.ceil(self.alpha * self.num_shards))

    @property
    def seq_len(self) -> int:
        """Fixed LM training length: prompt + the largest response."""
        return self.prompt_len + self.max_gen


class VirtualUsers:
    """Lazily generated heterogeneous user population."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg

    # ----------------------------------------------------------- identity

    def shard_of(self, uid: int) -> int:
        return uid * self.cfg.num_shards // self.cfg.num_users

    def byzantine_shard(self, shard: int) -> bool:
        return shard < self.cfg.num_byz_shards

    def is_byzantine(self, uid: int) -> bool:
        return self.byzantine_shard(self.shard_of(uid))

    def topic_centers(self, uids: torch.Tensor) -> torch.Tensor:
        """Each user's persistent topic center in [0, vocab), keyed by
        (seed, uid) alone."""
        u = rng.uniform(self.cfg.seed, _USER_STREAM, uids, 1)[:, 0].double()
        return torch.floor(u * self.cfg.vocab).to(torch.int64)

    # ----------------------------------------------------------- requests

    def sample_requests(self, num: int, *, stream: int = 0,
                        start_time: float = 0.0) -> List[Request]:
        """``num`` requests with cumulative-latency arrival times, sorted.

        ``stream`` names an independent batch of the request process;
        request ids are globally unique across streams.
        """
        cfg = self.cfg

        def gen(part: int) -> torch.Generator:
            return rng.generator(cfg.seed, _REQ_STREAM, stream, part)

        rids = stream * num + torch.arange(num, dtype=torch.int64)
        uids = torch.randint(0, cfg.num_users, (num,), generator=gen(1))
        gaps = sample_latencies(rng.fold(cfg.seed, _REQ_STREAM, stream, 2), rids, cfg.arrival)
        arrivals = start_time + torch.cumsum(gaps, dim=0)
        gen_len = torch.randint(cfg.min_gen, cfg.max_gen + 1, (num,), generator=gen(3))
        noise = torch.randint(0, max(1, cfg.topic_spread), (num, cfg.prompt_len),
                              generator=gen(4))
        prompts = (self.topic_centers(uids)[:, None] + noise) % cfg.vocab
        uids_h = uids.numpy()
        arr_h = arrivals.numpy().astype(np.float64)
        gen_h = gen_len.numpy()
        prompts_h = prompts.numpy().astype(np.int32)
        return [
            Request(rid=int(rids[i]), uid=int(uids_h[i]), shard=self.shard_of(int(uids_h[i])),
                    arrival=float(arr_h[i]), prompt=prompts_h[i], gen_len=int(gen_h[i]))
            for i in range(num)
        ]

    # ----------------------------------------------------------- feedback

    def honest_score(self, done: Completed) -> float:
        """The user's honest rating of a served response, in [-1, 1]:
        seeded per-request noise minus a degeneracy penalty (the fraction
        of immediately repeated tokens)."""
        xi = float(rng.normal(self.cfg.seed, _SCORE_STREAM,
                              torch.tensor([done.request.rid]), 1)[0, 0])
        resp = done.response
        rep = 0.0
        if len(resp) > 1:
            rep = float(np.mean(resp[1:] == resp[:-1]))
        return float(np.clip(0.7 + 0.2 * math.tanh(xi) - 0.8 * rep, -1.0, 1.0))

    # -------------------------------------------------------- round batch

    def build_round(self, per_shard: Sequence[Sequence[Completed]],
                    rnd: int) -> Dict[str, torch.Tensor]:
        """Fixed-shape LM round batch from one cadence window's traffic, as
        CPU tensors.

        ``per_shard``: ``num_shards`` lists of exactly B completions each.
        Returns ``{"tokens", "labels", "weights"}`` shaped (m, B, L) plus the
        per-sequence ``scores``/``scores_honest`` (m, B).  Labels are
        next-token targets over the concatenated (prompt, response)
        sequence; ``weights`` carry the (possibly corrupted) feedback score
        on exactly the response positions, zero elsewhere.  Byzantine
        shards' score vectors pass through the configured feedback attack
        with a generator keyed by (seed, round, shard).
        """
        cfg = self.cfg
        m = cfg.num_shards
        if len(per_shard) != m:
            raise ValueError(f"expected {m} shards, got {len(per_shard)}")
        B = len(per_shard[0])
        if any(len(sh) != B for sh in per_shard):
            raise ValueError("all shards must contribute the same batch size")
        L = cfg.seq_len
        P = cfg.prompt_len
        tokens = np.zeros((m, B, L), np.int64)
        labels = np.zeros((m, B, L), np.int64)
        wpos = np.zeros((m, B, L), np.float32)  # response-position mask
        honest = np.zeros((m, B), np.float32)
        for s, shard in enumerate(per_shard):
            for b, done in enumerate(shard):
                seq = np.concatenate([done.request.prompt, done.response])
                seq = np.pad(seq, (0, L + 1 - len(seq)))
                tokens[s, b] = seq[:L]
                labels[s, b] = seq[1: L + 1]
                g = len(done.response)
                # positions predicting response tokens: P-1 .. P+g-2
                wpos[s, b, P - 1: P + g - 1] = 1.0
                honest[s, b] = self.honest_score(done)
        honest_t = torch.from_numpy(honest)
        scores = honest_t.clone()
        q = cfg.num_byz_shards
        if q > 0:
            atk = atk_engine.as_attack(cfg.attack)
            for s in range(q):
                g = rng.generator(cfg.seed, _ATTACK_STREAM, rnd * m + s)
                scores[s] = atk_engine.corrupt_feedback(atk, honest_t[s], g, cfg.strength)
        return {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels),
            "weights": torch.from_numpy(wpos) * scores[:, :, None],
            "scores": scores,
            "scores_honest": honest_t,
        }
