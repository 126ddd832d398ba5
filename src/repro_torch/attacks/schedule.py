"""Adaptive per-round attack scheduling.

Static mixtures (:class:`repro_torch.fed.rounds.AttackMixture`
``fixed``/``cycle``) replay a predetermined attack sequence.  The greedy
scheduler instead adapts to the defence: it explores each candidate
attack once, observes the damage the server's own broadcast state reveals
(every worker sees the per-round aggregate, so the drift is public), and
then replays the most damaging attack, re-exploring periodically.
:class:`ArrivalScheduler` runs the same search over the arrival-timing
modes of buffered async rounds.
"""
from __future__ import annotations

from typing import Optional, Sequence


class GreedyScheduler:
    """Explore-then-exploit attack selection (deterministic, RNG-free).

    ``pick(r)`` returns the index of the attack to run in round ``r``;
    ``feedback(r, damage)`` reports the realized damage of that round's
    attack.  Every ``reexplore`` rounds the scheduler cycles through all
    candidates once more, so it tracks non-stationary defences.
    """

    def __init__(self, num_attacks: int, reexplore: int = 16):
        if num_attacks < 1:
            raise ValueError("need at least one attack")
        self.num_attacks = num_attacks
        self.reexplore = max(num_attacks + 1, reexplore)
        self._damage = [float("-inf")] * num_attacks
        self._picked: dict = {}

    def pick(self, r: int) -> int:
        phase = r % self.reexplore
        if phase < self.num_attacks:
            idx = phase  # exploration sweep
        else:
            idx = max(range(self.num_attacks), key=lambda i: self._damage[i])
        self._picked[r] = idx
        return idx

    def feedback(self, r: int, damage: float) -> None:
        idx = self._picked.pop(r, None)
        if idx is not None:
            self._damage[idx] = float(damage)

    def best(self) -> Optional[int]:
        """Index of the currently most damaging attack (None before any
        feedback)."""
        if all(d == float("-inf") for d in self._damage):
            return None
        return max(range(self.num_attacks), key=lambda i: self._damage[i])

    # The damage table decides future picks, so a resumed run must continue
    # the SAME adversary: the state is JSON-serializable (json round-trips
    # -inf and float reprs exactly) and has the reference's layout.

    def state_dict(self) -> dict:
        return {
            "num_attacks": self.num_attacks,
            "reexplore": self.reexplore,
            "damage": list(self._damage),
            "picked": {str(r): i for r, i in self._picked.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        if state["num_attacks"] != self.num_attacks:
            raise ValueError(
                f"scheduler snapshot has {state['num_attacks']} attacks, "
                f"this run has {self.num_attacks}")
        self.reexplore = int(state["reexplore"])
        self._damage = [float(d) for d in state["damage"]]
        self._picked = {int(r): int(i) for r, i in state["picked"].items()}


# Arrival-timing modes a greedy async adversary explores.  "honest" keeps
# the Byzantine clients' simulated latencies; "first" rushes the buffer
# window; "last" lags into the buffer tail (maximum staleness that still
# lands in the aggregate).  An attack declared ``greedy``
# (attacks/base.ARRIVAL_BEHAVIOURS) searches over these at run time.
ARRIVAL_MODES = ("honest", "first", "last")


class ArrivalScheduler:
    """Explore-then-exploit over arrival-timing modes: a
    :class:`GreedyScheduler` whose candidates are ``ARRIVAL_MODES``.  The
    async engine asks ``pick(r)`` for round r's Byzantine timing and
    reports the realized damage (the public err drift) via ``feedback``;
    deterministic and RNG-free.  ``state_dict`` has the reference's
    layout."""

    def __init__(self, modes: Sequence[str] = ARRIVAL_MODES, reexplore: int = 16):
        self.modes = tuple(modes)
        for m in self.modes:
            if m not in ARRIVAL_MODES:
                raise ValueError(
                    f"unknown arrival mode {m!r}; want one of {ARRIVAL_MODES}")
        self._sched = GreedyScheduler(len(self.modes), reexplore=reexplore)

    def pick(self, r: int) -> str:
        return self.modes[self._sched.pick(r)]

    def feedback(self, r: int, damage: float) -> None:
        self._sched.feedback(r, damage)

    def best(self) -> Optional[str]:
        idx = self._sched.best()
        return None if idx is None else self.modes[idx]

    def state_dict(self) -> dict:
        return {"modes": list(self.modes), "sched": self._sched.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if tuple(state["modes"]) != self.modes:
            raise ValueError(
                f"arrival-scheduler snapshot has modes {state['modes']}, "
                f"this run has {list(self.modes)}")
        self._sched.load_state_dict(state["sched"])


def schedule_indices(
    schedule: str, num_attacks: int, num_rounds: int,
    damages: Optional[Sequence[float]] = None,
) -> list:
    """The attack index each round of ``schedule`` (fixed, cycle or greedy)
    picks against a fixed per-attack damage profile ``damages``."""
    if schedule == "fixed":
        return [0] * num_rounds
    if schedule == "cycle":
        return [r % num_attacks for r in range(num_rounds)]
    if schedule == "greedy":
        sched = GreedyScheduler(num_attacks)
        out = []
        for r in range(num_rounds):
            i = sched.pick(r)
            out.append(i)
            sched.feedback(r, damages[i] if damages is not None else 0.0)
        return out
    raise ValueError(f"unknown schedule {schedule!r}")
