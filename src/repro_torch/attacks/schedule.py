"""Adaptive per-round attack scheduling.

Static mixtures (:class:`repro_torch.fed.rounds.AttackMixture`
``fixed``/``cycle``) replay a predetermined attack sequence.  The greedy
scheduler instead adapts to the defence: it explores each candidate
attack once, observes the damage the server's own broadcast state reveals
(every worker sees the per-round aggregate, so the drift is public), and
then replays the most damaging attack, re-exploring periodically.

The reference's ``ArrivalScheduler`` (timing modes of buffered async
rounds) is not ported here.
"""
from __future__ import annotations

from typing import Optional


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
