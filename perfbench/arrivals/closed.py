"""The closed loop (``"loop": "closed"``): ``sessions`` that each hold a
document, prefilled into the cache in set-up; a session sends its next
turn the moment its last answer completes, from ``preroll_s`` before the
window on."""

from __future__ import annotations

from typing import Dict, List

from perfbench.harness import traffic
from perfbench.harness.traffic import Arrival


class Process:
    def __init__(self, mix: Dict, seed: int, vocab: int, max_len: int):
        self.sessions = traffic.sessions(mix, seed, vocab, max_len)
        self.setup = [Arrival(uid=-1 - i, due=0.0, prompt=s.document,
                              max_new_tokens=2, temperature=0.0)
                      for i, s in enumerate(self.sessions)]
        self.cached = int(mix["document"])
        self.turn_of: Dict[int, tuple] = {}

    def start(self, mix: Dict, seconds: float) -> List[Arrival]:
        """Every session's first turn, due as the pre-roll opens."""
        first = [s.turn(0, i, -float(mix["preroll_s"]))
                 for i, s in enumerate(self.sessions)]
        self.turn_of = {a.uid: (i, 0) for i, a in enumerate(first)}
        return first

    def released(self, uid: int, now: float, next_uid: int
                 ) -> List[Arrival]:
        """The next turn of the session whose answer ``uid`` completed,
        due ``now``."""
        i, j = self.turn_of.pop(uid)
        a = self.sessions[i].turn(j + 1, next_uid, now)
        self.turn_of[a.uid] = (i, j + 1)
        return [a]
