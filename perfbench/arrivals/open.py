"""The open loop (``"loop": "open"``): requests sent at the mix's
``rate_per_s`` whatever the engine does, from ``preroll_s`` before the
window on. Set-up serves one greedy and one sampled request that carry
the shared prefix, so the prefix is in the cache before the window."""

from __future__ import annotations

from typing import Dict, List

from perfbench.harness import traffic
from perfbench.harness.traffic import Arrival


class Process:
    def __init__(self, mix: Dict, seed: int, vocab: int, max_len: int):
        self.seed, self.vocab, self.max_len = seed, vocab, max_len
        warm = traffic.warmup_prompt(mix, seed, vocab)
        self.setup = [
            Arrival(uid=-1, due=0.0, prompt=list(warm), max_new_tokens=4,
                    temperature=0.0),
            Arrival(uid=-2, due=0.0, prompt=list(warm), max_new_tokens=4,
                    temperature=float(mix.get("temperature", 1.0)))]
        #: prompt tokens every request finds in the cache
        self.cached = int(mix["shared_prefix"])

    def start(self, mix: Dict, seconds: float) -> List[Arrival]:
        """Every arrival of the pre-roll and the window, in due order."""
        return traffic.open_loop(mix, self.seed, seconds, self.vocab,
                                 self.max_len)

    def released(self, uid: int, now: float, next_uid: int
                 ) -> List[Arrival]:
        """A completion releases nothing in an open loop."""
        return []
