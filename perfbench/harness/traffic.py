"""The one traffic generator: it reads a mix's data file and the seed.

A mix (``perfbench/traffic/<name>.json``) is parameters only:

* ``kind`` ``"serve"`` — requests to a serving engine in an open loop
  (``loop`` ``"open"``): sent at ``rate_per_s`` whatever the engine does,
  starting ``preroll_s`` before the window. ``shared_prefix`` tokens open
  every prompt (a system prompt), ``prompt`` and ``output`` give the
  lengths of the rest and of the answer, one request in
  ``sampled_every`` samples at ``temperature`` (the rest are greedy).
* ``kind`` ``"serve"``, ``loop`` ``"closed"`` — ``sessions`` that each
  hold a ``document`` of that many tokens, prefilled into the cache in
  set-up; a session sends its next turn (``question`` tokens after its
  document, an answer of ``answer`` tokens, greedy) the moment its last
  answer completes, from ``preroll_s`` before the window on.
* ``kind`` ``"score"`` — batches of ``batch × seq_len`` tokens scored
  back to back.

A serving mix's ``loop`` names its arrival process,
``perfbench/arrivals/<loop>.py`` (:func:`process`): what set-up serves,
what is due as the window opens, and what a completed request releases.
A new kind of arrivals (bursts, say) is a new file there, read by name.

Lengths and gaps are drawn *stratified*: the n values are the
distribution's quantiles at (i + ½) / n, permuted by the mix's own
``schedule_seed``, so every run replays one schedule and offers the same
work; the run's seed draws the token ids (and the weights). Latencies
hang on the order in which long and short prompts meet: drawn per run,
the order alone moved the median time to first token from 536 to 851 ms
between seeds of one mix.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List

import numpy as np

TRAFFIC_STREAM = 0x7A11
ARRIVALS = Path(__file__).resolve().parents[1] / "arrivals"


@dataclasses.dataclass
class Arrival:
    """One request: when it is due (seconds from the window's start;
    negative in the pre-roll), its prompt, its answer's length and
    temperature."""

    uid: int
    due: float
    prompt: List[int]
    max_new_tokens: int
    temperature: float


def rng_for(seed: int, stream: int = TRAFFIC_STREAM) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, lognormal
    (``median``, ``sigma``) or uniform, clipped to ``min`` .. ``max`` and
    rounded."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        vals = dist["min"] + u * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(vals), dist["min"], dist["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n stratified exponential gaps of mean ``1 / rate``."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def shared_prefix(mix: Dict, seed: int, vocab: int) -> List[int]:
    rng = rng_for(seed, TRAFFIC_STREAM + 1)
    return rng.integers(0, vocab, mix["shared_prefix"]).tolist()


def _segment(rate: float, start: float, length: float,
             rng: np.random.Generator) -> np.ndarray:
    """``round(rate × length)`` arrival times in ``[start, start +
    length)``: stratified exponential gaps, permuted by ``rng`` and scaled
    to the segment, the first at its start."""
    k = max(1, int(round(rate * length)))
    gaps = rng.permutation(exp_gaps(rate, k))
    before = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return start + length * before / gaps.sum()


def open_loop(mix: Dict, seed: int, seconds: float, vocab: int,
              max_len: int) -> List[Arrival]:
    """An open loop's arrivals over the pre-roll and the window, in due
    order. The pre-roll and the window each hold a fixed number of
    requests with fixed lengths, in the order and at the gaps the mix's
    ``schedule_seed`` draws; token ids come from the run's seed."""
    rate = float(mix["rate_per_s"])
    pre = float(mix["preroll_s"])
    sched = rng_for(mix["schedule_seed"], TRAFFIC_STREAM + 2)
    rng = rng_for(seed)
    system = shared_prefix(mix, seed, vocab)
    every = int(mix.get("sampled_every", 0))
    arrivals: List[Arrival] = []
    for start, length in ((-pre, pre), (0.0, float(seconds))):
        due = _segment(rate, start, length, sched)
        n = len(due)
        users = sched.permutation(quantiles(mix["prompt"], n))
        outs = sched.permutation(quantiles(mix["output"], n))
        sampled = np.zeros(n, bool)
        if every:
            sampled[sched.permutation(n)[:n // every]] = True
        for i in range(n):
            prompt = system + rng.integers(0, vocab, int(users[i])).tolist()
            room = max(1, max_len - len(prompt))
            arrivals.append(Arrival(
                uid=len(arrivals), due=float(due[i]), prompt=prompt,
                max_new_tokens=int(min(outs[i], room)),
                temperature=float(mix["temperature"]) if sampled[i]
                else 0.0))
    return arrivals


@dataclasses.dataclass
class Session:
    """One closed-loop session: its document and its turns in order, each
    ``(question tokens, answer length)``."""

    document: List[int]
    turns: List[tuple]
    #: the run's seed, the session's index and the vocabulary, for turns
    #: past ``turns``
    key: tuple = (0, 0, 1)

    def turn(self, j: int, uid: int, due: float) -> Arrival:
        """Turn ``j`` as a request. Past the drawn turns, the lengths come
        round again with fresh question tokens drawn from the seed, the
        session and ``j`` (a repeated question would hit the prefix
        cache and change the work)."""
        question, answer = self.turns[j % len(self.turns)]
        if j >= len(self.turns):
            seed, s, vocab = self.key
            rng = np.random.default_rng(
                [int(seed) % 2 ** 63, TRAFFIC_STREAM + 5, s, j])
            question = rng.integers(0, vocab, len(question)).tolist()
        return Arrival(uid=uid, due=due, prompt=self.document + question,
                       max_new_tokens=answer, temperature=0.0)


def sessions(mix: Dict, seed: int, vocab: int, max_len: int
             ) -> List[Session]:
    """A closed loop's sessions. The lengths of all sessions' ``turns``
    turns are the stratified quantiles of ``question`` and ``answer``,
    dealt out in the order the mix's ``schedule_seed`` draws, so every
    run offers the same work; documents and questions take their token
    ids from the run's seed."""
    k, turns = int(mix["sessions"]), int(mix["turns"])
    doc = int(mix["document"])
    sched = rng_for(mix["schedule_seed"], TRAFFIC_STREAM + 3)
    qs = sched.permutation(quantiles(mix["question"], k * turns))
    outs = sched.permutation(quantiles(mix["answer"], k * turns))
    rng = rng_for(seed, TRAFFIC_STREAM + 4)
    out = []
    for s in range(k):
        document = rng.integers(0, vocab, doc).tolist()
        ts = []
        for j in range(s * turns, (s + 1) * turns):
            q = rng.integers(0, vocab, int(qs[j])).tolist()
            room = max(1, max_len - doc - len(q))
            ts.append((q, int(min(outs[j], room))))
        out.append(Session(document=document, turns=ts,
                           key=(seed, s, vocab)))
    return out


def score_tokens(mix: Dict, seed: int, call: int, vocab: int, device):
    """Call ``call``'s tokens ``[batch, seq_len + 1]``, made on ``device``
    from the seed (inputs are ``[:, :-1]``, targets ``[:, 1:]``)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + call * 7919 + TRAFFIC_STREAM) % 2 ** 63)
    return torch.randint(0, vocab, (mix["batch"], mix["seq_len"] + 1),
                         generator=gen, device=device)


def warmup_prompt(mix: Dict, seed: int, vocab: int,
                  extra: int = 64) -> List[int]:
    """The set-up's request: the shared prefix and a short tail, so the
    prefix is in the cache before the window."""
    rng = rng_for(seed, TRAFFIC_STREAM - 1)
    return shared_prefix(mix, seed, vocab) + rng.integers(
        0, vocab, extra).tolist()


def check_sample(done: List, seed: int, min_tokens: int,
                 max_requests: int) -> List:
    """Which finished greedy requests the reference checks: the one that
    served the most tokens, then others drawn from the seed until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    greedy = [r for r in done if r.temperature == 0.0]
    if not greedy:
        return []
    greedy.sort(key=lambda r: r.uid)
    first = max(greedy, key=lambda r: (len(r.tokens_out), -r.uid))
    rest = [r for r in greedy if r is not first]
    order = rng_for(seed, TRAFFIC_STREAM + 99).permutation(len(rest))
    out, total = [first], len(first.tokens_out)
    for i in order:
        if total >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        total += len(rest[i].tokens_out)
    return out


def process(mix: Dict, seed: int, vocab: int, max_len: int):
    """The serving mix's arrival process: ``Process`` of
    ``perfbench/arrivals/<loop>.py``, made for this run's seed."""
    path = ARRIVALS / f"{mix['loop']}.py"
    if not path.is_file():
        known = sorted(p.stem for p in ARRIVALS.glob("*.py"))
        raise KeyError(f"no arrival process {mix['loop']!r} "
                       f"(known: {known})")
    spec = importlib.util.spec_from_file_location(
        "perfbench_arrivals_" + mix["loop"].replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Process(mix, seed, vocab, max_len)
