"""Deterministic synthetic LM corpora (a numpy copy of
``repro.data.synthetic``: the same streams for the same seeds; no
external data needed).

Two sources:

* ``zipf_ngram`` — a seeded order-2 Markov chain with Zipf-distributed
  transitions. Has real learnable structure (bigram entropy far below
  unigram entropy), so a small LM trained on it shows meaningful
  perplexity — which the Energon accuracy benchmarks need to measure
  MP-MRF's perplexity delta against dense attention.
* ``bytes_corpus`` — byte-level stream over an in-repo text blob
  (deterministic, for char-LM examples).
"""

from __future__ import annotations

import numpy as np


def zipf_ngram_corpus(
    vocab_size: int,
    length: int,
    seed: int = 0,
    branching: int = 8,
) -> np.ndarray:
    """Order-2 Markov stream: each (prev, cur) context has ``branching``
    possible successors with Zipf(1.2) weights. Deterministic in seed."""
    rng = np.random.default_rng(seed)
    # context hash → successor table, generated lazily but deterministically
    # via a per-context RNG stream (counter-based for reproducibility).
    weights = 1.0 / np.arange(1, branching + 1) ** 1.2
    weights /= weights.sum()

    def successors(prev: int, cur: int) -> np.ndarray:
        h = (prev * 1000003 + cur * 101 + seed * 7919) % (2 ** 31)
        local = np.random.default_rng(h)
        return local.integers(0, vocab_size, size=branching)

    out = np.empty(length, dtype=np.int32)
    prev, cur = 1, 2
    choices = rng.choice(branching, size=length, p=weights)
    for i in range(length):
        succ = successors(prev, cur)
        nxt = int(succ[choices[i]])
        out[i] = nxt
        prev, cur = cur, nxt
    return out


_DEFAULT_TEXT = (
    "energon is the preferred fuel of the transformer race . "
    "attention results only depend on a few important query key pairs . "
    "multi round filtering selects the pairs at runtime with low bitwidth "
    "tensors and only the finally selected keys perform high precision "
    "sparse attention . the filtering unit computes approximate scores "
    "and compares them with a dynamic threshold estimated from the min "
    "max and mean values of each row . on demand fetching loads only the "
    "keys and values that survived filtering which reduces dram access . "
)


def bytes_corpus(length: int, seed: int = 0) -> np.ndarray:
    """Byte-level corpus built from a repeated, lightly shuffled text."""
    rng = np.random.default_rng(seed)
    words = _DEFAULT_TEXT.split()
    chunks = []
    total = 0
    while total < length:
        k = int(rng.integers(5, 20))
        start = int(rng.integers(0, len(words) - k))
        s = " ".join(words[start:start + k]) + " . "
        b = np.frombuffer(s.encode(), dtype=np.uint8)
        chunks.append(b)
        total += len(b)
    return np.concatenate(chunks)[:length].astype(np.int32)
