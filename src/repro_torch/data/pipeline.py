"""Sharded, deterministic, checkpointable data pipeline (a numpy copy
of ``repro.data.pipeline``: the same batches for the same seeds).

Design goals for 1000+ node jobs:
  * determinism — batch content is a pure function of (seed, step), so a
    restarted / rescheduled worker reproduces the exact stream;
  * shard-awareness — each data-parallel shard reads a disjoint slice;
  * checkpointability — pipeline state is one integer (step) persisted
    with the model checkpoint; no file offsets to lose;
  * prefetch — a background thread keeps ``prefetch`` batches ready
    (straggler smoothing on hosts with slow input processing).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data import synthetic


class TokenDataset:
    """Infinite next-token-prediction stream over a token corpus."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        source: str = "zipf",
        seed: int = 0,
        corpus_tokens: int = 1_000_000,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        if global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        if source == "zipf":
            self.corpus = synthetic.zipf_ngram_corpus(
                vocab_size, corpus_tokens, seed=seed
            )
        elif source == "bytes":
            self.corpus = synthetic.bytes_corpus(corpus_tokens, seed=seed)
        else:
            raise ValueError(f"unknown source {source}")
        self._step = 0

    # --- checkpointable state ------------------------------------------
    @property
    def state(self) -> Dict[str, int]:
        return {"step": self._step}

    def restore(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    # --- batch generation ----------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step: the global batch's local shard."""
        n = self.seq_len
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) % (2 ** 63)
        )
        starts = rng.integers(
            0, len(self.corpus) - n - 1, size=self.global_batch
        )
        lo = self.shard_index * self.local_batch
        starts = starts[lo:lo + self.local_batch]
        inputs = np.stack([self.corpus[s:s + n] for s in starts])
        targets = np.stack([self.corpus[s + 1:s + n + 1] for s in starts])
        return {
            "inputs": inputs.astype(np.int32),
            "targets": targets.astype(np.int32),
        }

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self


class PrefetchIterator:
    """Background-thread prefetching wrapper around any batch iterator."""

    def __init__(self, it, prefetch: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            while not self._stop.is_set():
                self._q.put(next(self._it))
        except StopIteration:
            self._q.put(None)

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
