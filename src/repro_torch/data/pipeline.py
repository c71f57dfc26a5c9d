"""Client-local data pipeline: deterministic shuffled batching (+LM windows).

A numpy copy of ``repro.data.pipeline.ClientDataset`` and ``TokenDataset``:
the same seed gives the same shuffles and windows, so a port world and a
reference world built from one seed see identical batches.  Batches stay numpy; the trainer moves them to
its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class ClientDataset:
    """A client's local shard with epoch shuffling and fixed-size batches."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
        if len(x) != len(y) or len(x) == 0:
            raise ValueError(f"need equal, non-empty x and y: {len(x)} vs {len(y)}")
        self.x, self.y = x, y
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(x))
        self._pos = 0
        self._reshuffle()

    def _reshuffle(self):
        self._rng.shuffle(self._order)
        self._pos = 0

    def __len__(self) -> int:
        return len(self.x)

    def next_batch(self) -> Dict[str, np.ndarray]:
        n = len(self.x)
        b = self.batch_size
        if self._pos + b > n:
            self._reshuffle()
        # wrap-around for shards smaller than a batch
        idx = self._order[np.arange(self._pos, self._pos + b) % n]
        self._pos += b
        return {"x": self.x[idx], "y": self.y[idx]}

    def batches(self, n_batches: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n_batches):
            yield self.next_batch()


class TokenDataset:
    """Contiguous-window LM batches over a token stream."""

    def __init__(self, tokens: np.ndarray, seq_len: int, batch_size: int, seed: int = 0):
        self.tokens = tokens
        self.seq_len = seq_len
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def next_batch(self) -> Dict[str, np.ndarray]:
        max_start = len(self.tokens) - self.seq_len - 1
        starts = self._rng.integers(0, max_start, size=self.batch_size)
        toks = np.stack([self.tokens[s : s + self.seq_len] for s in starts])
        return {"tokens": toks.astype(np.int32)}
