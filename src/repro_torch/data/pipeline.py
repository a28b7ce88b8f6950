"""Data pipeline (port of ``repro/data/pipeline.py``): deterministic
synthetic token streams and batching, numpy only.  For the same seed the
batches equal the reference's bit for bit: the same generator
(``np.random.default_rng``) drawn in the same order.  The synthetic LM
distribution is a mixture of skewed unigrams and copy patterns, so the
loss falls during the example training runs."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenStream:
    """Deterministic pseudo-corpus: an iterator of {tokens, labels}
    (batch, seq_len) int32 numpy batches."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0, copy_period: int = 17):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.copy_period = copy_period

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, S, V = self.batch, self.seq_len, self.vocab_size
        # zipf-ish unigram base
        base = self.rng.zipf(1.3, size=(B, S + 1)) % V
        # copy structure: token[t] = token[t - copy_period]
        cp = self.copy_period
        for row in base:
            start = int(self.rng.integers(0, cp))
            src = row[start: S + 1 - cp: cp]
            dst = row[start + cp: S + 1: cp]
            dst[: len(src)] = src[: len(dst)]
        seq = base.astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def synthetic_batches(vocab_size: int, seq_len: int, batch: int, n: int,
                      seed: int = 0):
    """The first ``n`` batches of ``TokenStream(..., seed)``."""
    it = TokenStream(vocab_size, seq_len, batch, seed)
    for _ in range(n):
        yield next(it)
