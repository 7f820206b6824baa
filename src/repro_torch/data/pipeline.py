"""Deterministic synthetic LM stream (copy of ``repro/data/pipeline.py``).

Numpy only, so the same seed yields the same batches in both packages:
tokens follow a fixed random first-order Markov chain, so a model that
learns the bigram structure drops well below the unigram entropy.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Seeded Markov-chain token stream of ``{tokens, labels}`` int32 batches."""

    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq_len: int,
        seed: int = 0,
        branching: int = 8,
        table_seed: int | None = None,
    ):
        """``seed`` drives the sampled stream; ``table_seed`` (default 0)
        drives the Markov transition table."""
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        vocab = cfg.vocab_size
        rng = np.random.default_rng(0 if table_seed is None else table_seed)
        self.successors = rng.integers(0, vocab, size=(vocab, branching))
        raw = rng.random((vocab, branching)) ** 2
        self.trans_p = raw / raw.sum(axis=1, keepdims=True)
        self.rng = np.random.default_rng(seed + 1)

    def _sample_rows(self, n: int) -> np.ndarray:
        vocab = self.cfg.vocab_size
        out = np.empty((n, self.seq_len + 1), np.int32)
        state = self.rng.integers(0, vocab, size=n)
        out[:, 0] = state
        for t in range(1, self.seq_len + 1):
            choice = (
                (self.rng.random(n)[:, None] > np.cumsum(self.trans_p[state], axis=1))
                .sum(axis=1)
            )
            state = self.successors[state, choice]
            out[:, t] = state
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            rows = self._sample_rows(self.batch)
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}
