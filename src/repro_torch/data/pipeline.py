"""Data pipeline: synthetic LM stream and memmap-backed dataset (copy of
``repro/data/pipeline.py``).

Numpy only, so the same seed yields the same batches in both packages:
tokens follow a fixed random first-order Markov chain, so a model that
learns the bigram structure drops well below the unigram entropy.
``MemmapDataset`` reads pre-tokenized uint16/uint32 binary files. Both
produce ``{tokens, labels}`` with next-token labels, and both report their
stream position (``state()``/``set_state()``) for checkpoints. The
synthetic stream also carries the stub modality inputs, drawn from its rng
after the tokens in the reference's order: ``vision_embeds`` (B,
vision_tokens, D) for a VLM and ``audio_frames`` (B, encoder_seq, D) for
whisper, N(0, 0.02^2) float32.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Seeded Markov-chain token stream of ``{tokens, labels}`` int32 batches
    (plus a VLM's or whisper's float32 stub inputs)."""

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

    def state(self) -> dict:
        """JSON-serializable stream position (numpy bit-generator state),
        persisted in a checkpoint's ``meta.json`` so a resumed run continues
        the token stream where it left off."""
        return {"rng": self.rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]

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
        cfg = self.cfg
        while True:
            rows = self._sample_rows(self.batch)
            batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}
            if cfg.arch_type == "vlm":
                batch["vision_embeds"] = 0.02 * self.rng.standard_normal(
                    (self.batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            if cfg.arch_type == "audio":
                batch["audio_frames"] = 0.02 * self.rng.standard_normal(
                    (self.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
            yield batch


class MemmapDataset:
    """Pre-tokenized flat binary token file -> ``{tokens, labels}`` batches."""

    def __init__(self, path: str, batch: int, seq_len: int, dtype=np.uint16, seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def state(self) -> dict:
        """JSON-serializable stream position -- see ``SyntheticLM.state``."""
        return {"rng": self.rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]

    def __iter__(self) -> Iterator[dict]:
        n = len(self.data) - self.seq_len - 1
        while True:
            starts = self.rng.integers(0, n, size=self.batch)
            tokens = np.stack([self.data[s:s + self.seq_len] for s in starts]).astype(np.int32)
            labels = np.stack(
                [self.data[s + 1:s + self.seq_len + 1] for s in starts]).astype(np.int32)
            yield {"tokens": tokens, "labels": labels}


def unigram_entropy(pipeline: SyntheticLM, samples: int = 4) -> float:
    """Empirical unigram cross-entropy floor of the synthetic stream."""
    rows = np.concatenate([pipeline._sample_rows(pipeline.batch) for _ in range(samples)])
    counts = np.bincount(rows.ravel(), minlength=pipeline.cfg.vocab_size) + 1e-9
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())
