"""Deterministic synthetic data (numpy copy of ``repro.data.pipeline``).

* :class:`BigramSource` — sequences from a fixed random Markov chain.  It
  builds a vocab x vocab float64 table, so it serves small vocabularies
  only (the CPU parity tests); at qwen3-0.6b's 151936 tokens the table
  would take 185 GB.
* :class:`SyntheticBatches` — uniform tokens, the throughput source the
  card runs at full width.

Batch t depends only on (seed, t[, worker]); the arrays are host numpy, the
caller moves them to its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass
class BigramSource:
    vocab: int
    seed: int = 0
    temperature: float = 0.5

    def __post_init__(self):
        rng = np.random.default_rng(np.random.Philox(key=self.seed))
        logits = rng.normal(size=(self.vocab, self.vocab)) / self.temperature
        self.P = np.exp(logits - logits.max(1, keepdims=True))
        self.P /= self.P.sum(1, keepdims=True)
        self.cum = np.cumsum(self.P, axis=1)

    def batch(self, step: int, batch: int, seq: int, worker: int = 0) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.Philox(key=self.seed + 1, counter=[step, worker, 0, 0]))
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            toks[:, t + 1] = (self.cum[toks[:, t]] > u[:, t : t + 1]).argmax(1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclass
class SyntheticBatches:
    cfg: ModelConfig
    shape: InputShape
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        if cfg.modality != "text" or cfg.is_encoder_decoder:
            raise NotImplementedError("only text batches are ported")
        B, S = shape.global_batch, shape.seq_len
        rng = np.random.default_rng(np.random.Philox(key=self.seed, counter=[step, 0, 0, 0]))
        out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if shape.kind == "train":
            out["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        return out
