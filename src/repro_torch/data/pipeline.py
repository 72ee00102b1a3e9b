"""Deterministic synthetic data (numpy copy of ``repro.data.pipeline``).

* :class:`BigramSource` — sequences from a fixed random Markov chain.  It
  builds a vocab x vocab float64 table, so it serves small vocabularies
  only (the CPU parity tests); at qwen3-0.6b's 151936 tokens the table
  would take 185 GB.
* :class:`SyntheticBatches` — uniform tokens, with gaussian patch or frame
  embeddings for the vision and audio families: the throughput source
  the card runs at full width.

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


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> dict[str, tuple[tuple[int, ...], type]]:
    """The arrays of a batch, ``{name: (shape, numpy dtype)}`` in the order
    :class:`SyntheticBatches` draws them (the reference's): vision
    ``patches`` (B, int(S * vision_fraction), d) f32, the encoder-decoder's
    ``frames`` (B, max(1, S // encoder_ratio), d) f32, then ``tokens`` and
    (train) ``labels`` over the S_text = S - S_vis text positions."""
    B, S = shape.global_batch, shape.seq_len
    out: dict[str, tuple[tuple[int, ...], type]] = {}
    S_text = S
    if cfg.modality == "vision":
        S_vis = int(S * cfg.vision_fraction)
        S_text = S - S_vis
        out["patches"] = ((B, S_vis, cfg.d_model), np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = ((B, max(1, S // cfg.encoder_ratio), cfg.d_model), np.float32)
    out["tokens"] = ((B, S_text), np.int32)
    if shape.kind == "train":
        out["labels"] = ((B, S_text), np.int32)
    return out


@dataclass
class SyntheticBatches:
    cfg: ModelConfig
    shape: InputShape
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Gaussian ``patches`` / ``frames`` and uniform ``tokens`` /
        ``labels`` (:func:`input_specs`), drawn from one Philox stream keyed
        by (seed, step) in the reference's order."""
        rng = np.random.default_rng(np.random.Philox(key=self.seed, counter=[step, 0, 0, 0]))
        return {name: (rng.normal(size=shp).astype(dt) if dt == np.float32
                       else rng.integers(0, self.cfg.vocab, shp).astype(dt))
                for name, (shp, dt) in input_specs(self.cfg, self.shape).items()}
