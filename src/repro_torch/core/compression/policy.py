"""Adaptive compression policies (counterpart of
``repro.core.compression.policy``): compressors that pick their operating
point per tensor or per round.

* ``size_adaptive`` routes by tensor size (the Hivemind heuristic): at or
  above ``threshold`` elements, stochastic 8-bit uniform quantization
  (int8 ``q8`` and the f32 ``scale``); below it, a saturating f16 cast.
  The branch is static in ``x.numel()``, so a plan's payload formats are
  known when it is built.
* ``adaptive_qsgd`` picks QSGD's level count each round from the vector's
  dispersion, ``s = clip(||x||_1 / (||x||_2 * var_target), 1, 127)``, on
  max-scaled norms, and sends ``s`` in the payload beside the norm.

Plain PyTorch, as the reference's is jnp.  For the convergence engine
both take per-row knobs on a (rows, dim) stack (``roundtrip_p``): the
routing threshold and the variance target are values there, so
``size_adaptive`` computes both reconstructions and selects per row.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register
from repro_torch.core.compression.quantization import knob

f32 = torch.float32


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=f32, device=like.device)


def _dither(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding of ``y`` to the integers below and above."""
    lv = torch.floor(y)
    return lv + (u < y - lv)


@register("size_adaptive")
@dataclass
class SizeAdaptive:
    """At least ``threshold`` elements: unbiased rounding of x / max|x| * 127
    to the int8 grid; fewer: f16, clipped to +-65504 (no inf on overflow)."""

    threshold: int = 65536  # elements (Hivemind routes at 2**16)
    unbiased: bool = False  # the f16 branch rounds deterministically
    reduce_mode: str = "none"
    NEEDS_NOISE = True
    BATCH_KNOBS = ("threshold",)

    def roundtrip_p(self, u, x, p):
        n = x.shape[1]
        big = n >= knob(p, "threshold", self.threshold, x)
        scale = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-30)
        q8 = _dither(u, x / scale * 127.0) / 127.0 * scale
        half = torch.clamp(x, -65504.0, 65504.0).to(torch.float16).to(f32)
        bits = torch.where(big, n * 8.0 + 32, n * 16.0)[:, 0]
        return torch.where(big, q8, half), bits

    def compress(self, u, x, out=None) -> Compressed:
        if x.numel() >= self.threshold:
            scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-30)
            q8 = _dither(u, x / scale * _scalar(127.0, x))  # in [-127, 127]
            return Compressed({"q8": q8.to(torch.int8), "scale": scale.reshape(1)}, x.numel())
        return Compressed({"half": torch.clamp(x, -65504.0, 65504.0).to(torch.float16)},
                          x.numel())

    def decompress(self, c) -> torch.Tensor:
        if "q8" in c.payload:
            q8 = c.payload["q8"]
            return q8.to(f32) / _scalar(127.0, q8) * c.payload["scale"][0]
        return c.payload["half"].to(f32)

    def wire_bits(self, n) -> float:
        return n * 8.0 + 32 if n >= self.threshold else n * 16.0


@register("adaptive_qsgd")
@dataclass
class AdaptiveQSGD:
    """QSGD whose level count follows the vector's dispersion each round:
    the relative variance of s-level dithering is about ||x||_1 / (s
    ||x||_2), so s = clip(||x||_1 / (||x||_2 var_target), 1, 127)."""

    var_target: float = 1.0  # target relative quantization variance
    unbiased: bool = True
    reduce_mode: str = "none"
    BATCH_KNOBS = ("var_target",)
    RUNTIME_KNOBS = ("var_target",)
    NEEDS_NOISE = True

    def roundtrip_p(self, u, x, p):
        vt = knob(p, "var_target", self.var_target, x)
        amax = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-30)
        xs = x / amax
        n2 = torch.linalg.vector_norm(xs, dim=-1, keepdim=True)
        norm = torch.clamp_min(n2 * amax, 1e-30)
        s = torch.clamp(torch.abs(xs).sum(-1, keepdim=True) / torch.clamp_min(n2, 1e-30) / vt,
                        1.0, 127.0)
        lv = _dither(u, torch.abs(x) / norm * s)
        # int8 code + norm + s: the wire format does not depend on s
        bits = torch.full((x.shape[0],), x.shape[1] * 8.0 + 64, dtype=f32, device=x.device)
        return torch.sign(x) * lv / s * norm, bits

    def _check(self) -> dict:
        if self.var_target <= 0:
            raise ValueError(f"var_target must be > 0, got {self.var_target!r}")
        return {"var_target": self.var_target}

    def batch_params(self, dim: int) -> dict:
        return self._check()

    def runtime_params(self) -> dict:
        return self._check()

    @staticmethod
    def _levels(x, vt) -> tuple[torch.Tensor, torch.Tensor]:
        # max-scaled norms: ||x||^2 overflows f32 past ~1e19 per coordinate
        amax = torch.clamp_min(torch.max(torch.abs(x)), 1e-30)
        xs = x / amax
        n2 = torch.linalg.vector_norm(xs)
        norm = torch.clamp_min(n2 * amax, 1e-30)
        s = torch.clamp(torch.sum(torch.abs(xs)) / torch.clamp_min(n2, 1e-30) / vt, 1.0, 127.0)
        return s, norm

    def compress_p(self, u, x, p, out=None) -> Compressed:
        vt = _scalar((p or {}).get("var_target", self.var_target), x)
        s, norm = self._levels(x, vt)
        lv = _dither(u, torch.abs(x) / norm * s)
        code = (torch.sign(x) * lv).to(torch.int8)  # |l| <= ceil(y) <= s <= 127
        return Compressed({"code": code, "norm": norm.reshape(1), "s": s.reshape(1)},
                          x.numel())

    def decompress_p(self, c, p) -> torch.Tensor:
        return c.payload["code"].to(f32) / c.payload["s"][0] * c.payload["norm"][0]

    def compress(self, u, x, out=None) -> Compressed:
        return self.compress_p(u, x, {}, out=out)

    def decompress(self, c) -> torch.Tensor:
        return self.decompress_p(c, {})

    def wire_bits(self, n) -> float:
        return n * 8.0 + 64
