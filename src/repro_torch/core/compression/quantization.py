"""Quantization compressors (counterpart of
``repro.core.compression.quantization``): 1-bit SGD, TernGrad, QSGD,
SignSGD, Natural Compression and Natural Dithering.

The reference computes these in jnp, not in Pallas, so their faithful port
is plain PyTorch: no kernel of its own.  ``qsgd`` shares the int8
compressed wire of ``qsgd_kernel`` (kernel ``int8_acc`` reduces it); its
runtime payload carries the level count ``s`` beside the norm, as the
reference's does.  Scalars that divide are 0-dim tensors on the input's
device: on the card PyTorch divides by a host scalar as a multiply by its
reciprocal.

Each class also has its convergence-engine roundtrip on a (rows, dim)
stack, as the reference has one per worker under ``jax.vmap``:
``roundtrip_p(u, x, p)`` with per-row knob values where the reference
defines it (qsgd, terngrad, natural_dithering), else a row-stack
``compress_decompress(u, x)``; norms, maxima and sums run along dim=-1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register

f32 = torch.float32


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(v), dtype=f32, device=like.device)


def _sign8(x: torch.Tensor) -> torch.Tensor:
    """``where(x >= 0, 1, -1)`` as int8."""
    return (x >= 0).to(torch.int8) * 2 - 1


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.linalg.vector_norm(x), 1e-30)


def knob(p: dict, name: str, default, x: torch.Tensor) -> torch.Tensor:
    """Knob ``name`` of each row of the stack ``x`` as a (rows, 1) f32
    column: ``p[name]`` ((rows,)) when given, else ``default`` everywhere."""
    v = p.get(name)
    if v is None:
        return torch.full((x.shape[0], 1), float(default), dtype=f32, device=x.device)
    return v.to(device=x.device, dtype=f32).reshape(-1, 1)


def row_norm(x: torch.Tensor) -> torch.Tensor:
    """max(||row||_2, 1e-30) of each row, as a (rows, 1) column."""
    return torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-30)


def dither(u: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding: ``floor(y) + [u < y - floor(y)]``."""
    lv = torch.floor(y)
    return lv + (u < y - lv)


def _check_levels(name: str, levels) -> dict:
    # the int8 wire format caps |code| at s: fail loudly, don't wrap
    if levels > 127:
        raise ValueError(f"{name} levels={levels} exceeds the int8 wire format (max 127)")
    return {"levels": levels}


@register("onebit")
@dataclass
class OneBitSGD:
    """Seide et al.: one bit per element and the means of the non-negative
    and of the negative elements; biased, meant for error feedback."""

    unbiased: bool = False
    reduce_mode: str = "none"

    def compress(self, u, x, out=None) -> Compressed:
        """``u`` is unused (deterministic)."""
        pos = x >= 0
        npos = torch.clamp_min(pos.sum(), 1)
        nneg = torch.clamp_min((~pos).sum(), 1)
        zero = _scalar(0.0, x)
        mu_pos = torch.where(pos, x, zero).sum() / npos
        mu_neg = torch.where(pos, zero, x).sum() / nneg
        return Compressed({"bits": pos.to(torch.int8), "mu": torch.stack([mu_neg, mu_pos])},
                          x.numel())

    def decompress(self, c) -> torch.Tensor:
        mu = c.payload["mu"]
        return torch.where(c.payload["bits"] > 0, mu[1], mu[0])

    def compress_decompress(self, u, x) -> torch.Tensor:
        """Row stack: each row's two means, taken along the row."""
        pos = x >= 0
        npos = torch.clamp_min(pos.sum(-1, keepdim=True), 1)
        nneg = torch.clamp_min((~pos).sum(-1, keepdim=True), 1)
        mu_pos = torch.where(pos, x, 0.0).sum(-1, keepdim=True) / npos
        mu_neg = torch.where(pos, 0.0, x).sum(-1, keepdim=True) / nneg
        return torch.where(pos, mu_pos, mu_neg)

    def wire_bits(self, n) -> float:
        return n * 1.0 + 64


@register("terngrad")
@dataclass
class TernGrad:
    """Wen et al.: ternary {-1, 0, 1} * s with s = max|x| after optional
    clipping to ``clip_sigma`` population standard deviations; unbiased."""

    unbiased: bool = True
    reduce_mode: str = "none"
    clip_sigma: float = 0.0
    wire_reduce = "tern_acc"  # compressed-domain: 2-bit packed wire
    BATCH_KNOBS = ("clip_sigma",)
    #: clip_sigma only rescales values, so the (tern, scale) payload keeps
    #: its shape whatever its value
    RUNTIME_KNOBS = ("clip_sigma",)
    NEEDS_NOISE = True

    def roundtrip_p(self, u, x, p):
        cs = knob(p, "clip_sigma", self.clip_sigma, x)
        bound = cs * torch.std(x, dim=-1, correction=0, keepdim=True)
        x = torch.where(cs > 0, torch.minimum(torch.maximum(x, -bound), bound), x)
        s = torch.clamp_min(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1e-30)
        b = (u < torch.abs(x) / s).to(f32)
        bits = torch.full((x.shape[0],), x.shape[1] * 2.0 + 32, dtype=f32, device=x.device)
        return torch.sign(x) * b * s, bits

    def compress_p(self, u, x, p, out=None) -> Compressed:
        """``out``: optional {"tern": int8 (n,)} buffer for the codes."""
        cs = (p or {}).get("clip_sigma", self.clip_sigma)
        if cs > 0:
            bound = torch.std(x, correction=0) * cs  # jnp.std: the population std
            x = torch.clamp(x, -bound, bound)
        s = torch.clamp_min(torch.max(torch.abs(x)), 1e-30)
        # a division by the 0-dim device tensor s, as the reference divides
        b = (u < torch.abs(x) / s).to(torch.int8)
        tern = torch.sign(x).to(torch.int8) * b
        dst = (out or {}).get("tern")
        if dst is not None:
            tern = dst.copy_(tern)
        return Compressed({"tern": tern, "scale": s.reshape(1)}, x.numel())

    def compress(self, u, x, out=None) -> Compressed:
        return self.compress_p(u, x, {}, out=out)

    def decompress(self, c) -> torch.Tensor:
        return c.payload["tern"].to(f32) * c.payload["scale"][0]

    def wire_bits(self, n) -> float:
        return n * 2.0 + 32  # log2(3) rounded up to 2 bits


@register("qsgd")
@dataclass
class QSGD:
    """Alistarh et al.: stochastic dithering of |x| / ||x||_2 to s levels,
    int8 codes.  The plain twin of ``qsgd_kernel``: the same wire, and
    ``compress_p`` adds ``s`` to the payload so a receiver needs no side
    channel."""

    levels: int = 16  # s
    unbiased: bool = True
    reduce_mode: str = "none"
    wire_reduce = "int8_acc"  # compressed-domain: int8 codes on the wire
    BATCH_KNOBS = ("levels",)
    RUNTIME_KNOBS = ("levels",)
    NEEDS_NOISE = True

    def batch_params(self, dim: int) -> dict:
        return _check_levels("qsgd", self.levels)

    def roundtrip_p(self, u, x, p):
        """Equal to decompress(compress(...)) while |l| <= 127 (int8)."""
        s = knob(p, "levels", self.levels, x)
        norm = row_norm(x)
        lv = dither(u, torch.abs(x) / norm * s)
        bits = x.shape[1] * (torch.log2(s[:, 0]) + 1) + 32
        return torch.sign(x) * lv / s * norm, bits

    def runtime_params(self) -> dict:
        return _check_levels("qsgd", self.levels)

    def _codes(self, u, x, s, out) -> tuple[torch.Tensor, torch.Tensor]:
        norm = _norm(x)
        y = torch.abs(x) / norm * s
        lv = torch.floor(y)
        lv = lv + (u < y - lv)
        code = (torch.sign(x) * lv).to(torch.int8)  # |l| <= s <= 127
        dst = (out or {}).get("code")
        return (code if dst is None else dst.copy_(code)), norm

    def compress_p(self, u, x, p, out=None) -> Compressed:
        """``out``: optional {"code": int8 (n,)} buffer for the codes."""
        s = _scalar((p or {}).get("levels", self.levels), x)
        code, norm = self._codes(u, x, s, out)
        return Compressed({"code": code, "norm": norm.reshape(1), "s": s.reshape(1)},
                          x.numel())

    def decompress_p(self, c, p) -> torch.Tensor:
        code = c.payload["code"]
        s = (c.payload["s"][0] if "s" in c.payload
             else _scalar((p or {}).get("levels", self.levels), code))
        return code.to(f32) / s * c.payload["norm"][0]

    def compress(self, u, x, out=None) -> Compressed:
        code, norm = self._codes(u, x, _scalar(self.levels, x), out)
        return Compressed({"code": code, "norm": norm.reshape(1)}, x.numel())

    def decompress(self, c) -> torch.Tensor:
        return self.decompress_p(c, {})

    def wire_bits(self, n) -> float:
        return n * (math.log2(self.levels) + 1) + 32


@register("signsgd")
@dataclass
class SignSGD:
    """Bernstein et al.: +-1 int8 payloads aggregated by majority vote (an
    int8 psum of the signs, ties to +1) on the dense wire, or by the 1-bit
    packed vote on the compressed wire."""

    unbiased: bool = False
    reduce_mode: str = "majority"
    wire_reduce = "sign_vote"  # compressed-domain: 1-bit packed majority

    def compress(self, u, x, out=None) -> Compressed:
        """``u`` is unused (deterministic); ``out``: optional {"sign": int8
        (n,)} buffer."""
        sign = _sign8(x)
        dst = (out or {}).get("sign")
        if dst is not None:
            sign = dst.copy_(sign)
        return Compressed({"sign": sign}, x.numel())

    def decompress(self, c) -> torch.Tensor:
        return c.payload["sign"].to(f32)

    def compress_decompress(self, u, x) -> torch.Tensor:
        return (x >= 0).to(f32) * 2.0 - 1.0

    def wire_bits(self, n) -> float:
        return n * 1.0


@register("natural")
@dataclass
class NaturalCompression:
    """Horvath et al.: unbiased stochastic rounding of |x| to a power of
    two; the payload is an int8 exponent (-127: zero) and an int8 sign."""

    unbiased: bool = True
    reduce_mode: str = "none"
    NEEDS_NOISE = True

    def compress(self, u, x, out=None) -> Compressed:
        ax = torch.abs(x)
        e = torch.floor(torch.log2(torch.clamp_min(ax, 1e-38)))
        lo = torch.exp2(e)
        p_up = (ax - lo) / lo  # P(round up to 2^(e+1)) = (|x| - 2^e) / 2^e
        e = torch.where(u < p_up, e + 1, e)
        e = torch.where(ax < 1e-37, _scalar(-127.0, x), e)
        code = torch.clamp(e, -127, 127).to(torch.int8)
        return Compressed({"exp": code, "sign": _sign8(x)}, x.numel())

    def decompress(self, c) -> torch.Tensor:
        e = c.payload["exp"].to(f32)
        mag = torch.where(e <= -127, _scalar(0.0, e), torch.exp2(e))
        return c.payload["sign"].to(f32) * mag

    def compress_decompress(self, u, x) -> torch.Tensor:
        """Row stack (elementwise: the flat pair serves any shape)."""
        return self.decompress(self.compress(u, x))

    def wire_bits(self, n) -> float:
        return n * 9.0


@register("natural_dithering")
@dataclass
class NaturalDithering:
    """Horvath et al. section 5: QSGD with power-of-two levels: |x| / ||x||
    rounds unbiasedly between neighbouring powers of two down to
    2^-(L-1), and below that between 0 and 2^-(L-1).  The payload is the
    int8 exponent (-L: zero), the int8 sign and the norm; ``compress_p``
    adds ``L``, so ``levels`` is a runtime knob."""

    levels: int = 8  # L, the number of geometric levels
    unbiased: bool = True
    reduce_mode: str = "none"
    BATCH_KNOBS = ("levels",)
    RUNTIME_KNOBS = ("levels",)
    NEEDS_NOISE = True

    def roundtrip_p(self, u, x, p):
        L = knob(p, "levels", self.levels, x)
        norm = row_norm(x)
        y = torch.abs(x) / norm
        ymin = torch.exp2(-(L - 1))
        e = torch.ceil(torch.log2(torch.maximum(y, ymin)))
        e = torch.clamp_max(torch.maximum(e, -(L - 1)), 0.0)
        hi = torch.exp2(e)
        lo = hi / 2
        small = y < ymin
        p_hi = torch.where(small, y / ymin, (y - lo) / torch.clamp_min(hi - lo, 1e-30))
        code = torch.where(u < p_hi, e, torch.where(small, -L, e - 1))
        code = torch.clamp_max(torch.maximum(code, -L), 0.0)
        mag = torch.where(code <= -L, 0.0, torch.exp2(code))
        bits = x.shape[1] * (torch.log2(L[:, 0]) + 1) + 32
        return torch.sign(x) * mag * norm, bits

    @staticmethod
    def _codes(u, x, L, ymin, zero_code, norm):
        y = torch.abs(x) / norm
        e = torch.ceil(torch.log2(torch.maximum(y, ymin)))
        e = torch.clamp_max(torch.clamp_min(e, -(L - 1)), 0.0)
        hi = torch.exp2(e)
        lo = hi / 2
        small = y < ymin
        p_hi = torch.where(small, y / ymin, (y - lo) / torch.clamp_min(hi - lo, 1e-30))
        code = torch.where(u < p_hi, e, torch.where(small, zero_code, e - 1))
        return torch.clamp_max(torch.clamp_min(code, zero_code), 0.0).to(torch.int8)

    def compress_p(self, u, x, p, out=None) -> Compressed:
        L = _scalar((p or {}).get("levels", self.levels), x)
        norm = _norm(x)
        code = self._codes(u, x, L, torch.exp2(-(L - 1)), -L, norm)
        return Compressed({"exp": code, "sign": _sign8(x), "norm": norm.reshape(1),
                           "L": L.reshape(1)}, x.numel())

    def compress(self, u, x, out=None) -> Compressed:
        L, norm = self.levels, _norm(x)
        code = self._codes(u, x, _scalar(L, x), _scalar(2.0 ** -(L - 1), x), _scalar(-L, x),
                           norm)
        return Compressed({"exp": code, "sign": _sign8(x), "norm": norm.reshape(1)},
                          x.numel())

    @staticmethod
    def _decode(c, L) -> torch.Tensor:
        e = c.payload["exp"].to(f32)
        mag = torch.where(e <= -L, _scalar(0.0, e), torch.exp2(e))
        return c.payload["sign"].to(f32) * mag * c.payload["norm"][0]

    def decompress_p(self, c, p) -> torch.Tensor:
        return self._decode(c, c.payload["L"][0] if "L" in c.payload
                            else (p or {}).get("levels", self.levels))

    def decompress(self, c) -> torch.Tensor:
        return self._decode(c, self.levels)

    def wire_bits(self, n) -> float:
        return n * (math.log2(self.levels) + 1) + 32
