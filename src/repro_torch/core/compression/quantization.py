"""Quantization compressors (counterpart of
``repro.core.compression.quantization``; ``terngrad`` and ``signsgd`` so
far, the other twins come with their slices).

The reference computes these in jnp, not in Pallas, so their faithful port
is plain PyTorch: no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register

f32 = torch.float32


@register("terngrad")
@dataclass
class TernGrad:
    """Wen et al.: ternary {-1, 0, 1} * s with s = max|x| after optional
    clipping to ``clip_sigma`` population standard deviations; unbiased."""

    unbiased: bool = True
    reduce_mode: str = "none"
    clip_sigma: float = 0.0
    wire_reduce = "tern_acc"  # compressed-domain: 2-bit packed wire
    #: clip_sigma only rescales values, so the (tern, scale) payload keeps
    #: its shape whatever its value
    RUNTIME_KNOBS = ("clip_sigma",)
    NEEDS_NOISE = True

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
        sign = (x >= 0).to(torch.int8) * 2 - 1  # where(x >= 0, 1, -1), in int8
        dst = (out or {}).get("sign")
        if dst is not None:
            sign = dst.copy_(sign)
        return Compressed({"sign": sign}, x.numel())

    def decompress(self, c) -> torch.Tensor:
        return c.payload["sign"].to(f32)

    def wire_bits(self, n) -> float:
        return n * 1.0
