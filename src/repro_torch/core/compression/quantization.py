"""Quantization compressors (counterpart of
``repro.core.compression.quantization``; ``signsgd`` so far, the other
twins come with their slices).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register

f32 = torch.float32


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
