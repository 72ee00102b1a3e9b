"""Compressors backed by the port's Hopper kernels (counterpart of
``repro.core.compression.kernels_backed``: ``qsgd_kernel``,
``terngrad_kernel`` and ``signsgd_packed``).

``levels`` is a runtime value: it reaches the kernels as a scalar
argument, so cells that differ only in levels share everything else.

The convergence engine calls them on a (rows, dim) stack, one row per
(cell, replica, worker): ``qsgd_kernel``'s ``roundtrip_p`` and fused
``roundtrip_ef_p`` launch the row-batched ``qsgd`` and ``qsgd_ef`` kernels
with per-row levels, ``terngrad_kernel``'s ``compress_decompress`` the
row-batched ``terngrad``, and ``signsgd_packed``'s ``sign_pack`` and
``sign_unpack`` over per-row-padded stacks: one launch per kernel per call,
however many rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register
from repro_torch.core.compression.quantization import knob
from repro_torch.kernels import ops


@register("qsgd_kernel")
@dataclass
class QSGDKernel:
    levels: int = 16
    unbiased: bool = True
    reduce_mode: str = "none"
    wire_reduce: str = "int8_acc"  # compressed-domain: int8 codes on the wire
    BATCH_KNOBS = ("levels",)
    RUNTIME_KNOBS = ("levels",)
    NEEDS_NOISE = True

    def _check(self):
        # the int8 wire format caps |code| at s — fail loudly, don't wrap
        if self.levels > 127:
            raise ValueError(f"qsgd_kernel levels={self.levels} exceeds the "
                             "int8 wire format (max 127)")
        return {"levels": self.levels}

    def runtime_params(self) -> dict:
        return self._check()

    def batch_params(self, dim: int) -> dict:
        return self._check()

    @staticmethod
    def _row_bits(n: int, lv: torch.Tensor) -> torch.Tensor:
        return n * (torch.log2(lv[:, 0]) + 1.0) + 32.0

    def roundtrip_p(self, u, x, p):
        """Row stack through kernel ``qsgd`` (one launch), levels per row."""
        lv = knob(p, "levels", self.levels, x)
        codes, norm = ops.qsgd_quantize_rows(x, u, lv[:, 0])
        return ops.qsgd_dequantize_rows(codes, norm, lv[:, 0]), self._row_bits(x.shape[1], lv)

    def roundtrip_ef_p(self, u, g, e, p):
        """Fused EF + quantize of a row stack through kernel ``qsgd_ef`` (one
        launch instead of three dense passes), levels per row."""
        lv = knob(p, "levels", self.levels, g)
        codes, norm, e_new = ops.qsgd_ef_fused_rows(g, e, u, lv[:, 0])
        return (ops.qsgd_dequantize_rows(codes, norm, lv[:, 0]), e_new,
                self._row_bits(g.shape[1], lv))

    def _levels(self, p) -> float:
        lv = (p or {}).get("levels", self.levels)
        if lv > 127:
            raise ValueError(f"qsgd_kernel levels={lv} exceeds the int8 wire format (max 127)")
        return float(lv)

    def compress_p(self, u, x, p, out=None) -> Compressed:
        """``out``: optional {"code": int8 (n,)} buffer for the codes."""
        codes, norm = ops.qsgd_quantize(x, u, self._levels(p),
                                        out=(out or {}).get("code"))
        return Compressed({"code": codes, "norm": norm}, x.numel())

    def decompress_p(self, c, p) -> torch.Tensor:
        return ops.qsgd_dequantize(c.payload["code"], c.payload["norm"], self._levels(p))

    def compress(self, u, x, out=None) -> Compressed:
        return self.compress_p(u, x, {}, out=out)

    def decompress(self, c) -> torch.Tensor:
        return self.decompress_p(c, {})

    def compress_ef_p(self, u, g, e, p, decay, out=None):
        """Fused EF+quantize returning the wire payload and the new residual:
        one kernel pass yields the int8 codes and ``e' = a - C(a)`` for
        ``a = e*decay + g``.  ``out`` may name {"code": ..., "e": ...}
        buffers; ``"e": e`` overwrites the residual in place."""
        out = out or {}
        codes, norm, e_new = ops.qsgd_ef_fused(g, e, u, self._levels(p), decay,
                                               codes_out=out.get("code"), e_out=out.get("e"))
        return Compressed({"code": codes, "norm": norm}, g.numel()), e_new

    def wire_bits(self, n) -> float:
        return n * (math.log2(self.levels) + 1) + 32


@register("terngrad_kernel")
@dataclass
class TernGradKernel:
    """TernGrad (Wen et al.) through kernel ``terngrad``: ternary codes
    ``sign(x) * [u < |x| / max|x|]`` and the scale ``max|x|``."""

    unbiased: bool = True
    reduce_mode: str = "none"
    wire_reduce: str = "tern_acc"  # compressed-domain: 2-bit packed wire
    NEEDS_NOISE = True

    def compress(self, u, x, out=None) -> Compressed:
        """``out``: optional {"tern": int8 (n,)} buffer for the codes."""
        tern, smax = ops.terngrad_quantize(x, u, out=(out or {}).get("tern"))
        return Compressed({"tern": tern, "scale": smax}, x.numel())

    def decompress(self, c) -> torch.Tensor:
        return c.payload["tern"].to(torch.float32) * c.payload["scale"][0]

    def compress_decompress(self, u, x) -> torch.Tensor:
        """Row stack through kernel ``terngrad`` (one launch)."""
        tern, smax = ops.terngrad_quantize_rows(x, u)
        return tern.to(torch.float32) * smax[:, None]

    def wire_bits(self, n) -> float:
        return n * 2.0 + 32


@register("signsgd_packed")
@dataclass
class SignSGDPacked:
    """SignSGD with true bit packing: 1 bit/element on the wire."""

    unbiased: bool = False
    reduce_mode: str = "none"
    wire_reduce: str = "sign_acc"  # compressed-domain: mean of +-1 votes

    def compress(self, u, x, out=None) -> Compressed:
        """``u`` is unused (deterministic); ``out``: optional {"packed":
        uint8 (sign_packed_bytes(n),)} buffer for the bitmap."""
        return Compressed({"packed": ops.sign_pack(x, out=(out or {}).get("packed"))},
                          x.numel())

    def decompress(self, c) -> torch.Tensor:
        return ops.sign_unpack(c.payload["packed"], c.n)

    def compress_decompress(self, u, x) -> torch.Tensor:
        """Row stack through kernels ``sign_pack`` and ``sign_unpack``."""
        return ops.sign_unpack_rows(ops.sign_pack_rows(x), x.shape[1])

    def wire_bits(self, n) -> float:
        return n * 1.0
