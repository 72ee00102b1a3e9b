"""PowerSGD (Vogels et al., 2019): rank-r power-iteration compression
(counterpart of ``repro.core.compression.powersgd``).

PowerSGD is linear, so its factors aggregate with a plain sum: the wire per
step is r (a + b) f32 values per bucket whatever the worker count.  The
distributed round lives in ``repro_torch.core.aggregate`` (route
``powersgd``), with ``Q`` carried in the communication state, the same on
every worker:

    M   = a.reshape(a_rows, b_rows)       (zero-padded; a after EF)
    P   = orthonormalize(psum(M @ Q) / W)
    Q'  = psum(M^T @ P) / W
    M^  = P @ Q'^T;  e <- M - M^          (EF against the global M^)

The local ``compress``/``decompress`` pair here is the reference's
fidelity roundtrip.  Its initial ``Q`` comes from ``jax.random.key(7)`` in
the reference, which torch cannot draw, so it is an argument: ``q0``, or
a seeded torch draw when it is left out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register

f32 = torch.float32


def shape2d(n: int) -> tuple[int, int]:
    """Near-square factorization with padding: a x b >= n."""
    a = max(1, math.isqrt(n))
    return a, -(-n // a)


def orthonormalize(P: torch.Tensor) -> torch.Tensor:
    """Orthonormal column basis of P by reduced QR (Householder)."""
    return torch.linalg.qr(P.to(f32), mode="reduced").Q


def matmul_rows(v: torch.Tensor, Q: torch.Tensor, b: int) -> torch.Tensor:
    """``pad(v).reshape(a, b) @ Q`` without the padded copy: the full rows
    of v, then its short last row against the top of Q."""
    n, k = v.numel(), Q.shape[1]
    full = n // b
    out = v[:full * b].reshape(full, b) @ Q
    if full * b == n:
        return out
    return torch.cat([out, (v[full * b:] @ Q[:n - full * b]).reshape(1, k)])


def matmul_rows_t(v: torch.Tensor, P: torch.Tensor, b: int) -> torch.Tensor:
    """``pad(v).reshape(a, b).T @ P`` without the padded copy."""
    n = v.numel()
    full = n // b
    out = v[:full * b].reshape(full, b).T @ P[:full]
    if full * b < n:
        rem = n - full * b
        out[:rem] += torch.outer(v[full * b:], P[full])
    return out


@register("powersgd")
@dataclass
class PowerSGD:
    rank: int = 4
    unbiased: bool = False
    reduce_mode: str = "powersgd"

    def init_q(self, n: int, seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
        """A (b, rank) standard-normal initial Q from a torch generator
        seeded with ``seed``, the same on every worker (the reference
        draws it from ``jax.random.key(seed)``); shape-only on ``meta``."""
        _, b = shape2d(n)
        device = torch.device(device)
        if device.type == "meta":
            return torch.empty((b, self.rank), dtype=f32, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return torch.randn((b, self.rank), generator=gen, dtype=f32, device=device)

    def factor_shapes(self, n: int) -> tuple[tuple[int, int], tuple[int, int]]:
        a, b = shape2d(n)
        return (a, self.rank), (b, self.rank)

    def compress(self, u, x, out=None, q0: torch.Tensor | None = None) -> Compressed:
        """Two local power iterations from ``q0`` ((b, rank); default: the
        draw of ``init_q(n, 7)``).  ``u`` is unused."""
        n = x.numel()
        _, b = shape2d(n)
        Q = self.init_q(n, 7, x.device) if q0 is None else q0.to(f32)
        for _ in range(2):
            P = orthonormalize(matmul_rows(x, Q, b))
            Q = matmul_rows_t(x, P, b)
        return Compressed({"P": P, "Q": Q}, n)

    def decompress(self, c) -> torch.Tensor:
        return (c.payload["P"] @ c.payload["Q"].T).reshape(-1)[:c.n]

    def wire_bits(self, n) -> float:
        a, b = shape2d(n)
        return (a + b) * self.rank * 32.0
