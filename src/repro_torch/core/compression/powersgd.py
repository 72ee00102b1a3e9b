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

The convergence engine's ``roundtrip_p`` runs that local roundtrip on a
(rows, dim) stack with a per-row rank: the factors are as wide as the
class's largest rank (``merge_representative``, ``structural_envelope``)
and the columns at or past a row's rank are zeroed after every
projection.  Householder QR's leading columns depend only on the input's
leading columns, so a masked wide program equals the narrow one; for that
the initial Q (:meth:`PowerSGD.init_q_cols`) draws each column from its own
seed, so a wide draw's first columns are the narrow draw.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from repro_torch.core.compression.base import Compressed, register
from repro_torch.core.compression.quantization import knob

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
    BATCH_KNOBS = ("rank",)

    def init_q_cols(self, n: int, seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
        """A (b, rank) standard-normal initial Q whose column c is drawn from
        a torch generator seeded ``seed * 1009 + c``: a draw of width R
        agrees with one of width r < R on its first r columns."""
        _, b = shape2d(n)
        device = torch.device(device)
        cols = []
        for c in range(self.rank):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 1009 + c)
            cols.append(torch.randn(b, generator=gen, dtype=f32, device=device))
        return torch.stack(cols, dim=1)

    def structural_envelope(self) -> tuple:
        return ("rank", self.rank)

    def merge_representative(self, comps: list) -> "PowerSGD":
        """The widest instance of the shape class: its (b, max rank) factors
        serve every cell; narrower ranks zero the trailing columns."""
        return dataclasses.replace(self, rank=max(c.rank for c in comps))

    def roundtrip_p(self, u, x, p):
        """Two local power iterations per row, rank per row (``u`` unused)."""
        r = knob(p, "rank", self.rank, x)
        rows, n = x.shape
        a, b = shape2d(n)
        colmask = (torch.arange(self.rank, device=x.device) < r)[:, None, :]  # (rows, 1, R)
        key = (n, str(x.device))
        q0 = self.__dict__.setdefault("_q0", {})
        if key not in q0:
            q0[key] = self.init_q_cols(n, 7, x.device)
        M = torch.nn.functional.pad(x, (0, a * b - n)).reshape(rows, a, b)
        Q = q0[key] * colmask
        for _ in range(2):
            P = orthonormalize(M @ Q) * colmask
            Q = (M.transpose(1, 2) @ P) * colmask
        out = (P @ Q.transpose(1, 2)).reshape(rows, a * b)[:, :n]
        return out, (a + b) * r[:, 0] * 32.0

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
