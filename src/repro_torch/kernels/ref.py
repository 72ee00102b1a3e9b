"""Plain PyTorch versions of the port's kernels.

Each function repeats its kernel's arithmetic in the kernel's order, one
f32 rounding per operation (``|x| * inv * levels``, not the reference
oracle's ``|x| / norm * levels``), so on the card a kernel and its plain
version agree bit for bit on codes.  Scalars arrive as 0-dim tensors on the
data's device: a Python-float divisor would let PyTorch's CUDA division
turn ``a / s`` into ``a * (1/s)``, which rounds differently.

These are the CPU path of ``repro_torch.kernels.ops`` and the yardstick the
kernels are held to on the card; they are not a fallback for CUDA tensors.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def qsgd_codes(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
               levels: torch.Tensor) -> torch.Tensor:
    """QSGD dither codes ``sign(x) * (floor(y) + [u < y - floor(y)])`` with
    ``y = |x| * inv * levels``, as int8."""
    y = torch.abs(x) * inv * levels
    lv = torch.floor(y)
    lv = lv + (u < (y - lv)).to(f32)
    return (torch.sign(x) * lv).to(torch.int8)


def qsgd_ef(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
            levels: torch.Tensor, decay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused error feedback + QSGD: ``a = e * decay + g``; code = Q(a);
    ``e' = a - code / levels / max(inv, 1e-38)``."""
    a = e * decay
    a = a + g
    y = torch.abs(a) * inv * levels
    lv = torch.floor(y)
    lv = lv + (u < (y - lv)).to(f32)
    code = torch.sign(a) * lv
    deq = code / levels / torch.clamp_min(inv, 1e-38)
    return code.to(torch.int8), a - deq


def int8_acc(codes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Widening ``sum_w weights[w] * codes[w]`` over a (W, n) int8 stack,
    accumulated in f32 in worker order."""
    acc = torch.zeros(codes.shape[1], dtype=f32, device=codes.device)
    for w in range(codes.shape[0]):
        acc = acc + weights[w] * codes[w].to(f32)
    return acc
