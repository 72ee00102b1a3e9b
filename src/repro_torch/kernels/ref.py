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


def _bit_shifts(device) -> torch.Tensor:
    """Bit k of a packed byte holds slot k: shifts 0..7 along the slot axis."""
    return torch.arange(8, dtype=torch.uint8, device=device).view(1, 8, 1)


def sign_pack(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Flat f32 (n,) -> (nbytes,) uint8 in the lane-interleaved layout: bit
    k of byte ``(r, l)`` is ``x[r*1024 + k*128 + l] >= 0``, the tail padded
    with +1.0 (pad bits 1)."""
    pad = torch.ones(nbytes * 8 - x.numel(), dtype=f32, device=x.device)
    bits = (torch.cat([x, pad]).view(-1, 8, 128) >= 0).to(torch.uint8)
    return (bits << _bit_shifts(x.device)).sum(1, dtype=torch.uint8).view(-1)


def sign_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`sign_pack`: the first n elements as +-1.0 f32."""
    rows = -(-n // 1024)
    bits = (packed[:rows * 128].view(-1, 1, 128) >> _bit_shifts(packed.device)) & 1
    return (bits.to(f32) * 2.0 - 1.0).view(-1)[:n]


def sign_vote(packed: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted vote ``sum_w weights[w] * (2*bit_w - 1)`` over a (W, bytes)
    stack of packed rows, accumulated in f32 in worker order."""
    acc = torch.zeros(n, dtype=f32, device=packed.device)
    for w in range(packed.shape[0]):
        acc = acc + weights[w] * sign_unpack(packed[w], n)
    return acc


def terngrad_codes(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """TernGrad codes ``sign(x) * [u < |x| * inv]`` as int8, with ``inv =
    1 / max|x|`` (a multiply by the reciprocal, as the kernel does)."""
    b = (u < torch.abs(x) * inv).to(f32)
    return (torch.sign(x) * b).to(torch.int8)


def _crumb_shifts(device) -> torch.Tensor:
    """Slot k of a packed byte sits at bits 2k..2k+1: shifts 0, 2, 4, 6."""
    return (2 * torch.arange(4, dtype=torch.uint8, device=device)).view(1, 4, 1)


def tern_pack(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Flat int8 (n,) -> (nbytes,) uint8 of 2-bit crumbs in the
    lane-interleaved layout: crumb k of byte ``(r, l)`` codes
    ``t[r*512 + k*128 + l]`` as ``[t != 0] | [t < 0] << 1`` (0 zero, 1 for
    +1, 3 for -1); the tail pads with 0."""
    pad = torch.zeros(nbytes * 4 - t.numel(), dtype=torch.int8, device=t.device)
    t3 = torch.cat([t, pad]).view(-1, 4, 128)
    code = (t3 != 0).to(torch.uint8) | ((t3 < 0).to(torch.uint8) << 1)
    return (code << _crumb_shifts(t.device)).sum(1, dtype=torch.uint8).view(-1)


def tern_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`tern_pack`: the first n elements as f32
    ``[crumb = 1] - [crumb = 3]`` (crumb 2 decodes to 0)."""
    rows = -(-n // 512)
    crumbs = (packed[:rows * 128].view(-1, 1, 128) >> _crumb_shifts(packed.device)) & 3
    return ((crumbs == 1).to(f32) - (crumbs == 3).to(f32)).view(-1)[:n]


def tern_acc(packed: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Weighted sum ``sum_w weights[w] * decode(packed[w])`` over a (W, bytes)
    stack of 2-bit rows, accumulated in f32 in worker order."""
    acc = torch.zeros(n, dtype=f32, device=packed.device)
    for w in range(packed.shape[0]):
        acc = acc + weights[w] * tern_unpack(packed[w], n)
    return acc


def int8_acc(codes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Widening ``sum_w weights[w] * codes[w]`` over a (W, n) int8 stack,
    accumulated in f32 in worker order."""
    acc = torch.zeros(codes.shape[1], dtype=f32, device=codes.device)
    for w in range(codes.shape[0]):
        acc = acc + weights[w] * codes[w].to(f32)
    return acc


def threshold(x: torch.Tensor, tau: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Threshold sparsification: ``where(|x| >= tau, x, +0.0)`` and the int32
    kept count of each ``block``-element block (the tail block counts only
    real elements)."""
    keep = torch.abs(x) >= tau
    nblk = -(-x.numel() // block)
    pad = torch.zeros(nblk * block - x.numel(), dtype=torch.int32, device=x.device)
    counts = torch.cat([keep.to(torch.int32), pad]).view(nblk, block).sum(1, dtype=torch.int32)
    return torch.where(keep, x, 0.0), counts


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
         s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6 (the reference's ``ref.wkv6_ref`` and
    ``rwkv.wkv_scan``), a loop over time: r, k, v, w (B, S, H, hd), u (H, hd),
    s0 (B, H, hd, hd), all widened to f32 -> (y (B, S, H, hd), sT (B, H, hd,
    hd)), with ``y_t = r_t (S + u kv)`` and ``S <- w_t S + kv``, each product
    and sum of S rounded on its own."""
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    u = u.to(f32)[..., :, None]
    state = s0.to(f32)
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + u * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state
