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


def qsgd_codes_rows(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                    levels: torch.Tensor) -> torch.Tensor:
    """:func:`qsgd_codes` of a (rows, n) stack, with ``inv`` and ``levels``
    (rows,) broadcast along each row."""
    return qsgd_codes(x, u, inv[:, None], levels[:, None])


def qsgd_ef_rows(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                 levels: torch.Tensor, decay: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`qsgd_ef` of a (rows, n) stack, with ``inv`` and ``levels``
    (rows,) broadcast along each row and one ``decay``."""
    return qsgd_ef(g, e, u, inv[:, None], levels[:, None], decay)


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


def terngrad_codes_rows(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """:func:`terngrad_codes` of a (rows, n) stack, with ``inv`` (rows,)
    broadcast along each row."""
    return terngrad_codes(x, u, inv[:, None])


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


#: floor of the log2 decay: a w that underflowed to 0 (or any w below
#: 2**-100) decays by 2**-100 per step, so no -inf - -inf reaches an exp2
WKV6_LOG2_FLOOR = -100.0


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, s0: torch.Tensor, *, chunk: int = 32, sub: int = 16
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked WKV6 of kernel ``wkv6``'s prefill path, in plain PyTorch:
    the same function as :func:`wkv6` (same arguments and results), in the
    kernel's arithmetic.  Used by the tests and ``chip_smoke.py``; the kernel
    cannot run on a CPU.

    Per channel ``a = max(log2 w, WKV6_LOG2_FLOOR)``, summed within each
    sub-chunk of ``sub`` steps: ``c`` inclusive, ``cp`` exclusive, ``T`` the
    sub-chunk's total.  Per chunk of ``chunk`` steps (a multiple of ``sub``;
    the ragged tail is zero-padded with ``a = 0``), for sub-chunk q:

    * state term ``(r * 2**cp) @ (2**B_q * S)`` with ``B_q`` the totals of
      the sub-chunks before q in the chunk, S the chunk's starting state;
    * off-diagonal blocks p < q, factored through the last step of p:
      ``(r_q * 2**(cp_q + T_{p+1} + ... + T_{q-1})) @ (k_p * 2**(T_p - c_p))^T
      @ v_p``;
    * the diagonal block elementwise, by running products of the decay
      floored at ``2**WKV6_LOG2_FLOOR``: ``A[t, s] = sum_i r_t k_s
      prod_{s < tau < t} max(w_tau, 2**-100)`` for s < t and ``A[t, t] =
      sum_i r_t u k_t``, then ``A @ v_q``;
    * the state carried sub-chunk by sub-chunk: ``S <- 2**T_q * S + (k_q *
      2**(T_q - c_q))^T @ v_q``.

    Every exponent is <= 0, so nothing overflows whatever the decay."""
    if chunk % sub:
        raise ValueError(f"wkv6_chunked: chunk {chunk} must be a multiple of sub {sub}")
    B, S, H, hd = r.shape
    r, k, v = (t.to(f32).permute(0, 2, 1, 3) for t in (r, k, v))
    w = w.to(f32).permute(0, 2, 1, 3)
    a = torch.clamp_min(torch.log2(w), WKV6_LOG2_FLOOR)
    w = torch.clamp_min(w, 2.0 ** WKV6_LOG2_FLOOR)
    u = u.to(f32)
    pad = (-S) % chunk
    if pad:
        r, k, v, a = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (r, k, v, a))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    state = s0.to(f32).clone()
    ys = []
    for c0 in range(0, S + pad, chunk):
        subs = []
        for q0 in range(c0, c0 + chunk, sub):
            rq, kq, vq, aq, wq = (t[:, :, q0:q0 + sub] for t in (r, k, v, a, w))
            c = torch.cumsum(aq, dim=2)
            cp = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], 2)
            T = c[:, :, -1]
            subs.append(dict(r=rq * torch.exp2(cp), k=kq * torch.exp2(T[:, :, None] - c), v=vq,
                             T=T, rr=rq, kk=kq, w=wq))
        start = state
        Bq = torch.zeros_like(subs[0]["T"])
        for q, sq in enumerate(subs):
            y = sq["r"] @ (torch.exp2(Bq)[..., None] * start)
            for p in range(q):
                mid = torch.zeros_like(Bq)
                for m in range(p + 1, q):
                    mid = mid + subs[m]["T"]
                y = y + ((sq["r"] * torch.exp2(mid)[:, :, None]) @ subs[p]["k"].transpose(-1, -2)
                         ) @ subs[p]["v"]
            A = torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", sq["rr"], u, sq["kk"]))
            run = torch.ones_like(sq["kk"])  # run[s] = prod_{s < tau < t} w_tau, for s < t
            for t in range(1, sub):
                run[:, :, :t] *= sq["w"][:, :, t - 1:t]
                run[:, :, t - 1] = 1.0
                A[:, :, t, :t] = torch.einsum("bhi,bhsi,bhsi->bhs", sq["rr"][:, :, t],
                                              sq["kk"][:, :, :t], run[:, :, :t])
            ys.append(y + A @ sq["v"])
            Bq = Bq + sq["T"]
        for sq in subs:
            state = torch.exp2(sq["T"])[..., None] * state + sq["k"].transpose(-1, -2) @ sq["v"]
    y = torch.cat(ys, dim=2)[:, :, :S].permute(0, 2, 1, 3).contiguous()
    return y, state


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor,
                  dsT: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6` (kernel ``wkv6_bwd``'s plain version), a
    reverse loop over time in the kernel's arithmetic.  Arguments as
    :func:`wkv6`, plus ``dy`` (B, S, H, hd) and ``dsT`` (B, H, hd, hd; None:
    zero), all widened to f32 -> (dr, dk, dv, dw (B, S, H, hd), du (H, hd),
    ds0 (B, H, hd, hd)), f32.  With P_t the state before step t and D the
    gradient of the state after it (dsT at t = S - 1):

    * ``dr_t = P_t dy_t + u k_t (v_t . dy_t)``, ``dk_t = D v_t + r_t u (v_t .
      dy_t)``, ``dv_t = D^T k_t + (sum_i r_t u k_t) dy_t``, ``dw_t[i] =
      sum_j D[i, j] P_t[i, j]``, ``du += r_t k_t (v_t . dy_t)``;
    * then ``D <- w_t D + r_t dy_t^T``, which is ds0 after step 0.

    The states P_t are rebuilt forward (``w_t P_t + k_t v_t^T``), so no
    step divides by w: a decay that underflowed to 0 is safe."""
    r, k, v, w, dy = (t.to(f32) for t in (r, k, v, w, dy))
    u = u.to(f32)
    states = [s0.to(f32)]
    for t in range(r.shape[1] - 1):
        states.append(w[:, t, :, :, None] * states[-1] + k[:, t, :, :, None] * v[:, t, :, None, :])
    D = torch.zeros_like(states[0]) if dsT is None else dsT.to(f32).clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, 0])
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dyt = (x[:, t] for x in (r, k, v, w, dy))
        P = states[t]
        vdy = (vt * dyt).sum(-1, keepdim=True)
        ruk = (rt * u * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", P, dyt) + u * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", D, vt) + rt * u * vdy
        dv[:, t] = torch.einsum("bhij,bhi->bhj", D, kt) + ruk * dyt
        dw[:, t] = (D * P).sum(-1)
        du = du + rt * kt * vdy
        D = wt[..., None] * D + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), D
