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


#: steps per chunk of kernel wkv6_bwd (one boundary state of each kind per
#: chunk goes to device memory) and per sub-chunk inside a chunk
WKV6_BWD_CHUNK = 64
WKV6_BWD_SUB = 16


def _head_major(*ts: torch.Tensor, pad: int) -> list[torch.Tensor]:
    """(B, S, H, hd) -> (B, H, S + pad, hd) f32, zero-padded in time."""
    out = [t.to(f32).permute(0, 2, 1, 3) for t in ts]
    return [torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t for t in out]


def _running(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per channel, along dim -2 of (..., n, hd) decays: the product of the
    decays before each step (rho, 1 at the first step) and after it (sigma,
    1 at the last), each a running product of exact w: every factor is <= 1,
    so nothing overflows and nothing is divided."""
    n = w.shape[-2]
    rho, sig = torch.ones_like(w), torch.ones_like(w)
    for t in range(1, n):
        rho[..., t, :] = rho[..., t - 1, :] * w[..., t - 1, :]
        sig[..., n - 1 - t, :] = sig[..., n - t, :] * w[..., n - t, :]
    return rho, sig


def wkv6_bwd_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    s0: torch.Tensor, dy: torch.Tensor, dsT: torch.Tensor | None = None, *,
                    chunk: int = WKV6_BWD_CHUNK
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The first pass of kernel ``wkv6_bwd`` (launch ``wkv6_bwd_states``) in
    plain PyTorch: the states at the chunk boundaries.  Arguments as
    :func:`wkv6_backward` -> (P (B, H, C, hd, hd): the state before each
    chunk of ``chunk`` steps, P[:, :, 0] = s0; G (B, H, C, hd, hd): the
    gradient of the state after each chunk, G[:, :, -1] = dsT; ds0), C =
    ceil(S / chunk), all f32.  Per chunk, with E = prod w over the chunk,
    sigma and rho the running products of w after and before each step:
    ``P <- E * P + (k * sigma)^T v`` forward and ``G <- E * G + (r *
    rho)^T dy`` backward (the tail is padded with r = k = v = dy = 0, w =
    1, which leaves both unchanged)."""
    B, S, H, hd = r.shape
    C = -(-S // chunk)
    pad = C * chunk - S
    r, k, v, dy = _head_major(r, k, v, dy, pad=pad)
    w = w.to(f32).permute(0, 2, 1, 3)
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    P = torch.empty((B, H, C, hd, hd), dtype=f32, device=r.device)
    G = torch.empty_like(P)
    state = s0.to(f32)
    for c in range(C):
        P[:, :, c] = state
        sl = slice(c * chunk, (c + 1) * chunk)
        rho, sig = _running(w[:, :, sl])
        E = rho[:, :, -1] * w[:, :, sl][:, :, -1]
        state = E[..., None] * state + (k[:, :, sl] * sig).transpose(-1, -2) @ v[:, :, sl]
    state = torch.zeros_like(s0, dtype=f32) if dsT is None else dsT.to(f32)
    for c in reversed(range(C)):
        G[:, :, c] = state
        sl = slice(c * chunk, (c + 1) * chunk)
        rho, _ = _running(w[:, :, sl])
        E = rho[:, :, -1] * w[:, :, sl][:, :, -1]
        state = E[..., None] * state + (r[:, :, sl] * rho).transpose(-1, -2) @ dy[:, :, sl]
    return P, G, state


def wkv6_backward_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                          u: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor,
                          dsT: torch.Tensor | None = None, *, chunk: int = WKV6_BWD_CHUNK,
                          sub: int = WKV6_BWD_SUB) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6` in kernel ``wkv6_bwd``'s arithmetic, in
    plain PyTorch: the same function as :func:`wkv6_backward` (same
    arguments and results).  Used by the tests and ``chip_smoke.py``; the
    kernel cannot run on a CPU.

    :func:`wkv6_bwd_states` gives each chunk's starting state P and the
    gradient G of its final state.  Inside a chunk, G is carried backward
    sub-chunk by sub-chunk (``G <- E * G + (r * rho)^T dy``), then the
    sub-chunks are taken forward with P carried (``P <- E * P + (k *
    sigma)^T v``).  In a sub-chunk of ``sub`` steps, with P its starting
    state, G the gradient of its final state, rho / sigma the running
    products of w before / after each step and pi(s, t) = prod_{s < tau <
    t} w_tau:

    * ``M = dy v^T``, ``PD = dy P^T``, ``GV = v G^T`` (16 x 16 and 16 x hd
      products, no decay inside the sum);
    * ``dr_t = rho_t PD_t + sum_{s<t} pi(s, t) k_s M[t, s] + u k_t M[t, t]``;
    * ``dk_t = sigma_t GV_t + sum_{s>t} pi(t, s) r_s M[s, t] + r_t u M[t, t]``;
    * ``dv = (k * sigma) G + A^T dy`` with A the forward's intra-chunk
      scores, ``A[s, t] = sum_i r_s k_t pi(t, s)`` below the diagonal and
      ``sum_i r_t u k_t`` on it;
    * ``dw_t = rho_t sigma_t rowsum(P * G) + rho_t sum_{s>t} pi(t, s) r_s
      PD_s + sigma_t sum_{s<t} pi(s, t) k_s GV_s + sum_{s<t<s'} pi(s, t)
      pi(t, s') k_s r_s' M[s', s]``, the expansion of ``sum_j D_t[i, j]
      P_t[i, j]`` over the boundary states: no division by w anywhere, so
      w = 0 is exact;
    * ``du += sum_t r_t k_t M[t, t]``."""
    if chunk % sub:
        raise ValueError(f"wkv6_backward_chunked: chunk {chunk} must be a multiple of sub {sub}")
    B, S, H, hd = r.shape
    Pc, Gc, ds0 = wkv6_bwd_states(r, k, v, w, s0, dy, dsT, chunk=chunk)
    C = Pc.shape[2]
    pad = C * chunk - S
    r, k, v, dy = _head_major(r, k, v, dy, pad=pad)
    w = w.to(f32).permute(0, 2, 1, 3)
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    u = u.to(f32)
    lower = torch.tril(torch.ones(sub, sub, dtype=torch.bool, device=r.device), -1)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=f32, device=r.device)
    for c in range(C):
        subs = range(c * chunk, (c + 1) * chunk, sub)
        G = Gc[:, :, c]
        Gs = {}
        for q0 in reversed(subs):  # G at the end of each sub-chunk
            Gs[q0] = G
            sl = slice(q0, q0 + sub)
            rho, _ = _running(w[:, :, sl])
            E = rho[:, :, -1] * w[:, :, sl][:, :, -1]
            G = E[..., None] * G + (r[:, :, sl] * rho).transpose(-1, -2) @ dy[:, :, sl]
        P = Pc[:, :, c]
        for q0 in subs:
            sl = slice(q0, q0 + sub)
            rq, kq, vq, wq, dyq = (t[:, :, sl] for t in (r, k, v, w, dy))
            G = Gs[q0]
            rho, sig = _running(wq)
            # pi[t, s] = prod_{s < tau < t} w_tau for s < t, else 0
            pi = torch.zeros((B, H, sub, sub, hd), dtype=f32, device=r.device)
            for t in range(1, sub):
                pi[:, :, t, :t - 1] = pi[:, :, t - 1, :t - 1] * wq[:, :, t - 1, None]
                pi[:, :, t, t - 1] = 1.0
            M = dyq @ vq.transpose(-1, -2)
            PD = dyq @ P.transpose(-1, -2)
            GV = vq @ G.transpose(-1, -2)
            diag = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]
            Mlow = M * lower
            dr[:, :, sl] = (rho * PD + torch.einsum("btsi,bsi,bts->bti", pi.flatten(0, 1),
                                                    kq.flatten(0, 1), Mlow.flatten(0, 1)
                                                    ).view(B, H, sub, hd) + u[:, None] * kq * diag)
            dk[:, :, sl] = (sig * GV + torch.einsum("bsti,bsi,bst->bti", pi.flatten(0, 1),
                                                    rq.flatten(0, 1), Mlow.flatten(0, 1)
                                                    ).view(B, H, sub, hd) + rq * u[:, None] * diag)
            A = torch.einsum("bhsi,bhti,bhsti->bhst", rq, kq, pi)
            A = A + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rq, u, kq))
            dv[:, :, sl] = (kq * sig) @ G + A.transpose(-1, -2) @ dyq
            left = pi * kq[:, :, None]          # [t, s]: pi(s, t) k_s, s < t
            right = pi * rq[:, :, :, None]      # [s', t]: pi(t, s') r_s', s' > t
            d = torch.einsum("bhtsi,bhpti,bhps->bhti", left, right, Mlow)
            b = torch.einsum("bhtsi,bhsi->bhti", left, GV)
            cc = torch.einsum("bhpti,bhpi->bhti", right, PD)
            rd = (P * G).sum(-1)[:, :, None]
            dw[:, :, sl] = rho * sig * rd + rho * cc + sig * b + d
            du = du + (rq * kq * diag).sum(2)
            E = rho[:, :, -1] * wq[:, :, -1]
            P = E[..., None] * P + (kq * sig).transpose(-1, -2) @ vq
    out = [t[:, :, :S].permute(0, 2, 1, 3).contiguous() for t in (dr, dk, dv, dw)]
    return (*out, du.sum(0), ds0)
