"""Flat-vector API over the port's kernels (counterpart of
``repro.kernels.ops``: ``qsgd_quantize``, ``qsgd_dequantize``,
``qsgd_ef_fused``, ``int8_weighted_sum``, ``sign_pack``, ``sign_unpack``,
``sign_vote``, ``terngrad_quantize``, ``tern_pack``, ``tern_acc``,
``threshold_sparsify``, ``wkv6``; ``wkv6`` differentiable through kernel
``wkv6_bwd``, two launches, ``wkv6_bwd_states`` and ``wkv6_bwd``, which have
no TPU counterpart), with the row-batched forms of the
quantizers that the convergence engine calls on a (rows, n) stack
(``*_rows``: the reference's ops under ``jax.vmap``, one launch per call).

The tensor norm and max are computed here, outside the kernels, as in the
reference;
``levels`` and ``decay`` are runtime scalars.  On a CUDA tensor each wrapper
launches its hand-written kernel (``csrc/*.cu``) on the current stream,
checks the returned ``cudaGetLastError()`` and counts the launch in
``LAUNCHES``; there is no fallback.  Off the card (CPU tensors, or the
shape-only ``meta`` device the trainer books its wire bytes on) it runs the
kernel's plain version from ``ref.py``; ``wkv6`` and ``wkv6_backward`` give
shapes alone on ``meta`` (their plain versions loop over time).  No padding to the TPU's
(rows, 128) tiles for the quantizers and the threshold: the kernels mask
their own tails.
The packed wires keep the reference's padded payloads byte for byte, so
payloads interchange between the packages: ``ceil(n/8192)*1024`` bytes for
the 1-bit sign wire, ``ceil(n/4096)*1024`` for the 2-bit ternary wire.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import LIBRARY, ROW_SIGNATURES, SHARED_SIGNATURES

f32 = torch.float32

#: launches per kernel since the last ``reset_launches()``
LAUNCHES: dict[str, int] = {"qsgd": 0, "qsgd_ef": 0, "int8_acc": 0, "sign_pack": 0,
                            "sign_unpack": 0, "sign_vote": 0, "terngrad": 0,
                            "tern_pack": 0, "tern_acc": 0, "threshold": 0, "wkv6": 0,
                            "wkv6_bwd_states": 0, "wkv6_bwd": 0}

#: elements per 1024-byte tile of the packed sign wire: the reference packs
#: (8 rows, 8 bits, 128 lanes) blocks, and pads the last one with +1.0
SIGN_TILE = 8 * 8 * 128
#: elements per 1024-byte tile of the packed ternary wire: (8 rows, 4 2-bit
#: slots, 128 lanes), the last one padded with 0
TERN_TILE = 8 * 4 * 128
#: elements per kept-count block of the threshold kernel: the reference's
#: (256, 128) tile
THRESH_BLOCK = 256 * 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device, filled there: a host-to-card
    copy (``torch.tensor(v, device=...)``) would wait for the card."""
    return torch.full((), float(v), dtype=f32, device=like.device)


def _check(t: torch.Tensor, dtype: torch.dtype, n: int, device: torch.device,
           what: str) -> None:
    """Every pointer handed to a kernel must be a contiguous tensor of the
    right type and size on the launch's device."""
    if t.dtype != dtype or t.numel() != n or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: need a contiguous {dtype} tensor of {n} elements on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"contiguous={t.is_contiguous()}")


def _launch(name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = LIBRARY.fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def _launch_rows(name: str, *args) -> None:
    """One launch of kernel ``name``'s row-batched entry point, counted under
    the kernel's name."""
    stream = torch.cuda.current_stream().cuda_stream
    err = LIBRARY.symbol(name, *ROW_SIGNATURES[name])(*args, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} (rows) failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def _launch_shared(name: str, *args) -> None:
    """One launch of ``name``, whose kernel lives in another launch's source
    (``SHARED_SIGNATURES``), counted under ``name``."""
    stream = torch.cuda.current_stream().cuda_stream
    source, symbol, argtypes = SHARED_SIGNATURES[name]
    err = LIBRARY.symbol(source, symbol, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def _check_stack(t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device,
                 what: str) -> None:
    """A row stack handed to a kernel: contiguous, of the right type and shape,
    on the launch's device."""
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{what}: need a contiguous {dtype} tensor of shape {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"contiguous={t.is_contiguous()}")


def _per_row(v, rows: int, like: torch.Tensor) -> torch.Tensor:
    """A (rows,) f32 tensor on ``like``'s device from a number or a tensor."""
    if not isinstance(v, torch.Tensor):
        return torch.full((rows,), float(v), dtype=f32, device=like.device)
    return v.to(device=like.device, dtype=f32).reshape(-1).expand(rows).contiguous()


def qsgd_codes_into(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor, levels: float,
                    out: torch.Tensor) -> None:
    """Kernel ``qsgd``: int8 codes of flat f32 ``x`` into ``out``."""
    n = x.numel()
    for t, dt, size, what in ((x, f32, n, "x"), (u, f32, n, "u"), (inv, f32, 1, "inv"),
                              (out, torch.int8, n, "codes")):
        _check(t, dt, size, x.device, what)
    if x.is_cuda:
        _launch("qsgd", x.data_ptr(), u.data_ptr(), inv.data_ptr(), float(levels),
                out.data_ptr(), n)
    else:
        out.copy_(ref.qsgd_codes(x, u, inv, _scalar(levels, x)))


def qsgd_ef_into(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                 levels: float, decay: float, codes: torch.Tensor, e_out: torch.Tensor) -> None:
    """Kernel ``qsgd_ef``: codes and the new residual (``e_out`` may be ``e``)."""
    n = g.numel()
    for t, dt, size, what in ((g, f32, n, "g"), (e, f32, n, "e"), (u, f32, n, "u"),
                              (inv, f32, 1, "inv"), (codes, torch.int8, n, "codes"),
                              (e_out, f32, n, "e_out")):
        _check(t, dt, size, g.device, what)
    if g.is_cuda:
        _launch("qsgd_ef", g.data_ptr(), e.data_ptr(), u.data_ptr(), inv.data_ptr(),
                float(levels), float(decay), codes.data_ptr(), e_out.data_ptr(), n)
    else:
        c, en = ref.qsgd_ef(g, e, u, inv, _scalar(levels, g), _scalar(decay, g))
        codes.copy_(c)
        e_out.copy_(en)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)


def qsgd_quantize(x: torch.Tensor, u: torch.Tensor, levels: float = 16, *,
                  out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat x, uniform noise u -> (codes int8 (n,), norm (1,) f32).
    ``out``: where to write the codes (e.g. a row of a gathered stack)."""
    x = x.reshape(-1).to(f32)
    norm = _norm(x)
    codes = torch.empty(x.numel(), dtype=torch.int8, device=x.device) if out is None else out
    qsgd_codes_into(x, u.reshape(-1).to(device=x.device, dtype=f32), torch.reciprocal(norm),
                    levels, codes)
    return codes, norm.reshape(1)


def qsgd_dequantize(codes: torch.Tensor, norm: torch.Tensor, levels: float = 16) -> torch.Tensor:
    """Inverse of qsgd_quantize / the codes half of qsgd_ef_fused."""
    return codes.to(f32) / _scalar(levels, codes) * norm[0]


def qsgd_ef_fused(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, levels: float = 16,
                  decay: float = 1.0, *, codes_out: torch.Tensor | None = None,
                  e_out: torch.Tensor | None = None):
    """Fused EF+quantize: returns (codes (n,) int8, norm (1,), e_new (n,)).
    ``codes_out``/``e_out`` name the output buffers; ``e_out=e`` updates the
    residual in place."""
    g = g.reshape(-1).to(f32)
    e = e.reshape(-1).to(f32)
    a_norm = _norm(e * _scalar(decay, e) + g)
    codes = (torch.empty(g.numel(), dtype=torch.int8, device=g.device)
             if codes_out is None else codes_out)
    e_new = torch.empty_like(g) if e_out is None else e_out
    qsgd_ef_into(g, e, u.reshape(-1).to(device=g.device, dtype=f32), torch.reciprocal(a_norm),
                 levels, decay, codes, e_new)
    return codes, a_norm.reshape(1), e_new


def qsgd_codes_rows_into(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                         levels: torch.Tensor, out: torch.Tensor) -> None:
    """Kernel ``qsgd`` on a (rows, n) stack: int8 codes into ``out``, each row
    with its own ``inv`` and ``levels`` ((rows,) f32)."""
    rows, n = x.shape
    for t, dt, shape, what in ((x, f32, (rows, n), "x"), (u, f32, (rows, n), "u"),
                               (inv, f32, (rows,), "inv"), (levels, f32, (rows,), "levels"),
                               (out, torch.int8, (rows, n), "codes")):
        _check_stack(t, dt, shape, x.device, what)
    if x.is_cuda:
        _launch_rows("qsgd", x.data_ptr(), u.data_ptr(), inv.data_ptr(), levels.data_ptr(),
                     out.data_ptr(), rows, n)
    else:
        out.copy_(ref.qsgd_codes_rows(x, u, inv, levels))


def qsgd_quantize_rows(x: torch.Tensor, u: torch.Tensor, levels
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, n) x and noise u, per-row ``levels`` ((rows,) tensor or a
    number) -> (codes int8 (rows, n), norm (rows,) f32): each row quantized
    as :func:`qsgd_quantize` quantizes a flat vector, in one launch."""
    x = x.to(f32).contiguous()
    rows = x.shape[0]
    norm = torch.clamp_min(torch.linalg.vector_norm(x, dim=-1), 1e-30)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    qsgd_codes_rows_into(x, u.to(device=x.device, dtype=f32).contiguous(),
                         torch.reciprocal(norm), _per_row(levels, rows, x), codes)
    return codes, norm


def qsgd_dequantize_rows(codes: torch.Tensor, norm: torch.Tensor, levels) -> torch.Tensor:
    """Inverse of :func:`qsgd_quantize_rows` / the codes half of
    :func:`qsgd_ef_fused_rows`: ``codes / levels * norm`` per row."""
    lv = _per_row(levels, codes.shape[0], codes)
    return codes.to(f32) / lv[:, None] * norm[:, None]


def qsgd_ef_rows_into(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                      levels: torch.Tensor, decay: float, codes: torch.Tensor,
                      e_out: torch.Tensor) -> None:
    """Kernel ``qsgd_ef`` on a (rows, n) stack: codes and the new residual
    (``e_out`` may be ``e``), each row with its own ``inv`` and ``levels``."""
    rows, n = g.shape
    for t, dt, shape, what in ((g, f32, (rows, n), "g"), (e, f32, (rows, n), "e"),
                               (u, f32, (rows, n), "u"), (inv, f32, (rows,), "inv"),
                               (levels, f32, (rows,), "levels"),
                               (codes, torch.int8, (rows, n), "codes"),
                               (e_out, f32, (rows, n), "e_out")):
        _check_stack(t, dt, shape, g.device, what)
    if g.is_cuda:
        _launch_rows("qsgd_ef", g.data_ptr(), e.data_ptr(), u.data_ptr(), inv.data_ptr(),
                     levels.data_ptr(), float(decay), codes.data_ptr(), e_out.data_ptr(),
                     rows, n)
    else:
        c, en = ref.qsgd_ef_rows(g, e, u, inv, levels, _scalar(decay, g))
        codes.copy_(c)
        e_out.copy_(en)


def qsgd_ef_fused_rows(g: torch.Tensor, e: torch.Tensor, u: torch.Tensor, levels,
                       decay: float = 1.0):
    """Fused EF+quantize of a (rows, n) stack, per-row ``levels``: returns
    (codes (rows, n) int8, norm (rows,), e_new (rows, n)), each row as
    :func:`qsgd_ef_fused` treats a flat vector, in one launch."""
    g = g.to(f32).contiguous()
    e = e.to(f32).contiguous()
    rows = g.shape[0]
    a_norm = torch.clamp_min(torch.linalg.vector_norm(e * _scalar(decay, e) + g, dim=-1), 1e-30)
    codes = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    e_new = torch.empty_like(g)
    qsgd_ef_rows_into(g, e, u.to(device=g.device, dtype=f32).contiguous(),
                      torch.reciprocal(a_norm), _per_row(levels, rows, g), decay, codes, e_new)
    return codes, a_norm, e_new


def int8_weighted_sum(codes: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Gathered int8 codes (W, n) + per-worker decode weights (W,) ->
    ``sum_w weights[w] * codes[w]`` as (n,) f32.  Rows may be padded
    (``codes.stride(0) >= n``); each row must be contiguous."""
    n_w, n = codes.shape
    if codes.dtype != torch.int8 or codes.stride(1) != 1 or codes.stride(0) < n:
        raise ValueError(f"codes: need int8 (W, n) with contiguous rows, got "
                         f"{codes.dtype} strides {codes.stride()}")
    weights = weights.to(device=codes.device, dtype=f32).contiguous()
    if weights.shape != (n_w,):
        raise ValueError(f"weights: need shape ({n_w},), got {tuple(weights.shape)}")
    if codes.is_cuda:
        if n_w > 8192:
            raise ValueError(f"int8_acc keeps the weights in shared memory: W={n_w} > 8192")
        out = torch.empty(n, dtype=f32, device=codes.device)
        _launch("int8_acc", codes.data_ptr(), codes.stride(0), weights.data_ptr(), n_w,
                out.data_ptr(), n)
        return out
    return ref.int8_acc(codes, weights)


def sign_packed_bytes(n: int) -> int:
    """Bytes of the padded 1-bit payload of n elements (the reference's
    ``ops.sign_pack`` length)."""
    return -(-n // SIGN_TILE) * (SIGN_TILE // 8)


def _rows_ok(row_bytes: int, n: int, per_row: int) -> bool:
    """A packed row covers n elements: whole 128-byte rows of ``per_row``
    elements each (1024 for sign bits, 512 for 2-bit crumbs), enough of them."""
    return row_bytes % 128 == 0 and row_bytes >= -(-n // per_row) * 128


def _gathered(packed: torch.Tensor, weights: torch.Tensor, n: int, per_row: int,
              kernel: str) -> torch.Tensor:
    """Check a gathered (W, bytes) stack of packed rows and its (W,) weights
    for ``kernel``; returns the weights as contiguous f32 on the stack's
    device.  Rows may be padded (``stride(0) >= bytes``); each row must be
    contiguous."""
    n_w, row_bytes = packed.shape
    if packed.dtype != torch.uint8 or packed.stride(1) != 1 or packed.stride(0) < row_bytes \
            or not _rows_ok(row_bytes, n, per_row):
        raise ValueError(f"packed: need uint8 (W, bytes) with contiguous rows of whole "
                         f"128-byte rows covering {n} elements, got {packed.dtype} "
                         f"{tuple(packed.shape)} strides {packed.stride()}")
    weights = weights.to(device=packed.device, dtype=f32).contiguous()
    if weights.shape != (n_w,):
        raise ValueError(f"weights: need shape ({n_w},), got {tuple(weights.shape)}")
    if packed.is_cuda and n_w > 8192:
        raise ValueError(f"{kernel} keeps the weights in shared memory: W={n_w} > 8192")
    return weights


def sign_pack(x: torch.Tensor, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Flat f32 (n,) -> the padded uint8 bitmap, ``sign_packed_bytes(n)``
    bytes, lane-interleaved: bit ``(e // 128) % 8`` of byte
    ``(e // 1024) * 128 + e % 128`` is ``x[e] >= 0``; pad bits are 1.
    ``out``: where to write the bytes (e.g. a row of the wire stack)."""
    x = x.reshape(-1).to(f32)
    n, nbytes = x.numel(), sign_packed_bytes(x.numel())
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    _check(out, torch.uint8, nbytes, x.device, "packed")
    if x.is_cuda:
        _launch("sign_pack", x.data_ptr(), n, out.data_ptr(), nbytes)
    else:
        out.copy_(ref.sign_pack(x, nbytes))
    return out


def sign_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`sign_pack` (same layout): the first n elements as
    +-1.0 f32."""
    if packed.dtype != torch.uint8 or packed.dim() != 1 or not packed.is_contiguous() \
            or not _rows_ok(packed.numel(), n, 1024):
        raise ValueError(f"packed: need a contiguous 1-D uint8 bitmap of whole 128-byte "
                         f"rows covering {n} elements, got {packed.dtype} "
                         f"{tuple(packed.shape)} contiguous={packed.is_contiguous()}")
    if packed.is_cuda:
        out = torch.empty(n, dtype=f32, device=packed.device)
        _launch("sign_unpack", packed.data_ptr(), out.data_ptr(), n)
        return out
    return ref.sign_unpack(packed, n)


def sign_vote(packed: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Gathered packed bitmaps (W, bytes) + per-worker vote weights (W,) ->
    weighted vote sums ``sum_w weights[w] * (2*bit - 1)`` as (n,) f32, decoded
    and accumulated in one pass.  Rows may be padded
    (``packed.stride(0) >= bytes``); each row must be contiguous."""
    weights = _gathered(packed, weights, n, 1024, "sign_vote")
    if packed.is_cuda:
        out = torch.empty(n, dtype=f32, device=packed.device)
        _launch("sign_vote", packed.data_ptr(), packed.stride(0), weights.data_ptr(),
                packed.shape[0], out.data_ptr(), n)
        return out
    return ref.sign_vote(packed, weights, n)


def terngrad_codes_into(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                        out: torch.Tensor) -> None:
    """Kernel ``terngrad``: int8 ternary codes of flat f32 ``x`` into ``out``."""
    n = x.numel()
    for t, dt, size, what in ((x, f32, n, "x"), (u, f32, n, "u"), (inv, f32, 1, "inv"),
                              (out, torch.int8, n, "tern")):
        _check(t, dt, size, x.device, what)
    if x.is_cuda:
        _launch("terngrad", x.data_ptr(), u.data_ptr(), inv.data_ptr(), out.data_ptr(), n)
    else:
        out.copy_(ref.terngrad_codes(x, u, inv))


def terngrad_quantize(x: torch.Tensor, u: torch.Tensor, *,
                      out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat x, uniform noise u -> (tern int8 (n,) in {-1, 0, 1}, smax (1,)
    f32) with ``smax = max(max|x|, 1e-30)``.  ``out``: where to write the
    codes."""
    x = x.reshape(-1).to(f32)
    smax = torch.clamp_min(torch.max(torch.abs(x)), 1e-30)
    tern = torch.empty(x.numel(), dtype=torch.int8, device=x.device) if out is None else out
    terngrad_codes_into(x, u.reshape(-1).to(device=x.device, dtype=f32), torch.reciprocal(smax),
                        tern)
    return tern, smax.reshape(1)


def terngrad_codes_rows_into(x: torch.Tensor, u: torch.Tensor, inv: torch.Tensor,
                             out: torch.Tensor) -> None:
    """Kernel ``terngrad`` on a (rows, n) stack: ternary codes into ``out``,
    each row with its own ``inv`` ((rows,) f32)."""
    rows, n = x.shape
    for t, dt, shape, what in ((x, f32, (rows, n), "x"), (u, f32, (rows, n), "u"),
                               (inv, f32, (rows,), "inv"), (out, torch.int8, (rows, n), "tern")):
        _check_stack(t, dt, shape, x.device, what)
    if x.is_cuda:
        _launch_rows("terngrad", x.data_ptr(), u.data_ptr(), inv.data_ptr(), out.data_ptr(),
                     rows, n)
    else:
        out.copy_(ref.terngrad_codes_rows(x, u, inv))


def terngrad_quantize_rows(x: torch.Tensor, u: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, n) x and noise u -> (tern int8 (rows, n), smax (rows,) f32):
    each row as :func:`terngrad_quantize` treats a flat vector, in one
    launch."""
    x = x.to(f32).contiguous()
    smax = torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-30)
    tern = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    terngrad_codes_rows_into(x, u.to(device=x.device, dtype=f32).contiguous(),
                             torch.reciprocal(smax), tern)
    return tern, smax


def sign_pack_rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) f32 -> (rows, ``sign_packed_bytes(n)``) uint8: each row's
    padded bitmap, as :func:`sign_pack` packs a flat vector, in one launch.
    Each row is padded with +1.0 to whole 1024-element byte-rows and the
    stack packed flat (row r's byte-rows follow row r-1's); the byte-rows a
    row's tile holds beyond its data are pad bits, 0xFF."""
    x = x.to(f32)
    rows, n = x.shape
    m = -(-n // 1024)  # byte-rows of 128 bytes holding a row's elements
    xp = torch.ones((rows, m * 1024), dtype=f32, device=x.device)
    xp[:, :n] = x
    packed = sign_pack(xp.view(-1))[:rows * m * 128].view(rows, m * 128)
    out = torch.full((rows, sign_packed_bytes(n)), 0xFF, dtype=torch.uint8, device=x.device)
    out[:, :m * 128] = packed
    return out


def sign_unpack_rows(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`sign_pack_rows`: (rows, bytes) -> (rows, n) +-1.0
    f32, in one launch over the byte-rows that hold the elements."""
    rows = packed.shape[0]
    m = -(-n // 1024)
    if packed.dim() != 2 or packed.dtype != torch.uint8 or packed.shape[1] < m * 128:
        raise ValueError(f"packed: need a uint8 (rows, bytes) stack covering {n} elements per "
                         f"row, got {packed.dtype} {tuple(packed.shape)}")
    head = packed[:, :m * 128].contiguous().view(-1)
    return sign_unpack(head, rows * m * 1024).view(rows, m * 1024)[:, :n]


def tern_packed_bytes(n: int) -> int:
    """Bytes of the padded 2-bit payload of n elements (the reference's
    ``ops.tern_pack`` length)."""
    return -(-n // TERN_TILE) * (TERN_TILE // 4)


def tern_pack(tern: torch.Tensor, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Flat int8 (n,) -> the padded uint8 payload, ``tern_packed_bytes(n)``
    bytes, lane-interleaved: bits ``2*((e // 128) % 4)`` and up of byte
    ``(e // 512) * 128 + e % 128`` hold ``[t != 0] | [t < 0] << 1`` of
    element e; pad crumbs are 0.  ``out``: where to write the bytes (e.g. a
    row of the wire stack)."""
    tern = tern.reshape(-1)
    n, nbytes = tern.numel(), tern_packed_bytes(tern.numel())
    _check(tern, torch.int8, n, tern.device, "tern")
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=tern.device)
    _check(out, torch.uint8, nbytes, tern.device, "packed")
    if tern.is_cuda:
        _launch("tern_pack", tern.data_ptr(), n, out.data_ptr(), nbytes)
    else:
        out.copy_(ref.tern_pack(tern, nbytes))
    return out


def tern_acc(packed: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Gathered 2-bit payloads (W, bytes) + per-worker weights (W,) (the
    ternary scales) -> ``sum_w weights[w] * decode(packed[w])`` as (n,) f32,
    decoded and accumulated in one pass.  Rows may be padded
    (``packed.stride(0) >= bytes``); each row must be contiguous."""
    weights = _gathered(packed, weights, n, 512, "tern_acc")
    if packed.is_cuda:
        out = torch.empty(n, dtype=f32, device=packed.device)
        _launch("tern_acc", packed.data_ptr(), packed.stride(0), weights.data_ptr(),
                packed.shape[0], out.data_ptr(), n)
        return out
    return ref.tern_acc(packed, weights, n)


def threshold_blocks(x: torch.Tensor, tau: torch.Tensor | float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``threshold``: flat f32 ``x`` -> (``where(|x| >= tau, x, +0.0)``
    (n,), the int32 kept count of each ``THRESH_BLOCK``-element block
    (ceil(n / THRESH_BLOCK),)).  ``tau`` is a one-element f32 tensor on x's
    device (the kernel reads it there) or a number.  The tail block counts
    only real elements: the reference's padded tile also counts its zero
    pads when tau <= 0."""
    x = x.reshape(-1).to(f32)
    n = x.numel()
    tau = _scalar(tau, x) if not isinstance(tau, torch.Tensor) else tau.reshape(-1)
    for t, dt, size, what in ((x, f32, n, "x"), (tau, f32, 1, "tau")):
        _check(t, dt, size, x.device, what)
    if not x.is_cuda:
        return ref.threshold(x, tau.reshape(()), THRESH_BLOCK)
    out = torch.empty(n, dtype=f32, device=x.device)
    counts = torch.empty(-(-n // THRESH_BLOCK), dtype=torch.int32, device=x.device)
    _launch("threshold", x.data_ptr(), tau.data_ptr(), out.data_ptr(), counts.data_ptr(), n)
    return out, counts


def threshold_sparsify(x: torch.Tensor, tau: torch.Tensor | float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat x -> (masked (n,), nnz int32 scalar), with the reference's
    ``nnz = sum(|masked| > 0)``: unlike the kept count, a kept +-0.0 (tau
    <= 0) is not counted."""
    masked, _ = threshold_blocks(x, tau)
    return masked, torch.sum(torch.abs(masked) > 0, dtype=torch.int32)


#: head widths the wkv6 kernel is instantiated for (the recurrent design
#: unrolls a state column into registers, the chunked one tiles hd by 16)
WKV6_HEAD_DIMS = (16, 32, 64, 80)
#: steps per chunk of wkv6's chunked design: a call with at least this many
#: steps (prefill) takes it, a shorter one (decode) the recurrent design
WKV6_CHUNK = 32


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel copies 16-byte units);
    an offset view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
         s0: torch.Tensor, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``wkv6``: the RWKV6 recurrence over (B, S, H, hd) r, k, v (bf16
    or f32, one type) and w (the decay), u (H, hd) and s0 (B, H, hd, hd),
    the last three taken as f32 (widening a bf16 u is exact) -> (y (B, S,
    H, hd) f32, sT (B, H, hd, hd) f32), read in the model's layout (no
    relayout copies).  On the card, S >= ``WKV6_CHUNK`` takes the chunked
    tensor-core design (sT within f32 rounding of the plain scan) and a
    shorter S the recurrent one (sT bitwise); one launch either way.
    ``chunk`` is the reference's TPU tile and is accepted for its
    signature: it changes nothing."""
    del chunk
    B, S, H, hd = r.shape
    if r.dtype not in (f32, torch.bfloat16) or k.dtype != r.dtype or v.dtype != r.dtype \
            or u.dtype not in (f32, torch.bfloat16) or S < 1:
        raise ValueError(f"wkv6: need r, k, v of one type (f32 or bf16), u f32 or bf16 and "
                         f"S >= 1, got {r.dtype} {k.dtype} {v.dtype}, u {u.dtype}, S={S}")
    for t, shape, what in ((k, r.shape, "k"), (v, r.shape, "v"), (w, r.shape, "w"),
                           (u, (H, hd), "u"), (s0, (B, H, hd, hd), "s0")):
        if tuple(t.shape) != tuple(shape) or t.device != r.device:
            raise ValueError(f"wkv6: {what} must be {tuple(shape)} on {r.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if not _on_card(r):
        return ref.wkv6(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        # the casts are recorded, so each gradient comes back in its input's type
        return WKV6Function.apply(r, k, v, w.to(f32), u.to(f32), s0.to(f32))
    return _wkv6_launch(r, k, v, w, u, s0, chunked=S >= WKV6_CHUNK)


def _on_card(t: torch.Tensor) -> bool:
    """wkv6's route: a CUDA tensor launches the kernels; a meta tensor (the
    trainer's shape-only trace of its wire) takes the same route with
    shape-only outputs, where the plain version would trace S steps a
    layer.  One function, so a CPU test can send the autograd route through
    the plain versions."""
    return t.is_cuda or t.is_meta


class WKV6Function(torch.autograd.Function):
    """``wkv6`` on CUDA tensors under autograd: forward kernel ``wkv6`` (the
    design ``ops.wkv6`` takes), backward kernel ``wkv6_bwd``.  w, u and s0
    arrive as f32; r, k, v keep their type, and so do their gradients."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _wkv6_launch(r, k, v, w, u, s0, chunked=r.shape[1] >= WKV6_CHUNK)

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=f32, device=r.device)
        dr, dk, dv, dw, du, ds0 = wkv6_backward(r, k, v, w, u, s0, dy, dsT)
        grads = (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, ds0)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


#: steps per chunk of kernel wkv6_bwd: its first launch writes one state of
#: each kind (P before a chunk, the gradient D after it) per chunk and head
WKV6_BWD_CHUNK = ref.WKV6_BWD_CHUNK


def _wkv6_bwd_checked(r, k, v, w, u, s0, dy, dsT, what: str):
    """Check wkv6_backward's arguments: shapes, devices and r, k, v's type."""
    B, S, H, hd = r.shape
    for t, shape, name in ((k, r.shape, "k"), (v, r.shape, "v"), (w, r.shape, "w"),
                           (dy, r.shape, "dy"), (u, (H, hd), "u"), (s0, (B, H, hd, hd), "s0"),
                           (dsT, (B, H, hd, hd), "dsT")):
        if t is not None and (tuple(t.shape) != tuple(shape) or t.device != r.device):
            raise ValueError(f"{what}: {name} must be {tuple(shape)} on {r.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if r.dtype not in (f32, torch.bfloat16) or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"{what}: need r, k, v of one type (f32 or bf16), got "
                         f"{r.dtype} {k.dtype} {v.dtype}")
    if r.is_cuda and hd not in WKV6_HEAD_DIMS:
        raise ValueError(f"{what}: head width {hd} not in the kernel's {WKV6_HEAD_DIMS}")


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, s0: torch.Tensor, dy: torch.Tensor,
                  dsT: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """Kernel ``wkv6_bwd``: the gradient of :func:`wkv6` -> (dr, dk, dv, dw
    (B, S, H, hd), du (H, hd), ds0 (B, H, hd, hd)), all f32, from ``dy`` (B,
    S, H, hd) and ``dsT`` (B, H, hd, hd; None: zero), both taken as f32, and
    :func:`wkv6`'s inputs.  Two launches: ``wkv6_bwd_states`` (the states
    at the chunk boundaries, :func:`wkv6_bwd_states`) and ``wkv6_bwd`` (one
    CTA per head and chunk).  The kernel writes du per (b, h, chunk); one
    ``torch.sum`` adds them, so the result is bitwise from run to run.  On a
    CPU tensor: ``ref.wkv6_backward``."""
    B, S, H, hd = r.shape
    _wkv6_bwd_checked(r, k, v, w, u, s0, dy, dsT, "wkv6_backward")
    if r.is_meta:
        return tuple(torch.empty(shape, dtype=f32, device=r.device)
                     for shape in (r.shape,) * 4 + ((H, hd), (B, H, hd, hd)))
    if not r.is_cuda:
        return ref.wkv6_backward(r, k, v, w, u, s0, dy, dsT)
    r, k, v = (_aligned(t) for t in (r, k, v))
    w, u, dy = (_aligned(t.to(f32)) for t in (w, u, dy))
    P, G, ds0 = wkv6_bwd_states(r, k, v, w, s0, dy, dsT)
    dr, dk, dv, dw, du_part = _wkv6_bwd_chunks(r, k, v, w, u, dy, P, G)
    return dr, dk, dv, dw, torch.sum(du_part, dim=(0, 2)), ds0


def wkv6_bwd_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    s0: torch.Tensor, dy: torch.Tensor, dsT: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``wkv6_bwd_states``, wkv6_backward's first: (P, D, ds0), P and
    D (B, H, C, hd, hd) with C = ceil(S / WKV6_BWD_CHUNK) the state before
    each chunk and the gradient of the state after it.  On a CPU tensor:
    ``ref.wkv6_bwd_states``."""
    B, S, H, hd = r.shape
    _wkv6_bwd_checked(r, k, v, w, None, s0, dy, dsT, "wkv6_bwd_states")
    if not r.is_cuda:
        return ref.wkv6_bwd_states(r, k, v, w, s0, dy, dsT, chunk=WKV6_BWD_CHUNK)
    r, k, v = (_aligned(t) for t in (r, k, v))  # the kernel copies 16-byte units
    w, dy = (_aligned(t.to(f32)) for t in (w, dy))
    s0 = s0.to(f32).contiguous()
    dsT = None if dsT is None else dsT.to(f32).contiguous()
    C = -(-S // WKV6_BWD_CHUNK)
    P, G = (torch.empty((B, H, C, hd, hd), dtype=f32, device=r.device) for _ in range(2))
    ds0 = torch.empty((B, H, hd, hd), dtype=f32, device=r.device)
    _launch_shared("wkv6_bwd_states", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   s0.data_ptr(), dy.data_ptr(), None if dsT is None else dsT.data_ptr(),
                   P.data_ptr(), G.data_ptr(), ds0.data_ptr(), B, S, H, hd,
                   int(r.dtype == torch.bfloat16), WKV6_BWD_CHUNK)
    return P, G, ds0


def _wkv6_bwd_chunks(r, k, v, w, u, dy, P, G) -> tuple[torch.Tensor, ...]:
    """Launch ``wkv6_bwd`` on checked, 16-byte aligned CUDA tensors and the
    boundary states of :func:`wkv6_bwd_states` -> (dr, dk, dv, dw, du's
    partials (B, H, C, hd))."""
    B, S, H, hd = r.shape
    C = P.shape[2]
    dr, dk, dv, dw = (torch.empty((B, S, H, hd), dtype=f32, device=r.device) for _ in range(4))
    du_part = torch.empty((B, H, C, hd), dtype=f32, device=r.device)
    _launch("wkv6_bwd", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            dy.data_ptr(), P.data_ptr(), G.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), B, S, H, hd,
            int(r.dtype == torch.bfloat16), WKV6_BWD_CHUNK)
    return dr, dk, dv, dw, du_part


def _wkv6_launch(r, k, v, w, u, s0, *, chunked: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel ``wkv6`` on checked CUDA tensors, through the
    chunked design or the recurrent one (``chip_smoke.py`` times both).
    Outputs carry no gradient, so a call that autograd would record is
    refused: such calls go through :class:`WKV6Function`."""
    B, S, H, hd = r.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, s0)):
        raise RuntimeError("wkv6: a kernel launch under autograd would drop the gradient; "
                           "call ops.wkv6, which routes it through WKV6Function")
    if r.is_meta:
        return (torch.empty((B, S, H, hd), dtype=f32, device=r.device),
                torch.empty((B, H, hd, hd), dtype=f32, device=r.device))
    if hd not in WKV6_HEAD_DIMS:
        raise ValueError(f"wkv6: head width {hd} not in the kernel's {WKV6_HEAD_DIMS}")
    r, k, v = (_aligned(t) for t in (r, k, v))
    w, u, s0 = (_aligned(t.to(f32)) for t in (w, u, s0))
    y = torch.empty((B, S, H, hd), dtype=f32, device=r.device)
    sT = torch.empty((B, H, hd, hd), dtype=f32, device=r.device)
    _launch("wkv6", r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), sT.data_ptr(), B, S, H, hd,
            int(r.dtype == torch.bfloat16), int(chunked))
    return y, sT


def wkv6_chunked_info(hd: int, bf16: bool) -> dict[str, int]:
    """Registers per thread, dynamic and static shared bytes per CTA and
    resident CTAs per SM of wkv6's chunked design, from the CUDA runtime."""
    out = (ctypes.c_int * 4)()
    err = LIBRARY.symbol("wkv6", "wkv6_chunked_info", (ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_void_p))(hd, int(bf16), out)
    if err != 0:
        raise RuntimeError(f"wkv6_chunked_info failed: cudaError {err}")
    return dict(zip(("registers", "dynamic_smem", "static_smem", "ctas_per_sm"), out))


def wkv6_bwd_info(hd: int, bf16: bool) -> dict[str, dict[str, int]]:
    """Registers per thread, dynamic and static shared bytes per CTA and
    resident CTAs per SM of wkv6_backward's two launches, from the CUDA
    runtime."""
    out = (ctypes.c_int * 8)()
    err = LIBRARY.symbol("wkv6_bwd", "wkv6_bwd_info", (ctypes.c_int, ctypes.c_int,
                                                       ctypes.c_void_p))(hd, int(bf16), out)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd_info failed: cudaError {err}")
    keys = ("registers", "dynamic_smem", "static_smem", "ctas_per_sm")
    return {"wkv6_bwd": dict(zip(keys, out[:4])), "wkv6_bwd_states": dict(zip(keys, out[4:]))}
