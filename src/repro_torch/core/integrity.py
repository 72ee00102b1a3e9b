"""Gradient-integrity fault injection and payload validation (counterpart of
``repro.core.integrity``), the shared vocabulary of the convergence engine
and the trainer for detect -> quarantine -> recover.

* **Injection** is sender-side and post-compression: the payload leaves the
  worker corrupted in its wire domain (f32 words on the dense path, int8
  codes and f32 scales or norms for the quantizers, packed uint8 words for
  the 1- and 2-bit wires).  The sender keeps its clean copy.
* **Validation** is receiver-side and uses only the redundancy the wire
  format has: finiteness and range of scales and norms, the range of int8
  codes, the illegal crumb of the 2-bit wire.  A 1-bit sign bitmap has no
  redundancy, so a flipped one is undetectable by construction.
* Every select is a ``torch.where`` whose predicate holds everywhere when no
  flag is set, so a cell at corruption rate 0 reproduces the clean one.

Kinds (structural; the rate is a value):

========  ==================================================================
kind      wire-domain effect
========  ==================================================================
nan       float payloads (dense words, scales, norms) become NaN
inf       float payloads become +Inf
spike     float magnitudes multiplied by ``SPIKE_FACTOR``
bitflip   f32 words get exponent bit 30 flipped; int8 codes and packed
          uint8 words are XORed with ``0x55``
========  ==================================================================

Plain torch throughout: the reference's versions are jnp and reach no
Pallas kernel.
"""

from __future__ import annotations

import torch

f32 = torch.float32

KINDS = ("nan", "inf", "spike", "bitflip")

#: magnitude multiplier of the "spike" fault
SPIKE_FACTOR = 1e8
#: receiver-side ceiling on |dense word|, scale and norm
VALID_MAX = 1e6

#: fold tag of the corruption draw in the reference's key chain ("corr"),
#: beside the churn mask's 0x6368
CORRUPT_FOLD = 0x636F72
#: fold tag of the churn mask draw ("ch")
MASK_FOLD = 0x6368


def _f32(v, device) -> torch.Tensor:
    """``v`` as f32 on ``device``; a number is filled there (a host-to-card
    copy would wait for the card's queue)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=f32)
    return torch.full((), float(v), dtype=f32, device=device)


def corruption_flag(u: torch.Tensor, rate, gate: torch.Tensor) -> torch.Tensor:
    """Per-worker corruption bit, 1.0 where the payload is corrupted this
    round: ``u`` is the worker's uniform corruption draw, ``gate`` its
    alive-and-in-window predicate (a dead worker sends nothing)."""
    return torch.where(gate & (u < _f32(rate, u.device)), 1.0, 0.0).to(f32)


def bitflip(x: torch.Tensor) -> torch.Tensor:
    """The ``bitflip`` fault without a flag: bit 30 (the top exponent bit)
    of every f32 word, or ``0x55`` XORed into every int8 / uint8 word."""
    if x.dtype == f32:
        return (x.view(torch.int32) ^ (1 << 30)).view(f32)
    if x.dtype in (torch.int8, torch.uint8):
        return x ^ 0x55
    raise TypeError(f"bitflip: no wire image for {x.dtype}")


def _flag(flag, like: torch.Tensor) -> torch.Tensor:
    return _f32(flag, like.device) > 0


def corrupt_dense(kind: str, x: torch.Tensor, flag) -> torch.Tensor:
    """Corrupt a dense float payload where ``flag`` (0/1, a scalar or a
    broadcastable tensor) is set."""
    x = x.to(f32)
    if kind == "nan":
        bad = torch.full_like(x, float("nan"))
    elif kind == "inf":
        bad = torch.full_like(x, float("inf"))
    elif kind == "spike":
        bad = x * SPIKE_FACTOR
    elif kind == "bitflip":
        bad = bitflip(x)
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return torch.where(_flag(flag, x), bad, x)


def corrupt_codes(kind: str, codes: torch.Tensor, flag) -> torch.Tensor:
    """Corrupt an integer payload (int8 codes, packed uint8 words): only
    ``bitflip`` has an integer image; the float-born faults live in the
    scales and norms beside the codes."""
    if kind != "bitflip":
        return codes
    return torch.where(_flag(flag, codes), bitflip(codes), codes)


def corrupt_payload(kind: str, payload: dict, flag) -> dict:
    """Corrupt a compressed payload dict: float leaves get the float fault,
    integer leaves the XOR fault; sparse ``indices`` stay (an addressing
    fault is out of scope, as in the reference)."""
    out = {}
    for k, v in payload.items():
        if v.is_floating_point():
            out[k] = corrupt_dense(kind, v, flag)
        elif k == "indices":
            out[k] = v
        else:
            out[k] = corrupt_codes(kind, v, flag)
    return out


def _reduce_all(ok: torch.Tensor, per_row: bool) -> torch.Tensor:
    if per_row:
        return torch.all(ok.reshape(ok.shape[0], -1), dim=1).to(f32)
    return torch.all(ok).to(f32)


def dense_valid(x: torch.Tensor, *, per_row: bool = False) -> torch.Tensor:
    """Every word finite and within ``VALID_MAX``: a 0/1 f32 scalar, or one
    per leading row with ``per_row``."""
    ok = torch.isfinite(x) & (torch.abs(x) <= VALID_MAX)
    return _reduce_all(ok, per_row)


def scale_valid(*scales: torch.Tensor) -> torch.Tensor:
    """Scales or norms (each (W,) or a scalar) finite and within range: the
    AND, as 0/1 f32."""
    ok = None
    for s in scales:
        s = _f32(s, scales[0].device if isinstance(scales[0], torch.Tensor) else "cpu")
        o = torch.isfinite(s) & (torch.abs(s) <= VALID_MAX)
        ok = o if ok is None else ok & o
    return ok.to(f32)


def code_valid(codes: torch.Tensor, bound, *, per_row: bool = False) -> torch.Tensor:
    """Every |code| within the quantizer's level bound (a scalar, or one
    per row (W,) with ``per_row``)."""
    mag = torch.abs(codes.to(f32))
    bound = _f32(bound, codes.device)
    if per_row and bound.dim() == 1:
        bound = bound.reshape((-1,) + (1,) * (codes.dim() - 1))
    return _reduce_all(mag <= bound, per_row)


def packed2_valid(words: torch.Tensor, *, per_row: bool = False) -> torch.Tensor:
    """The 2-bit ternary wire (crumbs 0 = zero, 1 = +1, 3 = -1): crumb 2 is
    not a legal code, so an XOR fault shows wherever it makes one."""
    w = words.to(torch.uint8)
    ok = None
    for shift in (0, 2, 4, 6):
        o = ((w >> shift) & 3) != 2
        ok = o if ok is None else ok & o
    return _reduce_all(ok, per_row)
