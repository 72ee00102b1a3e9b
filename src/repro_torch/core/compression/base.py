"""Compressor protocol and registry (counterpart of
``repro.core.compression.base``: ``Compressed``, ``register``,
``get_compressor``, ``runtime_knob_values``, ``runtime_fingerprint``, ``compress_p``,
``decompress_p``, and the convergence engine's half of the protocol:
``compress_decompress``, ``roundtrip_bits``, ``roundtrip_bits_ef``,
``measured_wire_bits``, ``batch_knobs``, ``batch_param_values``,
``shape_fingerprint``, ``structural_envelope``, ``merge_representative``).

The stochastic compressors take their uniform noise ``u`` as a tensor
rather than a PRNG key: torch's generators cannot reproduce jax's threefry
draws, and the caller decides where the noise comes from (a seeded
``torch.Generator`` on the card, or the reference's own draws in a test).
A compressor that draws noise says so with ``NEEDS_NOISE = True``; the
deterministic ones (the sign family) are handed ``u=None``, so no bucket-
sized draw is made for them.  A compressor whose draw is not shaped like
its input (``atomo_svd`` draws one value per singular value) says how many
it needs with ``noise_len(n)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

f32 = torch.float32


@dataclass
class Compressed:
    """Wire representation of one tensor/bucket."""

    payload: dict[str, torch.Tensor]
    n: int  # original element count

    def payload_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.payload.values())


def runtime_knobs(comp) -> tuple[str, ...]:
    """Knob names that may change per call without changing payload shapes."""
    return tuple(getattr(comp, "RUNTIME_KNOBS", ()))


def runtime_knob_values(comp) -> dict[str, float]:
    """Runtime knob values of one cell, keyed for ``compress_p``."""
    if comp is None:
        return {}
    fn = getattr(comp, "runtime_params", None)
    if fn is not None:
        return {k: float(v) for k, v in fn().items()}
    return {k: float(getattr(comp, k)) for k in runtime_knobs(comp)}


def runtime_fingerprint(comp) -> tuple:
    """The trainer-layer identity of a compressor: its class and every
    dataclass field that is not a runtime knob (payload-shaping knobs such
    as top-k's ratio are structural here).  Two cells whose compressors
    share it book the same wire."""
    if comp is None:
        return ("dense",)
    knobs = set(runtime_knobs(comp))
    return (type(comp).__name__,) + tuple((f.name, getattr(comp, f.name))
                                          for f in dataclasses.fields(comp)
                                          if f.name not in knobs)


def needs_noise(comp) -> bool:
    return bool(getattr(comp, "NEEDS_NOISE", False))


def noise_len(comp, n: int) -> int:
    """Uniform draws ``comp`` takes to compress ``n`` elements (n unless
    the compressor says otherwise)."""
    fn = getattr(comp, "noise_len", None)
    return n if fn is None else fn(n)


def compress_p(comp, u: torch.Tensor | None, x: torch.Tensor, p: dict | None,
               out: dict | None = None) -> Compressed:
    """Compress with runtime knob values ``p`` (baked values when empty)."""
    fn = getattr(comp, "compress_p", None)
    if fn is not None and p:
        return fn(u, x, p, out=out)
    return comp.compress(u, x, out=out)


def decompress_p(comp, c: Compressed, p: dict | None) -> torch.Tensor:
    fn = getattr(comp, "decompress_p", None)
    if fn is not None and p:
        return fn(c, p)
    return comp.decompress(c)


# ---------------------------------------------------------------------------
# The convergence engine's half (``repro_torch.core.simulate``): roundtrips
# of a ROW STACK.  ``x`` is (B, dim), one row per (cell, replica, worker);
# the noise ``u`` is (B, noise_len) (None for a deterministic compressor);
# each value knob in ``p`` is a (B,) f32 tensor, since the cells of one
# batch differ in their knob values.  Every reduction (norm, max, quantile,
# top-k) runs along dim=-1, never in a Python loop over rows.
#
# A compressor's knobs split into structural attributes (the class, and any
# field not in ``BATCH_KNOBS``: they key the class program, see
# ``shape_fingerprint``) and value knobs (``BATCH_KNOBS``), which reach
# ``roundtrip_p(u, x, p)`` per row.  A class without ``roundtrip_p`` has a
# row-stack ``compress_decompress(u, x)`` and an analytic ``wire_bits``.
# ---------------------------------------------------------------------------


def compress_decompress(comp, u: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """The row-stack roundtrip ``decompress(compress(x))`` of a compressor
    whose knobs are all structural."""
    fn = getattr(comp, "compress_decompress", None)
    if fn is None:
        raise TypeError(f"{type(comp).__name__} has neither roundtrip_p nor a row-stack "
                        "compress_decompress")
    return fn(u, x)


def measured_wire_bits(x_hat: torch.Tensor) -> torch.Tensor:
    """Realized wire bits of each row of a data-dependent sparse payload: 64
    bits (a 32-bit value and a 32-bit index) per transmitted coordinate,
    (B,) f32."""
    return torch.count_nonzero(x_hat, dim=-1).to(f32) * 64.0


def roundtrip_bits(comp, u: torch.Tensor | None, x: torch.Tensor, p: dict | None = None):
    """``(x_hat (B, dim), bits (B,))`` of a row stack with per-row knob
    values ``p``: the compressor's ``roundtrip_p`` when it has one, else
    :func:`compress_decompress` with the analytic ``wire_bits``, or the
    measured bits where the analytic size is NaN."""
    fn = getattr(comp, "roundtrip_p", None)
    if fn is not None:
        return fn(u, x, p or {})
    x_hat = compress_decompress(comp, u, x)
    wb = comp.wire_bits(x.shape[-1])
    if wb != wb:
        return x_hat, measured_wire_bits(x_hat)
    return x_hat, torch.full(x.shape[:-1], float(wb), dtype=f32, device=x.device)


def roundtrip_bits_ef(comp, u: torch.Tensor | None, g: torch.Tensor, e: torch.Tensor,
                      p: dict | None = None):
    """Error-feedback roundtrip of a row stack: ``(x_hat, e_new, bits)`` for
    ``a = g + e``.  A compressor's fused ``roundtrip_ef_p`` (one kernel pass
    for accumulate, quantize and residual) comes first; otherwise ``e' = a -
    C(a)`` around :func:`roundtrip_bits`."""
    fn = getattr(comp, "roundtrip_ef_p", None)
    if fn is not None:
        return fn(u, g, e, p or {})
    a = g + e
    x_hat, bits = roundtrip_bits(comp, u, a, p)
    return x_hat, a - x_hat, bits


def batch_knobs(comp) -> tuple[str, ...]:
    """Field names whose values reach the engine per row (not structural)."""
    return tuple(getattr(comp, "BATCH_KNOBS", ()))


def batch_param_values(comp, dim: int) -> dict[str, float]:
    """The knob values of one cell, keyed for ``roundtrip_p``: the class's
    ``batch_params(dim)`` when it derives them (top-k's element count), else
    the ``BATCH_KNOBS`` attributes verbatim."""
    if comp is None:
        return {}
    fn = getattr(comp, "batch_params", None)
    if fn is not None:
        return {k: float(v) for k, v in fn(dim).items()}
    return {k: float(getattr(comp, k)) for k in batch_knobs(comp)}


def shape_fingerprint(comp) -> tuple:
    """Hashable identity of the compressor's program structure: the class
    and every dataclass field that is not a batch knob.  Cells with equal
    fingerprints (and equal engine statics) share one class program."""
    if comp is None:
        return ("dense",)
    fn = getattr(comp, "shape_fingerprint", None)
    if fn is not None:
        return fn()
    knobs = set(batch_knobs(comp))
    static = tuple((f.name, getattr(comp, f.name)) for f in dataclasses.fields(comp)
                   if f.name not in knobs)
    return (type(comp).__name__,) + static


def structural_envelope(comp) -> tuple:
    """Knob values of a class representative that also size arrays
    (PowerSGD's factor width): part of the class program's key; () for
    everything else."""
    if comp is None:
        return ()
    fn = getattr(comp, "structural_envelope", None)
    return fn() if fn is not None else ()


def merge_representative(comps: list):
    """One instance whose structure serves every cell of a shape class: the
    first, unless the class widens an envelope (PowerSGD: the largest
    rank)."""
    rep = comps[0]
    if rep is None:
        return None
    fn = getattr(rep, "merge_representative", None)
    return fn(comps) if fn is not None else rep


_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_compressor(name: str, **kwargs) -> Any:
    if name in (None, "none"):
        return None
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_compressors() -> list[str]:
    return sorted(_REGISTRY)
