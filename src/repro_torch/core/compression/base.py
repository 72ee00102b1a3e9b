"""Compressor protocol and registry (counterpart of
``repro.core.compression.base``: ``Compressed``, ``register``,
``get_compressor``, ``runtime_knob_values``, ``compress_p``,
``decompress_p``).

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

from dataclasses import dataclass
from typing import Any, Callable

import torch


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
