"""Shape plan and parameter definitions (counterpart of
``repro.models.sharding``).

The port runs one model replica per card, so only the model-axis size 1 of
the reference's plan is exercised; ``make_plan`` keeps the padding rules
(vocab padded to a multiple of 128, heads to the axis size) so shapes match
the reference's at msize 1.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.tree import flatten_with_paths, tree_map, unflatten_like


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShapePlan:
    """Padded/global dimensions for one (config, model-axis size)."""

    msize: int
    d: int
    H: int  # padded q heads
    KV: int  # kv heads
    kv_sharded: bool
    hd: int
    Dff: int
    V: int  # padded vocab
    rwkv_heads: int  # padded rwkv heads
    rwkv_hd: int


def check_ported(cfg: ModelConfig) -> None:
    """Raise for model options the port does not run yet: the dense GQA
    family with standard RoPE (what qwen3-0.6b sets) and the attention-free
    RWKV6 family (``family="ssm"``, no attention, no RoPE), both without qkv
    bias, logits softcap or MoE.  Sliding windows are checked per sequence
    length in ``layers.attention``."""
    if cfg.family == "ssm":
        wanted = (("attn_kind", "none"), ("rope_type", "none"))
    elif cfg.family == "dense" and cfg.attn_kind == "gqa" and not cfg.kv_lora:
        wanted = (("rope_type", "rope"),)
    else:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA and RWKV6 families are ported")
    for field, default in (*wanted, ("qkv_bias", False), ("logits_softcap", 0.0),
                           ("moe", False)):
        if getattr(cfg, field) != default:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} is not ported yet")


def make_plan(cfg: ModelConfig, msize: int = 1) -> ShapePlan:
    check_ported(cfg)
    H = pad_to(cfg.n_heads, msize)
    if cfg.n_kv_heads == cfg.n_heads:
        KV, kv_sharded = H, True
    else:
        KV = cfg.n_kv_heads
        kv_sharded = KV % msize == 0 and cfg.n_heads % msize == 0
    if cfg.family == "ssm" and cfg.d_model % (cfg.rwkv_head_dim * msize):
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} does not split into heads "
                         f"of {cfg.rwkv_head_dim} over {msize}")
    return ShapePlan(
        msize=msize,
        d=cfg.d_model,
        H=H,
        KV=KV,
        kv_sharded=kv_sharded,
        hd=cfg.resolved_head_dim,
        Dff=pad_to(cfg.d_ff, msize),
        V=pad_to(cfg.vocab, 128 * msize),
        rwkv_heads=pad_to(cfg.d_model // cfg.rwkv_head_dim, msize),
        rwkv_hd=cfg.rwkv_head_dim,
    )


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 1.0


def stack_defs(defs: Any, n: int) -> Any:
    """Add a leading stacked-layer dimension to every def."""
    return tree_map(lambda d: dataclasses.replace(d, shape=(n, *d.shape)), defs)


def materialize(defs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Random parameters for a ParamDef tree, with the reference's init
    rules (normal with std scale/sqrt(shape[0]), "small" std 0.02, ones,
    zeros).  Draws come from ``generator`` in leaf order; they are not the
    reference's draws (carry those across with ``repro_torch.interop``)."""
    out = []
    for d in flatten_with_paths(defs).values():
        if d.init == "zeros":
            out.append(torch.zeros(d.shape, dtype=dtype, device=device))
        elif d.init == "ones":
            out.append(torch.ones(d.shape, dtype=dtype, device=device))
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(1, d.shape[-1])
            std = 0.02 if d.init == "small" else d.scale / math.sqrt(fan_in)
            w = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32)
            out.append((w * std).to(dtype))
    return unflatten_like(defs, out)
