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
    E: int  # routed experts (a multiple of msize)
    Dff_e: int  # expert hidden
    Dff_shared: int  # shared-expert hidden, all shared experts together
    rwkv_heads: int  # padded rwkv heads
    rwkv_hd: int
    d_inner: int  # the SSM heads' inner width (hybrid)

    @property
    def E_l(self) -> int:
        return self.E // self.msize if self.E else 0


def check_ported(cfg: ModelConfig) -> None:
    """Raise for model options the port does not run.  Ported: the attention
    families (dense and MoE, GQA or MLA, standard, partial or M-RoPE, qkv
    bias, logits softcap, leading dense layers, sliding-window patterns),
    the attention-free RWKV6 family (``family="ssm"``: no attention, no
    RoPE), the hybrid family (hymba: GQA attention and Mamba heads side by
    side in every layer), the vision family (qwen2-vl: patch embeddings
    before the text, M-RoPE) and the audio encoder-decoder (seamless: frame
    embeddings through a non-causal encoder, cross-attention in every
    decoder block), both on dense GQA/MHA blocks."""
    if cfg.modality not in ("text", "vision", "audio"):
        raise NotImplementedError(f"{cfg.name}: modality {cfg.modality!r} is not ported")
    if cfg.is_encoder_decoder != (cfg.modality == "audio"):
        # the encoder reads the audio frames through frontend_proj, and only
        # the encoder-decoder draws frames
        raise NotImplementedError(f"{cfg.name}: is_encoder_decoder={cfg.is_encoder_decoder} "
                                  f"with modality {cfg.modality!r} is not ported")
    if cfg.family == "ssm":
        for field, want in (("attn_kind", "none"), ("rope_type", "none"), ("moe", False),
                            ("qkv_bias", False), ("logits_softcap", 0.0),
                            ("modality", "text")):
            if getattr(cfg, field) != want:
                raise NotImplementedError(
                    f"{cfg.name}: RWKV6 with {field}={getattr(cfg, field)!r} is not ported")
        return
    if cfg.family not in ("dense", "moe", "hybrid", "vlm", "audio"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported")
    if cfg.rope_type not in ("rope", "partial", "mrope"):
        raise NotImplementedError(f"{cfg.name}: rope_type={cfg.rope_type!r} is not ported")
    if cfg.rope_type == "mrope" and sum(cfg.mrope_sections) != cfg.resolved_head_dim // 2:
        raise ValueError(f"{cfg.name}: M-RoPE sections {cfg.mrope_sections} do not fill "
                         f"half of head_dim {cfg.resolved_head_dim}")
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.name}: attn_kind={cfg.attn_kind!r} is not ported")
    if cfg.moe != (cfg.family == "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} with moe={cfg.moe}")
    if cfg.is_encoder_decoder and (cfg.kv_lora or cfg.moe or cfg.family == "hybrid"):
        # no configuration asks for one; the reference's encoder would still
        # be dense while its decoder blocks were not
        raise NotImplementedError(f"{cfg.name}: an encoder-decoder with MLA, MoE or Mamba "
                                  "heads is not ported")


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
    E = cfg.n_experts
    if E % msize:
        raise ValueError(f"{cfg.name}: {E} experts do not split over {msize}")
    dff_e = cfg.d_ff_expert or cfg.d_ff
    return ShapePlan(
        msize=msize,
        d=cfg.d_model,
        H=H,
        KV=KV,
        kv_sharded=kv_sharded,
        hd=cfg.resolved_head_dim,
        Dff=pad_to(cfg.d_ff, msize),
        V=pad_to(cfg.vocab, 128 * msize),
        E=E,
        Dff_e=dff_e,
        Dff_shared=pad_to(cfg.n_shared_experts * dff_e, msize) if cfg.n_shared_experts else 0,
        rwkv_heads=pad_to(cfg.d_model // cfg.rwkv_head_dim, msize),
        rwkv_hd=cfg.rwkv_head_dim,
        d_inner=pad_to(int(cfg.ssm_expand * cfg.d_model), msize),
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
            # scaled in place: a leaf of billions of elements takes 4 B
            # each in f32 beside its own dtype, not 8
            out.append(w.mul_(std).to(dtype))
    return unflatten_like(defs, out)
