"""Model/config schema (jax-free copy of ``repro.configs.base``).

The fields, defaults, ``reduced()`` and ``with_updates()`` are kept exactly,
so a config built here describes the same model as the reference's; only the
dtype properties map to ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str = "tiny"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""

    # trunk ------------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab: int = 1024
    tie_embeddings: bool = False

    # attention --------------------------------------------------------------
    attn_kind: str = "gqa"
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_pattern: tuple[str, ...] = ("global",)
    window: int = 1024
    rope_type: str = "rope"  # rope | mrope | partial | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)

    # MLA (deepseek) ---------------------------------------------------------
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE --------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    router_aux_coef: float = 0.001
    moe_capacity_factor: float = 1.25

    # SSM / hybrid -------------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 3
    ssm_expand: float = 1.0
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encoder-decoder ----------------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_ratio: int = 4

    # modality frontend stub ---------------------------------------------------
    modality: str = "text"
    vision_fraction: float = 0.25

    # numerics / implementation ------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    scan_layers: bool = True
    remat: str = "none"  # none | full | dots_saveable
    logits_softcap: float = 0.0

    # runtime overrides ----------------------------------------------------------
    swa_override: int = 0
    seq_par: bool = False

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_repeats(self) -> int:
        if self.n_layers % len(self.attn_pattern):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not divisible "
                             f"by pattern {self.attn_pattern}")
        return self.n_layers // len(self.attn_pattern)

    def layer_window(self, attn_type: str, seq_len: int) -> int:
        """Effective attention window for a layer type at a given seq_len."""
        if attn_type == "local":
            return self.window
        if self.swa_override:
            return self.swa_override
        return seq_len

    def with_updates(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 pattern repeats,
        d_model<=256, <=4 experts)."""
        if len(self.attn_pattern) > 1:
            pattern = (self.attn_pattern[0], self.attn_pattern[-1])
        else:
            pattern = self.attn_pattern
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        upd = dict(
            attn_pattern=pattern,
            window=min(self.window, 16),
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=min(self.resolved_head_dim, 64),
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            scan_layers=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe:
            upd.update(
                n_experts=min(self.n_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                d_ff_expert=min(self.d_ff_expert or self.d_ff, 256),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.rope_type == "mrope":
            s = min(self.resolved_head_dim, 64) // 2
            upd.update(mrope_sections=(s - 2 * (s // 3), s // 3, s // 3))
        if self.kv_lora:
            upd.update(kv_lora=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.is_encoder_decoder:
            upd.update(encoder_layers=2)
        if self.family in ("ssm", "hybrid"):
            upd.update(rwkv_head_dim=32, rwkv_decay_lora=16, rwkv_mix_lora=8)
        return self.with_updates(**upd)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]
