"""Gemma3-12B [hf:google/gemma-3-1b-pt family card] — 5:1 local:global
attention pattern, 1024-token sliding window, 128k context."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab=262144,
        attn_pattern=("local",) * 5 + ("global",),
        window=1024,
        qk_norm=True,
        rope_theta=1e6,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
