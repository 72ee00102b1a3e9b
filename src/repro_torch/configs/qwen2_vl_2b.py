"""Qwen2-VL-2B backbone [arXiv:2409.12191] — M-RoPE, dynamic resolution.

The vision frontend is a stub (precomputed patch embeddings, projected by
``frontend_proj``); this config is the language transformer that consumes
them.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        rope_type="mrope",
        mrope_sections=(16, 24, 24),
        rope_theta=1e6,
        modality="vision",
        vision_fraction=0.25,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
