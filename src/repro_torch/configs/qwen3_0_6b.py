"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family card] — dense, qk-norm, GQA kv=8."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
