"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts, top-8, GQA kv=4,
qk-norm."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=6144,  # (unused: all layers MoE)
        vocab=151936,
        qk_norm=True,
        rope_theta=1e6,
        moe=True,
        n_experts=128,
        experts_per_token=8,
        d_ff_expert=768,
        router_aux_coef=0.001,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
