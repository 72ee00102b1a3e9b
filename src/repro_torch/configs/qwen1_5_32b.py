"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B] — dense, QKV bias, MHA (kv=40)."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        source="hf:Qwen/Qwen1.5-0.5B (family card); 32B dims per brief",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1e6,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
