"""GLM4-9B [hf:THUDM/glm-4-9b] — dense, GQA kv=2, partial RoPE (half dims)."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        source="hf:THUDM/glm-4-9b",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab=151552,
        rope_type="partial",
        rope_fraction=0.5,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
