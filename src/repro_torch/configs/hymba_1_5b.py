"""Hymba-1.5B [arXiv:2411.13676] — parallel attention + Mamba heads per layer,
ssm_state=16; mostly sliding-window attention with periodic global layers.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="arXiv:2411.13676",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        attn_pattern=("global",) + ("local",) * 15,  # 2 repeats of 16
        window=1024,
        ssm_state=16,
        ssm_conv=3,
        ssm_expand=2.0,
        rope_type="rope",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
