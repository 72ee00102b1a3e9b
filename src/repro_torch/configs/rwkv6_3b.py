"""RWKV6 "Finch" 3B [arXiv:2404.05892] — attention-free, data-dependent decay.

As in the reference: head_dim 80 (32 heads) instead of the usual 64 (40
heads), so the heads divide a 16-way model axis without padding.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        source="arXiv:2404.05892",
        n_layers=32,
        d_model=2560,
        n_heads=4,  # unused (attention-free)
        n_kv_heads=4,
        d_ff=8960,
        vocab=65536,
        attn_kind="none",
        rope_type="none",
        rwkv_head_dim=80,
        rwkv_decay_lora=64,
        rwkv_mix_lora=32,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
