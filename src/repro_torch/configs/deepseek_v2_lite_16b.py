"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MLA kv_lora=512, MoE with
2 shared + 64 routed experts (top-6), first layer dense."""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="arXiv:2405.04434",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense first layer
        vocab=102400,
        kv_lora=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe=True,
        n_experts=64,
        experts_per_token=6,
        n_shared_experts=2,
        d_ff_expert=1408,
        first_dense_layers=1,
        router_aux_coef=0.003,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
