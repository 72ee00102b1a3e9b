"""SeamlessM4T-Large-v2 backbone [arXiv:2308.11596] — encoder-decoder,
multimodal.  The audio frontend (mel + conv codec) is a stub: batches carry
precomputed frame embeddings; the transformer encoder and the text decoder
with cross-attention are the model.
"""

from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596",
        n_layers=24,
        encoder_layers=24,
        is_encoder_decoder=True,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        rope_type="rope",
        modality="audio",
        encoder_ratio=4,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        remat="full",
    )
