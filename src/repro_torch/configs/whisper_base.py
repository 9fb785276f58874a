"""Whisper-base backbone: 6-layer encoder + 6-layer decoder, enc-dec
cross-attention.  Conv/mel frontend is a STUB: input_specs supplies frame
embeddings [B, 1500, 512]. [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import AudioConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab=51865,
        audio=AudioConfig(n_encoder_layers=6, n_audio_ctx=1500),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", family="audio",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=128,
        audio=AudioConfig(n_encoder_layers=2, n_audio_ctx=12),
    )
