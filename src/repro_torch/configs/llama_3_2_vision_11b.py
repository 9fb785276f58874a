"""Llama-3.2-Vision 11B backbone: 32 self + 8 gated cross-attn layers (40L).
Vision frontend is a STUB: input_specs supplies ViT patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ModelConfig, VisionConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, rope_theta=500000.0,
        vision=VisionConfig(cross_attn_every=5, n_patches=6404, vision_dim=1280),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm",
        n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128,
        vision=VisionConfig(cross_attn_every=2, n_patches=8, vision_dim=16),
    )
