"""Hymba 1.5B: hybrid blocks with parallel attention + mamba heads,
sliding-window attention + 128 learnable meta tokens. [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab=32001, head_dim=64,
        sliding_window=1024, n_meta_tokens=128,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128, head_dim=8,
        sliding_window=8, n_meta_tokens=4,
        ssm=SSMConfig(d_state=4, d_conv=3, expand=2),
    )
