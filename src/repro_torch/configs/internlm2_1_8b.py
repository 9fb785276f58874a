"""InternLM2 1.8B: dense GQA. [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544, rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128,
    )
