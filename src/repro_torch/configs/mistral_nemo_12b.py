"""Mistral-Nemo 12B: dense GQA, 128k context, head_dim=128 (< d_model/H).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=131072, head_dim=128, rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128, head_dim=8,
    )
