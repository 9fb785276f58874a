"""GLM-4 9B: dense, RoPE, extreme GQA (kv=2). [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=128,
    )
