"""DBRX 132B: 16 routed experts top-4, GQA kv=8.
[hf:databricks/dbrx-base; unverified]."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab=100352, rope_theta=500000.0,
        moe=MoEConfig(n_routed=16, top_k=4, d_expert=10752, n_shared=0),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=48, vocab=128,
        moe=MoEConfig(n_routed=4, top_k=2, d_expert=48, n_shared=0),
    )
