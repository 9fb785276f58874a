"""DeepSeek-MoE 16B: fine-grained MoE, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf].  d_ff=1408 is the per-(routed-)expert hidden dim."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=102400, rope_theta=10000.0,
        moe=MoEConfig(n_routed=64, top_k=6, d_expert=1408,
                      n_shared=2, d_shared=2 * 1408),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=16, vocab=128,
        moe=MoEConfig(n_routed=8, top_k=2, d_expert=16, n_shared=2, d_shared=32),
    )
