"""MiniCPM3 4B: dense with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]."""
from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73448,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=128,
        mla=MLAConfig(q_lora_rank=16, kv_lora_rank=8,
                      qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8),
    )
