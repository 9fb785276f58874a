"""xLSTM 350M: alternating mLSTM/sLSTM residual blocks, no separate FFN
(d_ff=0; channel mixing lives inside the blocks). [arXiv:2405.04517; unverified]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        xlstm=XLSTMConfig(slstm_every=2, proj_factor_mlstm=2.0,
                          proj_factor_slstm=1.333, conv_width=4),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        n_layers=4, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=128,
        xlstm=XLSTMConfig(slstm_every=2, conv_width=3),
    )
