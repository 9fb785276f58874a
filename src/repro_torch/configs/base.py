"""Configuration system: model configs, input shapes, and the arch registry.

The port's own copy of ``src/repro/configs/base.py`` (the port imports
nothing of ``repro``, not even its jax-free modules).  Every assigned
architecture is a ``ModelConfig`` produced by a module in
``repro_torch.configs``.  Configs are plain frozen dataclasses: hashable
and printable, and equal field for field to the reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs for architecture families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Fine-grained mixture-of-experts FFN (DeepSeek-MoE / DBRX style)."""

    n_routed: int                 # routed experts
    top_k: int                    # experts per token
    d_expert: int                 # hidden dim of each routed expert
    n_shared: int = 0             # always-on shared experts (DeepSeek-MoE)
    d_shared: int = 0             # hidden dim of the shared expert(s)
    router_aux_coef: float = 0.01  # load-balance aux loss coefficient
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int              # low-rank bottleneck for Q
    kv_lora_rank: int             # compressed latent dim cached at decode
    qk_nope_head_dim: int         # non-rotary part of the QK head
    qk_rope_head_dim: int         # rotary part of the QK head (shared K)
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM branch (Hymba hybrid blocks)."""

    d_state: int = 16
    d_conv: int = 4               # causal depthwise conv width
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack: alternating mLSTM (matrix memory) / sLSTM blocks."""

    slstm_every: int = 2          # every k-th block is an sLSTM block
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.333
    conv_width: int = 4


@dataclass(frozen=True)
class VisionConfig:
    """Cross-attention VLM (Llama-3.2-Vision).  Frontend is a STUB: the
    input pipeline supplies pre-computed patch embeddings."""

    cross_attn_every: int = 5     # every 5th layer is a cross-attn layer
    n_patches: int = 6404         # 4 tiles x 1601 patches
    vision_dim: int = 1280        # ViT-H/14 output width (pre-projector)


@dataclass(frozen=True)
class AudioConfig:
    """Encoder-decoder audio model (Whisper).  Conv/mel frontend is a STUB:
    the input pipeline supplies pre-computed frame embeddings."""

    n_encoder_layers: int = 6
    n_audio_ctx: int = 1500       # encoder positions (30s @ 50Hz)


# ---------------------------------------------------------------------------
# The unified model config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window attention; 0 = full/global attention
    sliding_window: int = 0
    # always-visible learnable prefix (Hymba meta tokens); 0 = none
    n_meta_tokens: int = 0
    # decode hillclimb: shard the KV cache on the SEQUENCE dim over the
    # model axis and flash-decode with psum-combined softmax stats
    # (distributed.collectives.sharded_kv_decode_attention)
    decode_kv_shard: bool = False
    # family-specific sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    # dtypes
    param_dtype: str = "float32"  # master weights
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        assert self.family in FAMILIES, self.family

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_group_size(self) -> int:
        """GQA group size (query heads per KV head)."""
        return max(self.n_heads // max(self.n_kv_heads, 1), 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6*N*D roofline term) --------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and per-token-active."""
        from repro_torch.models.model import count_params  # lazy, avoids cycle

        return count_params(self)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape suite)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeSpec("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeSpec("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeSpec("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable per the assignment rules.

    long_500k needs sub-quadratic sequence mixing: run only for ssm/hybrid
    archs; pure full-attention archs skip it (recorded in DESIGN.md).
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "full-attention arch: 500k context needs sub-quadratic mixing"
    return True, ""
