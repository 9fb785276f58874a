"""Decoder stack of the dense GQA, MoE and hybrid (Hymba) families.

The port of the dense, MoE and hybrid branches of
``src/repro/models/transformer.py``.  Stacked ``[L, ...]`` layer weights,
as in the reference; the stack is a Python loop over the layers (the
reference's ``lax.scan``), each layer reading its slice of the weights and
of the cache.

Modes
-----
``train``   — full sequence, no cache, returns hidden states: attention
              through `models.attention.chunked_attention` (plain torch
              with autograd, the reference's rounding), the SSM through
              `models.ssm.ssm_forward_train` from the zero state, the MoE
              through `models.moe.moe_ffn_train` (no kernel: none has a
              backward), and each layer under ``torch.utils.checkpoint``,
              so that backward recomputes it from its input (the
              reference's layer remat).
``prefill`` — full sequence; attention through the flash kernel; writes the
              layer's cache in place; returns hidden states.
``decode``  — T new tokens (usually 1) against the cache.

A hybrid layer runs attention and the selective SSM (`models.ssm`) in
parallel on the same normed input and mixes them as ``0.5 * (rms(attn) +
rms(ssm))``; its SSM state lives in the layer's ``ssm_h`` / ``ssm_conv``
cache, read and written in place (train mode starts each layer from the
zero state and writes nothing).  An MoE layer's channel mix is
`models.moe.moe_ffn` (the grouped-matmul kernel; in train mode
`moe_ffn_train`), and its aux loss is summed over the stack.  The
reference's ``constrain_heads``, its sharded-decode branch and its
expert-parallel MoE dispatch are the identity on one device; they wait
for slice 11.  MLA, VLM and audio blocks raise (slice 10).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    cache_write,
    chunked_attention,
    decode_attention,
    prefill_attention,
)
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    ones_init,
    rms_norm,
    swiglu,
    swiglu_params,
)


def _ported_block(cfg: ModelConfig) -> None:
    if cfg.mla is not None or cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the ported archs are internlm2-1.8b, glm4-9b, "
            "mistral-nemo-12b, deepseek-moe-16b, dbrx-132b, hymba-1.5b and "
            "xlstm-350m; MLA, VLM and audio are ROADMAP slice 10")


TRAIN_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless the port trains ``cfg``'s family."""
    if cfg.family not in TRAIN_FAMILIES or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: train mode is ported for the dense, MoE, hybrid "
            "and xLSTM families; MLA, VLM and audio are ROADMAP slice 10")


# ---------------------------------------------------------------------------
# GQA attention sub-layer
# ---------------------------------------------------------------------------


def gqa_params_spec(cfg: ModelConfig, dtype) -> dict:
    hd = cfg.resolved_head_dim
    return {
        "w_q": ((cfg.d_model, cfg.n_heads * hd), dense_init, dtype),
        "w_k": ((cfg.d_model, cfg.n_kv_heads * hd), dense_init, dtype),
        "w_v": ((cfg.d_model, cfg.n_kv_heads * hd), dense_init, dtype),
        "w_o": ((cfg.n_heads * hd, cfg.d_model), dense_init, dtype),
    }


def gqa_project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    """x [B, T, d] -> q [B, T, H, hd], k and v [B, T, KVH, hd], rotary on
    q and k; weights cast to x's dtype at each use."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (x @ p["w_k"].to(x.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ p["w_v"].to(x.dtype)).reshape(b, t, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  layer_cache: Optional[dict] = None,
                  kv_pos: Optional[torch.Tensor] = None,
                  cursor=None, q_chunk: int = 1024,
                  kv_chunk: int = 1024) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-layer (pre-norm residual applied by the caller).
    Returns (out [B, T, d], the layer's cache {k, v}, written in place;
    None in train mode)."""
    b, t, _ = x.shape
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    new_cache = None
    if mode == "train":
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                window=cfg.sliding_window,
                                n_meta=cfg.n_meta_tokens, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    elif mode == "prefill":
        out = prefill_attention(q, k, v, positions, positions, causal=True,
                                window=cfg.sliding_window,
                                n_meta=cfg.n_meta_tokens)
        ck, cv = cache_write(layer_cache["k"], layer_cache["v"], k, v, cursor,
                             n_pinned=cfg.n_meta_tokens)
        new_cache = {"k": ck, "v": cv}
    elif mode == "decode":
        ck, cv = cache_write(layer_cache["k"], layer_cache["v"], k, v, cursor,
                             n_pinned=cfg.n_meta_tokens)
        out = decode_attention(q, ck, cv, positions, kv_pos,
                               window=cfg.sliding_window,
                               n_meta=cfg.n_meta_tokens)
        new_cache = {"k": ck, "v": cv}
    else:
        raise ValueError(mode)
    hd = cfg.resolved_head_dim
    out = out.reshape(b, t, cfg.n_heads * hd) @ p["w_o"].to(x.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# Layer blocks
# ---------------------------------------------------------------------------


def block_params_spec(cfg: ModelConfig, dtype) -> dict:
    """Parameter spec for one dense, MoE or hybrid decoder layer."""
    _ported_block(cfg)
    spec: dict = {"norm_attn": ((cfg.d_model,), ones_init, torch.float32),
                  "norm_ffn": ((cfg.d_model,), ones_init, torch.float32),
                  "attn": gqa_params_spec(cfg, dtype)}
    if cfg.moe is not None:
        spec["ffn"] = moe_mod.moe_params_spec(cfg.d_model, cfg.moe, dtype)
    elif cfg.d_ff > 0:
        spec["ffn"] = swiglu_params(cfg.d_model, cfg.d_ff, dtype)
    if cfg.family == "hybrid" and cfg.ssm is not None:
        spec["ssm"] = ssm_mod.ssm_params_spec(cfg.d_model, cfg.ssm, dtype)
        spec["norm_attn_out"] = ((cfg.d_model,), ones_init, torch.float32)
        spec["norm_ssm_out"] = ((cfg.d_model,), ones_init, torch.float32)
    return spec


def decoder_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  layer_cache: Optional[dict] = None,
                  kv_pos: Optional[torch.Tensor] = None, cursor=None,
                  q_chunk: int = 1024, kv_chunk: int = 1024
                  ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """One dense, MoE or hybrid decoder layer.  Returns (x, layer_cache,
    aux_loss): the MoE layer's load-balance loss, else 0."""
    _ported_block(cfg)
    if mode == "train":
        check_trainable(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    attn_out, new_cache = gqa_attention(
        cfg, p["attn"], h, positions, mode=mode, layer_cache=layer_cache,
        kv_pos=kv_pos, cursor=cursor, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if cfg.family == "hybrid" and cfg.ssm is not None:
        # Hymba: attention and mamba heads in parallel on the same normed
        # input, each output normed, then averaged
        if mode == "train":
            ssm_out, _ = ssm_mod.ssm_forward_train(cfg.ssm, p["ssm"], h)
        else:
            st = ssm_mod.SSMState(h=layer_cache["ssm_h"],
                                  conv=layer_cache["ssm_conv"])
            ssm_out, st_new = ssm_mod.ssm_forward(cfg.ssm, p["ssm"], h, st)
            layer_cache["ssm_h"].copy_(st_new.h)
            layer_cache["ssm_conv"].copy_(st_new.conv)
        x = x + 0.5 * (rms_norm(attn_out, p["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(ssm_out, p["norm_ssm_out"], cfg.norm_eps))
    else:
        x = x + attn_out
    if cfg.moe is not None:
        moe_ffn = moe_mod.moe_ffn_train if mode == "train" else moe_mod.moe_ffn
        ffn_out, aux = moe_ffn(
            cfg.moe, p["ffn"], rms_norm(x, p["norm_ffn"], cfg.norm_eps))
        x = x + ffn_out
    elif cfg.d_ff > 0:
        x = x + swiglu(p["ffn"], rms_norm(x, p["norm_ffn"], cfg.norm_eps))
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# The stack: a loop over stacked [L, ...] layer params and cache slices
# ---------------------------------------------------------------------------


def _layer(tree: dict, i: int) -> dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _train_block(cfg, p, x, positions, q_chunk, kv_chunk):
    x, _, aux = decoder_block(cfg, p, x, positions, mode="train",
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    return x, aux


def stack_apply(cfg: ModelConfig, blocks_params: dict, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                cache: Optional[dict] = None,
                kv_pos: Optional[torch.Tensor] = None, cursor=None,
                q_chunk: int = 1024, kv_chunk: int = 1024
                ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Homogeneous decoder stack.  Returns (h, cache, aux_loss_sum); the
    stacked cache (``k``, ``v`` [L, B, S, KVH, D], and for the hybrid family
    ``ssm_h``, ``ssm_conv``) is written in place, one layer's view at a
    time.  In train mode each layer runs under ``torch.utils.checkpoint``:
    what it keeps for backward is its input."""
    if mode == "train":
        check_trainable(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p_i = _layer(blocks_params, i)
        if mode == "train":
            x, aux_i = checkpoint(_train_block, cfg, p_i, x, positions,
                                  q_chunk, kv_chunk, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            cache_i = _layer(cache, i) if cache is not None else None
            x, _, aux_i = decoder_block(
                cfg, p_i, x, positions, mode=mode, layer_cache=cache_i,
                kv_pos=kv_pos, cursor=cursor)
        aux = aux + aux_i
    return x, cache, aux
