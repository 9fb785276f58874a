"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3): the port of
``src/repro/models/mla.py``.

Train and prefill decompress the latent into per-head K and V (Dk =
``qk_nope + qk_rope``, Dv = ``v_head_dim``) and attend causally: train
through `models.attention.chunked_attention` (plain torch with autograd),
prefill through the flash kernel (`models.attention.prefill_attention`,
whose wrapper pads V with zero columns to Dk).  Decode uses the *absorbed*
form in plain torch, as the reference does: the cache holds only the
compressed latent ``c_kv`` [B, S, r_kv] and the shared rotary key [B, S,
d_rope]; ``W_uk`` is folded into the query and ``W_uv`` applied after the
read, with the reference's rounding (fp32 scores scaled by ``1 / sqrt(dn +
dr)``, P cast to the cache's dtype before P·c_kv, the latent output cast to
x's dtype before ``W_uv``).  The tensor-parallel stack
(`models.transformer._mla_attention_tp`) forms its latents and heads on
a rank's weight blocks and shares the two attention bodies,
`decompressed_attention` and `latent_attention`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.attention import (
    NEG_INF,
    chunked_attention,
    prefill_attention,
    visibility_mask,
)
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    ones_init,
    rms_norm,
)


def mla_params_spec(d_model: int, n_heads: int, mla: MLAConfig,
                    dtype) -> dict:
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    return {
        "w_dq": ((d_model, mla.q_lora_rank), dense_init, dtype),
        "q_norm": ((mla.q_lora_rank,), ones_init, torch.float32),
        "w_uq": ((mla.q_lora_rank, n_heads * qk), dense_init, dtype),
        "w_dkv": ((d_model, mla.kv_lora_rank), dense_init, dtype),
        "kv_norm": ((mla.kv_lora_rank,), ones_init, torch.float32),
        "w_uk": ((mla.kv_lora_rank, n_heads * mla.qk_nope_head_dim),
                 dense_init, dtype),
        "w_uv": ((mla.kv_lora_rank, n_heads * mla.v_head_dim), dense_init,
                 dtype),
        "w_kr": ((d_model, mla.qk_rope_head_dim), dense_init, dtype),
        "w_o": ((n_heads * mla.v_head_dim, d_model), dense_init, dtype),
    }


def _project_q(mla: MLAConfig, n_heads: int, params: dict, x: torch.Tensor,
               positions: torch.Tensor, rope_theta: float):
    """-> q_nope [B, T, H, dn], q_rope [B, T, H, dr] (rotary applied)."""
    b, t, _ = x.shape
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    cq = rms_norm(x @ params["w_dq"].to(x.dtype), params["q_norm"])
    q = (cq @ params["w_uq"].to(x.dtype)).reshape(b, t, n_heads, qk)
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def mla_latents(mla: MLAConfig, params: dict, x: torch.Tensor,
                positions: torch.Tensor, rope_theta: float):
    """The compressed latent [B, T, r_kv] and the shared rotary key [B, T,
    dr]: what the decode cache stores."""
    ckv = rms_norm(x @ params["w_dkv"].to(x.dtype), params["kv_norm"])
    kr = (x @ params["w_kr"].to(x.dtype))[:, :, None, :]
    kr = apply_rope(kr, positions, rope_theta)[:, :, 0, :]
    return ckv, kr


def decompressed_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                           k_nope: torch.Tensor, kr: torch.Tensor,
                           v: torch.Tensor, positions: torch.Tensor, *,
                           mode: str, q_chunk: int = 1024,
                           kv_chunk: int = 1024) -> torch.Tensor:
    """Causal attention of the decompressed heads: q_nope [B, T, H, dn]
    and q_rope [B, T, H, dr] (rotary applied) against k_nope [B, T, H,
    dn], the shared rotary key kr [B, T, dr] and v [B, T, H, dv] -> [B, T,
    H, dv]; train (``mode="train"``) through `chunked_attention`, prefill
    through the flash kernel."""
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand_as(q_rope)], dim=-1)
    if mode == "train":
        return chunked_attention(q, k, v, positions, positions, causal=True,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    return prefill_attention(q, k, v, positions, positions, causal=True)


def mla_attention_full(mla: MLAConfig, n_heads: int, params: dict,
                       x: torch.Tensor, positions: torch.Tensor,
                       rope_theta: float, *, mode: str, q_chunk: int = 1024,
                       kv_chunk: int = 1024
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Train (``mode="train"``) or prefill path: decompress, then causal
    attention.  Returns (out [B, T, d], (c_kv, k_rope) for the cache)."""
    b, t, _ = x.shape
    h = n_heads
    q_nope, q_rope = _project_q(mla, h, params, x, positions, rope_theta)
    ckv, kr = mla_latents(mla, params, x, positions, rope_theta)
    k_nope = (ckv @ params["w_uk"].to(x.dtype)).reshape(
        b, t, h, mla.qk_nope_head_dim)
    v = (ckv @ params["w_uv"].to(x.dtype)).reshape(b, t, h, mla.v_head_dim)
    out = decompressed_attention(q_nope, q_rope, k_nope, kr, v, positions,
                                 mode=mode, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    out = out.reshape(b, t, h * mla.v_head_dim) @ params["w_o"].to(x.dtype)
    return out, (ckv, kr)


def mla_attention_decode(mla: MLAConfig, n_heads: int, params: dict,
                         x: torch.Tensor, positions: torch.Tensor,
                         ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
                         kv_pos: torch.Tensor,
                         rope_theta: float) -> torch.Tensor:
    """Absorbed decode: score and read in latent space.  x [B, Tq, d],
    positions [B, Tq], caches [B, S, r_kv] and [B, S, dr] holding the
    current tokens, kv_pos [B, S] (-1 empty) -> [B, Tq, d]."""
    b, tq, _ = x.shape
    dn, r_kv = mla.qk_nope_head_dim, mla.kv_lora_rank
    q_nope, q_rope = _project_q(mla, n_heads, params, x, positions,
                                rope_theta)
    # W_uk folded into q_nope: q_abs[b,t,h,r] = sum_n q_nope W_uk[r,h,n]
    w_uk = params["w_uk"].to(x.dtype).reshape(r_kv, n_heads, dn)
    q_abs = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)
    o_latent = latent_attention(mla, q_abs, q_rope, ckv_cache, kr_cache,
                                positions, kv_pos)
    w_uv = params["w_uv"].to(x.dtype).reshape(r_kv, n_heads, mla.v_head_dim)
    o = torch.einsum("bthr,rhv->bthv", o_latent, w_uv)
    return (o.reshape(b, tq, n_heads * mla.v_head_dim)
            @ params["w_o"].to(x.dtype))


def latent_attention(mla: MLAConfig, q_abs: torch.Tensor,
                     q_rope: torch.Tensor, ckv_cache: torch.Tensor,
                     kr_cache: torch.Tensor, positions: torch.Tensor,
                     kv_pos: torch.Tensor) -> torch.Tensor:
    """The absorbed decode's read: q_abs [B, Tq, H, r_kv] and q_rope [B,
    Tq, H, dr] against the whole latent caches -> the latent output [B,
    Tq, H, r_kv] in q_abs's dtype."""
    scale = 1.0 / math.sqrt(mla.qk_nope_head_dim + mla.qk_rope_head_dim)
    # products of the inputs' values summed in fp32 (the reference's
    # preferred_element_type=float32)
    s = (torch.einsum("bthr,bsr->bhts", q_abs.float(), ckv_cache.float())
         + torch.einsum("bthp,bsp->bhts", q_rope.float(),
                        kr_cache.float())) * scale
    vis = visibility_mask(positions, kv_pos, causal=True)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bsr->bthr", p.to(ckv_cache.dtype),
                        ckv_cache).to(q_abs.dtype)
