"""Whisper-style encoder-decoder backbone: the port of
``src/repro/models/whisper.py``.

The conv/mel frontend is a stub, as in the reference: the caller gives
frame embeddings [B, n_audio_ctx, d_model]; the encoder adds sinusoidal
positions and runs non-causal self-attention.  The decoder is causal
self-attention, cross-attention to the encoder's output, and a GELU MLP,
pre-LN with biases on q, v and the output projections; it adds no
positional embedding, exactly as the reference does.

Attention: in train mode `models.attention.chunked_attention` (plain torch
with autograd, chunks of 512 as the reference's), each layer under
``torch.utils.checkpoint``; at prefill the flash kernel, non-causal for
the encoder and the cross-attention (`noncausal_attention`), causal for
the decoder's self-attention (`prefill_attention`); at decode plain torch
(`decode_attention`) against the self-attention cache and the cross K and
V (``xk``, ``xv`` [L, B, n_audio_ctx, KVH, D]) that the prefill wrote in
place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.models.attention import (
    cache_write,
    chunked_attention,
    decode_attention,
    noncausal_attention,
    prefill_attention,
    zero_positions,
)
from repro_torch.models.layers import (
    dense_init,
    gelu_mlp,
    gelu_mlp_params,
    layer_norm,
    layer_slice,
    ones_init,
    sinusoidal_positions,
    zeros_init,
)

CHUNK = 512     # the reference's q and kv chunks in train mode


def _attn_spec(cfg: ModelConfig, dtype) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "w_q": ((d, cfg.n_heads * hd), dense_init, dtype),
        "b_q": ((cfg.n_heads * hd,), zeros_init, dtype),
        "w_k": ((d, cfg.n_kv_heads * hd), dense_init, dtype),
        "w_v": ((d, cfg.n_kv_heads * hd), dense_init, dtype),
        "b_v": ((cfg.n_kv_heads * hd,), zeros_init, dtype),
        "w_o": ((cfg.n_heads * hd, d), dense_init, dtype),
        "b_o": ((d,), zeros_init, dtype),
    }


def _ln_spec(d: int) -> dict:
    return {"scale": ((d,), ones_init, torch.float32),
            "bias": ((d,), zeros_init, torch.float32)}


def enc_block_spec(cfg: ModelConfig, dtype) -> dict:
    return {
        "ln_attn": _ln_spec(cfg.d_model),
        "attn": _attn_spec(cfg, dtype),
        "ln_mlp": _ln_spec(cfg.d_model),
        "mlp": gelu_mlp_params(cfg.d_model, cfg.d_ff, dtype),
    }


def dec_block_spec(cfg: ModelConfig, dtype) -> dict:
    return {
        "ln_self": _ln_spec(cfg.d_model),
        "self": _attn_spec(cfg, dtype),
        "ln_cross": _ln_spec(cfg.d_model),
        "cross": _attn_spec(cfg, dtype),
        "ln_mlp": _ln_spec(cfg.d_model),
        "mlp": gelu_mlp_params(cfg.d_model, cfg.d_ff, dtype),
    }


def _ln(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _project_q(cfg: ModelConfig, p: dict, xq: torch.Tensor) -> torch.Tensor:
    b, t = xq.shape[:2]
    q = xq @ p["w_q"].to(xq.dtype) + p["b_q"].to(xq.dtype)
    return q.reshape(b, t, cfg.n_heads, cfg.resolved_head_dim)


def _project(cfg: ModelConfig, p: dict, xq: torch.Tensor,
             xkv: torch.Tensor):
    """q [B, Tq, H, D] from xq; k, v [B, Tk, KVH, D] from xkv."""
    hd = cfg.resolved_head_dim
    b, tk = xkv.shape[:2]
    k = xkv @ p["w_k"].to(xq.dtype)
    v = xkv @ p["w_v"].to(xq.dtype) + p["b_v"].to(xq.dtype)
    return (_project_q(cfg, p, xq), k.reshape(b, tk, cfg.n_kv_heads, hd),
            v.reshape(b, tk, cfg.n_kv_heads, hd))


def _out(cfg: ModelConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    b, t = o.shape[:2]
    flat = o.reshape(b, t, cfg.n_heads * cfg.resolved_head_dim)
    return flat @ p["w_o"].to(o.dtype) + p["b_o"].to(o.dtype)


def _enc_block(cfg: ModelConfig, p: dict, h: torch.Tensor, train: bool):
    p = col.gather_layer(p)
    a = _ln(cfg, p["ln_attn"], h)
    q, k, v = _project(cfg, p["attn"], a, a)
    if train:
        pos = zero_positions(h.shape[0], h.shape[1], h.device)
        o = chunked_attention(q, k, v, pos, pos, causal=False,
                              q_chunk=CHUNK, kv_chunk=CHUNK)
    else:
        o = noncausal_attention(q, k, v)
    h = h + _out(cfg, p["attn"], o)
    return h + gelu_mlp(p["mlp"], _ln(cfg, p["ln_mlp"], h))


def encoder_forward(cfg: ModelConfig, enc_params: dict, frames: torch.Tensor,
                    *, mode: str) -> torch.Tensor:
    """frames [B, n_audio_ctx, d_model] (stub embeddings, in the compute
    dtype) -> the encoder's states, after its final LayerNorm."""
    t, d = frames.shape[1:]
    x = frames + sinusoidal_positions(t, d, frames.device).to(frames.dtype)
    train = mode == "train"
    for i in range(cfg.audio.n_encoder_layers):
        p_i = layer_slice(enc_params["blocks"], i)
        if train:
            x = checkpoint(_enc_block, cfg, p_i, x, True, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_block(cfg, p_i, x, False)
    return _ln(cfg, enc_params["ln_f"], x)


def _dec_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor, enc_out: Optional[torch.Tensor], *,
               mode: str, cache_l: Optional[dict] = None, kv_pos=None,
               cursor=None) -> torch.Tensor:
    b = h.shape[0]
    s = _ln(cfg, p["ln_self"], h)
    q, k, v = _project(cfg, p["self"], s, s)
    if mode == "decode":
        ck, cv = cache_write(cache_l["k"], cache_l["v"], k, v, cursor)
        o = decode_attention(q, ck, cv, positions, kv_pos)
    elif mode == "prefill":
        o = prefill_attention(q, k, v, positions, positions, causal=True)
        cache_write(cache_l["k"], cache_l["v"], k, v, cursor)
    else:
        o = chunked_attention(q, k, v, positions, positions, causal=True,
                              q_chunk=CHUNK, kv_chunk=CHUNK)
    h = h + _out(cfg, p["self"], o)

    c = _ln(cfg, p["ln_cross"], h)
    if mode == "decode":
        xk, xv = cache_l["xk"], cache_l["xv"]
        qc = _project_q(cfg, p["cross"], c)
    else:
        qc, xk, xv = _project(cfg, p["cross"], c, enc_out)
    # zero positions on both sides: every encoder state visible
    zq = zero_positions(b, qc.shape[1], h.device)
    zk = zero_positions(b, xk.shape[1], h.device)
    if mode == "decode":
        o = decode_attention(qc, xk, xv, zq, zk)
    elif mode == "prefill":
        o = noncausal_attention(qc, xk, xv)
        cache_l["xk"].copy_(xk)
        cache_l["xv"].copy_(xv)
    else:
        o = chunked_attention(qc, xk, xv, zq, zk, causal=False,
                              q_chunk=CHUNK, kv_chunk=CHUNK)
    h = h + _out(cfg, p["cross"], o)
    return h + gelu_mlp(p["mlp"], _ln(cfg, p["ln_mlp"], h))


def _train_dec_block(cfg, p, h, positions, enc_out):
    return _dec_block(cfg, col.gather_layer(p), h, positions, enc_out,
                      mode="train")


def decoder_forward(cfg: ModelConfig, dec_params: dict, x: torch.Tensor,
                    positions: torch.Tensor,
                    enc_out: Optional[torch.Tensor], *, mode: str,
                    cache: Optional[dict] = None,
                    kv_pos: Optional[torch.Tensor] = None, cursor=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B, T, d] token embeddings, positions [B, T], ``enc_out`` [B, Te,
    d] (train, prefill; None at decode) -> (the states after the final
    LayerNorm, the cache {k, v, xk, xv} [L, ...], written in place; None
    in train mode)."""
    for i in range(cfg.n_layers):
        p_i = layer_slice(dec_params["blocks"], i)
        if mode == "train":
            x = checkpoint(_train_dec_block, cfg, p_i, x, positions, enc_out,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_block(cfg, p_i, x, positions, enc_out, mode=mode,
                           cache_l=layer_slice(cache, i), kv_pos=kv_pos,
                           cursor=cursor)
    return _ln(cfg, dec_params["ln_f"], x), cache
