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

Under a mesh (``mesh``: the ambient one, `transformer.spmd_mesh`) the
encoder, the decoder's self-attention and its cross-attention run on the
rank's heads where the model axis divides them (`transformer.
heads_aligned`): ``w_q``, ``b_q``, ``w_k``, ``w_v`` and ``b_v`` by the
heads' columns, ``w_o`` row-parallel, its partial sums reduced in fp32 and
rounded once, and ``b_o`` (placed split over d) gathered and added once,
after the sum; the caches hold the rank's KV heads.  Elsewhere (8 heads
on a 16-way axis: ROADMAP Queue 1, item 1) attention runs every head
from gathered weights.  The MLP splits wherever the model axis divides
d_ff: ``w_in``, ``b_in`` column-parallel, ``w_out`` row-parallel, ``b_out``
added once after the sum.  The residual stream, the encoder's output and
the LayerNorms' are whole on every rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.models import transformer as tfm
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


class _Attn:
    """An attention block's weights as a rank computes with them: under a
    mesh whose model axis divides the heads its heads' columns (``w_q``,
    ``b_q``, ``w_k``, ``w_v``, ``b_v``) and rows (``w_o``), the inputs
    passed through `collectives.copy_to_tp` (`share`) and the output
    projection's partial sums reduced before ``b_o`` (``partial``); else
    every weight whole (gathered under a mesh, counted in
    ``COLLECTIVES["attn_gather"]``)."""

    def __init__(self, cfg: ModelConfig, p: dict, mesh):
        self.mesh, self.partial = mesh, (mesh is not None
                                         and tfm.heads_aligned(cfg, mesh))
        if self.partial:
            self.w = {k: col.tp_local(p[k], -1, mesh)
                      for k in ("w_q", "b_q", "w_k", "w_v", "b_v")}
            self.w.update(w_o=col.tp_local(p["w_o"], -2, mesh), b_o=p["b_o"])
        else:
            self.w = {k: col.full(v, "attn_gather") for k, v in p.items()}

    def share(self, x: torch.Tensor) -> torch.Tensor:
        return col.copy_to_tp(x, self.mesh) if self.partial else x


def _project_q(cfg: ModelConfig, a: _Attn, xq: torch.Tensor) -> torch.Tensor:
    b, t = xq.shape[:2]
    p, xq = a.w, a.share(xq)
    q = xq @ p["w_q"].to(xq.dtype) + p["b_q"].to(xq.dtype)
    return q.reshape(b, t, -1, cfg.resolved_head_dim)


def _project(cfg: ModelConfig, a: _Attn, xq: torch.Tensor,
             xkv: torch.Tensor):
    """q [B, Tq, H, D] from xq; k, v [B, Tk, KVH, D] from xkv (the heads
    ``a`` holds: all of them, or a rank's)."""
    hd = cfg.resolved_head_dim
    b, tk = xkv.shape[:2]
    p, kv_in = a.w, a.share(xkv)
    k = kv_in @ p["w_k"].to(xq.dtype)
    v = kv_in @ p["w_v"].to(xq.dtype) + p["b_v"].to(xq.dtype)
    return (_project_q(cfg, a, xq), k.reshape(b, tk, -1, hd),
            v.reshape(b, tk, -1, hd))


def _out(a: _Attn, o: torch.Tensor) -> torch.Tensor:
    """The output projection and ``b_o``: row-parallel with ``a.partial``,
    the heads' fp32 partial products summed over the model axis and
    rounded once, ``b_o`` added after the sum."""
    b, t = o.shape[:2]
    flat, w_o = o.reshape(b, t, -1), a.w["w_o"].to(o.dtype)
    if a.partial:
        y = col.reduce_from_tp(flat.float() @ w_o.float(), a.mesh).to(o.dtype)
    else:
        y = flat @ w_o
    return y + a.w["b_o"].to(o.dtype)


def _mlp(cfg: ModelConfig, p: dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """`layers.gelu_mlp`; under a mesh whose model axis divides d_ff
    ``w_in`` and ``b_in`` column-parallel and ``w_out`` row-parallel, the
    partial sums reduced in fp32 and rounded once, ``b_out`` added after
    the sum; under another mesh from gathered weights."""
    n = 1 if mesh is None else col.tp_size(mesh)
    if mesh is None or cfg.d_ff % n or cfg.d_ff < n:
        return gelu_mlp({k: col.full(v) for k, v in p.items()}, x)
    dt = x.dtype
    h = col.copy_to_tp(x, mesh) @ col.tp_local(p["w_in"], -1, mesh).to(dt)
    h = F.gelu(h + col.tp_local(p["b_in"], -1, mesh).to(dt),
               approximate="tanh")
    part = h @ col.tp_local(p["w_out"], -2, mesh).to(dt)
    return (col.reduce_from_tp(part.float(), mesh).to(dt)
            + p["b_out"].to(dt))


def _enc_block(cfg: ModelConfig, p: dict, h: torch.Tensor, train: bool,
               mesh=None):
    p = col.gather_layer(p)
    attn = _Attn(cfg, p["attn"], mesh)
    a = _ln(cfg, p["ln_attn"], h)
    q, k, v = _project(cfg, attn, a, a)
    if train:
        pos = zero_positions(h.shape[0], h.shape[1], h.device)
        o = chunked_attention(q, k, v, pos, pos, causal=False,
                              q_chunk=CHUNK, kv_chunk=CHUNK)
    else:
        o = noncausal_attention(q, k, v)
    h = h + _out(attn, o)
    return h + _mlp(cfg, p["mlp"], _ln(cfg, p["ln_mlp"], h), mesh)


def encoder_forward(cfg: ModelConfig, enc_params: dict, frames: torch.Tensor,
                    *, mode: str, mesh=None) -> torch.Tensor:
    """frames [B, n_audio_ctx, d_model] (stub embeddings, in the compute
    dtype) -> the encoder's states, after its final LayerNorm, whole on
    every rank under ``mesh``."""
    t, d = frames.shape[1:]
    x = frames + sinusoidal_positions(t, d, frames.device).to(frames.dtype)
    train = mode == "train"
    for i in range(cfg.audio.n_encoder_layers):
        p_i = layer_slice(enc_params["blocks"], i)
        if train:
            x = checkpoint(_enc_block, cfg, p_i, x, True, mesh,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_block(cfg, p_i, x, False, mesh)
    return _ln(cfg, enc_params["ln_f"], x)


def _dec_block(cfg: ModelConfig, p: dict, h: torch.Tensor,
               positions: torch.Tensor, enc_out: Optional[torch.Tensor], *,
               mode: str, cache_l: Optional[dict] = None, kv_pos=None,
               cursor=None, mesh=None) -> torch.Tensor:
    b = h.shape[0]
    attn, cross = _Attn(cfg, p["self"], mesh), _Attn(cfg, p["cross"], mesh)
    s = _ln(cfg, p["ln_self"], h)
    q, k, v = _project(cfg, attn, s, s)
    if mode == "decode":
        ck, cv = cache_write(cache_l["k"], cache_l["v"], k, v, cursor)
        o = decode_attention(q, ck, cv, positions, kv_pos)
    elif mode == "prefill":
        o = prefill_attention(q, k, v, positions, positions, causal=True)
        cache_write(cache_l["k"], cache_l["v"], k, v, cursor)
    else:
        o = chunked_attention(q, k, v, positions, positions, causal=True,
                              q_chunk=CHUNK, kv_chunk=CHUNK)
    h = h + _out(attn, o)

    c = _ln(cfg, p["ln_cross"], h)
    if mode == "decode":
        xk, xv = cache_l["xk"], cache_l["xv"]
        qc = _project_q(cfg, cross, c)
    else:
        qc, xk, xv = _project(cfg, cross, c, enc_out)
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
    h = h + _out(cross, o)
    return h + _mlp(cfg, p["mlp"], _ln(cfg, p["ln_mlp"], h), mesh)


def _train_dec_block(cfg, p, h, positions, enc_out, mesh):
    return _dec_block(cfg, col.gather_layer(p), h, positions, enc_out,
                      mode="train", mesh=mesh)


def decoder_forward(cfg: ModelConfig, dec_params: dict, x: torch.Tensor,
                    positions: torch.Tensor,
                    enc_out: Optional[torch.Tensor], *, mode: str,
                    cache: Optional[dict] = None,
                    kv_pos: Optional[torch.Tensor] = None, cursor=None,
                    mesh=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B, T, d] token embeddings, positions [B, T], ``enc_out`` [B, Te,
    d] (train, prefill; None at decode) -> (the states after the final
    LayerNorm, the cache {k, v, xk, xv} [L, ...], written in place; None
    in train mode)."""
    for i in range(cfg.n_layers):
        p_i = layer_slice(dec_params["blocks"], i)
        if mode == "train":
            x = checkpoint(_train_dec_block, cfg, p_i, x, positions, enc_out,
                           mesh, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _dec_block(cfg, p_i, x, positions, enc_out, mode=mode,
                           cache_l=layer_slice(cache, i), kv_pos=kv_pos,
                           cursor=cursor, mesh=mesh)
    return _ln(cfg, dec_params["ln_f"], x), cache
