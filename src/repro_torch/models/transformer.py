"""Decoder stacks of the dense GQA, MLA, MoE, hybrid (Hymba) and VLM
(Llama-3.2-Vision) families.

The port of ``src/repro/models/transformer.py``.  Stacked ``[L, ...]``
layer weights, as in the reference; the stack is a Python loop over the
layers (the reference's ``lax.scan``), each layer reading its slice of the
weights and of the cache.

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
`moe_ffn_train`), and its aux loss is summed over the stack.  An MLA layer
(`models.mla`) caches its latent ``ckv`` and rotary key ``kr`` and decodes
in the absorbed form.  The VLM stack (`vlm_stack_apply`) runs groups of
``cross_attn_every - 1`` self layers, each followed by one gated
cross-attention block over the projected vision states, whose K and V it
caches per group (``xk``, ``xv``) at prefill and reads at decode; the
cross-attention is non-causal (the flash kernel at prefill, plain torch at
decode and in train mode).

Under an ambient mesh (`distributed.collectives.use_mesh`) the dense, MLA,
MoE, hybrid and VLM stacks run tensor-parallel on each rank's local
tensors (`_gqa_attention_tp`, `_mla_attention_tp`, `_cross_attention_tp`,
`collectives.swiglu_tp`, the hybrid's SSM on the rank's channels through
`ssm.ssm_forward_tp`): the residual stream is replicated over the model
axis, and GQA attention takes one of four forms, after the reference's
placements and the pins of its ``constrain_heads``:

* ``heads`` (`heads_aligned`: both head counts divide the model axis):
  q, k and v column-parallel by heads;
* ``head_dim`` (`head_dim_split`: the query heads divide, the KV heads
  divide the model axis instead; internlm2-1.8b, glm4-9b,
  mistral-nemo-12b, dbrx-132b and llama-3.2-vision-11b on 16 model
  ranks): q column-parallel by heads, k and v from the rank's columns
  all-gathered into whole KV heads, each rank's query heads attending
  over the one KV head they use (`_columns_attention`,
  `_cross_head_dim_attention`);
* ``columns`` (`columns_split`: neither, but the model axis divides the
  weights' flat widths and head_dim; hymba-1.5b): the rank multiplies by
  its column blocks of q, k and v, all-gathers the products and attends
  on the query heads its rows of ``w_o`` touch (`_columns_attention`,
  whose head_dim form is the case where those are its own heads; MLA's
  twin in `_mla_attention_tp`, minicpm3-4b's 40 heads on 16 ranks);
* otherwise every head on every rank from gathered weights
  (``COLLECTIVES["attn_gather"]``; the VLM's cross blocks in the columns
  case too).

The output projection is row-parallel, its partial sums reduced with one
fp32 SUM all-reduce; a VLM cross block's gates apply after the reduce.
The KV cache's layout (`kv_layout`) is its sequence axis over the model
axis with ``decode_kv_shard`` (decode then goes through
`collectives.sharded_kv_decode_attention`), else the local heads, else
the rank's head_dim slice of every KV head (decode through
`collectives.head_dim_decode_attention`; the head_dim and columns
forms), else whole; the VLM's vision K/V cache takes `cross_kv_layout`,
the heads and head_dim forms' and never "seq"; an MLA cache holds the
rank's columns of ``ckv`` and ``kr`` where the model axis divides both
("latent", decode through `collectives.latent_decode_attention`), else
whole; the hybrid's SSM state its channels where the model axis divides
d_inner (`ssm_split`).  The MoE FFN goes through
`distributed.moe_ep.moe_ffn_ep` where the model axis divides
``n_routed``.  In train mode each layer gathers its own weights inside
its checkpointed function (`collectives.gather_layer`: the sharded train
step's per-layer FSDP gather; a no-op otherwise).  Without a mesh every
path is the one-device one.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import moe_ep
from repro_torch.distributed import sharding as shd
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    cache_write,
    cache_write_single,
    chunked_attention,
    decode_attention,
    noncausal_attention,
    prefill_attention,
    zero_positions,
)
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    layer_slice,
    ones_init,
    rms_norm,
    swiglu,
    swiglu_params,
    zeros_init,
)

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
    """x [B, T, d] -> q [B, T, H, hd], k and v [B, T, KVH, hd] (the heads
    the weights hold: all of them, or a rank's), rotary on q and k;
    weights cast to x's dtype at each use."""
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, t, -1, hd)
    k = (x @ p["w_k"].to(x.dtype)).reshape(b, t, -1, hd)
    v = (x @ p["w_v"].to(x.dtype)).reshape(b, t, -1, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor, *, mode: str,
                  layer_cache: Optional[dict] = None,
                  kv_pos: Optional[torch.Tensor] = None,
                  cursor=None, q_chunk: int = 1024,
                  kv_chunk: int = 1024, mesh=None,
                  kv_layout: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention sub-layer (pre-norm residual applied by the caller).
    Returns (out [B, T, d], the layer's cache {k, v}, written in place;
    None in train mode).  The weights may hold a rank's heads only
    (`_gqa_attention_tp`): ``out`` is then the rank's partial sum of the
    output projection.  With ``kv_layout="seq"`` the cache is the rank's
    slots of every head under ``mesh``: prefill writes the slots that fall
    in it (`seq_write`), decode goes through
    `collectives.sharded_kv_decode_attention`."""
    b, t, _ = x.shape
    q, k, v = gqa_project_qkv(cfg, p, x, positions)
    seq = kv_layout == "seq"
    local_heads = q.shape[2] != cfg.n_heads

    def whole(z):          # every head, for the sequence-split cache
        return col.all_gather(z, col.tp_group(mesh), 2) if local_heads else z

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
        if seq:
            ck = seq_write(layer_cache["k"], whole(k), cursor, mesh)
            cv = seq_write(layer_cache["v"], whole(v), cursor, mesh)
        else:
            ck, cv = cache_write(layer_cache["k"], layer_cache["v"], k, v,
                                 cursor, n_pinned=cfg.n_meta_tokens)
        new_cache = {"k": ck, "v": cv}
    elif mode == "decode":
        if seq:
            out, ck, cv, _ = col.sharded_kv_decode_attention(
                whole(q), layer_cache["k"], layer_cache["v"], whole(k),
                whole(v), positions, kv_pos, cursor, mesh)
            if local_heads:
                h_loc = q.shape[2]
                out = out.narrow(2, col.tp_rank(mesh) * h_loc, h_loc)
        else:
            ck, cv = cache_write(layer_cache["k"], layer_cache["v"], k, v,
                                 cursor, n_pinned=cfg.n_meta_tokens)
            out = decode_attention(q, ck, cv, positions, kv_pos,
                                   window=cfg.sliding_window,
                                   n_meta=cfg.n_meta_tokens)
        new_cache = {"k": ck, "v": cv}
    else:
        raise ValueError(mode)
    out = out.reshape(b, t, -1) @ p["w_o"].to(x.dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# The sharded forward (under an ambient mesh)
# ---------------------------------------------------------------------------

def spmd_mesh(cfg: ModelConfig):
    """The ambient mesh, under which every family's stack runs
    tensor-parallel (the xLSTM's and the audio model's in
    `models.xlstm` and `models.whisper`), else None."""
    del cfg
    return col.current_mesh()


def heads_aligned(cfg: ModelConfig, mesh) -> bool:
    """Whether both head counts divide the model axis: each rank then
    holds whole query and KV heads."""
    n = col.tp_size(mesh)
    return cfg.n_heads % n == 0 and cfg.n_kv_heads % n == 0


def head_dim_split(cfg: ModelConfig, mesh) -> bool:
    """Whether attention splits K and V on head_dim (`_columns_attention`'s
    head_dim form): the query heads divide the model axis, the KV heads do
    not but divide it (so each rank's query heads use one KV head), and
    head_dim divides it."""
    n = col.tp_size(mesh)
    return (cfg.n_heads % n == 0 and cfg.n_kv_heads % n != 0
            and n % cfg.n_kv_heads == 0 and cfg.resolved_head_dim % n == 0)


def columns_split(cfg: ModelConfig, mesh) -> bool:
    """Whether attention runs on the column blocks of its weights that the
    reference places on a rank (`_columns_attention`, and MLA's columns
    form in `_mla_attention_tp`): the query heads do not divide the model
    axis, and it divides every flat width that the reference splits (its
    ``_fits``; GQA: ``H * hd`` of ``w_q`` and ``w_o``'s rows, ``KVH * hd``
    of ``w_k`` and ``w_v``; MLA: ``H * (dn + dr)`` of ``w_uq``, ``H * dn``
    of ``w_uk``, ``H * dv`` of ``w_uv`` and ``w_o``'s rows).  A GQA layer
    also needs head_dim to fit, where the reference's cache rule splits
    the KV heads' head_dim: elsewhere it would replicate the cache, and
    the layer takes the gathered path with its whole cache."""
    n = col.tp_size(mesh)
    h = cfg.n_heads
    if h % n == 0:
        return False
    if cfg.mla is not None:
        m = cfg.mla
        widths = (m.qk_nope_head_dim + m.qk_rope_head_dim,
                  m.qk_nope_head_dim, m.v_head_dim)
        return all(shd.fits(h * w, n) for w in widths)
    hd = cfg.resolved_head_dim
    return all(shd.fits(w, n) for w in (h * hd, cfg.n_kv_heads * hd, hd))


def touched_heads(n_heads: int, n: int, r: int) -> Tuple[int, int]:
    """The query heads ``[lo, hi)`` that model rank ``r`` of ``n``
    computes on its column blocks: its row block of ``w_o`` covers heads
    ``[r H / n, (r + 1) H / n)``, so it touches ``[floor(r H / n),
    ceil((r + 1) H / n))`` (its own heads where ``n`` divides ``H``)."""
    return r * n_heads // n, -(-(r + 1) * n_heads // n)


def latent_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the model axis divides both MLA cache widths (``kv_lora_rank``
    and ``qk_rope_head_dim``: the reference's ``_fits``), so that a rank
    holds its columns of ``ckv`` and ``kr``."""
    n = col.tp_size(mesh)
    return all(shd.fits(w, n) for w in (cfg.mla.kv_lora_rank,
                                        cfg.mla.qk_rope_head_dim))


def ssm_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the hybrid's SSM runs on a rank's ``d_inner / TP`` channels
    (the model axis divides d_inner, as the reference's cache rule asks
    of ``ssm_h`` and ``ssm_conv``)."""
    return shd.fits(cfg.ssm.expand * cfg.d_model, col.tp_size(mesh))


def kv_layout(cfg: ModelConfig, mesh, slots: int) -> str:
    """How a rank holds the K/V cache under ``mesh``: "seq" (its slots
    ``[r * S / TP, (r + 1) * S / TP)``, every head: ``decode_kv_shard``
    without a window, so without a ring and its pinned slots), "heads"
    (its KV heads), "head_dim" (its ``hd / TP`` slice of every KV head,
    the reference's ``Shard(4)``: the head_dim and columns forms) or
    "full"; an MLA cache "latent" (its columns of ``ckv`` and ``kr``,
    `latent_split`) or "full"."""
    if cfg.mla is not None:
        return "latent" if latent_split(cfg, mesh) else "full"
    if (col.usable_mesh() is not None and cfg.decode_kv_shard
            and not cfg.sliding_window and slots % col.tp_size(mesh) == 0):
        return "seq"
    if columns_split(cfg, mesh):
        return "head_dim"
    return cross_kv_layout(cfg, mesh)


def cross_kv_layout(cfg: ModelConfig, mesh) -> str:
    """How a rank holds the VLM's vision K/V cache (``xk``, ``xv``):
    `kv_layout`'s "heads", "head_dim" or "full", never "seq" (the
    reference splits the sequence of the self cache only, its
    ``cache_shardings``)."""
    if heads_aligned(cfg, mesh):
        return "heads"
    return "head_dim" if head_dim_split(cfg, mesh) else "full"


def seq_write(cache: torch.Tensor, new: torch.Tensor, cursor,
              mesh) -> torch.Tensor:
    """Write [B, T, ...] entries at global slots ``cursor + j`` into this
    rank's [B, S / TP, ...] slice of a sequence-split cache, in place; the
    slots of other ranks are dropped.  No host read."""
    s_loc, t = cache.shape[1], new.shape[1]
    g = col.tp_rank(mesh) * s_loc + torch.arange(s_loc, device=cache.device)
    j = g - torch.as_tensor(cursor, device=cache.device).to(torch.int64)
    mine = ((j >= 0) & (j < t)).view(1, s_loc, *([1] * (cache.dim() - 2)))
    src = new.index_select(1, j.clamp(0, t - 1)).to(cache.dtype)
    return cache.copy_(torch.where(mine, src, cache))


def _gqa_attention_tp(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, *, mesh, **kw
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """`gqa_attention` over the model axis: a rank's heads where both head
    counts divide (q, k, v column-parallel, the output projection
    row-parallel, its partial sums reduced in fp32), `_columns_attention`
    where the KV heads do not divide but the reference splits the
    weights' columns (`head_dim_split`, `columns_split`), else every head
    on every rank from weights gathered whole
    (``COLLECTIVES["attn_gather"]``).  The flash kernel gets plain local
    tensors."""
    if heads_aligned(cfg, mesh):
        w = {n: col.tp_local(p[n], -1, mesh) for n in ("w_q", "w_k", "w_v")}
        w["w_o"] = col.tp_local(p["w_o"], -2, mesh)
        out, cache = gqa_attention(cfg, w, col.copy_to_tp(x, mesh),
                                   positions, mesh=mesh, **kw)
    elif head_dim_split(cfg, mesh) or columns_split(cfg, mesh):
        out, cache = _columns_attention(cfg, p, x, positions, mesh=mesh,
                                        **kw)
    else:
        w = {n: col.full(w, "attn_gather") for n, w in p.items()}
        return gqa_attention(cfg, w, x, positions, mesh=mesh, **kw)
    return col.reduce_from_tp(out.float(), mesh).to(x.dtype), cache


def gather_columns(mesh, *parts: torch.Tensor,
                   summed: bool = True) -> Tuple[torch.Tensor, ...]:
    """Each [B, T, w / TP] column block, whole: one all-gather of their
    concatenation over the model axis.  Where the ranks consume the
    products differently (``summed``, `collectives.gather_summed`) each
    block's gradient is the fp32 sum of every rank's, cut to this rank's
    columns; else (`collectives.gather`) this rank's cut of its own."""
    b, t = parts[0].shape[:2]
    n = col.tp_size(mesh)
    widths = [z.shape[-1] for z in parts]
    gather = col.gather_summed if summed else col.gather
    whole = gather(torch.cat(parts, -1), col.tp_group(mesh),
                   -1).reshape(b, t, n, sum(widths))
    return tuple(z.reshape(b, t, n * w)
                 for z, w in zip(whole.split(widths, -1), widths))


def _columns_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       positions: torch.Tensor, *, mesh, mode: str,
                       layer_cache: Optional[dict] = None,
                       kv_pos: Optional[torch.Tensor] = None, cursor=None,
                       q_chunk: int = 1024, kv_chunk: int = 1024,
                       kv_layout: Optional[str] = None
                       ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Attention on the column blocks of ``w_q``, ``w_k`` and ``w_v`` that
    the reference places on a rank, where the KV heads do not divide the
    model axis (`head_dim_split`, `columns_split`).  The rank multiplies x
    by its columns (`collectives.column_parallel_qkv`: x's gradient summed
    over the model axis in fp32) and attends on the query heads that its
    rows of ``w_o`` touch (`touched_heads`).  In the head_dim form (the
    query heads divide the axis) those are its own heads, its columns of
    k and v a slice of the one KV head they use: K and V are all-gathered
    and that head's gradient is summed over the ranks that use it inside
    attention, before rounding, as on one device
    (`collectives.kv_group_sum`); the gather's backward then cuts the
    rank's columns.  In the columns form (hymba-1.5b's 25 / 5 heads on 4
    or 16 model ranks) the three products are all-gathered at once
    (`gather_columns`: a head two ranks share gets both ranks'
    gradients), q is cut to the touched heads, and K and V are expanded
    to one KV head per touched head (a touched group need not be whole).
    The cache ("head_dim") holds the rank's head_dim slice of every KV
    head: prefill writes it from the gathered K and V; decode scores every
    head's q over the slice (`collectives.head_dim_decode_attention`) and
    all-gathers its output's head_dim.  With ``kv_layout="seq"`` the cache
    is the sequence split's, as in `gqa_attention`.  The output is cut to
    the columns ``[r H hd / TP, (r + 1) H hd / TP)`` that the rank's block
    of ``w_o`` multiplies, so each output column is computed once over
    the ranks.  x is replicated over the model axis.  Returns (the rank's
    partial sum of the output projection in fp32, the layer's cache; None
    in train mode)."""
    b, t, _ = x.shape
    dt, hd = x.dtype, cfg.resolved_head_dim
    h_all, kvh = cfg.n_heads, cfg.n_kv_heads
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    lo, hi = touched_heads(h_all, n, r)
    own = h_all % n == 0             # the head_dim form
    q, k, v = col.column_parallel_qkv(
        x, *(col.tp_local(p[w], -1, mesh).to(dt)
             for w in ("w_q", "w_k", "w_v")), mesh)
    if own:
        k, v = (col.gather(z, grp, -1) for z in (k, v))
    else:
        q, k, v = gather_columns(mesh, q, k, v)
    q = q.reshape(b, t, -1, hd)
    k = apply_rope(k.reshape(b, t, kvh, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, kvh, hd)
    # the rank's head_dim slice of every KV head, for the cache
    k_d, v_d = (z.narrow(3, r * (hd // n), hd // n) for z in (k, v))
    seq = kv_layout == "seq"
    attend = dict(window=cfg.sliding_window, n_meta=cfg.n_meta_tokens)
    new_cache = None
    if mode == "decode":
        q = apply_rope(col.all_gather(q, grp, 2) if own else q, positions,
                       cfg.rope_theta)               # every head's query
        if seq:
            out, ck, cv, _ = col.sharded_kv_decode_attention(
                q, layer_cache["k"], layer_cache["v"], k, v, positions,
                kv_pos, cursor, mesh)
        else:
            ck, cv = cache_write(layer_cache["k"], layer_cache["v"], k_d, v_d,
                                 cursor, n_pinned=cfg.n_meta_tokens)
            out = col.all_gather(col.head_dim_decode_attention(
                q, ck, cv, positions, kv_pos, mesh, **attend), grp, -1)
        out = out[:, :, lo:hi]
        new_cache = {"k": ck, "v": cv}
    elif mode in ("train", "prefill"):
        q = apply_rope(q if own else q[:, :, lo:hi], positions,
                       cfg.rope_theta)
        if own:
            j = lo // (h_all // kvh)     # the one KV head the rank uses
            k_t, v_t = (z.narrow(2, j, 1).contiguous() for z in (k, v))

            def kv_grad(z):
                return col.kv_group_sum(z, mesh, j, kvh)
        else:                            # the KV head of each touched head
            kv_of = torch.arange(lo, hi, device=x.device) // (h_all // kvh)
            k_t, v_t = (z.index_select(2, kv_of) for z in (k, v))
            kv_grad = None
        if mode == "train":
            out = chunked_attention(q, k_t, v_t, positions, positions,
                                    causal=True, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, kv_grad=kv_grad,
                                    **attend)
        else:
            out = prefill_attention(q, k_t, v_t, positions, positions,
                                    causal=True, **attend)
            if seq:
                ck = seq_write(layer_cache["k"], k, cursor, mesh)
                cv = seq_write(layer_cache["v"], v, cursor, mesh)
            else:
                ck, cv = cache_write(layer_cache["k"], layer_cache["v"],
                                     k_d, v_d, cursor,
                                     n_pinned=cfg.n_meta_tokens)
            new_cache = {"k": ck, "v": cv}
    else:
        raise ValueError(mode)
    width = h_all * hd // n
    out = out.reshape(b, t, -1).narrow(-1, r * width - lo * hd, width)
    # the partial product of the rank's rows in fp32 (the bf16 operands'
    # products summed as a bf16 GEMM sums them), so that the output is
    # rounded to the compute dtype once, after the all-reduce
    w_o = col.tp_local(p["w_o"], -2, mesh).to(dt)
    return out.float() @ w_o.float(), new_cache


def _ffn_tp(cfg: ModelConfig, p: dict, h: torch.Tensor, mode: str,
            mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The channel mix over the model axis: the MoE through `moe_ffn_ep`
    at `moe_ep.EP_CAPACITY_FACTOR` where the model axis divides the
    experts (else the one-device MoE on gathered weights, its aux averaged
    over the data axes), the dense SwiGLU through
    `collectives.swiglu_tp`."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.moe is None:
        return col.swiglu_tp(p["ffn"], h, mesh), aux
    if (col.usable_mesh() is not None
            and cfg.moe.n_routed % col.tp_size(mesh) == 0):
        return moe_ep.moe_ffn_ep(cfg.moe, p["ffn"], h, mesh,
                                 capacity_factor=moe_ep.EP_CAPACITY_FACTOR,
                                 mode="train" if mode == "train" else "serve")
    whole = {k: ({n: col.full(w) for n, w in v.items()}
                 if isinstance(v, dict) else col.full(v))
             for k, v in p["ffn"].items()}
    moe_ffn = moe_mod.moe_ffn_train if mode == "train" else moe_mod.moe_ffn
    y, aux = moe_ffn(cfg.moe, whole, h)
    return y, col.dp_mean(aux, mesh)


def _mla_attention(cfg: ModelConfig, p: dict, h: torch.Tensor,
                   positions: torch.Tensor, *, mode: str,
                   layer_cache: Optional[dict], kv_pos, cursor, q_chunk: int,
                   kv_chunk: int) -> Tuple[torch.Tensor, Optional[dict]]:
    """The MLA sub-layer: (out [B, T, d], the layer's cache {ckv, kr},
    written in place; None in train mode)."""
    mla = cfg.mla
    if mode == "decode":
        ckv_new, kr_new = mla_mod.mla_latents(mla, p, h, positions,
                                              cfg.rope_theta)
        ckv = cache_write_single(layer_cache["ckv"], ckv_new, cursor)
        kr = cache_write_single(layer_cache["kr"], kr_new, cursor)
        out = mla_mod.mla_attention_decode(mla, cfg.n_heads, p, h, positions,
                                           ckv, kr, kv_pos, cfg.rope_theta)
        return out, {"ckv": ckv, "kr": kr}
    if mode not in ("train", "prefill"):
        raise ValueError(mode)
    out, (ckv_new, kr_new) = mla_mod.mla_attention_full(
        mla, cfg.n_heads, p, h, positions, cfg.rope_theta, mode=mode,
        q_chunk=q_chunk, kv_chunk=kv_chunk)
    if mode == "train":
        return out, None
    return out, {"ckv": cache_write_single(layer_cache["ckv"], ckv_new,
                                           cursor),
                 "kr": cache_write_single(layer_cache["kr"], kr_new, cursor)}


#: MLA's down-projections: the query latent's, c_kv's and the rotary key's
_MLA_DOWN = ("w_dq", "w_dkv", "w_kr")


def _mla_latents_tp(cfg: ModelConfig, p: dict, h: torch.Tensor,
                    positions: torch.Tensor, mesh):
    """The query latent cq, c_kv and the rotary key, whole on every rank.
    Where the model axis divides the three widths (the reference places
    the down-projections split) the rank multiplies h by its columns
    (`collectives.column_parallel_qkv`: h's gradient summed over the
    model axis in fp32) and the three products are all-gathered at once
    (`gather_columns`); else the weights are gathered whole.  The norms
    and rotary apply to the whole latents."""
    mla = cfg.mla
    n, dt = col.tp_size(mesh), h.dtype
    if all(shd.fits(w, n) for w in (mla.q_lora_rank, mla.kv_lora_rank,
                                    mla.qk_rope_head_dim)):
        cq, ckv, kr = gather_columns(mesh, *col.column_parallel_qkv(
            h, *(col.tp_local(p[k], -1, mesh).to(dt) for k in _MLA_DOWN),
            mesh), summed=False)
    else:
        cq, ckv, kr = (h @ col.full(p[k], "attn_gather").to(dt)
                       for k in _MLA_DOWN)
    cq = rms_norm(cq, p["q_norm"])
    ckv = rms_norm(ckv, p["kv_norm"])
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return cq, ckv, kr


def _touched_block(w: torch.Tensor, n_heads: int, width: int,
                   mesh) -> torch.Tensor:
    """The rank's block of columns ``[r H w / TP, (r + 1) H w / TP)`` of a
    flat ``[rows, H * width]`` weight, padded with zero columns to the
    touched heads' ``[lo * width, hi * width)`` (`touched_heads`), so
    that it multiplies per head; at most two heads are partial."""
    n, r = col.tp_size(mesh), col.tp_rank(mesh)
    lo, hi = touched_heads(n_heads, n, r)
    start = r * n_heads * width // n
    return torch.nn.functional.pad(
        w, (start - lo * width, hi * width - start - w.shape[-1]))


def _mla_attention_tp(cfg: ModelConfig, p: dict, h: torch.Tensor,
                      positions: torch.Tensor, *, mesh, mode: str,
                      layer_cache: Optional[dict], kv_pos, cursor,
                      q_chunk: int, kv_chunk: int,
                      kv_layout: Optional[str] = None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """`_mla_attention` over the model axis.  The latents come whole from
    the rank's columns of the down-projections (`_mla_latents_tp`); then
    the rank multiplies them by its columns of ``w_uq``, ``w_uk`` and
    ``w_uv``: in the heads form (the model axis divides the heads) whole
    heads; in the columns form (`columns_split`: minicpm3-4b's 40 heads on
    16 ranks) blocks that cut heads, whose products are all-gathered
    (`gather_columns`) and narrowed to the heads the rank's rows of
    ``w_o`` touch (`touched_heads`).  The latents pass
    `collectives.copy_to_tp` first: each rank consumes them through its
    own columns, so their gradients are summed over the model axis before
    the norms' backward (the norm scales, whole on every rank, get the
    whole gradient).  Train and prefill attend on the touched heads
    (`mla.decompressed_attention`, prefill through the flash kernel); the
    output is narrowed to the rank's rows of ``w_o`` and the partial sums
    reduced once in fp32.  Decode reads the cache in the absorbed form,
    every head's queries on every rank: the heads form absorbs ``w_uk``
    into its heads' queries and all-gathers them; the columns form
    all-gathers q, absorbs the rank's ``w_uk`` block (`_touched_block`)
    and sums the partial absorbed queries with one fp32 SUM; the rank's
    ``w_uv`` block then gives exactly its ``w_o`` rows' input, so decode
    gathers no weight.  Where neither form holds (a width the reference
    replicates) every head runs on every rank from the up-projections and
    ``w_o`` gathered whole (``COLLECTIVES["attn_gather"]``).  With
    ``kv_layout="latent"``, in every form, the cache holds the rank's
    columns of ``ckv`` and ``kr``, scored with
    `collectives.latent_decode_attention` (one fp32 SUM of the partial
    scores, the latent output all-gathered), else whole."""
    mla = cfg.mla
    h_all, (b, t, _), dt = cfg.n_heads, h.shape, h.dtype
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    rk = mla.kv_lora_rank
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    heads = h_all % n == 0
    columns = columns_split(cfg, mesh)
    latent = kv_layout == "latent"

    def mine(z):             # the rank's columns of a whole latent
        if not latent:
            return z
        return z.narrow(-1, r * (z.shape[-1] // n), z.shape[-1] // n)

    cq, ckv, kr = _mla_latents_tp(cfg, p, h, positions, mesh)
    if heads or columns:
        cq, ckv, kr = (col.copy_to_tp(z, mesh) for z in (cq, ckv, kr))
        lo, hi = touched_heads(h_all, n, r)
        w_uq, w_uk, w_uv = (col.tp_local(p[k], -1, mesh).to(dt)
                            for k in ("w_uq", "w_uk", "w_uv"))
        w_o = col.tp_local(p["w_o"], -2, mesh).to(dt)
    else:                    # every head, from weights gathered whole
        lo, hi = 0, h_all
        w_uq, w_uk, w_uv, w_o = (col.full(p[k], "attn_gather").to(dt)
                                 for k in ("w_uq", "w_uk", "w_uv", "w_o"))
    new_cache = None
    if mode == "decode":
        ckv_c = cache_write_single(layer_cache["ckv"], mine(ckv), cursor)
        kr_c = cache_write_single(layer_cache["kr"], mine(kr), cursor)
        new_cache = {"ckv": ckv_c, "kr": kr_c}
        q = cq @ w_uq
        if columns:          # every head's queries
            q = col.all_gather(q, grp, -1)
        q = q.reshape(b, t, -1, dn + dr)
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        if columns:
            # the rank's w_uk columns absorbed into its touched heads'
            # queries; each head's partials summed over the ranks
            part = torch.einsum(
                "bthn,rhn->bthr", q[:, :, lo:hi, :dn].float(),
                _touched_block(w_uk, h_all, dn, mesh).float().reshape(
                    rk, hi - lo, dn))
            q_abs = col.all_reduce(torch.nn.functional.pad(
                part, (0, 0, lo, h_all - hi)), grp).to(dt)
        else:
            q_abs = torch.einsum("bthn,rhn->bthr", q[..., :dn],
                                 w_uk.reshape(rk, hi - lo, dn))
        if heads:            # every head's queries: one all-gather
            q = col.all_gather(torch.cat([q_abs, q_rope], -1), grp, 2)
            q_abs, q_rope = q.split([rk, dr], -1)
        if latent:
            o_lat = col.latent_decode_attention(
                mine(q_abs), mine(q_rope), ckv_c, kr_c, positions, kv_pos,
                mesh, scale=1.0 / math.sqrt(dn + dr))
        else:
            o_lat = mla_mod.latent_attention(mla, q_abs, q_rope, ckv_c, kr_c,
                                             positions, kv_pos)
        if columns:
            w_uv = _touched_block(w_uv, h_all, dv, mesh)
        out = torch.einsum("bthr,rhv->bthv", o_lat[:, :, lo:hi],
                           w_uv.reshape(rk, hi - lo, dv))
    elif mode in ("train", "prefill"):
        q, k_nope, v = cq @ w_uq, ckv @ w_uk, ckv @ w_uv
        touched = slice(None)           # the rank's own heads, or all
        if columns:                     # every head, cut to the touched
            q, k_nope, v = gather_columns(mesh, q, k_nope, v)
            touched = slice(lo, hi)
        q, k_nope, v = (z.reshape(b, t, -1, w)[:, :, touched]
                        for z, w in ((q, dn + dr), (k_nope, dn), (v, dv)))
        out = mla_mod.decompressed_attention(
            q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta),
            k_nope, kr, v, positions, mode=mode, q_chunk=q_chunk,
            kv_chunk=kv_chunk)
        if mode == "prefill":
            new_cache = {
                "ckv": cache_write_single(layer_cache["ckv"], mine(ckv),
                                          cursor),
                "kr": cache_write_single(layer_cache["kr"], mine(kr),
                                         cursor)}
    else:
        raise ValueError(mode)
    if not (heads or columns):
        return out.reshape(b, t, -1) @ w_o, new_cache
    width = h_all * dv // n
    out = out.reshape(b, t, -1).narrow(-1, r * width - lo * dv, width)
    return col.reduce_from_tp(out.float() @ w_o.float(), mesh).to(dt), \
        new_cache


def _ssm_mix(cfg: ModelConfig, p: dict, h: torch.Tensor, mode: str,
             layer_cache: Optional[dict], mesh) -> torch.Tensor:
    """The hybrid layer's SSM branch on the normed input: (y [B, T, d]),
    its state read and written in the layer's cache in place (train mode:
    from the zero state, nothing written).  Under ``mesh`` with
    `ssm_split`, on the rank's channels (`ssm.ssm_forward_tp`), y whole
    after its fp32 SUM; without a mesh, or where the model axis does not
    divide d_inner, the one-device SSM (on gathered weights)."""
    tp = mesh is not None and ssm_split(cfg, mesh)
    if not tp and mesh is not None:
        p = {k: col.full(w) for k, w in p.items()}
    if mode == "train":
        if tp:
            return ssm_mod.ssm_forward_train_tp(cfg.ssm, p, h, mesh)[0]
        return ssm_mod.ssm_forward_train(cfg.ssm, p, h)[0]
    st = ssm_mod.SSMState(h=layer_cache["ssm_h"], conv=layer_cache["ssm_conv"])
    if tp:
        y, st_new = ssm_mod.ssm_forward_tp(cfg.ssm, p, h, st, mesh)
    else:
        y, st_new = ssm_mod.ssm_forward(cfg.ssm, p, h, st)
    layer_cache["ssm_h"].copy_(st_new.h)
    layer_cache["ssm_conv"].copy_(st_new.conv)
    return y


# ---------------------------------------------------------------------------
# Layer blocks
# ---------------------------------------------------------------------------


def block_params_spec(cfg: ModelConfig, dtype) -> dict:
    """Parameter spec for one decoder layer of the cfg's family."""
    spec: dict = {"norm_attn": ((cfg.d_model,), ones_init, torch.float32),
                  "norm_ffn": ((cfg.d_model,), ones_init, torch.float32)}
    if cfg.mla is not None:
        spec["attn"] = mla_mod.mla_params_spec(cfg.d_model, cfg.n_heads,
                                               cfg.mla, dtype)
    else:
        spec["attn"] = gqa_params_spec(cfg, dtype)
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
                  q_chunk: int = 1024, kv_chunk: int = 1024,
                  kv_layout: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """One decoder layer (GQA or MLA attention; dense, MoE or hybrid
    channel mix).  Returns (x, layer_cache, aux_loss): the MoE layer's
    load-balance loss, else 0.  Under an ambient mesh the stack runs
    tensor-parallel (``kv_layout`` is the cache's `kv_layout`):
    `_gqa_attention_tp` or `_mla_attention_tp`, the hybrid's SSM on the
    rank's channels (`_ssm_mix`) and `_ffn_tp`; every sub-layer's output
    is whole on every rank before the residual add (the hybrid's two
    after their fp32 sums, before either output norm)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    mesh = spmd_mesh(cfg)
    attend = dict(mode=mode, layer_cache=layer_cache, kv_pos=kv_pos,
                  cursor=cursor, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if mesh is not None:
        tp_attention = (_mla_attention_tp if cfg.mla is not None
                        else _gqa_attention_tp)
        attn_out, new_cache = tp_attention(cfg, p["attn"], h, positions,
                                           mesh=mesh, kv_layout=kv_layout,
                                           **attend)
    elif cfg.mla is not None:
        attn_out, new_cache = _mla_attention(cfg, p["attn"], h, positions,
                                             **attend)
    else:
        attn_out, new_cache = gqa_attention(cfg, p["attn"], h, positions,
                                            **attend)
    if cfg.family == "hybrid" and cfg.ssm is not None:
        # Hymba: attention and mamba heads in parallel on the same normed
        # input, each output normed, then averaged
        ssm_out = _ssm_mix(cfg, p["ssm"], h, mode, layer_cache, mesh)
        x = x + 0.5 * (rms_norm(attn_out, p["norm_attn_out"], cfg.norm_eps)
                       + rms_norm(ssm_out, p["norm_ssm_out"], cfg.norm_eps))
    else:
        x = x + attn_out
    h2 = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    if mesh is not None:
        ffn_out, aux = _ffn_tp(cfg, p, h2, mode, mesh)
        x = x + ffn_out
    elif cfg.moe is not None:
        moe_ffn = moe_mod.moe_ffn_train if mode == "train" else moe_mod.moe_ffn
        ffn_out, aux = moe_ffn(cfg.moe, p["ffn"], h2)
        x = x + ffn_out
    elif cfg.d_ff > 0:
        x = x + swiglu(p["ffn"], h2)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Cross-attention block (VLM)
# ---------------------------------------------------------------------------


def cross_block_params_spec(cfg: ModelConfig, dtype) -> dict:
    """Parameter spec of one gated cross-attention block; its gates start
    at zero, so that at init the block adds nothing."""
    hd = cfg.resolved_head_dim
    return {
        "norm_attn": ((cfg.d_model,), ones_init, torch.float32),
        "norm_ffn": ((cfg.d_model,), ones_init, torch.float32),
        "w_q": ((cfg.d_model, cfg.n_heads * hd), dense_init, dtype),
        "w_k": ((cfg.d_model, cfg.n_kv_heads * hd), dense_init, dtype),
        "w_v": ((cfg.d_model, cfg.n_kv_heads * hd), dense_init, dtype),
        "w_o": ((cfg.n_heads * hd, cfg.d_model), dense_init, dtype),
        "gate_attn": ((1,), zeros_init, torch.float32),
        "gate_ffn": ((1,), zeros_init, torch.float32),
        "ffn": swiglu_params(cfg.d_model, cfg.d_ff, dtype),
    }


def cross_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *, mode: str,
                memory: Optional[torch.Tensor] = None,
                mem_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                q_chunk: int = 1024
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Gated cross-attention block (Llama-3.2-Vision): x [B, T, d] attends
    to every vision state, ``memory`` [B, P, d] (train, prefill) or the
    cached K and V ``mem_kv`` (decode).  Returns (x, (k, v)).  Under an
    ambient mesh the block runs tensor-parallel (`_cross_attention_tp`,
    `collectives.swiglu_tp`; ``mem_kv`` and the returned k and v are then
    the rank's part, as `cross_kv_layout` names it); each gate multiplies
    its sub-layer's output after the reduce."""
    mesh = spmd_mesh(cfg)
    h = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    attend = dict(mode=mode, memory=memory, mem_kv=mem_kv, q_chunk=q_chunk)
    if mesh is None:
        out, kv = _cross_attention(cfg, p, h, **attend)
    else:
        out, kv = _cross_attention_tp(cfg, p, h, mesh=mesh, **attend)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
    h2 = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    ffn = (swiglu(p["ffn"], h2) if mesh is None
           else col.swiglu_tp(p["ffn"], h2, mesh))
    x = x + torch.tanh(p["gate_ffn"]).to(x.dtype) * ffn
    return x, kv


def _cross_attention(cfg: ModelConfig, p: dict, h: torch.Tensor, *,
                     mode: str, memory: Optional[torch.Tensor],
                     mem_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
                     q_chunk: int
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The cross block's attention on the normed h [B, T, d]: (out [B, T,
    d], (k, v)).  The weights may hold a rank's heads only: ``out`` is
    then the rank's partial sum of the output projection."""
    b, t, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["w_q"].to(h.dtype)).reshape(b, t, -1, hd)
    if mem_kv is None:
        pm = memory.shape[1]
        k = (memory @ p["w_k"].to(h.dtype)).reshape(b, pm, -1, hd)
        v = (memory @ p["w_v"].to(h.dtype)).reshape(b, pm, -1, hd)
    else:
        k, v = mem_kv
    # zero positions on both sides: every key visible
    zq = zero_positions(b, t, h.device)
    zk = zero_positions(b, k.shape[1], h.device)
    if mode == "train":
        out = chunked_attention(q, k, v, zq, zk, causal=False,
                                q_chunk=q_chunk, kv_chunk=4096)
    elif mode == "prefill":
        out = noncausal_attention(q, k, v)
    elif mode == "decode":
        out = decode_attention(q, k, v, zq, zk)
    else:
        raise ValueError(mode)
    return out.reshape(b, t, -1) @ p["w_o"].to(h.dtype), (k, v)


def _cross_attention_tp(cfg: ModelConfig, p: dict, h: torch.Tensor, *,
                        mesh, memory: Optional[torch.Tensor], **kw
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """`_cross_attention` over the model axis, in `_gqa_attention_tp`'s
    three forms: a rank's heads where both head counts divide (q, k and v
    column-parallel by heads, K and V from the vision states, the output
    projection row-parallel), `_cross_head_dim_attention` where only the
    query heads do, else every head on every rank from gathered weights.
    The partial sums are reduced once in fp32.  The flash kernel gets
    plain local tensors."""
    if heads_aligned(cfg, mesh):
        w = {n: col.tp_local(p[n], -1, mesh) for n in ("w_q", "w_k", "w_v")}
        w["w_o"] = col.tp_local(p["w_o"], -2, mesh)
        if memory is not None:
            memory = col.copy_to_tp(memory, mesh)
        out, kv = _cross_attention(cfg, w, col.copy_to_tp(h, mesh),
                                   memory=memory, **kw)
    elif head_dim_split(cfg, mesh):
        out, kv = _cross_head_dim_attention(cfg, p, h, mesh=mesh,
                                            memory=memory, **kw)
    else:
        w = {n: col.full(p[n], "attn_gather")
             for n in ("w_q", "w_k", "w_v", "w_o")}
        return _cross_attention(cfg, w, h, memory=memory, **kw)
    return col.reduce_from_tp(out.float(), mesh).to(h.dtype), kv


def _cross_head_dim_attention(cfg: ModelConfig, p: dict, h: torch.Tensor,
                              *, mesh, mode: str,
                              memory: Optional[torch.Tensor],
                              mem_kv: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]],
                              q_chunk: int
                              ) -> Tuple[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """The cross block's attention where the query heads divide the model
    axis and the KV heads do not (`head_dim_split`), as the head_dim form
    of `_columns_attention` runs the self layers: q column-parallel (the
    rank's H / TP heads), k and v from the vision states and the rank's
    columns of ``w_k`` and ``w_v``, all-gathered into whole KV heads, the
    rank's query heads attending over the one KV head they use.  In train
    mode the gradients are summed over the model axis where one device
    sums them (`collectives.column_parallel_qkv` with the vision states as
    the K/V input, `collectives.kv_group_sum`).  The cache ("head_dim")
    holds the rank's head_dim slice of every KV head: prefill returns it
    from the gathered K and V; decode all-gathers q, scores over the slice
    with zero positions on both sides, so that every key is visible
    (`collectives.head_dim_decode_attention`), and all-gathers its
    output's head_dim.  Returns (the rank's partial sum of the output
    projection in fp32, (k, v): the rank's head_dim slices)."""
    b, t, _ = h.shape
    dt, hd = h.dtype, cfg.resolved_head_dim
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    wq, wk, wv = (col.tp_local(p[w], -1, mesh).to(dt)
                  for w in ("w_q", "w_k", "w_v"))
    h_loc = cfg.n_heads // n
    # the KV head of this rank's query heads, whose head_dim holds its
    # columns of w_k and w_v
    j = r * h_loc // (cfg.n_heads // cfg.n_kv_heads)
    zq = zero_positions(b, t, h.device)
    if mem_kv is None:
        pm = memory.shape[1]
        q, k, v = col.column_parallel_qkv(h, wq, wk, wv, mesh, kv_in=memory)
        k, v = (col.gather(z, grp, -1).reshape(b, pm, cfg.n_kv_heads, hd)
                for z in (k, v))
        k_j, v_j = (z.narrow(2, j, 1).contiguous() for z in (k, v))
        kv = tuple(z.narrow(3, r * (hd // n), hd // n) for z in (k, v))
    else:
        q, kv = h @ wq, mem_kv
    q = q.reshape(b, t, h_loc, hd)
    if mode == "train":
        out = chunked_attention(
            q, k_j, v_j, zq, zero_positions(b, pm, h.device), causal=False,
            q_chunk=q_chunk, kv_chunk=4096,
            kv_grad=lambda z: col.kv_group_sum(z, mesh, j, cfg.n_kv_heads))
    elif mode == "prefill":
        out = noncausal_attention(q, k_j, v_j)
    elif mode == "decode":
        zk = zero_positions(b, kv[0].shape[1], h.device)
        out = col.all_gather(col.head_dim_decode_attention(
            col.all_gather(q, grp, 2), *kv, zq, zk, mesh), grp, -1)
        out = out.narrow(2, r * h_loc, h_loc)
    else:
        raise ValueError(mode)
    w_o = col.tp_local(p["w_o"], -2, mesh).to(dt)
    return out.reshape(b, t, -1).float() @ w_o.float(), kv


# ---------------------------------------------------------------------------
# The stack: a loop over stacked [L, ...] layer params and cache slices
# ---------------------------------------------------------------------------


def _train_block(cfg, p, x, positions, q_chunk, kv_chunk):
    x, _, aux = decoder_block(cfg, col.gather_layer(p), x, positions,
                              mode="train", q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    return x, aux


def stack_apply(cfg: ModelConfig, blocks_params: dict, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                cache: Optional[dict] = None,
                kv_pos: Optional[torch.Tensor] = None, cursor=None,
                q_chunk: int = 1024, kv_chunk: int = 1024,
                kv_layout: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Homogeneous decoder stack.  Returns (h, cache, aux_loss_sum); the
    stacked cache (``k``, ``v`` [L, B, S, KVH, D], and for the hybrid family
    ``ssm_h``, ``ssm_conv``) is written in place, one layer's view at a
    time.  In train mode each layer runs under ``torch.utils.checkpoint``:
    what it keeps for backward is its input."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p_i = layer_slice(blocks_params, i)
        if mode == "train":
            x, aux_i = checkpoint(_train_block, cfg, p_i, x, positions,
                                  q_chunk, kv_chunk, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            cache_i = layer_slice(cache, i) if cache is not None else None
            x, _, aux_i = decoder_block(
                cfg, p_i, x, positions, mode=mode, layer_cache=cache_i,
                kv_pos=kv_pos, cursor=cursor, kv_layout=kv_layout)
        aux = aux + aux_i
    return x, cache, aux


def _train_cross(cfg, p, x, memory, q_chunk):
    return cross_block(cfg, col.gather_layer(p), x, mode="train",
                       memory=memory, q_chunk=q_chunk)[0]


def vlm_stack_apply(cfg: ModelConfig, params: dict, x: torch.Tensor,
                    positions: torch.Tensor, *, mode: str,
                    vision_states: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None,
                    kv_pos: Optional[torch.Tensor] = None, cursor=None,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    kv_layout: Optional[str] = None
                    ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The interleaved stack: groups of ``cross_attn_every - 1`` self
    layers (``params["blocks"]``, stacked ``[n_self, ...]``), each group
    followed by one gated cross-attention block (``params["cross"]``,
    ``[n_groups, ...]``).  ``vision_states`` [B, P, d] feed the cross
    blocks in train and prefill; prefill writes each group's K and V into
    the cache's ``xk`` / ``xv`` [n_groups, B, P, KVH, D] in place (under a
    mesh the rank's part, `cross_kv_layout`), decode reads them.
    ``kv_layout`` is the self layers' cache layout (`kv_layout`).  Returns
    (h, cache, aux_loss_sum); in train mode every self layer and cross
    block runs under ``torch.utils.checkpoint``."""
    per = cfg.vision.cross_attn_every - 1
    n_groups = cfg.n_layers // cfg.vision.cross_attn_every
    train = mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    self_cache = None if train else {"k": cache["k"], "v": cache["v"]}
    for g in range(n_groups):
        for i in range(g * per, (g + 1) * per):
            p_i = layer_slice(params["blocks"], i)
            if train:
                x, aux_i = checkpoint(_train_block, cfg, p_i, x, positions,
                                      q_chunk, kv_chunk, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, _, aux_i = decoder_block(
                    cfg, p_i, x, positions, mode=mode,
                    layer_cache=layer_slice(self_cache, i), kv_pos=kv_pos,
                    cursor=cursor, kv_layout=kv_layout)
            aux = aux + aux_i
        p_c = layer_slice(params["cross"], g)
        if train:
            x = checkpoint(_train_cross, cfg, p_c, x, vision_states, q_chunk,
                           use_reentrant=False, preserve_rng_state=False)
        elif mode == "prefill":
            x, (k, v) = cross_block(cfg, p_c, x, mode=mode,
                                    memory=vision_states, q_chunk=q_chunk)
            cache["xk"][g].copy_(k)
            cache["xv"][g].copy_(v)
        else:
            x, _ = cross_block(cfg, p_c, x, mode=mode,
                               mem_kv=(cache["xk"][g], cache["xv"][g]),
                               q_chunk=q_chunk)
    return x, cache, aux
