"""Attention: the training primitive, prefill through the flash kernel,
decode against a padded KV cache, and the ring KV cache itself.

The port of ``src/repro/models/attention.py``.

* ``chunked_attention`` is the reference's training primitive, plain torch
  with autograd (the reference runs no kernel on this path): an online
  softmax over KV chunks inside a loop over Q chunks, fp32 scores and
  sums, P cast to V's dtype before P·V (the reference's
  ``p.astype(vc.dtype)``, ``attention.py:124``), so that bf16 training
  rounds as the reference does.  Each Q chunk runs under
  ``torch.utils.checkpoint``: backward recomputes its KV loop (the
  reference's ``jax.checkpoint``), so that what a Q chunk keeps for
  backward is its inputs and output, never its ``[Sq, Skv]`` scores.

* ``prefill_attention`` is the reference prefill's ``chunked_attention(q,
  k, v, positions, positions, causal=True, ...)`` for the one case the model
  calls it with, ``positions = arange``: exactly the function of the flash
  kernel, whose positions are the row and column indices.  It calls
  `kernels.flash_attention.ops.flash_attention` and raises for any other
  positions.  Positions built by ``arange_positions`` (the model's prefill
  builds its own there) carry a mark and pass without a look at their
  values; any other positions are compared with arange, which on the card
  costs a device read (a host sync).
* ``noncausal_attention`` is the reference prefill's cross-attention and
  Whisper encoder call, ``chunked_attention(q, k, v, zeros, zeros,
  causal=False, ...)`` with Sq != Skv allowed: every key visible to every
  query, a function of no position, so it takes none and calls the flash
  kernel with ``causal=False, window=0, n_meta=0``.
* ``decode_attention`` is plain torch, as in the reference (no kernel):
  fp32 scores, then P cast to the cache's dtype before P·V
  (``attention.py:184``).
* The cache writers scatter **in place** (``index_copy_`` on the cache
  tensor, or on the view of one layer of the stacked cache) and return the
  tensor they wrote.  The reference's ``mode="drop"`` (entries overwritten
  by a later entry of the same write land on slot ``size``), since torch
  raises on an index out of bounds, becomes a write of the entries that
  can be kept, of a size known on the host, each dropped one turned into
  a second write of the last entry: no read back; a write that fits the
  ring drops nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


def visibility_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    n_meta: int = 0) -> torch.Tensor:
    """Boolean [..., Sq, Skv] visibility from positions [..., Sq] and
    [..., Skv] (-1 marks an invalid cache slot)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    vis = kp >= 0
    if causal:
        vis = vis & (kp <= qp)
    if window > 0:
        in_window = (qp - kp) < window
        if n_meta > 0:
            in_window = in_window | (kp < n_meta)
        vis = vis & in_window
    return vis


def _pad_axis(x: torch.Tensor, axis: int, multiple: int, value=0):
    """``x`` padded with ``value`` along ``axis`` to a multiple of
    ``multiple``."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    shape = list(x.shape)
    shape[axis] = target - n
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _attend_q_chunk(qc, qp, kr, vr, kpr, *, causal, window, n_meta,
                    out_dtype, kv_grad=None):
    """One Q chunk against every KV chunk: qc [B, qc, KVH, G, Dk], qp
    [B, qc]; kr [B, nk, kc, KVH, Dk], vr [B, nk, kc, KVH, Dv], kpr
    [B, nk, kc] -> [B, qc, KVH, G, Dv] in ``out_dtype``.  ``kv_grad``, if
    given, is applied to each K and V chunk in fp32 (`chunked_attention`)."""
    b, n, kvh, g, dk = qc.shape
    scale = 1.0 / math.sqrt(dk)
    f32 = torch.float32
    m = torch.full((b, kvh, g, n), NEG_INF, dtype=f32, device=qc.device)
    l = torch.zeros((b, kvh, g, n), dtype=f32, device=qc.device)
    acc = torch.zeros((b, kvh, g, n, vr.shape[-1]), dtype=f32,
                      device=qc.device)
    qf = qc.float()
    for j in range(kr.shape[1]):
        kc, vc, kp = kr[:, j], vr[:, j], kpr[:, j]
        # the products of the inputs' values, summed in fp32 (the
        # reference's preferred_element_type=float32)
        kf, vf = kc.float(), vc.float()
        if kv_grad is not None:
            kf, vf = kv_grad(kf), kv_grad(vf)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf, kf) * scale
        vis = visibility_mask(qp, kp, causal=causal, window=window,
                              n_meta=n_meta)
        s = torch.where(vis[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vc.dtype).float(), vf)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(out_dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0, n_meta: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      kv_grad=None) -> torch.Tensor:
    """Flash-style attention with autograd: q [B, Sq, H, Dk], k [B, Skv,
    KVH, Dk], v [B, Skv, KVH, Dv], positions [B, Sq] and [B, Skv] (-1 an
    invalid slot) -> [B, Sq, H, Dv] in q's dtype.  GQA: H a multiple of
    KVH; fp32 softmax sums.  ``kv_grad`` (an identity in value, e.g.
    `distributed.collectives.kv_group_sum`) sees each K and V chunk in
    fp32, where its gradient is still unrounded; None on one device."""
    b, sq, h, dk = q.shape
    _, skv, kvh, _ = k.shape
    dv = v.shape[-1]
    g = h // kvh
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    q = _pad_axis(q, 1, q_chunk)
    q_pos = _pad_axis(q_pos, 1, q_chunk, 0)
    k = _pad_axis(k, 1, kv_chunk)
    v = _pad_axis(v, 1, kv_chunk)
    kv_pos = _pad_axis(kv_pos, 1, kv_chunk, -1)  # padded slots invisible
    nq = q.shape[1] // q_chunk
    nk = k.shape[1] // kv_chunk
    qr = q.reshape(b, nq, q_chunk, kvh, g, dk)
    qpr = q_pos.reshape(b, nq, q_chunk)
    kr = k.reshape(b, nk, kv_chunk, kvh, dk)
    vr = v.reshape(b, nk, kv_chunk, kvh, dv)
    kpr = kv_pos.reshape(b, nk, kv_chunk)
    outs = []
    for i in range(nq):
        # backward recomputes the chunk's KV loop (the reference's
        # jax.checkpoint); the model has no randomness to replay
        outs.append(checkpoint(
            _attend_q_chunk, qr[:, i], qpr[:, i], kr, vr, kpr,
            causal=causal, window=window, n_meta=n_meta, out_dtype=q.dtype,
            kv_grad=kv_grad, use_reentrant=False, preserve_rng_state=False))
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq]


_ARANGE_MARK = "_rows_are_arange"


def arange_positions(batch: int, length: int, device) -> torch.Tensor:
    """int32 positions [batch, length], ``arange(length)`` in every row (an
    expanded view, so nothing can write them), marked as such: they pass
    `prefill_attention`'s guard without a device read."""
    pos = torch.arange(length, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, length)
    setattr(pos, _ARANGE_MARK, True)
    return pos


def _is_arange(pos: torch.Tensor) -> bool:
    """Whether every row of ``pos`` is ``arange(S)``.  Positions that
    `arange_positions` built pass without a look at their values; only
    others are compared, one host read.  No serving path reaches the
    read: `Model.prefill` builds its positions so and passes them on
    unchanged (``dispatch-host-reads`` holds every family's prefill to
    the MoE's counted reads)."""
    if getattr(pos, _ARANGE_MARK, False):
        return True                  # built so: no look at the values
    ar = torch.arange(pos.shape[-1], dtype=pos.dtype, device=pos.device)
    return bool(torch.equal(pos, ar.expand_as(pos)))  # analysis: ignore[host-read] -- unmarked positions only: no serving path


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      n_meta: int = 0) -> torch.Tensor:
    """q [B, S, H, D], k [B, S, KVH, D], v [B, S, KVH, Dv <= D],
    positions [B, S] that must be ``arange(S)`` in every row -> [B, S, H,
    Dv] in q's dtype."""
    if q_pos.shape != kv_pos.shape or not _is_arange(q_pos) or (
            kv_pos is not q_pos and not _is_arange(kv_pos)):
        raise ValueError("prefill_attention takes positions arange(S) only "
                         "(the flash kernel's row and column indices); "
                         "other positions need chunked_attention")
    return flash_attention(q, k, v, causal=causal, window=window,
                           n_meta=n_meta)


def zero_positions(batch: int, length: int, device) -> torch.Tensor:
    """int32 positions [batch, length] of 0: with zeros on both sides
    every key is visible to every query, as the reference's cross-attention
    passes them."""
    return torch.zeros((batch, length), dtype=torch.int32, device=device)


def noncausal_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, H, D], k [B, Skv, KVH, D], v [B, Skv, KVH, Dv <= D] ->
    [B, Sq, H, Dv] in q's dtype, every key visible to every query."""
    return flash_attention(q, k, v, causal=False, window=0, n_meta=0)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_pos: torch.Tensor,
                     kv_pos: torch.Tensor, *, window: int = 0,
                     n_meta: int = 0) -> torch.Tensor:
    """Few-token attention against a padded KV cache: q [B, Tq, H, Dk],
    caches [B, S, KVH, D], q_pos [B, Tq], kv_pos [B, S] (-1 = empty) ->
    [B, Tq, H, Dv] in q's dtype."""
    b, tq, h, dk = q.shape
    kvh = k_cache.shape[2]
    scale = 1.0 / math.sqrt(dk)
    qr = q.reshape(b, tq, kvh, h // kvh, dk)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k_cache.float()) * scale
    vis = visibility_mask(q_pos, kv_pos, causal=True, window=window,
                          n_meta=n_meta)
    s = torch.where(vis[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, tq, h, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stacked KV cache.

    k, v: [L, B, S, KVH, D]; pos: [B, S] int32 slot positions (-1 empty);
    length: [] int32 write cursor (the same for all batch rows).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def init(n_layers, batch, max_seq, n_kv, d_k, d_v=None,
             dtype=torch.bfloat16, device="cpu"):
        d_v = d_k if d_v is None else d_v
        return KVCache(
            k=torch.zeros((n_layers, batch, max_seq, n_kv, d_k), dtype=dtype,
                          device=device),
            v=torch.zeros((n_layers, batch, max_seq, n_kv, d_v), dtype=dtype,
                          device=device),
            pos=torch.full((batch, max_seq), -1, dtype=torch.int32,
                           device=device),
            length=torch.zeros((), dtype=torch.int32, device=device),
        )


def ring_slots(cursor, n_new: int, size: int,
               n_pinned: int = 0) -> torch.Tensor:
    """Slot indices (int32 [n_new]) for writing ``n_new`` entries at
    ``cursor`` (an int or an int32 tensor) into a cache of ``size`` slots
    whose first ``n_pinned`` slots are never recycled and whose other
    ``size - n_pinned`` slots form a ring.  Entries that a later entry of
    the same write would overwrite are sent to slot ``size``."""
    cursor = torch.as_tensor(cursor, dtype=torch.int32)
    idx = cursor + torch.arange(n_new, dtype=torch.int32,
                                device=cursor.device)
    ring = max(size - n_pinned, 1)
    slot = torch.where(idx < n_pinned, idx,
                       n_pinned + torch.remainder(idx - n_pinned, ring))
    keep = (idx < n_pinned) | (idx >= cursor + n_new - ring)
    return torch.where(keep, slot, torch.full_like(slot, size))


def _scatter(cache: torch.Tensor, new: torch.Tensor, cursor,
             n_pinned: int) -> torch.Tensor:
    """``cache[:, slots] = new`` in place, dropping the entries sent to slot
    ``size``."""
    size, n_new = cache.shape[1], new.shape[1]
    slots = ring_slots(cursor, n_new, size, n_pinned).to(cache.device)
    new = new.to(cache.dtype)
    ring = max(size - n_pinned, 1)
    if n_new > ring:
        # the write keeps the last `ring` entries and, of the first
        # min(n_pinned, n_new - ring), those whose slot is pinned (the
        # cursor on the device decides which): a first entry that is
        # dropped writes the last entry's value into the last entry's
        # slot, the same value twice, so that nothing is read back (on
        # meta tensors too)
        head = min(n_pinned, n_new - ring)
        first, last = slots[:head], slots[n_new - ring:]
        drop = first == size
        mask = drop.view(1, head, *([1] * (new.dim() - 2)))
        slots = torch.cat([torch.where(drop, slots[-1], first), last])
        new = torch.cat([torch.where(mask, new[:, -1:], new[:, :head]),
                         new[:, n_new - ring:]], dim=1)
    return cache.index_copy_(1, slots.long(), new)


def cache_write(cache_k, cache_v, k_new, v_new, cursor, n_pinned: int = 0):
    """Scatter [B, T, KVH, D] new K/V into [B, S, KVH, D] caches at
    ``cursor``, in place; returns (k, v).  One code path for full caches,
    sliding-window rings and pinned meta-token slots."""
    return (_scatter(cache_k, k_new, cursor, n_pinned),
            _scatter(cache_v, v_new, cursor, n_pinned))


def cache_write_single(cache: torch.Tensor, new: torch.Tensor, cursor,
                       n_pinned: int = 0) -> torch.Tensor:
    """Scatter one [B, T, ...] tensor into a [B, S, ...] ring cache in
    place."""
    return _scatter(cache, new, cursor, n_pinned)


def cache_pos_write(pos: torch.Tensor, new_pos: torch.Tensor, cursor,
                    n_pinned: int = 0) -> torch.Tensor:
    """Scatter new absolute positions [B, T] into the pos ring [B, S] in
    place."""
    return _scatter(pos, new_pos, cursor, n_pinned)
