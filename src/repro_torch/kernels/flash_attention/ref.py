"""Plain PyTorch version of the flash-attention forward kernel: naive full
scores, the port of ``src/repro/kernels/flash_attention/ref.py``.

Full fp32 scores of the inputs converted to fp32, times ``sm_scale``; the
visibility rule of the TPU kernel (row and column index as positions:
causal, sliding window, always-visible meta tokens); masked scores
``-1e30``; an fp32 softmax; fp32 P·V; the result cast to q's dtype.  GQA
repeats each KV head over its ``group`` query heads.  V may be narrower
than Q and K (Dv <= D): P·V gives Dv columns, which are the first Dv
columns of the kernels' launch on V padded with zero columns to D.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visible(sq: int, skv: int, *, causal: bool, window: int, n_meta: int,
            device=None) -> torch.Tensor:
    """Boolean [Sq, Skv]: the kernel's rule, row i and column j being the
    query's and the key's positions (top-left aligned)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    vis = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        vis &= k_pos <= q_pos
    if window > 0:
        in_win = (q_pos - k_pos) < window
        if n_meta > 0:
            in_win |= k_pos < n_meta
        vis &= in_win
    return vis


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  group: int, causal: bool = True, window: int = 0,
                  n_meta: int = 0,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [BH, Sq, d], k [BKV, Skv, d], v [BKV, Skv, dv] (BH = BKV * group)
    -> [BH, Sq, dv] in q's dtype."""
    _, sq, d = q.shape
    skv = k.shape[1]
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kr = k.repeat_interleave(group, dim=0)
    vr = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * sm_scale
    vis = visible(sq, skv, causal=causal, window=window, n_meta=n_meta,
                  device=q.device)
    s = torch.where(vis[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vr.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        n_meta: int = 0) -> torch.Tensor:
    """The model layout: q [B, Sq, H, D], k [B, Skv, KVH, D], v [B, Skv,
    KVH, Dv] -> [B, Sq, H, Dv], scaled by the true head dim ``D ** -0.5``."""
    b, sq, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * kvh, k.shape[1], d)
    vt = v.transpose(1, 2).reshape(b * kvh, v.shape[1], dv)
    out = attention_ref(qt, kt, vt, group=h // kvh, causal=causal,
                        window=window, n_meta=n_meta)
    return out.reshape(b, h, sq, dv).transpose(1, 2)
