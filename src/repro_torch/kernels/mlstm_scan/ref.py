"""Plain PyTorch version of the chunkwise mLSTM kernel: the chunked form from
a zero or a carried state.

``mlstm_chunk`` is the port of ``src/repro/models/xlstm.py:87
_mlstm_chunk`` over any leading dims.  ``mlstm_chunks`` runs it chunk by
chunk from a carried state, with the ragged tail padded as the reference's
``mlstm_forward`` pads it (``:168-173``: q, k, v 0, lf 0, li -1e30, so a
padded step writes nothing).  ``mlstm_scan_ref`` is that from the zero
state C = n = 0, m = -1e30 of the TPU kernel's ``_init``
(``src/repro/kernels/mlstm_scan/kernel.py:59-63``) or from a given one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_BIG = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                lf: torch.Tensor, li: torch.Tensor,
                state: State) -> Tuple[torch.Tensor, State]:
    """One chunk of the stabilised chunked-parallel mLSTM.

    q, k, v [..., L, dh] (k pre-scaled by 1/sqrt(dh)); lf, li [..., L]
    log-forget (logsigmoid) and input-gate preactivations; state (c
    [..., dh(v), dh(k)], n [..., dh], m [...]) in fp32.  Returns (h
    [..., L, dh] fp32, the new state)."""
    c0, n0, m0 = state
    qf, kf, vf = q.float(), k.float(), v.float()
    b = torch.cumsum(lf, dim=-1)                       # inclusive log decay
    # g_i = max(m0, cummax_{t<=i}(li_t - b_t)); m_i = b_i + g_i
    g = torch.maximum(m0[..., None], torch.cummax(li - b, dim=-1).values)
    m_i = b + g
    # intra-chunk weights: D[i,t] = exp(li_t - b_t - g_i) for t <= i
    lt = (li - b)[..., None, :] - g[..., :, None]
    length = q.shape[-2]
    tri = torch.ones((length, length), dtype=torch.bool,
                     device=q.device).tril()
    d_w = torch.where(tri, torch.exp(lt), torch.zeros((), device=q.device))
    scores = qf @ kf.transpose(-1, -2)
    w_it = scores * d_w
    inter = torch.exp(m0[..., None] - g)
    h_num = w_it @ vf + (qf @ c0.transpose(-1, -2)) * inter[..., None]
    # the normaliser uses the decay weights only; the q.k scores enter once,
    # through the q.n contraction
    n_i = d_w @ kf + n0[..., None, :] * inter[..., None]
    qn = (qf * n_i).sum(-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_i))
    h = h_num / denom[..., None]
    # carry: C_L = e^{m0 - g_L} C_0 + sum_t e^{li_t - b_t - g_L} v_t k_t^T
    g_l = g[..., -1]
    m_new = m_i[..., -1]
    wc = torch.exp(li - b - g_l[..., None])
    decay = torch.exp(m0 - g_l)
    c_new = c0 * decay[..., None, None] + (vf * wc[..., None]).transpose(
        -1, -2) @ kf
    n_new = n0 * decay[..., None] + (kf * wc[..., None]).sum(-2)
    return h, (c_new, n_new, m_new)


def pad_chunks(q, k, v, lf, li, chunk: int):
    """Pad the time axis (``-2`` of q, k, v; ``-1`` of the gates) to whole
    chunks as ``mlstm_forward`` does: 0 for q, k, v and lf, -1e30 for li."""
    t = q.shape[-2]
    pad = -(-t // chunk) * chunk - t
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        lf = F.pad(lf, (0, pad))
        li = F.pad(li, (0, pad), value=NEG_BIG)
    return q, k, v, lf, li


def mlstm_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lf: torch.Tensor, li: torch.Tensor, state: State, *,
                 chunk: int) -> Tuple[torch.Tensor, State]:
    """``mlstm_chunk`` chunk by chunk over any leading dims: q, k, v
    [..., T, dh], lf, li [..., T] fp32, from the carried ``state`` ->
    (h [..., T, dh] fp32, the new state).  The ragged tail is padded."""
    t = q.shape[-2]
    chunk = min(chunk, t)
    q, k, v, lf, li = pad_chunks(q, k, v, lf, li, chunk)
    hs = []
    for c0 in range(0, q.shape[-2], chunk):
        sl = slice(c0, c0 + chunk)
        h, state = mlstm_chunk(q[..., sl, :], k[..., sl, :], v[..., sl, :],
                               lf[..., sl], li[..., sl], state)
        hs.append(h)
    return torch.cat(hs, dim=-2)[..., :t, :], state


def zero_state(bh: int, dh: int, device) -> State:
    """The TPU kernel's ``_init``: C = n = 0, m = -1e30, fp32."""
    return (torch.zeros((bh, dh, dh), device=device),
            torch.zeros((bh, dh), device=device),
            torch.full((bh,), NEG_BIG, device=device))


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lf: torch.Tensor, li: torch.Tensor,
                   state: Optional[State] = None, *, chunk: int = 256):
    """q, k, v [BH, S, dh]; lf, li [BH, S], from ``state`` (C0 [BH, dh(v),
    dh(k)], n0 [BH, dh], m0 [BH] fp32; None is ``zero_state``) -> (h
    [BH, S, dh] in q's dtype, (C [BH, dh, dh], n [BH, dh], m [BH, 1]) in
    fp32)."""
    bh, _, dh = q.shape
    if state is None:
        state = zero_state(bh, dh, q.device)
    h, (c, n, m) = mlstm_chunks(q, k, v, lf.float(), li.float(), state,
                                chunk=chunk)
    return h.to(q.dtype), (c, n, m[:, None])
