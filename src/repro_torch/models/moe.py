"""Fine-grained Mixture-of-Experts FFN (DeepSeek-MoE / DBRX style): the
serving path of the port of ``src/repro/models/moe.py``.

Routing is the reference's: fp32 router logits, softmax, top-k,
renormalised weights, and the Switch-style load-balance loss.  The expert
FFN runs in the capacity form that the grouped-matmul kernel computes
(`repro_torch.kernels.moe_gmm.ops.expert_swiglu`), held to the result of
the reference's ``ragged_dot`` over expert-sorted rows:

1. the T·k (token, slot) pairs are sorted by expert, stably (the
   reference's ``jnp.argsort``); each pair's position within its expert is
   its rank among that expert's pairs in flat order;
2. the rows are scattered into a zero ``[E, C, d]`` buffer in x's dtype,
   with C at least the largest count, so that no pair is dropped (the
   reference's ``moe_ffn`` drops nothing; the capacity-factor drops of
   ``distributed/moe_ep.py`` belong to the expert-parallel slice);
3. ``expert_swiglu(buffer, w_gate, w_up, w_down, counts)``: three kernel
   launches, with the weights in their stored dtype;
4. each pair's output row is gathered back from (expert, position),
   weighted, and each token's k contributions are summed in fp32, in slot
   order (no atomics); the shared experts' SwiGLU is added in fp32, and the
   sum is cast to x's dtype.

C is T when T is at most the kernel's row tile (a token picks an expert at
most once, so no count exceeds T: every decode step at small batch);
otherwise it is the largest count rounded up to the row tile, which takes
**one host read per MoE layer** (``HOST_READS`` counts them).  That read
is what stands in the way of capturing a prefill in a CUDA graph.  A step
costed on meta tensors (`roofline.counting.costing`) cannot read the
counts: there C is a uniform router's at the reference EP's factor 1.25,
``ceil(1.25 T k / E)`` rounded up to the row tile, and the count's record
notes it.

Training (`moe_ffn_train`) never reaches the kernel, which has no
backward: the same routing and dispatch feed a capacity buffer whose three
products are ``torch.bmm`` with autograd, the weights cast to x's dtype as
the reference's ``ragged_dot`` casts them (``w_gate.astype(dt)``), and the
same capacity, with its host read, in forward and again in the layer's
recompute.  Every op of it has a deterministic backward on the card: the
buffer is filled by ``index_copy`` and read back by ``index_select``, and
the combine gathers through the pair order instead of scattering.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import dense_init, swiglu, swiglu_params
from repro_torch.roofline import counting

#: host reads of the largest expert count (one per MoE layer whose tokens
#: exceed the kernel's row tile) since the count was last reset
HOST_READS = 0
#: the capacity factor of a step costed on meta tensors (the reference
#: EP's, ``distributed.moe_ep.EP_CAPACITY_FACTOR``)
UNIFORM_CAPACITY_FACTOR = 1.25


def moe_params_spec(d_model: int, moe: MoEConfig, dtype) -> dict:
    spec = {
        "router": ((d_model, moe.n_routed), dense_init, torch.float32),
        "w_gate": ((moe.n_routed, d_model, moe.d_expert), dense_init, dtype),
        "w_up": ((moe.n_routed, d_model, moe.d_expert), dense_init, dtype),
        "w_down": ((moe.n_routed, moe.d_expert, d_model), dense_init, dtype),
    }
    if moe.n_shared:
        d_sh = moe.d_shared or moe.d_expert * moe.n_shared
        spec["shared"] = swiglu_params(d_model, d_sh, dtype)
    return spec


def route_topk(router_logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k routing (DeepSeek-MoE).

    router_logits [T, E] -> (weights [T, k] renormalised, experts [T, k]
    int32, probs [T, E]).  The top k come from a stable descending sort, so
    that exact ties go to the lower expert index as ``lax.top_k``'s do
    (``torch.topk`` leaves ties unspecified)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx[:, :top_k].to(torch.int32), probs


def expert_counts(flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Pairs per expert [E] int64 of the int64 expert ids ``flat``: a
    scatter-add of ones, which reads nothing back to the host
    (``torch.bincount`` on the card reads the largest id to size its
    output)."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss ``E * sum_e f_e * p_e``: f_e the fraction
    of routed (token, slot) pairs sent to e, p_e the mean router probability
    of e; 1 at a perfectly uniform router."""
    counts = expert_counts(experts.reshape(-1).long(), n_experts)
    f = counts.float() / experts.numel()
    return n_experts * (f * probs.mean(dim=0)).sum()


def capacity(n_tokens: int, counts: torch.Tensor,
             top_k: Optional[int] = None) -> int:
    """Capacity rows per expert that drop no pair: ``n_tokens`` up to the
    kernel's row tile, else the largest count rounded up to it (one host
    read).  Costing on meta tensors, a uniform router's at
    `UNIFORM_CAPACITY_FACTOR` over ``top_k`` slots a token, with no
    read."""
    global HOST_READS
    tile = gmm_ops.ROW_TILE
    if n_tokens <= tile:
        return n_tokens
    if counting.dry(counts.device):
        if top_k is None:
            raise ValueError("costing a capacity on meta needs top_k")
        uniform = math.ceil(UNIFORM_CAPACITY_FACTOR * n_tokens * top_k
                            / counts.shape[0])
        cap = -(-uniform // tile) * tile
        counting.note("moe_capacity", cap)
        return cap
    HOST_READS += 1
    return -(-int(counts.max()) // tile) * tile  # analysis: ignore[host-read] -- counted in HOST_READS


def dispatch(experts: torch.Tensor, n_experts: int):
    """experts [T, k] -> (counts [E] int32, position [T, k] of each pair
    within its expert, in flat order)."""
    flat = experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = expert_counts(flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = (torch.arange(flat.numel(), device=flat.device)
             - starts[flat[order]])
    pos = torch.empty_like(ranks)
    pos[order] = ranks
    return counts.to(torch.int32), pos.view(experts.shape)


def _route(moe: MoEConfig, params: dict, xf: torch.Tensor):
    """Router logits in fp32, top-k and the scaled load-balance loss."""
    logits = xf.float() @ params["router"].float()
    weights, experts, probs = route_topk(logits, moe.top_k)
    aux = load_balance_loss(probs, experts, moe.n_routed)
    return weights, experts, aux * moe.router_aux_coef


def moe_ffn(moe: MoEConfig, params: dict,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x [..., d].  Returns (y [..., d] in x's dtype, aux loss
    scalar fp32)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e = moe.n_routed

    weights, experts, aux = _route(moe, params, xf)
    counts, pos = dispatch(experts, e)
    rows = experts.long()
    buf = torch.zeros((e, capacity(t, counts, moe.top_k), d),
                      dtype=x.dtype, device=x.device)
    buf[rows, pos] = xf[:, None, :].expand(t, moe.top_k, d)
    out = gmm_ops.expert_swiglu(buf, params["w_gate"], params["w_up"],
                                params["w_down"], counts,
                                pairs=t * moe.top_k)
    y = (out[rows, pos].float() * weights[..., None]).sum(dim=1)

    if moe.n_shared:
        y = y + swiglu(params["shared"], xf).float()
    return y.reshape(*lead, d).to(x.dtype), aux


def moe_ffn_train(moe: MoEConfig, params: dict,
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_ffn`'s train form, with autograd and no kernel: the reference's
    ``grouped_expert_ffn`` over expert-sorted pairs (``src/repro/models/
    moe.py:60-108``) as three ``torch.bmm`` over a zero-padded ``[E, C,
    d]`` buffer.  The pairs keep `moe_ffn`'s places (each pair's row is
    its rank among its expert's pairs in flat order, the reference's stable
    sort); the padding rows are zeros that no output reads, so they add
    exact zeros to every gradient.  Each token's k contributions are summed
    in fp32 in slot order.  Returns (y [..., d] in x's dtype, aux loss)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t, k, e = xf.shape[0], moe.top_k, moe.n_routed
    dt = x.dtype

    weights, experts, aux = _route(moe, params, xf)
    counts, pos = dispatch(experts, e)
    c = capacity(t, counts, k)
    # each (token, slot) pair's row of the [E * C, d] buffer, in flat order
    slot = (experts.long() * c + pos).reshape(-1)
    token = torch.arange(t * k, device=x.device) // k
    buf = xf.new_zeros((e * c, d)).index_copy(
        0, slot, xf.index_select(0, token))
    buf = buf.view(e, c, d)
    gate = torch.bmm(buf, params["w_gate"].to(dt))
    up = torch.bmm(buf, params["w_up"].to(dt))
    out = torch.bmm(F.silu(gate) * up, params["w_down"].to(dt))
    ys = out.view(e * c, d).index_select(0, slot).view(t, k, d).float()
    y = ys[:, 0] * weights[:, :1]
    for j in range(1, k):
        y = y + ys[:, j] * weights[:, j:j + 1]

    if moe.n_shared:
        y = y + swiglu(params["shared"], xf).float()
    return y.reshape(*lead, d).to(dt), aux
