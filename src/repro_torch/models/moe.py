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
is what stands in the way of capturing a prefill in a CUDA graph.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import dense_init, swiglu, swiglu_params

#: host reads of the largest expert count (one per MoE layer whose tokens
#: exceed the kernel's row tile) since the count was last reset
HOST_READS = 0


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


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss ``E * sum_e f_e * p_e``: f_e the fraction
    of routed (token, slot) pairs sent to e, p_e the mean router probability
    of e; 1 at a perfectly uniform router."""
    counts = torch.bincount(experts.reshape(-1).long(), minlength=n_experts)
    f = counts.float() / experts.numel()
    return n_experts * (f * probs.mean(dim=0)).sum()


def capacity(n_tokens: int, counts: torch.Tensor) -> int:
    """Capacity rows per expert that drop no pair: ``n_tokens`` up to the
    kernel's row tile, else the largest count rounded up to it (one host
    read)."""
    global HOST_READS
    tile = gmm_ops.ROW_TILE
    if n_tokens <= tile:
        return n_tokens
    HOST_READS += 1
    return -(-int(counts.max()) // tile) * tile


def dispatch(experts: torch.Tensor, n_experts: int):
    """experts [T, k] -> (counts [E] int32, position [T, k] of each pair
    within its expert, in flat order)."""
    flat = experts.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = (torch.arange(flat.numel(), device=flat.device)
             - starts[flat[order]])
    pos = torch.empty_like(ranks)
    pos[order] = ranks
    return counts.to(torch.int32), pos.view(experts.shape)


def moe_ffn(moe: MoEConfig, params: dict,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x [..., d].  Returns (y [..., d] in x's dtype, aux loss
    scalar fp32)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e = moe.n_routed

    logits = xf.float() @ params["router"].float()
    weights, experts, probs = route_topk(logits, moe.top_k)
    aux = load_balance_loss(probs, experts, e) * moe.router_aux_coef

    counts, pos = dispatch(experts, e)
    rows = experts.long()
    buf = torch.zeros((e, capacity(t, counts), d), dtype=x.dtype,
                      device=x.device)
    buf[rows, pos] = xf[:, None, :].expand(t, moe.top_k, d)
    out = gmm_ops.expert_swiglu(buf, params["w_gate"], params["w_up"],
                                params["w_down"], counts)
    y = (out[rows, pos].float() * weights[..., None]).sum(dim=1)

    if moe.n_shared:
        y = y + swiglu(params["shared"], xf).float()
    return y.reshape(*lead, d).to(x.dtype), aux
