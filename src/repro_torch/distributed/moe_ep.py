"""Expert-parallel MoE FFN (the twin of ``src/repro/distributed/moe_ep.py``).

The reference's ``shard_map`` body runs on each rank's local tensors:

* experts are split over the ``model`` axis (E_local = E / TP a rank);
  their weights, also FSDP-split over the data axes, are cast to x's
  dtype and all-gathered over the data axes at the call;
* every rank of a model group routes ALL of its data shard's tokens
  (`models.moe.route_topk` and `load_balance_loss`, shared with the
  one-device path), keeps only the (token, slot) pairs of its local
  experts, the first ``C_e`` of each expert in flat pair order, and drops
  the rest, pair for pair as the reference does;
* the kept rows fill a zero ``[E_local, C_e, d]`` buffer; serving runs the
  grouped-matmul kernel (`kernels.moe_gmm.ops.expert_swiglu`, three
  launches, counts capped at ``C_e``), training three ``torch.bmm`` with
  autograd, as `models.moe.moe_ffn_train` does (the kernel has no
  backward);
* the partial outputs are combined in fp32 with one SUM all-reduce over
  the model axis, the aux loss is averaged over the data axes, and the
  shared experts are added.

The capacity ``C_e = max(1, ceil(T_local * k / E * capacity_factor))`` is
static, so this path reads nothing back to the host.  A token picks an
expert at most once, so ``C_e >= T_local`` drops nothing.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import collectives as col
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.moe import dispatch, load_balance_loss, route_topk


#: the reference's capacity factor (its ``moe_ffn_ep`` default)
EP_CAPACITY_FACTOR = 1.25


def ep_capacity(t_local: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    return max(1, math.ceil(t_local * top_k / n_experts * capacity_factor))


def local_slots(experts: torch.Tensor, rank: int, e_local: int, n_experts: int,
                cap: int):
    """experts [T, k] (global ids) -> (slot [T, k] of each pair in the flat
    ``[E_local * cap]`` buffer, ``E_local * cap`` for a foreign or dropped
    pair; keep [T, k]; counts [E_local] int32 capped at ``cap``).  A pair's
    row is its rank among its expert's pairs in flat order, so an expert
    keeps its first ``cap`` pairs."""
    counts, pos = dispatch(experts, n_experts)
    local = experts.long() - rank * e_local
    keep = (local >= 0) & (local < e_local) & (pos.long() < cap)
    slot = torch.where(keep, local * cap + pos.long(),
                       torch.full_like(local, e_local * cap))
    mine = counts[rank * e_local:(rank + 1) * e_local]
    return slot, keep, torch.clamp(mine, max=cap).to(torch.int32)


def moe_ffn_ep(moe: MoEConfig, params: dict, x: torch.Tensor, mesh, *,
               capacity_factor: float = EP_CAPACITY_FACTOR,
               mode: str = "serve"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over this rank's x [B/DP, S, d] (the same on
    every rank of a model group).  ``params`` leaves are DTensors placed by
    `sharding.param_shardings` or the global tensors.  ``mode`` "serve"
    runs the kernel, "train" ``torch.bmm`` with autograd.  Returns (y in
    x's dtype, aux loss averaged over the data axes)."""
    tp = col.tp_size(mesh)
    e, k = moe.n_routed, moe.top_k
    if e % tp:
        raise ValueError(f"{e} experts do not divide over {tp} model ranks")
    e_local = e // tp
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t_local = xf.shape[0]
    cap = ep_capacity(t_local, k, e, capacity_factor)
    dt = x.dtype
    rank = col.tp_rank(mesh)

    # this rank's experts, cast to x's dtype, then gathered over the data
    # axes that split them
    wg, wu, wd = (col.tp_local(params[n], 0, mesh, dtype=dt)
                  for n in ("w_gate", "w_up", "w_down"))
    router = col.full(params["router"])
    logits = xf.float() @ router.float()
    weights, experts, probs = route_topk(logits, k)
    aux = load_balance_loss(probs, experts, e) * moe.router_aux_coef

    slot, keep, counts = local_slots(experts, rank, e_local, e, cap)
    flat = slot.reshape(-1)
    xin = col.copy_to_tp(xf, mesh)
    w_in = col.copy_to_tp(weights, mesh)
    rows = e_local * cap
    token = torch.arange(t_local * k, device=x.device) // k
    buf = xin.new_zeros((rows + 1, d)).index_put(
        (flat,), xin.index_select(0, token), accumulate=True)
    buf = buf[:rows].view(e_local, cap, d)
    if mode == "serve":
        # the cost record's rows (the counts are not read): a uniform
        # router's pairs to this rank's experts, up to the capacity
        out = gmm_ops.expert_swiglu(
            buf, wg, wu, wd, counts,
            pairs=min(rows, math.ceil(t_local * k * e_local / e)))
    elif mode == "train":
        gate = torch.bmm(buf, wg)
        up = torch.bmm(buf, wu)
        out = torch.bmm(torch.nn.functional.silu(gate) * up, wd)
    else:
        raise ValueError(mode)
    out = torch.cat([out.reshape(rows, d), out.new_zeros((1, d))])
    ys = out.index_select(0, flat).view(t_local, k, d).float()
    w_kept = torch.where(keep, w_in, torch.zeros_like(w_in))
    y = ys[:, 0] * w_kept[:, :1]
    for j in range(1, k):
        y = y + ys[:, j] * w_kept[:, j:j + 1]
    y = col.reduce_from_tp(y, mesh)
    aux = col.dp_mean(aux, mesh)
    y = y.to(dt)
    if moe.n_shared:
        y = y + col.swiglu_tp(params["shared"], xf, mesh)
    return y.reshape(*lead, d), aux
