"""Plain PyTorch version of the fused victim-select/placement kernel.

Spells the same stable lexsort + cumsum + greedy placement that
``core/omfs_torch.py``'s ``victim_order`` / ``select_victims`` /
``place_checkpoints`` perform, but over bare columns: the wrapper in
``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.

Everything stays int32: torch's ``cumsum`` and ``sum`` of int32 return
int64 unless told otherwise, so every reduction names its dtype.

Placement is T-tier: ``save_lat`` is the ``[J, T]`` effective save-cost
lattice (delta-aware — the caller already selected first vs recurrent
rows), ``occ``/``cap`` are ``[T]`` occupancy/capacity vectors, and the
chosen tier per victim is the first-occurrence argmin over feasible
columns (ties toward the faster tier, the last tier always feasible).

``plan_evictions_batch_ref`` is the batched launch's plain version: the
same plan for each requested cell of ``[B, J]`` columns, in a loop.
"""
from __future__ import annotations

import torch

MASK = 2**31 - 1      # int32 max: the infeasible-tier sentinel

#: reads of the device that `greedy_place` made since the count was reset
HOST_READS = 0


def lexsort(keys):
    """Stable lexicographic order along the last axis with the LAST key
    primary (numpy/jax ``lexsort`` semantics): a chain of stable sorts
    starting from the least significant key.  Leading axes are batch
    axes, each sorted on its own."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        order = order.gather(-1, torch.argsort(k.gather(-1, order), dim=-1,
                                               stable=True))
    return order


def first_argmin(lat: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin of ``[..., T]`` int32 with ties to the lowest column
    (strict ``<`` over an ascending scan), as int32."""
    best_c = lat[..., 0]
    best_t = torch.zeros_like(best_c)
    for k in range(1, lat.shape[-1]):
        better = lat[..., k] < best_c
        best_c = torch.where(better, lat[..., k], best_c)
        best_t = torch.where(better, k, best_t)
    return best_t


def greedy_place(want_sorted, mib_sorted, lat_sorted, occ, cap):
    """Bounded greedy placement in victim order, on the host.

    Only ``want`` rows move occupancy and keep their tier (the others get
    tier 0), so the loop walks just those rows: the reference's
    ``lax.scan`` over every row gives the same tiers.  Returns the
    ``[J]`` int32 sorted-position tiers on ``want_sorted``'s device.

    Reads the device once for the victims' rows (``nonzero``) and, if
    there is one, once more for ``occ`` and their sizes and costs, packed;
    ``HOST_READS`` counts both."""
    global HOST_READS
    pos = torch.nonzero(want_sorted).flatten()
    HOST_READS += 1
    tier_sorted = torch.zeros(want_sorted.shape, dtype=torch.int32,
                              device=want_sorted.device)
    if pos.numel() == 0:
        return tier_sorted
    n_tiers = lat_sorted.shape[-1]
    packed = torch.cat([occ.reshape(-1).to(torch.int64),
                        mib_sorted[pos].to(torch.int64),
                        lat_sorted[pos].reshape(-1).to(torch.int64)])
    vals = packed.tolist()
    HOST_READS += 1
    occ = vals[:n_tiers]
    cap = [int(v) for v in cap]
    mibs = vals[n_tiers:n_tiers + pos.numel()]
    flat = vals[n_tiers + pos.numel():]
    rows = [flat[k * n_tiers:(k + 1) * n_tiers] for k in range(len(mibs))]
    chosen = []
    for mib, costs in zip(mibs, rows):
        best_c, best_t = MASK, 0
        for k, c in enumerate(costs):
            feasible = cap[k] < 0 or occ[k] + mib <= cap[k]
            c = c if feasible else MASK
            if c < best_c:
                best_c, best_t = c, k
        occ[best_t] += mib
        chosen.append(best_t)
    tier_sorted[pos] = torch.tensor(chosen, dtype=torch.int32,
                                    device=want_sorted.device)
    return tier_sorted


def plan_evictions_ref(prio, run_start, jid, key_cost, evictable, cpus,
                       state_mib, is_ckpt, save_lat, idle, cpus_needed,
                       occ, cap, *, cheap: bool = False, tiered: bool = False,
                       bounded: bool = False):
    """Returns ``(planned[J] bool, enough bool, tier[J] int32)`` — see
    ``ops.plan_evictions_fused``.  ``idle``/``cpus_needed`` are Python ints
    or 0-d int32 tensors; ``cap`` is a sequence of ints."""
    keys = ((jid, run_start, prio, key_cost) if cheap
            else (jid, run_start, prio))
    order = lexsort(keys)
    evictable = evictable.to(torch.bool)
    evict_sorted = evictable[order]
    cpus_sorted = torch.where(evict_sorted, cpus[order], 0)
    freed_cum = torch.cumsum(cpus_sorted, 0, dtype=torch.int32)
    need = torch.clamp(torch.as_tensor(cpus_needed - idle,
                                       dtype=torch.int32), min=0)
    planned_sorted = evict_sorted & (freed_cum - cpus_sorted < need)
    enough = idle + freed_cum[-1] >= cpus_needed
    planned = torch.zeros_like(evictable)
    planned[order] = planned_sorted
    tier = torch.zeros_like(jid)
    if not tiered:
        return planned, enough, tier
    want_sorted = planned_sorted & is_ckpt.to(torch.bool)[order]
    lat_sorted = save_lat[order]
    if not bounded:                 # every tier unbounded: pure row-argmin
        tier_sorted = first_argmin(lat_sorted)
    else:
        tier_sorted = greedy_place(want_sorted, state_mib[order], lat_sorted,
                                   occ, cap)
    tier[order] = torch.where(want_sorted, tier_sorted, 0)
    return planned, enough, tier


def plan_evictions_batch_ref(prio, run_start, jid, key_cost, evictable, cpus,
                             state_mib, is_ckpt, save_lat, idle, cpus_needed,
                             occ, cap, *, cells=None, cheap: bool = False,
                             tiered: bool = False, bounded: bool = False):
    """The batched plan: `plan_evictions_ref` for each cell of ``cells``
    (default: all ``B``) over ``[B, J]`` columns, ``[B, J, T]`` lattices,
    ``[B]`` ``idle``/``cpus_needed`` and ``[B, T]`` ``occ``.  Returns
    ``(planned[B, J] bool, enough[B] bool, tier[B, J] int32)``; the cells
    not planned are all False / False / 0."""
    b, j = prio.shape
    planned = torch.zeros((b, j), dtype=torch.bool, device=prio.device)
    enough = torch.zeros(b, dtype=torch.bool, device=prio.device)
    tier = torch.zeros((b, j), dtype=torch.int32, device=prio.device)
    for c in (range(b) if cells is None else cells):
        p, e, t = plan_evictions_ref(
            prio[c], run_start[c], jid[c], key_cost[c], evictable[c],
            cpus[c], state_mib[c], is_ckpt[c], save_lat[c], idle[c],
            cpus_needed[c], occ[c], cap, cheap=cheap, tiered=tiered,
            bounded=bounded)
        planned[c], enough[c], tier[c] = p, e, t
    return planned, enough, tier
