"""Roofline terms of a counted step (the twin of
``src/repro/roofline/analysis.py``).

Three terms, all in seconds per step on one NVIDIA H100 80GB HBM3 (the
datasheet figures of `launch/mesh.py`), computed per device:

  compute    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / (links * NVLINK_BW_PER_LINK)

The reference reads XLA's ``cost_analysis()``, ``memory_analysis()`` and
the post-SPMD HLO text; the port reads a `counting.Costs` record, which
`counting.costing` fills by dispatch.  Its FLOPs are the matmul FLOPs of
the aten ops (``FlopCounterMode``) plus each hand-written kernel's own
count (its package's ``cost``); its bytes are the inputs plus outputs of
every aten op that is not a view, an unfused upper bound (XLA counts a
fusion's operands once), plus each kernel's bytes.  Collective bytes are
the result-shape bytes of each counted all-reduce and all-gather, an
all-reduce weighted 2x (a ring's reduce-scatter plus all-gather), as
the reference weights them.

The link term assumes every collective runs over one card's 18 NVLink 4
links at 25 GB/s each and direction, as inside one 8-card NVLink node.
A (16, 16) or (2, 16, 16) mesh spans many such nodes, whose traffic
between nodes goes over the slower network, so the collective term is a
lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.launch.mesh import (
    HBM_BW,
    NVLINK_BW_PER_LINK,
    NVLINK_LINKS,
    PEAK_FLOPS_BF16,
)


def tensor_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a dense tensor of ``shape`` and ``dtype`` (a 0-d tensor
    holds one element)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def collective_bytes(counted: Dict[str, float]) -> Dict[str, float]:
    """Per-device bytes moved by each collective kind, from the result
    bytes counted by kind (``"all-reduce"``, ``"all-gather"``): an
    all-reduce weighted 2x."""
    return {op: float(n) * (2.0 if op == "all-reduce" else 1.0)
            for op, n in counted.items()}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None      # 6*N*D (or 2*N*D for inference)
    model_flops_ratio: Optional[float] = None  # model_flops / (flops*chips)

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("coll_breakdown")
        return d


def _roofline(flops: float, nbytes: float, coll: Dict[str, float], *,
              n_devices: int, model_flops: Optional[float],
              links: int) -> Roofline:
    coll_total = float(sum(coll.values()))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = coll_total / (links * NVLINK_BW_PER_LINK)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    ratio = None
    if model_flops is not None and flops > 0:
        ratio = model_flops / (flops * n_devices)
    return Roofline(
        flops_per_device=flops, bytes_per_device=nbytes,
        coll_bytes_per_device=coll_total, coll_breakdown=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        model_flops_ratio=ratio)


def raw_costs(costs) -> dict:
    """Raw per-device totals of one counted step (pre-extrapolation), in
    the reference's keys: ``flops``, ``bytes`` and ``coll`` (weighted
    bytes by kind)."""
    return {"flops": float(costs.flops), "bytes": float(costs.bytes),
            "coll": collective_bytes(costs.coll)}


def analyze(costs, *, n_devices: int, model_flops: Optional[float] = None,
            links: int = NVLINK_LINKS, cost_scale: float = 1.0) -> Roofline:
    """The terms of a `counting.Costs` record.  ``cost_scale`` multiplies
    all three terms: used when the costing pass runs one microbatch of a
    grad_accum=N step (terms x N)."""
    raw = raw_costs(costs)
    coll = {k: v * cost_scale for k, v in raw["coll"].items()}
    return _roofline(raw["flops"] * cost_scale, raw["bytes"] * cost_scale,
                     coll, n_devices=n_devices, model_flops=model_flops,
                     links=links)


def memory_stats(costs) -> dict:
    """The reference's memory record from a counted step: the rank's
    argument, output and aliased bytes that the caller set on ``costs``,
    and temp as the counted peak of the storage the step made, less the
    outputs that are not aliased (which ``output_bytes`` holds), so that
    the peak estimate is the arguments plus the counted peak."""
    out_new = costs.output_bytes - costs.alias_bytes
    temp = max(int(costs.peak_bytes) - out_new, 0)
    return {
        "argument_bytes": int(costs.argument_bytes),
        "output_bytes": int(costs.output_bytes),
        "temp_bytes": int(temp),
        "alias_bytes": int(costs.alias_bytes),
        "peak_estimate_bytes": int(
            costs.argument_bytes + costs.output_bytes + temp
            - costs.alias_bytes),
    }


def analyze_extrapolated(
    cost_a: dict,
    cost_b: dict,
    depth_a: int,
    depth_b: int,
    depth_full: int,
    *,
    n_devices: int,
    model_flops: Optional[float] = None,
    links: int = NVLINK_LINKS,
    cost_scale: float = 1.0,
) -> Roofline:
    """Linear-in-depth extrapolation: cost(L) = base + L * per_layer.

    Valid because every per-layer cost (matmuls, attention, FSDP gathers,
    gradient reductions) is depth-independent; the base captures the
    embedding, the CE loss and the optimizer's scalars.  Negative
    per-layer deltas (noise on tiny terms) are clamped to zero."""
    def extrap(va: float, vb: float) -> float:
        per_layer = max((vb - va) / (depth_b - depth_a), 0.0)
        base = max(va - per_layer * depth_a, 0.0)
        return base + per_layer * depth_full

    flops = extrap(cost_a["flops"], cost_b["flops"]) * cost_scale
    nbytes = extrap(cost_a["bytes"], cost_b["bytes"]) * cost_scale
    coll = {}
    for op in set(cost_a["coll"]) | set(cost_b["coll"]):
        coll[op] = extrap(cost_a["coll"].get(op, 0.0),
                          cost_b["coll"].get(op, 0.0)) * cost_scale
    return _roofline(flops, nbytes, coll, n_devices=n_devices,
                     model_flops=model_flops, links=links)
