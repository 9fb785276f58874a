"""Restore a checkpoint onto a device or a mesh (the twin of
``src/repro/checkpoint/reshard.py``).

Checkpoints store *global* arrays keyed by tree path.  Restore fills a
template tree (tensors, or ``device="meta"`` tensors as the twin of
``eval_shape``) and puts each leaf on the target with the template's
dtype: on ``device``, or, given ``shardings`` (a tree of
`distributed.sharding.Sharding`, ``param_shardings``' say), as a DTensor
of which each rank copies only its own box to its device.  That is what
lets a preempted job restart on a differently shaped mesh (elastic
scaling) or on whatever capacity is left.  `save_global` gathers a tree
of DTensors back to global host arrays.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint import serialize
from repro_torch.distributed import sharding as shd


def restore_resharded(
    leaves: Dict[str, np.ndarray],
    template,
    shardings=None,
    *,
    device,
):
    """Fill ``template`` from global host leaves, each leaf a copy on
    ``device`` with its template leaf's dtype, or placed with the matching
    leaf of ``shardings``, which must place every leaf of the template and
    no other (ValueError otherwise: no leaf is replicated where a
    placement was asked for).  Returns once the copies have landed, so a
    caller's clock around it times the whole restore."""
    device = torch.device(device)
    by_key = None
    if shardings is not None:
        by_key = dict(serialize.leaf_paths(shardings))
        want = {k for k, _ in serialize.leaf_paths(template)}
        if set(by_key) != want:
            raise ValueError(
                f"shardings does not match the template: no placement for "
                f"{sorted(want - set(by_key))}, no leaf for "
                f"{sorted(set(by_key) - want)}")

    def put(key, arr, tleaf):
        dtype = getattr(tleaf, "dtype", None)
        if by_key is not None:
            return shd.place(arr, by_key[key], device=device, dtype=dtype)
        return serialize.host_tensor(arr).to(device=device, dtype=dtype,
                                             copy=True)

    tree = serialize.fill_template(template, leaves, put=put)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tree


def save_global(state) -> Dict[str, np.ndarray]:
    """Snapshot a tree of tensors to host numpy arrays keyed by tree path;
    a DTensor is gathered whole first (an all-gather over every mesh dim
    that shards it, the twin of ``full_tensor``)."""
    from repro_torch.distributed import collectives as col

    def host(v):
        with torch.no_grad():
            return serialize.to_numpy(col.full(v))

    return {k: host(v) for k, v in serialize.leaf_paths(state)}
