"""Restore a checkpoint onto a device (the twin of
``src/repro/checkpoint/reshard.py``).

Checkpoints store *global* arrays keyed by tree path.  Restore fills a
template tree (tensors, or ``device="meta"`` tensors as the twin of
``eval_shape``) and puts each leaf on the target device with the
template's dtype.  The reference also places each leaf with a target
sharding, which is what lets a preempted job restart on a differently
shaped slice; the port's multi-device restore waits for
``torch.distributed`` (ROADMAP Queue 1 slice 11).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint import serialize


def restore_resharded(
    leaves: Dict[str, np.ndarray],
    template,
    shardings=None,
    *,
    device,
):
    """Fill ``template`` from global host leaves, each leaf a copy on
    ``device`` with its template leaf's dtype.  Returns once the copies
    have landed, so a caller's clock around it times the whole restore."""
    if shardings is not None:
        raise NotImplementedError(
            "restore with shardings needs the multi-device port "
            "(torch.distributed, ROADMAP Queue 1 slice 11)")
    device = torch.device(device)

    def put(key, arr, tleaf):
        dtype = getattr(tleaf, "dtype", None)
        return serialize.host_tensor(arr).to(device=device, dtype=dtype,
                                             copy=True)

    tree = serialize.fill_template(template, leaves, put=put)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tree


def save_global(state) -> Dict[str, np.ndarray]:
    """Snapshot a tree of tensors to host numpy arrays keyed by tree path
    (single process: full arrays)."""
    return {k: serialize.to_numpy(v) for k, v in serialize.leaf_paths(state)}
