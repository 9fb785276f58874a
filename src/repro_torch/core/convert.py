"""Carry scheduler and job state across from the reference package.

The port imports nothing of ``repro``: a reference `JobTable` crosses as a
dict of numpy columns keyed by ``JobTable._fields`` (the two tables share
their column names and int32 layout), reference ``User``/``Job``
objects are read attribute by attribute, and a reference tree of arrays
(a ``TrainState``) crosses leaf by leaf through ``__array__``.  A
reference model's params tree crosses into a port `models.model.Model`
by `load_reference_params`, and a reference ``TrainState`` into a port
`train.state.TrainState` over that model by `load_reference_train_state`:
both walk the trees path by path, so they take every family's tree (MLA's
attention keys, the VLM's ``cross`` and ``vision_proj``, the audio
model's ``enc`` / ``dec`` with their LayerNorms' ``scale`` and ``bias``)
and check every path, shape and dtype.
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import serialize
from repro_torch.core.omfs_torch import JobTable, resolve_device
from repro_torch.core.types import Job, JobClass, JobState, User


def table_from_numpy(cols: Dict[str, np.ndarray], device="cuda") -> JobTable:
    """A `JobTable` on ``device`` from int32 numpy columns."""
    missing = set(JobTable._fields) - set(cols)
    if missing:
        raise KeyError(f"missing JobTable columns: {sorted(missing)}")
    dev = resolve_device(device)
    out = {}
    for f in JobTable._fields:
        col = np.asarray(cols[f])
        if col.dtype != np.int32:
            raise TypeError(f"column {f} has dtype {col.dtype}, expected int32")
        # a copy: the run updates its table in place, and the numpy
        # column may be the caller's (or a read-only JAX) buffer
        out[f] = torch.tensor(col, device=dev)
    return JobTable(**out)


def table_to_numpy(tbl: JobTable) -> Dict[str, np.ndarray]:
    """The table's columns as host int32 numpy arrays."""
    return {f: getattr(tbl, f).cpu().numpy() for f in JobTable._fields}  # analysis: ignore[host-read] -- host epilogue, once a run


_JOB_FIELDS = ("user", "cpus", "work", "priority", "submit_time",
               "state_bytes", "id", "progress", "run_start", "first_start",
               "finish_time", "n_preemptions", "n_checkpoints", "overhead",
               "backfilled", "ckpt_tier", "n_spills")


def jobs_from_reference(users, jobs) -> Tuple[List[User], List[Job]]:
    """The port's `User`/`Job` twins of objects carrying the reference's
    attributes, ids and runtime state kept."""
    out_users = [User(u.name, u.percent) for u in users]
    out_jobs = []
    for j in jobs:
        kw = {f: getattr(j, f) for f in _JOB_FIELDS}
        out_jobs.append(Job(job_class=JobClass(int(j.job_class)),
                            state=JobState(int(j.state)), **kw))
    return out_users, out_jobs


@functools.lru_cache(maxsize=None)
def _namedtuple_twin(name: str, fields: Tuple[str, ...]):
    return collections.namedtuple(name, fields)


def _mirror(tree, leaf_fn):
    """``tree`` rebuilt with ``leaf_fn`` on every leaf: a dict stays a dict,
    a list a list, a tuple a tuple, and a NamedTuple becomes a port
    NamedTuple of the same type name and fields."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        twin = _namedtuple_twin(type(tree).__name__, tuple(tree._fields))
        return twin(*(_mirror(getattr(tree, f), leaf_fn)
                      for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _mirror(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_mirror(c, leaf_fn) for c in tree)
    if tree is None:
        return None
    return leaf_fn(tree)


def tree_from_reference(tree, device="cuda"):
    """A tree whose leaves expose ``__array__`` (a reference ``TrainState``)
    as the same structure of tensors on ``device``, dtypes kept (bfloat16
    by its raw bits)."""
    dev = resolve_device(device)
    return _mirror(tree, lambda leaf: serialize.host_tensor(
        np.asarray(leaf)).to(device=dev, copy=True))


def tree_to_numpy(tree):
    """A tree of tensors as the same structure of host numpy arrays
    (bfloat16 as `serialize.BFLOAT16_BITS`)."""
    return serialize.map_with_path(lambda _k, t: serialize.to_numpy(t), tree)


def flat_paths(tree, prefix=""):
    """``{"a.b.c": leaf}`` for a nested dict of leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_reference_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a reference params tree (nested dicts of leaves with
    ``__array__``) into ``model``'s parameters, on their device.  Raises on
    a missing or extra path, or on a leaf of another shape or dtype;
    bfloat16 crosses by its raw bits."""
    leaves = flat_paths(tree)
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - leaves), sorted(leaves.keys() -
                                                            params)
    if missing or extra:
        raise KeyError(f"params paths differ: missing {missing}, "
                       f"extra {extra}")
    staged = {}
    for path, leaf in leaves.items():
        host = serialize.host_tensor(np.asarray(leaf))
        p = params[path]
        if tuple(host.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {tuple(host.shape)}, the model "
                             f"holds {tuple(p.shape)}")
        if host.dtype != p.dtype:
            raise TypeError(f"{path}: dtype {host.dtype}, the model holds "
                            f"{p.dtype}")
        staged[path] = host
    with torch.no_grad():
        for path, host in staged.items():
            params[path].copy_(host)
    return model


def _checked_leaf(path: str, leaf, shape, dtype) -> torch.Tensor:
    host = serialize.host_tensor(np.asarray(leaf))
    if tuple(host.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {tuple(host.shape)}, expected "
                         f"{tuple(shape)}")
    if host.dtype != dtype:
        raise TypeError(f"{path}: dtype {host.dtype}, expected {dtype}")
    return host


def _moments(model: torch.nn.Module, tree, name: str) -> dict:
    """A reference moment tree (fp32, the params' paths and shapes) as a
    nested dict of tensors on the model's device."""
    leaves = flat_paths(tree)
    params = dict(model.named_parameters())
    missing, extra = sorted(params.keys() - leaves), sorted(leaves.keys() -
                                                            params)
    if missing or extra:
        raise KeyError(f"{name} paths differ: missing {missing}, "
                       f"extra {extra}")
    out: dict = {}
    for path, leaf in leaves.items():
        host = _checked_leaf(f"{name}.{path}", leaf, params[path].shape,
                             torch.float32)
        node = out
        *owners, last = path.split(".")
        for k in owners:
            node = node.setdefault(k, {})
        node[last] = host.to(params[path].device, copy=True)
    return out


def load_reference_train_state(model: torch.nn.Module, state):
    """A reference ``TrainState`` (``params``, ``opt`` = ``(step, m, v)``,
    ``rng``, ``data_cursor``; leaves with ``__array__``: JAX or numpy
    arrays) as a port `train.state.TrainState` over ``model``: the
    parameters are copied into the model (`load_reference_params`), the
    moments, step and key onto its device, the cursor onto the host.
    Raises on a missing or extra path, or on a leaf of another shape or
    dtype."""
    from repro_torch.train.state import AdamWState, TrainState

    load_reference_params(model, state.params)
    dev = next(model.parameters()).device
    step = _checked_leaf("opt.step", state.opt.step, (), torch.int32)
    rng = _checked_leaf("rng", state.rng, (2,), torch.uint32)
    cursor = _checked_leaf("data_cursor", state.data_cursor, (), torch.int32)
    return TrainState(
        params=model.params(),
        opt=AdamWState(step=step.to(dev, copy=True),
                       m=_moments(model, state.opt.m, "opt.m"),
                       v=_moments(model, state.opt.v, "opt.v")),
        rng=rng.to(dev, copy=True),
        data_cursor=cursor.clone())
