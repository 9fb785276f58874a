"""Carry scheduler state across from the reference package.

The port imports nothing of ``repro``: a reference `JobTable` crosses as a
dict of numpy columns keyed by ``JobTable._fields`` (the two tables share
their column names and int32 layout), and reference ``User``/``Job``
objects are read attribute by attribute.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

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
    return {f: getattr(tbl, f).cpu().numpy() for f in JobTable._fields}


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
