"""Wrapper for the fused victim-select/placement kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/sched_select/kernel.py:59``
(``sched_select_kernel``) behind the reference's
``src/repro/kernels/sched_select/ops.py:37`` (``plan_evictions_fused``):
`core.omfs_torch.plan_evictions` dispatches here when
``SchedulerConfig.kernel_backend == "cuda"``.

* CPU tensors run the plain version (``ref.plan_evictions_ref``).
* CUDA tensors run the hand-written kernel (``csrc/sched_select.cu``,
  built for ``sm_90a`` at first use by ``kernels._build``) on the current
  stream, or raise: there is no fallback to the plain version.

One plan is one cooperative launch and no host read.  The kernel compacts
the evictable rows (the candidates) and sorts only them, in one CTA when
there are at most 512 (the fleet's case), else by 512-key tiles and merge
levels across the grid; it scans the freed CPUs,
plans, and walks the bounded placement 128 victims a round from shared
memory (the source's header has the design).  ``idle`` and
``cpus_needed`` go by value when they are Python ints (what the engine
passes) and by pointer when they are 0-d tensors; ``occ`` goes by
pointer; scratch comes from the caching allocator.  The wrapper launches
nothing else.

Bound on the H100, from a call's own inputs: rows that are not
candidates change nothing, so the plan must read the J evictable flags,
the E candidates' keys and CPUs, and the planned victims' checkpoint
flags and lattice rows (and sizes, bounded), and write ``5*J + 1``
bytes: ~0.6 MB for the fleet's plan (J=100k, E=91, 25 victims), ~0.18 us
at 3.35 TB/s.  One cooperative launch of the grid costs more than that;
``floor_launch`` makes an empty one, the floor the smoke run times
beside the bound.

**Batched.** Given ``[B, J]`` columns (``[B, J, T]`` lattices, ``[B]``
``idle``/``cpus_needed``, ``[B, T]`` ``occ``) and the host list of the
``cells`` to plan, one cooperative launch plans them all (the counterpart
of the reference's ``jax.vmap`` of the ``pallas_call``): the grid splits
into one group of CTAs a cell, and every barrier is met by the whole
launch.  More cells than the co-resident grid (132 CTAs on an H100) go
out as several launches of the same kernel.  Its plain version is the
single plan looped over the cells (``ref.plan_evictions_batch_ref``).

``LAUNCHES`` counts cooperative launches on CUDA tensors and ``PLANS`` the
cells they planned (a single plan is one of each); the CPU path and
``floor_launch`` move neither.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence

import torch

from repro_torch.kernels.sched_select.ref import (
    plan_evictions_batch_ref,
    plan_evictions_ref,
)

#: cooperative launches on the card since the count was last reset
LAUNCHES = 0
#: cells those launches planned (one per single plan)
PLANS = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_select.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    from repro_torch.kernels import _build

    built = _build.load("sched_select", [SOURCE])
    lib = built.lib
    lib.sched_select_launch.argtypes = (
        [_P] * 11 + [_I, _P, _I, _P] + [_I] * 5 + [_P] * 5)
    lib.sched_select_launch.restype = _I
    lib.sched_select_floor.argtypes = [_P]
    lib.sched_select_floor.restype = _I
    lib.sched_select_scratch_words.argtypes = [_I, _I]
    lib.sched_select_scratch_words.restype = ctypes.c_longlong
    lib.sched_select_error_string.argtypes = [_I]
    lib.sched_select_error_string.restype = ctypes.c_char_p
    lib.sched_select_max_tiers.argtypes = []
    lib.sched_select_max_tiers.restype = _I
    lib.sched_select_launch_batch.argtypes = (
        [_P] * 13 + [_I] * 6 + [_P, _I] + [_P] * 5)
    lib.sched_select_launch_batch.restype = _I
    lib.sched_select_batch_scratch_words.argtypes = [_I, _I, _I]
    lib.sched_select_batch_scratch_words.restype = ctypes.c_longlong
    lib.sched_select_cells_per_launch.argtypes = []
    lib.sched_select_cells_per_launch.restype = _I
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _check_col(name, x, lead, dtype, device):
    """``x`` is a contiguous ``dtype`` tensor on ``device`` whose leading
    dimensions are ``lead`` (an int: ``(lead,)``)."""
    lead = (lead,) if isinstance(lead, int) else tuple(lead)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape[:len(lead)]) != lead:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"leading {lead}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _int32(name, x):
    x = int(x)
    if not INT32_MIN <= x <= INT32_MAX:
        raise ValueError(f"{name}={x} does not fit in int32")
    return x


def _scalar_arg(name, x, device):
    """``(pointer, value)`` for the kernel: a 0-d int32 tensor on the card
    goes by pointer, a Python int by value."""
    if isinstance(x, torch.Tensor):
        if x.device != device or x.dtype != torch.int32 or x.dim() != 0:
            raise ValueError(f"{name} must be a 0-d int32 tensor on {device}")
        return x.data_ptr(), 0
    if not isinstance(x, int):
        raise TypeError(f"{name} must be an int or a 0-d int32 tensor")
    return None, _int32(name, x)


def plan_evictions_fused(prio, run_start, jid, key_cost, evictable, cpus,
                         state_mib, is_ckpt, save_lat, idle, cpus_needed,
                         occ, cap: Sequence[int], *, cheap: bool = False,
                         tiered: bool = False, bounded: bool = False,
                         cells: Optional[Sequence[int]] = None):
    """Fused plan over bare columns.

    ``planned`` is the paper's minimal victim prefix (lines 32-36) in the
    requested victim-key order (``key_cost`` — the delta-aware effective
    tier-0 save cost — leads the key when ``cheap``), ``enough`` the
    feasibility bit, and ``tier`` the greedy cheapest-feasible placement
    of the checkpointable planned victims over the ``[J, T]`` effective
    save lattice (all-zero when ``tiered=False``).  Columns are int32
    ``[J]`` (``evictable``/``is_ckpt`` bool), ``save_lat`` int32 ``[J, T]``,
    ``idle``/``cpus_needed`` ints or 0-d int32 tensors, ``occ`` the ``[T]``
    int32 per-tier occupancy and ``cap`` ``T`` ints (``< 0`` = unbounded).
    Returns ``(planned[J] bool, enough 0-d bool, tier[J] int32)``.

    Batched: ``[B, J]`` columns, ``save_lat`` ``[B, J, T]``,
    ``idle``/``cpus_needed`` ``[B]`` int32 tensors, ``occ`` ``[B, T]``, and ``cells`` the distinct batch indices to plan
    (host ints; default all ``B``).  Returns ``(planned[B, J], enough[B],
    tier[B, J])``, all False / False / 0 on the cells not planned.
    """
    if prio.dim() == 2:
        return _plan_batch(
            prio, run_start, jid, key_cost, evictable, cpus, state_mib,
            is_ckpt, save_lat, idle, cpus_needed, occ, cap, cells,
            dict(cheap=cheap, tiered=tiered, bounded=bounded))
    if cells is not None:
        raise ValueError("cells selects cells of [B, J] columns; these are "
                         f"{tuple(prio.shape)}")
    device = prio.device
    if device.type == "cpu":
        return plan_evictions_ref(
            prio, run_start, jid, key_cost, evictable, cpus, state_mib,
            is_ckpt, save_lat, idle, cpus_needed, occ, cap, cheap=cheap,
            tiered=tiered, bounded=bounded)
    if device.type != "cuda":
        raise ValueError(f"sched_select runs on cpu or cuda tensors, "
                         f"got {device}")
    j = prio.shape[0]
    if prio.dim() != 1 or j < 1:
        raise ValueError(f"prio must be a non-empty [J] column, "
                         f"got shape {tuple(prio.shape)}")
    for name, x in (("prio", prio), ("run_start", run_start), ("jid", jid),
                    ("key_cost", key_cost), ("cpus", cpus),
                    ("state_mib", state_mib)):
        _check_col(name, x, j, torch.int32, device)
    for name, x in (("evictable", evictable), ("is_ckpt", is_ckpt)):
        _check_col(name, x, j, torch.bool, device)
    _check_col("save_lat", save_lat, j, torch.int32, device)
    lib = _lib()
    n_tiers = save_lat.shape[1] if save_lat.dim() == 2 else -1
    if save_lat.dim() != 2 or not 1 <= n_tiers <= lib.sched_select_max_tiers():
        raise ValueError(f"save_lat must be [J, T] with 1 <= T <= "
                         f"{lib.sched_select_max_tiers()}, got "
                         f"{tuple(save_lat.shape)}")
    _check_col("occ", occ, n_tiers, torch.int32, device)
    cap = [_int32("cap", c) for c in cap]
    if len(cap) != n_tiers:
        raise ValueError(f"cap has {len(cap)} entries, expected {n_tiers}")
    idle_ptr, idle_val = _scalar_arg("idle", idle, device)
    need_ptr, need_val = _scalar_arg("cpus_needed", cpus_needed, device)

    scratch = torch.empty(lib.sched_select_scratch_words(j, n_tiers),
                          dtype=torch.int32, device=device)
    planned = torch.empty(j, dtype=torch.bool, device=device)
    enough = torch.empty((), dtype=torch.bool, device=device)
    tier = torch.empty(j, dtype=torch.int32, device=device)
    caps_host = (ctypes.c_int * n_tiers)(*cap)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        rc = lib.sched_select_launch(
            prio.data_ptr(), run_start.data_ptr(), jid.data_ptr(),
            key_cost.data_ptr(), evictable.data_ptr(), cpus.data_ptr(),
            state_mib.data_ptr(), is_ckpt.data_ptr(), save_lat.data_ptr(),
            occ.data_ptr(), idle_ptr, idle_val, need_ptr, need_val,
            ctypes.addressof(caps_host), j, n_tiers, int(cheap), int(tiered),
            int(bounded), scratch.data_ptr(), planned.data_ptr(),
            enough.data_ptr(), tier.data_ptr(), stream.cuda_stream)
    _raise_on(lib, rc, "launch")
    global LAUNCHES, PLANS
    LAUNCHES += 1
    PLANS += 1
    return planned, enough, tier


def _batch_scalar(name, x, b, device):
    """``idle``/``cpus_needed`` of a batch: a ``[B]`` int32 tensor."""
    _check_col(name, x, b, torch.int32, device)
    if x.dim() != 1:
        raise ValueError(f"{name} must be [B], got {tuple(x.shape)}")


def _plan_batch(prio, run_start, jid, key_cost, evictable, cpus, state_mib,
                is_ckpt, save_lat, idle, cpus_needed, occ, cap, cells,
                flags):
    """`plan_evictions_fused` over ``[B, J]`` columns (see there)."""
    device = prio.device
    b, j = prio.shape
    cells = list(range(b)) if cells is None else [int(c) for c in cells]
    if len(set(cells)) != len(cells) or not all(0 <= c < b for c in cells):
        raise ValueError(f"cells must be distinct indices in [0, {b}), "
                         f"got {cells}")
    _batch_scalar("idle", idle, b, device)
    _batch_scalar("cpus_needed", cpus_needed, b, device)
    if device.type == "cpu":
        return plan_evictions_batch_ref(
            prio, run_start, jid, key_cost, evictable, cpus, state_mib,
            is_ckpt, save_lat, idle, cpus_needed, occ, cap, cells=cells,
            **flags)
    if device.type != "cuda":
        raise ValueError(f"sched_select runs on cpu or cuda tensors, "
                         f"got {device}")
    if j < 1:
        raise ValueError(f"prio must be a non-empty [B, J] batch, got shape "
                         f"{tuple(prio.shape)}")
    for name, x in (("prio", prio), ("run_start", run_start), ("jid", jid),
                    ("key_cost", key_cost), ("cpus", cpus),
                    ("state_mib", state_mib)):
        _check_col(name, x, (b, j), torch.int32, device)
    for name, x in (("evictable", evictable), ("is_ckpt", is_ckpt)):
        _check_col(name, x, (b, j), torch.bool, device)
    lib = _lib()
    n_tiers = save_lat.shape[2] if save_lat.dim() == 3 else -1
    if save_lat.dim() != 3 or not 1 <= n_tiers <= lib.sched_select_max_tiers():
        raise ValueError(f"save_lat must be [B, J, T] with 1 <= T <= "
                         f"{lib.sched_select_max_tiers()}, got "
                         f"{tuple(save_lat.shape)}")
    _check_col("save_lat", save_lat, (b, j), torch.int32, device)
    _check_col("occ", occ, (b, n_tiers), torch.int32, device)
    cap = [_int32("cap", c) for c in cap]
    if len(cap) != n_tiers:
        raise ValueError(f"cap has {len(cap)} entries, expected {n_tiers}")
    per = lib.sched_select_cells_per_launch()
    if per <= 0:
        _raise_on(lib, -per, "grid set-up")
    n = len(cells)
    # cells not planned read as nothing planned; a full batch writes all
    alloc = torch.empty if n == b else torch.zeros
    planned = alloc((b, j), dtype=torch.bool, device=device)
    enough = alloc(b, dtype=torch.bool, device=device)
    tier = alloc((b, j), dtype=torch.int32, device=device)
    if n == 0:
        return planned, enough, tier
    scratch = torch.empty(
        lib.sched_select_batch_scratch_words(j, n_tiers, min(n, per)),
        dtype=torch.int32, device=device)
    caps_host = (ctypes.c_int * n_tiers)(*cap)
    cells_host = (ctypes.c_int * n)(*cells)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        rc = lib.sched_select_launch_batch(
            prio.data_ptr(), run_start.data_ptr(), jid.data_ptr(),
            key_cost.data_ptr(), evictable.data_ptr(), cpus.data_ptr(),
            state_mib.data_ptr(), is_ckpt.data_ptr(), save_lat.data_ptr(),
            occ.data_ptr(), idle.data_ptr(), cpus_needed.data_ptr(),
            ctypes.addressof(caps_host), b, j, n_tiers,
            int(flags["cheap"]), int(flags["tiered"]), int(flags["bounded"]),
            ctypes.addressof(cells_host), n, scratch.data_ptr(),
            planned.data_ptr(), enough.data_ptr(), tier.data_ptr(),
            stream.cuda_stream)
    _raise_on(lib, rc, "batched launch")
    global LAUNCHES, PLANS
    LAUNCHES += -(-n // per)
    PLANS += n
    return planned, enough, tier


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.sched_select_error_string(rc).decode()
        raise RuntimeError(f"sched_select {what} failed: CUDA error {rc} "
                           f"({msg})")


def floor_launch(device) -> None:
    """One empty cooperative launch of the plan's grid, block and shared
    memory on ``device``'s current stream (not counted in ``LAUNCHES``):
    the card's cost of any one-launch plan before its work."""
    device = torch.device(device)
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.sched_select_floor(torch.cuda.current_stream(device)
                                    .cuda_stream)
    _raise_on(lib, rc, "floor launch")
