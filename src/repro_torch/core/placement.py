"""Topology-aware slice placement (an adaptation of j.CPU_Count).

The port's own copy of ``repro.core.placement``.

Algorithm 1 treats CPUs as fungible counts; accelerator jobs need
*contiguous* slices of the interconnect.  A buddy allocator over the flattened chip space keeps
allocations power-of-two sized and aligned, which preserves torus locality
(standard practice for slice scheduling).  The scheduler consults this
as a pluggable feasibility oracle: ``counting`` (paper-faithful) or
``buddy`` (gang placement with fragmentation).

Fragmentation is the interesting failure mode: the counting policy may admit
a job the buddy policy cannot place; benchmarks/bench_utilization.py reports
the utilization gap, and eviction picks victims that actually free a usable
block (`victims_for_block`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass
class BuddyAllocator:
    """Buddy allocation over ``total`` chips (power of two)."""

    total: int
    free_blocks: Dict[int, Set[int]] = field(default_factory=dict)  # size -> offsets
    allocated: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # job -> (off, size)

    def __post_init__(self):
        assert self.total & (self.total - 1) == 0, "total must be a power of two"
        if not self.free_blocks:
            self.free_blocks = {self.total: {0}}

    # -- queries -------------------------------------------------------------
    def can_place(self, cpus: int) -> bool:
        size = _round_pow2(max(cpus, 1))
        return any(s >= size and offs for s, offs in self.free_blocks.items())

    def largest_free(self) -> int:
        return max((s for s, offs in self.free_blocks.items() if offs), default=0)

    def free_chips(self) -> int:
        return sum(s * len(offs) for s, offs in self.free_blocks.items())

    # -- mutation --------------------------------------------------------------
    def place(self, job_id: int, cpus: int) -> Optional[Tuple[int, int]]:
        """First-fit smallest sufficient block; splits buddies as needed."""
        size = _round_pow2(max(cpus, 1))
        cand = sorted(s for s, offs in self.free_blocks.items() if s >= size and offs)
        if not cand:
            return None
        s = cand[0]
        off = min(self.free_blocks[s])
        self.free_blocks[s].discard(off)
        while s > size:  # split down to fit
            s //= 2
            self.free_blocks.setdefault(s, set()).add(off + s)
        self.allocated[job_id] = (off, size)
        return (off, size)

    def release(self, job_id: int) -> None:
        off, size = self.allocated.pop(job_id)
        # coalesce with buddy blocks as far as possible
        while size < self.total:
            buddy = off ^ size
            peers = self.free_blocks.get(size, set())
            if buddy in peers:
                peers.discard(buddy)
                off = min(off, buddy)
                size *= 2
            else:
                break
        self.free_blocks.setdefault(size, set()).add(off)

    # -- eviction planning ------------------------------------------------------
    def victims_for_block(self, cpus: int, candidates: List[Tuple[int, int]]) -> Optional[List[int]]:
        """Smallest set of candidate jobs [(job_id, victim_rank), ...] whose
        release (in rank order) makes a ``cpus`` block placeable.  Simulates
        releases on a copy; returns job ids or None."""
        sim = BuddyAllocator(
            self.total,
            {s: set(o) for s, o in self.free_blocks.items()},
            dict(self.allocated),
        )
        chosen: List[int] = []
        for job_id, _rank in candidates:
            if sim.can_place(cpus):
                break
            if job_id in sim.allocated:
                sim.release(job_id)
                chosen.append(job_id)
        return chosen if sim.can_place(cpus) else None
