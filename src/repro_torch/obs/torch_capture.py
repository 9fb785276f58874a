"""Event capture for the torch backend: the twin of the reference's
``repro.obs.jax_capture``, on the table's device with shapes fixed by the
ring size.

Each tick yields three fixed-shape int32 tensors:

* ``counts[E]``  — exact per-type event counts (never lossy),
* ``ring[R, 3]`` — a bounded per-tick ring of ``(etype, jid, arg)`` rows,
  laid out in (etype, table-row) order; each event's slot is its prefix
  position (an int32 cumsum of the flattened flag matrix), and events past
  the capacity R are dropped, never aliased,
* ``dropped``    — how many events did not fit this tick (0 whenever
  ``R >= lossless_ring_size(J)``).

The engine stacks them on the device over the run and `decode_events`
reads them once after it: the capture makes no host read per tick.

A ``[B, J]`` table (``engine.simulate_batch``) gives every cell its own
``counts[B, E]``, ``ring[B, R, 3]`` and ``dropped[B]``.

The capture is a pure function of ``(pre, post, t)`` — the diff rules of
`obs.events` — and writes nothing to the table.  The port's tick updates
the table in place, so ``pre`` must hold copies of the columns the tick
writes (`snapshot`), not views of them.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.omfs_torch import (
    DONE,
    I32,
    PENDING,
    RUNNING,
    UNSUB,
    JobTable,
)
from repro_torch.obs.events import N_EVENT_TYPES, Event, EventType

#: ring row layout
RING_FIELDS = ("etype", "jid", "arg")

#: the pre-tick columns the diff rules read
PRE_FIELDS = ("state", "submit", "n_ckpt", "ckpt_tier", "n_preempt",
              "n_spill")


def snapshot(tbl: JobTable) -> JobTable:
    """``tbl`` with copies of the columns the rules read before the tick
    (the other columns are not read from ``pre``)."""
    return tbl._replace(**{f: getattr(tbl, f).clone() for f in PRE_FIELDS})


def event_flags(pre: JobTable, post: JobTable, t: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flags[..., E, J] bool, args[..., E, J] int32)`` for one tick diff
    — the schema table of `obs.events`, vectorized.  Row order = EventType
    code order, so the flattened matrix enumerates events in (etype,
    table-row) order."""
    start = (post.state == RUNNING) & (post.run_start == t)
    rules = {
        EventType.SUBMIT: ((pre.state == UNSUB) & (pre.submit <= t),
                           post.cpus),
        EventType.START: (start, post.cpus),
        EventType.RESTORE: (start & (pre.n_ckpt > 0),
                            pre.ckpt_tier.clamp(min=0)),
        EventType.EVICT: (post.n_preempt > pre.n_preempt, post.cpus),
        EventType.SAVE: (post.n_ckpt > pre.n_ckpt, post.ckpt_tier),
        EventType.SPILL: (post.n_spill > pre.n_spill, post.ckpt_tier),
        EventType.FINISH: ((post.state == DONE) & (post.finish == t),
                           post.progress),
        EventType.DEFER: (post.state == PENDING, post.cpus),
    }
    assert len(rules) == N_EVENT_TYPES
    flags = torch.stack([rules[EventType(e)][0]
                         for e in range(N_EVENT_TYPES)], -2)
    args = torch.stack([rules[EventType(e)][1].to(I32)
                        for e in range(N_EVENT_TYPES)], -2)
    return flags, args


def capture_tick(pre: JobTable, post: JobTable, t: int, ring_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tick's ``(counts[..., E], ring[..., R, 3], dropped[...])``, all
    int32 on the table's device, shapes fixed by ``ring_size``; the
    leading axes are the table's batch axes."""
    flags, args = event_flags(pre, post, t)
    dev = flags.device
    lead, n_rows = pre.jid.shape[:-1], pre.jid.shape[-1]
    counts = flags.sum(-1, dtype=I32)
    flat = flags.reshape(lead + (-1,))
    n_flat = flat.shape[-1]
    pos = torch.cumsum(flat.to(I32), -1, dtype=I32) - 1
    # non-events and overflow go to rows past R, one each (flat position k
    # to row R + k), which are cut off: the reference's scatter with
    # mode="drop", without a read of how many fit.  Distinct rows, because
    # E*J writes to one row serialise on the card
    flat_pos = torch.arange(n_flat, dtype=I32, device=dev)
    slot = torch.where(flat & (pos < ring_size), pos, ring_size + flat_pos)
    etype = torch.arange(N_EVENT_TYPES, dtype=I32,
                         device=dev).repeat_interleave(n_rows)
    jid = post.jid.repeat((1,) * len(lead) + (N_EVENT_TYPES,))
    rows = torch.stack([etype.expand(lead + (n_flat,)), jid,
                        args.reshape(lead + (-1,))], -1)
    ring = torch.full(lead + (ring_size + n_flat, len(RING_FIELDS)), -1,
                      dtype=I32, device=dev)
    ring.scatter_(-2, slot.long().unsqueeze(-1).expand(rows.shape), rows)
    dropped = (counts.sum(-1, dtype=I32) - ring_size).clamp(min=0)
    return counts, ring[..., :ring_size, :], dropped


def decode_events(counts, ring, dropped, t0: int = 0) -> List[Event]:
    """Host-side reader: the stacked per-tick outputs -> canonical
    per-tick-sorted Events.

    ``counts``: [T, E], ``ring``: [T, R, 3], ``dropped``: [T] (tensors or
    arrays).  Tick t's valid rows are ``ring[t, :min(counts[t].sum(), R)]``
    (slots are prefix positions); they are re-sorted to the canonical
    (etype, jid) order.  Only the ring's first ``min(max_t total, R)``
    slots of each tick hold events, so only those cross to the host."""
    counts = _host(counts)
    totals = counts.sum(axis=1)
    cap = ring.shape[1]
    ring = _host(ring[:, :int(min(totals.max(initial=0), cap))])
    out: List[Event] = []
    for t in range(counts.shape[0]):
        k = int(min(totals[t], cap))
        if k == 0:
            continue
        rows = ring[t, :k]
        order = np.lexsort((rows[:, 1], rows[:, 0]))   # (etype, jid)
        out.extend(Event(t0 + t, e, j, a)
                   for e, j, a in rows[order].tolist())
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
