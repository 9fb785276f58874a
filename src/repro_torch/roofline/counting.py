"""Counting a step's costs by dispatch: the port's stand-in for XLA's cost
and memory analysis.

``with costing() as costs: step(...)`` records, for everything the block
runs on this rank:

* ``matmul_flops`` — the FLOPs of the aten ops that
  ``torch.utils.flop_counter.FlopCounterMode`` counts (mm, bmm, addmm,
  convolutions, attention), forward and backward;
* ``op_bytes`` — the inputs plus the outputs of every aten op that is
  not a view or an allocation.  An unfused upper bound: XLA counts a
  fusion's operands once, the eager port moves every intermediate;
* ``live_bytes`` and ``peak_bytes`` — the bytes of the storages the block
  made that are still alive, and their largest value.  Each new output
  storage of an op adds its bytes, and a ``weakref.finalize`` on the
  storage takes them away when it is freed; storages that existed before
  the block (the arguments) are not counted;
* ``coll`` — the result bytes of the explicit collectives
  (`distributed.collectives.COLLECTIVE_BYTES`) by kind;
* ``kernel_flops``, ``kernel_bytes`` and ``kernels`` — what each
  hand-written kernel's wrapper recorded with `record_kernel`, from its
  package's ``cost`` function.  Under an active `costing` a wrapper given
  meta tensors returns meta outputs and launches nothing; on CPU tensors
  it runs its plain version inside `uncounted`, so that the count is the
  kernel's on every device.

``costing(memory_only=True)`` counts only the live storage and its peak
(and the kernels' and collectives' records), without the FLOP counter:
the dry run's production pass, whose FLOPs and bytes are not read, runs
about a third faster so.

It runs the same way on meta tensors (the dry run: nothing is allocated)
and on real ones, so one step counted on the card and on meta gives the
same numbers.  ``notes`` holds what a count assumed (the MoE layers'
capacity and rows on meta).  ``argument_bytes``, ``output_bytes`` and
``alias_bytes`` are the caller's to set (`launch.dryrun`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives as col

_aten = torch.ops.aten
#: ops that allocate and move no bytes
_ALLOCATIONS = {
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten.new_empty_strided.default,
}
#: ops that return their input's storage without a view's schema
_ALIASES = {_aten._unsafe_view.default, _aten.lift_fresh.default}
#: an op's kind, by op: "alias" (a view: no bytes, no storage), "mutate"
#: (in place or out=: bytes, the storage its argument's), "alloc" (a new
#: storage, no bytes) or "op" (bytes and a new storage)
_KINDS: Dict[Any, str] = {}


def _kind(func) -> str:
    kind = _KINDS.get(func)
    if kind is None:
        if func.is_view or func in _ALIASES:
            kind = "alias"
        elif func._schema.is_mutable:
            kind = "mutate"
        elif func in _ALLOCATIONS:
            kind = "alloc"
        else:
            kind = "op"
        _KINDS[func] = kind
    return kind


@dataclasses.dataclass
class Costs:
    matmul_flops: float = 0.0
    op_bytes: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    live_bytes: int = 0
    peak_bytes: int = 0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        return self.op_bytes + self.kernel_bytes


_ACTIVE: List["_Counter"] = []


def active() -> Optional[Costs]:
    """The record of the innermost active `costing`, else None."""
    return _ACTIVE[-1].costs if _ACTIVE else None


def dry(device) -> bool:
    """Whether a wrapper given tensors on ``device`` is costing a step
    without running it: ``device`` is meta and a `costing` is active."""
    return torch.device(device).type == "meta" and bool(_ACTIVE)


def record_kernel(name: str, cost: dict) -> None:
    """Add one call of the kernel ``name`` (its ``cost``'s ``flop`` and
    ``bytes``) to the active record; nothing outside `costing`."""
    if not _ACTIVE:
        return
    c = _ACTIVE[-1].costs
    row = c.kernels.setdefault(name, {"calls": 0, "flop": 0, "bytes": 0})
    row["calls"] += 1
    row["flop"] += cost["flop"]
    row["bytes"] += cost["bytes"]
    c.kernel_flops += cost["flop"]
    c.kernel_bytes += cost["bytes"]


def note(key: str, value) -> None:
    """Record what a count assumed, under ``key`` (the distinct values, in
    the order first seen)."""
    if _ACTIVE:
        seen = _ACTIVE[-1].costs.notes.setdefault(key, [])
        if value not in seen:
            seen.append(value)


@contextlib.contextmanager
def uncounted():
    """Neither the FLOPs nor the bytes of the block's ops are counted (a
    kernel's plain version, whose cost its wrapper recorded); its
    storages still are."""
    if not _ACTIVE:
        yield
        return
    counter = _ACTIVE[-1]
    flops0 = counter.total_flops()
    counter.paused += 1
    try:
        yield
    finally:
        counter.paused -= 1
        counter.excluded_flops += counter.total_flops() - flops0


def tensors(tree, out=None) -> list:
    """The tensors of a tree of lists, tuples and dicts.  (A recursive
    closure here would make a reference cycle that keeps the tensors
    alive until the next garbage collection.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


def _plain(t: torch.Tensor) -> bool:
    """A tensor with storage of its own (not a wrapper subclass)."""
    return type(t) in (torch.Tensor, torch.nn.Parameter)


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs, flop_mode: Optional[FlopCounterMode]):
        super().__init__()
        self.costs, self.flop_mode = costs, flop_mode
        self.paused = 0
        self.excluded_flops = 0
        #: keys of the live storages this counter made
        self.tracked: set = set()

    def total_flops(self) -> int:
        return 0 if self.flop_mode is None else \
            self.flop_mode.get_total_flops()

    def _release(self, key: int, nbytes: int) -> None:
        self.tracked.discard(key)
        self.costs.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        if kind == "alias":
            return out
        c = self.costs
        outs = [t for t in tensors(out) if _plain(t)]
        if self.flop_mode is not None and not self.paused and kind != "alloc":
            c.op_bytes += sum(t.numel() * t.element_size() for t in outs)
            c.op_bytes += sum(t.numel() * t.element_size()
                              for t in tensors((args, kwargs)) if _plain(t))
        if kind == "mutate":                 # its outputs are its arguments
            return out
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.tracked:
                continue
            n = st.nbytes()
            self.tracked.add(key)
            c.live_bytes += n
            c.peak_bytes = max(c.peak_bytes, c.live_bytes)
            weakref.finalize(st, self._release, key, n)
        return out


@contextlib.contextmanager
def costing(memory_only: bool = False):
    """Count the block's costs into a new `Costs` record (yielded); with
    ``memory_only`` neither its FLOPs nor its op bytes."""
    costs = Costs()
    coll0 = dict(col.COLLECTIVE_BYTES)
    flop_mode = None if memory_only else FlopCounterMode(display=False)
    counter = _Counter(costs, flop_mode)
    _ACTIVE.append(counter)
    try:
        with flop_mode or contextlib.nullcontext(), counter:
            yield costs
    finally:
        _ACTIVE.remove(counter)
        costs.matmul_flops = float(counter.total_flops()
                                   - counter.excluded_flops)
        costs.coll = {k: float(v - coll0.get(k, 0))
                      for k, v in col.COLLECTIVE_BYTES.items()
                      if v - coll0.get(k, 0)}
