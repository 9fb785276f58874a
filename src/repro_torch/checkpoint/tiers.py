"""Multi-tier checkpoint storage — the paper's NVM/DCPMM adaptation (the
twin of ``src/repro/checkpoint/tiers.py``).

The paper reduces C/R thrashing cost with persistent-memory file systems
(SplitFS/NOVA/Assise over Optane DCPMM) and, further, DAX direct access.
The TPU-fleet analogue:

* ``MemTier``  — host-DRAM object store: memory-speed save/restore,
  survives the *job* (the scheduler process holds it) but not the host —
  exactly the role DCPMM plays for recurrent preemption checkpoints.  The
  "DAX" property maps to zero-serialization: arrays are kept as live numpy
  buffers and restored by one host-to-device copy, no encode/decode pass.
* ``DiskTier`` — durable storage with zstd compression (the distributed-FS
  tier); used for the every-N-steps durable checkpoint and for node-failure
  recovery.

``TieredStore`` implements write-through/promote/evict between them with a
capacity-bounded LRU on the fast tier (DCPMM is small — same constraint).
"""
from __future__ import annotations

import shutil
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.checkpoint import serialize


@dataclass
class TierStats:
    saves: int = 0
    restores: int = 0
    evictions: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    save_seconds: float = 0.0
    restore_seconds: float = 0.0


class MemTier:
    """Capacity-bounded in-memory snapshot store (the "NVM" tier)."""

    def __init__(self, capacity_bytes: int = 8 << 30):
        self.capacity = capacity_bytes
        self._store: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self.stats = TierStats()

    def save(self, name: str, tree) -> None:
        leaves = {k: serialize.to_numpy(v)
                  for k, v in serialize.leaf_paths(tree)}
        self.save_leaves(name, leaves)

    def save_leaves(self, name: str, leaves: Dict[str, np.ndarray]) -> None:
        t0 = time.perf_counter()
        size = sum(a.nbytes for a in leaves.values())
        if size > self.capacity:
            # An admission could only succeed by evicting EVERY resident
            # snapshot and would still blow the capacity bound; reject with
            # the store untouched (callers write through to the durable
            # tier instead — manager.save / TieredStore.save).
            raise ValueError(
                f"snapshot {name!r} ({size} B) exceeds MemTier capacity "
                f"({self.capacity} B)")
        while self._store and (sum(self._sizes.values()) + size) > self.capacity:
            old, _ = self._store.popitem(last=False)           # LRU eviction
            self._sizes.pop(old)
            self.stats.evictions += 1
        self._store[name] = leaves
        self._sizes[name] = size
        self._store.move_to_end(name)
        self.stats.saves += 1
        self.stats.bytes_written += size
        self.stats.save_seconds += time.perf_counter() - t0

    def restore(self, name: str) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        leaves = self._store[name]
        self._store.move_to_end(name)
        self.stats.restores += 1
        self.stats.bytes_read += self._sizes[name]
        self.stats.restore_seconds += time.perf_counter() - t0
        return leaves

    def __contains__(self, name: str) -> bool:
        return name in self._store

    def delete(self, name: str) -> None:
        self._store.pop(name, None)
        self._sizes.pop(name, None)

    def names(self):
        return list(self._store)


class DiskTier:
    """Durable zstd-compressed checkpoints (the distributed-FS tier)."""

    def __init__(self, root: Path, compress: Optional[int] = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.compress = compress
        self.stats = TierStats()
        # save_leaves runs on the AsyncCheckpointer writer thread while the
        # caller thread saves/restores concurrently; stats is shared.
        self._lock = threading.Lock()

    def _dir(self, name: str) -> Path:
        return self.root / name

    def save(self, name: str, tree) -> None:
        t0 = time.perf_counter()
        manifest = serialize.save_tree(tree, self._dir(name), compress=self.compress)
        with self._lock:
            self.stats.saves += 1
            self.stats.bytes_written += sum(
                m["nbytes_stored"] for m in manifest["leaves"].values())
            self.stats.save_seconds += time.perf_counter() - t0

    def save_leaves(self, name: str, leaves: Dict[str, np.ndarray]) -> None:
        """Persist an already-snapshotted MemTier entry (promotion) —
        path keys are preserved verbatim."""
        t0 = time.perf_counter()
        manifest = serialize.save_leaf_dict(
            leaves, self._dir(name), compress=self.compress)
        with self._lock:
            self.stats.saves += 1
            self.stats.bytes_written += sum(
                m["nbytes_stored"] for m in manifest["leaves"].values())
            self.stats.save_seconds += time.perf_counter() - t0

    def restore(self, name: str) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        leaves = serialize.load_leaves(self._dir(name))
        with self._lock:
            self.stats.restores += 1
            self.stats.bytes_read += sum(a.nbytes for a in leaves.values())
            self.stats.restore_seconds += time.perf_counter() - t0
        return leaves

    def __contains__(self, name: str) -> bool:
        return (self._dir(name) / serialize.MANIFEST).exists()

    def delete(self, name: str) -> None:
        shutil.rmtree(self._dir(name), ignore_errors=True)

    def names(self):
        return sorted(p.parent.name if p.name == serialize.MANIFEST else p.name
                      for p in self.root.glob(f"*/{serialize.MANIFEST}"))


class TieredStore:
    """Write to the fast tier; promote to durable on demand; restore from
    the fastest tier that has the snapshot."""

    def __init__(self, mem: MemTier, disk: DiskTier):
        self.mem = mem
        self.disk = disk

    def save(self, name: str, tree, durable: bool = False) -> None:
        leaves = {k: serialize.to_numpy(v)
                  for k, v in serialize.leaf_paths(tree)}
        try:
            self.mem.save_leaves(name, leaves)
        except ValueError:
            durable = True    # oversized for the fast tier: write through
        if durable:
            self.disk.save_leaves(name, leaves)

    def promote(self, name: str) -> None:
        if name in self.mem and name not in self.disk:
            self.disk.save_leaves(name, self.mem.restore(name))

    def restore_leaves(self, name: str) -> Dict[str, np.ndarray]:
        if name in self.mem:
            return self.mem.restore(name)
        if name in self.disk:
            leaves = self.disk.restore(name)
            return leaves
        raise KeyError(f"snapshot {name} in no tier")

    def __contains__(self, name: str) -> bool:
        return name in self.mem or name in self.disk
