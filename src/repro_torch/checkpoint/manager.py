"""CheckpointManager: the framework's DMTCP — one object per job (the twin
of ``src/repro/checkpoint/manager.py``).

Policy implemented (all knobs in ManagerConfig):
* every preemption / quantum boundary -> **fast-tier** snapshot (MemTier,
  the NVM analogue) — optionally delta-encoded against the previous one;
* every ``durable_every`` saves -> promote to **disk tier** (zstd), written
  **asynchronously** (training overlaps the I/O);
* ``keep_last`` durable checkpoints are retained, older ones GC'd; the
  delta chain keeps the last ``delta_keep_last`` encoded snapshots and is
  *decodable*: a snapshot LRU-evicted from the fast tier can still be
  rebuilt by XOR-walking the chain from the nearest full snapshot;
* a snapshot too large for the fast tier writes through to the disk tier
  (the capacity bound is never silently blown);
* restore prefers the fastest tier, verifies integrity (crc in manifest),
  and puts the tensors on the template's device (or on ``device=``).

Like the reference, the manager does not run the int8 codec
(``kernels/ckpt_codec``): its snapshots are exact.

Most callers want `checkpoint.service.CheckpointService`, the facade that
adds unified stats and C/R cost-model calibration on top of this class.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import delta as delta_mod
from repro_torch.checkpoint.async_writer import AsyncCheckpointer
from repro_torch.checkpoint.reshard import restore_resharded, save_global
from repro_torch.checkpoint.serialize import leaf_paths
from repro_torch.checkpoint.tiers import DiskTier, MemTier
from repro_torch.core.omfs_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ManagerConfig:
    root: Path
    mem_capacity_bytes: int = 4 << 30
    durable_every: int = 5         # promote every k-th save to disk
    keep_last: int = 2             # durable checkpoints retained
    use_delta: bool = True         # delta-encode fast-tier snapshots
    delta_keep_last: int = 8       # encoded snapshots kept in the chain
    zstd_level: int = 3
    async_durable: bool = True


def _target_device(template, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    devices = {leaf.device for _, leaf in leaf_paths(template)
               if isinstance(leaf, torch.Tensor)}
    if len(devices) != 1 or torch.device("meta") in devices:
        raise ValueError(f"template leaves lie on {sorted(map(str, devices))}"
                         f": pass device=")
    return devices.pop()


class CheckpointManager:
    def __init__(self, cfg: ManagerConfig):
        self.cfg = cfg
        self.mem = MemTier(cfg.mem_capacity_bytes)
        self.disk = DiskTier(Path(cfg.root), compress=cfg.zstd_level)
        self._async = AsyncCheckpointer(self.disk.save_leaves)
        self._save_count = 0
        self._last_leaves: Optional[Dict[str, np.ndarray]] = None
        self._last_step: Optional[int] = None
        # name -> (blobs, meta, parent_name); bounded FIFO of delta-encoded
        # snapshots, decodable via _restore_from_chain
        self._delta_chain: "OrderedDict[str, Tuple]" = OrderedDict()
        self.timings: Dict[str, float] = {"fast_save_s": 0.0, "durable_save_s": 0.0}
        self.last_save_bytes = 0       # raw snapshot size of the last save
        self.last_restore_bytes = 0    # raw size of the last restored snapshot

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state, *, durable: Optional[bool] = None) -> str:
        name = f"step_{step:08d}"
        t0 = time.perf_counter()
        leaves = save_global(state)
        self.last_save_bytes = sum(a.nbytes for a in leaves.values())
        if self.cfg.use_delta and self._last_leaves is not None:
            blobs, _sizes = delta_mod.encode_snapshot(
                leaves, self._last_leaves, level=self.cfg.zstd_level)
            # the dtype itself, not its name: numpy cannot name bfloat16
            meta = {k: (a.dtype, a.shape) for k, a in leaves.items()}
            parent = f"step_{self._last_step:08d}"
            self._delta_chain[name] = (blobs, meta, parent)
            while len(self._delta_chain) > self.cfg.delta_keep_last:
                self._delta_chain.popitem(last=False)
        oversized = False
        try:
            self.mem.save_leaves(name, leaves)
        except ValueError:
            oversized = True        # write through to the durable tier below
        self._last_leaves = leaves
        self._last_step = step
        self.timings["fast_save_s"] += time.perf_counter() - t0

        self._save_count += 1
        make_durable = durable if durable is not None else (
            self._save_count % self.cfg.durable_every == 0)
        if make_durable or oversized:
            t1 = time.perf_counter()
            if self.cfg.async_durable and not oversized:
                self._async.save_leaves(name, leaves)
            else:
                # oversized snapshots persist synchronously: the fast tier
                # holds no copy, so the write must land before we return
                self.disk.save_leaves(name, leaves)
            self._gc()
            self.timings["durable_save_s"] += time.perf_counter() - t1
        return name

    def drain(self) -> None:
        """Barrier on any in-flight async durable write.  Restore timing
        should exclude this (it is save-side I/O that happens to complete
        late), so timed callers drain first — see CheckpointService."""
        self._async.wait()

    @property
    def fast_capacity_mib(self) -> int:
        """MemTier capacity on the scheduler's whole-MiB grid (floor: the
        simulator must never place more than the real tier can hold) —
        feeds `TieredCRCostModel.from_stats` via the service facade."""
        return self.mem.capacity >> 20

    # -- restore -------------------------------------------------------------
    def names(self):
        """Every restorable snapshot: fast tier, durable tier, delta chain."""
        return sorted(set(self.mem.names()) | set(self.disk.names())
                      | set(self._delta_chain))

    def restore_leaves(self, name: str) -> Dict[str, np.ndarray]:
        """Raw leaves from the fastest tier holding ``name`` — falling back
        to decoding the delta chain from the nearest full snapshot."""
        if name in self.mem:
            leaves = self.mem.restore(name)
        elif name in self.disk:
            leaves = self.disk.restore(name)
        elif name in self._delta_chain:
            leaves = self._restore_from_chain(name)
        else:
            raise FileNotFoundError(f"snapshot {name} in no tier")
        self.last_restore_bytes = sum(a.nbytes for a in leaves.values())
        return leaves

    def _restore_from_chain(self, name: str) -> Dict[str, np.ndarray]:
        """Walk parent links back to a full snapshot, then XOR-decode
        forward.  Raises if the chain's base left every tier (evicted and
        never made durable)."""
        chain = []
        cur: Optional[str] = name
        while cur is not None and cur not in self.mem and cur not in self.disk:
            if cur not in self._delta_chain:
                raise FileNotFoundError(
                    f"snapshot {name}: chain base {cur} left every tier")
            entry = self._delta_chain[cur]
            chain.append(entry)
            cur = entry[2]
        if cur is None:
            raise FileNotFoundError(f"snapshot {name}: chain has no base")
        base = self.mem.restore(cur) if cur in self.mem else self.disk.restore(cur)
        for blobs, meta, _parent in reversed(chain):
            base = delta_mod.decode_snapshot(blobs, base, meta)
        return base

    def restore(self, template, *, name: Optional[str] = None, shardings=None,
                device=None):
        """Latest (or named) snapshot -> tree shaped like template, on
        ``device`` (default: the template's device; a ``meta`` template
        needs ``device``)."""
        device = _target_device(template, device)
        self._async.wait()
        if name is None:
            names = self.names()
            if not names:
                raise FileNotFoundError("no checkpoints")
            name = names[-1]
        leaves = self.restore_leaves(name)
        return restore_resharded(leaves, template, shardings,
                                 device=device), name

    def latest_step(self) -> Optional[int]:
        names = self.names()
        return int(names[-1].split("_")[1]) if names else None

    # -- misc -----------------------------------------------------------------
    def _gc(self) -> None:
        self._async.wait()
        names = self.disk.names()
        for old in names[: -self.cfg.keep_last]:
            self.disk.delete(old)

    def close(self):
        self._async.close()
