"""CheckpointService: ONE save/restore/stats facade over `checkpoint/` (the
twin of ``src/repro/checkpoint/service.py``).

The subsystem has four moving parts — `CheckpointManager` (tier policy +
delta chain), `MemTier`/`DiskTier` (storage), `delta` (XOR+compress codec),
`AsyncCheckpointer` (overlapped durable writes).  Consumers should not care:
the executor, the benchmarks, and any future agent talk to this facade and
get

* ``save(step, state)`` / ``restore(template)`` — the DMTCP-style
  transparent C/R pair, timed and byte-counted; the service serves one
  job on one device (``device="cuda"`` by default, raising where CUDA is
  absent), and restores onto it;
* ``stats()`` — one `CRStats` aggregate over every tier (bytes moved, wall
  seconds, save/restore counts);
* ``calibrate(tick_seconds, tiers=...)`` — the bridge to the scheduler:
  measured bandwidths become a `core.crcost.CRCostModel` (``tiers=None``)
  or the `TieredCRCostModel` cost lattice (``tiers=("mem", "disk")``), so
  the simulated cost-per-eviction and the real executor's measured
  overhead are expressed in the same units (DESIGN.md §C/R cost model,
  §Cost lattice).  ``calibrate_tiered`` remains as a deprecated shim.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, Optional, Sequence

from repro_torch.checkpoint.manager import CheckpointManager, ManagerConfig
from repro_torch.core.crcost import (
    DEFAULT_CAP_TICKS,
    UNBOUNDED,
    CRCostModel,
    TieredCRCostModel,
)
from repro_torch.core.omfs_torch import resolve_device


@dataclasses.dataclass
class CRStats:
    """Aggregate C/R traffic, in the shape `CRCostModel.from_stats` reads."""

    saves: int = 0
    restores: int = 0
    bytes_saved: int = 0
    bytes_restored: int = 0
    save_seconds: float = 0.0
    restore_seconds: float = 0.0

    @property
    def save_bytes_per_s(self) -> float:
        return self.bytes_saved / self.save_seconds if self.save_seconds else 0.0

    @property
    def restore_bytes_per_s(self) -> float:
        return (self.bytes_restored / self.restore_seconds
                if self.restore_seconds else 0.0)


class CheckpointService:
    """The single entry point to the checkpoint subsystem (facade)."""

    def __init__(self, cfg: ManagerConfig, *, device="cuda"):
        self.device = resolve_device(device)
        self.manager = CheckpointManager(cfg)
        self._stats = CRStats()
        self.last_save_seconds = 0.0
        self.last_restore_seconds = 0.0

    # -- the save/restore protocol -------------------------------------------
    def save(self, step: int, state, *, durable: Optional[bool] = None) -> str:
        t0 = time.perf_counter()
        name = self.manager.save(step, state, durable=durable)
        dt = time.perf_counter() - t0
        self.last_save_seconds = dt
        self._stats.saves += 1
        self._stats.bytes_saved += self.manager.last_save_bytes
        self._stats.save_seconds += dt
        return name

    def restore(self, template, *, name: Optional[str] = None, shardings=None):
        # drain the async durable writer OUTSIDE the timed window: a pending
        # background save completing late is save-side I/O, and charging it
        # as restore would invert the calibrated save/restore bandwidths
        self.manager.drain()
        t0 = time.perf_counter()
        state, name = self.manager.restore(
            template, name=name, shardings=shardings, device=self.device)
        dt = time.perf_counter() - t0
        self.last_restore_seconds = dt
        self._stats.restores += 1
        self._stats.bytes_restored += self.manager.last_restore_bytes
        self._stats.restore_seconds += dt
        return state, name

    def drain(self) -> None:
        self.manager.drain()

    def latest_step(self) -> Optional[int]:
        return self.manager.latest_step()

    def names(self):
        return self.manager.names()

    # -- stats + calibration --------------------------------------------------
    def stats(self) -> CRStats:
        """Service-level aggregate (whole save/restore calls, every tier)."""
        return dataclasses.replace(self._stats)

    def tier_stats(self) -> Dict[str, object]:
        """Per-tier breakdown, for the bandwidth benchmarks."""
        return {"mem": self.manager.mem.stats, "disk": self.manager.disk.stats}

    def calibrate(self, tick_seconds: float, *,
                  tiers: Optional[Sequence[str]] = None,
                  compress_ratio: float = 1.0,
                  save_base: int = 0, restore_base: int = 0,
                  delta_ratio: float = 1.0,
                  cap_ticks: int = DEFAULT_CAP_TICKS):
        """Measured traffic -> a scheduler cost model (the unified entry).

        ``tick_seconds`` is the wall length of one scheduler tick (the
        executor's unit); requires at least one measured save.
        ``delta_ratio`` is the measured recurrent-save coefficient
        (`crcost.measured_delta_num` quantizes the bench_cr_cost blend).

        ``tiers=None`` returns a flat `CRCostModel` from the service-level
        aggregate.  ``tiers`` as a sequence of tier names (from
        ``tier_stats()``, fastest first — e.g. ``("mem", "disk")``)
        returns the `TieredCRCostModel` lattice over those tiers: the
        "mem" tier is capacity-bounded at the manager's real
        ``mem_capacity_bytes`` on the whole-MiB grid, the last tier is
        forced UNBOUNDED (the durable spill target).  A tier with no
        measured save traffic inherits the fastest measured tier's model."""
        if tiers is None:
            return CRCostModel.from_stats(
                self.stats(), tick_seconds=tick_seconds,
                compress_ratio=compress_ratio, save_base=save_base,
                restore_base=restore_base, cap_ticks=cap_ticks,
                delta_ratio=delta_ratio)
        ts = self.tier_stats()
        caps = {"mem": self.manager.fast_capacity_mib, "disk": UNBOUNDED}
        return TieredCRCostModel.from_stats(
            [ts[name] for name in tiers], tick_seconds=tick_seconds,
            capacity_mib=[caps.get(name, UNBOUNDED) for name in tiers],
            compress_ratio=compress_ratio, cap_ticks=cap_ticks,
            delta_ratio=delta_ratio)

    def calibrate_tiered(self, tick_seconds: float, *,
                         compress_ratio: float = 1.0,
                         cap_ticks: int = DEFAULT_CAP_TICKS,
                         ) -> TieredCRCostModel:
        """Deprecated shim: use ``calibrate(tiers=("mem", "disk"))``."""
        warnings.warn(
            "CheckpointService.calibrate_tiered is deprecated; use "
            "calibrate(tiers=('mem', 'disk'))", DeprecationWarning,
            stacklevel=2)
        return self.calibrate(tick_seconds, tiers=("mem", "disk"),
                              compress_ratio=compress_ratio,
                              cap_ticks=cap_ticks)

    def close(self) -> None:
        self.manager.close()
