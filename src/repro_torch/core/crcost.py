"""Size-aware C/R cost model: the paper's thrashing-cost term, first-class.

The port's own copy of ``repro.core.crcost`` (the port imports nothing of
``repro``); the arithmetic is unchanged, and only the tensor branch of
``_saturate`` speaks torch instead of jax.numpy.

The paper's argument is that transparent checkpoint-restart preemption is
cheap *because* the C/R cost is driven down by fast persistent-memory tiers
(SplitFS/NOVA over DCPMM, §III).  That cost is therefore not a constant: it
scales with the job's checkpoint image size and the tier's read/write
bandwidth, modulated by compression (delta/zstd/quantization, see
`checkpoint/`).  `CRCostModel` makes that relationship a deterministic,
integer-valued function every scheduler layer shares:

* ``save_cost(state_mib)``    — work units charged when a checkpointable
  victim is evicted (the snapshot write);
* ``restore_cost(state_mib)`` — work units charged when a previously
  checkpointed job is (re)started (the snapshot read).

Both are piecewise-linear — ``base + ceil(compressed_mib / mib_per_tick)``,
saturated at ``cap_ticks`` — so the same expression evaluates on Python
ints and on int32 tensors, which is what keeps the Python reference
and the vectorized backends bit-identical (DESIGN.md §C/R cost model).

The model is **delta-aware** (two-coefficient ``(first, recurrent)``): the
FIRST save of a job prices the full compressed image; every subsequent
save of the same job prices the *delta* against the previous snapshot —
``recurrent_save_cost`` moves ``ceil(c(m) * delta_num / delta_den)`` MiB
instead of ``c(m)``.  The coefficient lives on the same /256 rational grid
as compression; the default ``(1, 1)`` makes recurrent saves identical to
first saves (exact legacy behaviour).  `measured_delta_num` quantizes the
coefficient measured by ``benchmarks/bench_cr_cost.py``.

Determinism rules (load-bearing for cross-backend equality):

* all arithmetic is integer; ``ceil`` is ``(a + b - 1) // b``;
* sizes enter in MiB (``state_mib_of``), clamped to ``MAX_STATE_MIB`` so
  every intermediate fits int32 in the job table;
* the compression ratio is a rational ``compress_num / compress_den``
  (never a float) — ``from_stats`` quantizes measured ratios to /256ths.

``from_stats`` calibrates a model from measured tier statistics (bytes and
wall seconds — `checkpoint.tiers.TierStats` or the `CheckpointService`
aggregate), converting bandwidth to MiB per scheduler tick.  That is the
bridge from `benchmarks/bench_cr_cost.py`'s real measurements to a number
the jitted scheduling tick can consume.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

MIB = 1 << 20
#: Largest checkpoint image the model distinguishes (1 TiB).  Beyond this
#: the cost saturates; the clamp keeps ``state_mib * compress_num`` inside
#: int32 for the vectorized backends (2**20 MiB * num<=1024 < 2**31).
MAX_STATE_MIB = 1 << 20
#: Default cost saturation: no single C/R event is charged more than this.
DEFAULT_CAP_TICKS = 1 << 20


def _ceil_div(a, b):
    """Integer ceil-division that works on Python ints and int tensors."""
    return (a + b - 1) // b


def _saturate(v, cap: int):
    """min(v, cap) for Python ints and int tensors alike."""
    if isinstance(v, int):
        return min(v, cap)
    import torch

    return torch.clamp(v, max=cap)


def state_mib_of(state_bytes: int) -> int:
    """Checkpoint image size in whole MiB (ceil), clamped to MAX_STATE_MIB.

    0 bytes -> 0 MiB (a job that declared no state is free to C/R under a
    pure-bandwidth model; the ``*_base`` terms still apply)."""
    if state_bytes <= 0:
        return 0
    return min(_ceil_div(int(state_bytes), MIB), MAX_STATE_MIB)


@dataclass(frozen=True)
class CRCostModel:
    """Deterministic integer C/R cost as a function of checkpoint size.

    ``save_cost(m)    = min(save_base    + ceil(c(m) * save_tick_den / save_mib_per_tick),       cap_ticks)``
    ``restore_cost(m) = min(restore_base + ceil(c(m) * restore_tick_den / restore_mib_per_tick), cap_ticks)``
    with ``c(m) = ceil(m * compress_num / compress_den)`` the compressed
    image size.  Bandwidth is the RATIONAL ``save_mib_per_tick /
    save_tick_den`` MiB per tick (den=1 for hand-written models; calibration
    quantizes to /256ths so tiers slower than 1 MiB/tick are still priced
    correctly instead of floored to 1).  ``save_mib_per_tick <= 0`` means
    "free transfer" (only the base term is charged).  The all-defaults
    model charges nothing — legacy ``SchedulerConfig.cr_overhead``
    behaviour is exactly preserved.

    Hashable (frozen) on purpose: it rides `SchedulerConfig`, which is a
    static jit argument and an `lru_cache` key for the compiled tick scans.
    """

    save_mib_per_tick: int = 0       # fast-tier write bandwidth numerator
    restore_mib_per_tick: int = 0    # fast-tier read bandwidth numerator
    save_base: int = 0               # fixed per-checkpoint work units
    restore_base: int = 0            # fixed per-restore work units
    compress_num: int = 1            # effective bytes = raw * num / den
    compress_den: int = 1
    save_tick_den: int = 1           # bandwidth = mib_per_tick / tick_den
    restore_tick_den: int = 1
    cap_ticks: int = DEFAULT_CAP_TICKS
    delta_num: int = 1               # recurrent save moves c(m) * num / den
    delta_den: int = 1

    def __post_init__(self):
        assert self.compress_num >= 0 and self.compress_den >= 1
        # int32 safety in the job table: compressed mib <= 4 * MAX_STATE_MIB
        # = 2**22, times tick_den <= 256 stays under 2**31
        assert self.compress_num <= 4 * self.compress_den, \
            "compression ratio must be <= 4 (quantize to num/den)"
        assert self.compress_num <= 1024 and self.compress_den <= 256, \
            "keep num/den small: state_mib * num must fit int32"
        assert 1 <= self.save_tick_den <= 256
        assert 1 <= self.restore_tick_den <= 256
        assert self.cap_ticks >= 0
        # a delta can never move more than the full image, and the /256 cap
        # keeps compressed_mib * delta_num inside int32 (2**22 * 256 = 2**30)
        assert 1 <= self.delta_den <= 256
        assert 0 <= self.delta_num <= self.delta_den, \
            "recurrent saves move at most the full image (num <= den)"

    # -- the model ----------------------------------------------------------
    def compressed_mib(self, state_mib):
        """Effective MiB moved after compression (int or int tensor)."""
        return _ceil_div(state_mib * self.compress_num, self.compress_den)

    def delta_mib(self, state_mib):
        """Effective MiB a RECURRENT save moves: the delta against the
        previous snapshot, ``ceil(c(m) * delta_num / delta_den)``."""
        return _ceil_div(self.compressed_mib(state_mib) * self.delta_num,
                         self.delta_den)

    def _cost(self, moved, mib_per_tick: int, tick_den: int, base: int):
        if mib_per_tick > 0:
            var = _ceil_div(moved * tick_den, mib_per_tick)
        else:
            var = moved * 0                      # free transfer, keep shape
        return _saturate(base + var, self.cap_ticks)

    def save_cost(self, state_mib):
        """Work units charged at a job's FIRST eviction-checkpoint (full
        image); int in, int out — or elementwise over an int32 tensor."""
        return self._cost(self.compressed_mib(state_mib),
                          self.save_mib_per_tick,
                          self.save_tick_den, self.save_base)

    def recurrent_save_cost(self, state_mib):
        """Work units charged when a job that already holds a previous
        snapshot is evicted again — only the delta is moved."""
        return self._cost(self.delta_mib(state_mib),
                          self.save_mib_per_tick,
                          self.save_tick_den, self.save_base)

    def restore_cost(self, state_mib):
        """Work units charged at restart-restore (same polymorphism)."""
        return self._cost(self.compressed_mib(state_mib),
                          self.restore_mib_per_tick,
                          self.restore_tick_den, self.restore_base)

    @property
    def is_free(self) -> bool:
        """True iff the model never charges anything (the legacy default)."""
        return (self.save_base == 0 and self.restore_base == 0
                and self.save_mib_per_tick <= 0
                and self.restore_mib_per_tick <= 0) or self.cap_ticks == 0

    # -- calibration --------------------------------------------------------
    @classmethod
    def from_measured(
        cls,
        *,
        save_bytes_per_s: float,
        restore_bytes_per_s: float,
        tick_seconds: float,
        compress_ratio: float = 1.0,
        save_base: int = 0,
        restore_base: int = 0,
        cap_ticks: int = DEFAULT_CAP_TICKS,
        delta_ratio: float = 1.0,
    ) -> "CRCostModel":
        """Build a model from measured bandwidths.

        ``tick_seconds`` is the wall-clock length of one scheduler tick —
        the single unit conversion between the real executor and the
        simulator.  Bandwidths quantize to /256ths of a MiB per tick
        (floor of the representable grid, min 1/256), so tiers slower than
        1 MiB/tick are charged their real cost instead of being flattened
        to 1 MiB/tick; ``compress_ratio`` (stored/raw) quantizes to
        /256ths too.  NOTE: pass ``compress_ratio`` only when the measured
        bandwidth was taken on *raw* traffic that will additionally be
        compressed — stats whose wall time already includes compression
        (e.g. `CheckpointService` save timings) are an *effective* raw
        bandwidth and want the default 1.0.  ``delta_ratio`` is the
        measured recurrent-save fraction (delta bytes / full image bytes,
        see `measured_delta_num`); it quantizes to /256ths as well.
        """
        def mib_per_tick(bps: float):
            if bps <= 0:
                return 0
            return max(1, int(round(bps * tick_seconds / MIB * 256)))

        num = max(0, min(1024, int(round(compress_ratio * 256))))
        dnum = max(0, min(256, int(round(delta_ratio * 256))))
        return cls(
            save_mib_per_tick=mib_per_tick(save_bytes_per_s),
            restore_mib_per_tick=mib_per_tick(restore_bytes_per_s),
            save_base=save_base,
            restore_base=restore_base,
            compress_num=num,
            compress_den=256,
            save_tick_den=256,
            restore_tick_den=256,
            cap_ticks=cap_ticks,
            delta_num=dnum,
            delta_den=256,
        )

    @classmethod
    def from_stats(cls, stats: Any, *, tick_seconds: float,
                   compress_ratio: float = 1.0, save_base: int = 0,
                   restore_base: int = 0,
                   cap_ticks: int = DEFAULT_CAP_TICKS,
                   delta_ratio: float = 1.0) -> "CRCostModel":
        """Calibrate from measured tier statistics.

        ``stats`` is anything exposing bytes/seconds counters —
        `checkpoint.tiers.TierStats` (``bytes_written``/``bytes_read``,
        ``save_seconds``/``restore_seconds``) or the `CheckpointService`
        aggregate (``bytes_saved``/``bytes_restored``).  Missing restore
        traffic falls back to the save-side bandwidth (write-limited tiers).
        """
        saved = getattr(stats, "bytes_saved", None)
        if saved is None:
            saved = getattr(stats, "bytes_written", 0)
        restored = getattr(stats, "bytes_restored", None)
        if restored is None:
            restored = getattr(stats, "bytes_read", 0)
        t_save = getattr(stats, "save_seconds", 0.0)
        t_rest = getattr(stats, "restore_seconds", 0.0)

        save_bps = saved / t_save if (saved and t_save > 0) else 0.0
        restore_bps = restored / t_rest if (restored and t_rest > 0) else 0.0
        if restore_bps <= 0:
            restore_bps = save_bps
        return cls.from_measured(
            save_bytes_per_s=save_bps, restore_bytes_per_s=restore_bps,
            tick_seconds=tick_seconds, compress_ratio=compress_ratio,
            save_base=save_base, restore_base=restore_base,
            cap_ticks=cap_ticks, delta_ratio=delta_ratio)

    # -- executor accounting -------------------------------------------------
    @staticmethod
    def ticks_from_seconds(seconds: float, tick_seconds: float) -> int:
        """Measured wall time -> whole scheduler ticks (ceil, >= 0).

        The real executor charges *measured* C/R overhead through this so
        simulation (predicted, via save/restore_cost) and execution agree
        on units."""
        if seconds <= 0 or tick_seconds <= 0:
            return 0
        return int(math.ceil(seconds / tick_seconds))


#: `TieredCRCostModel.capacity_mib` convention: a negative capacity means
#: "unbounded" (the durable/spill tier); 0 means the tier holds nothing.
UNBOUNDED = -1

#: Measured recurrent-save coefficients from `benchmarks/bench_cr_cost.py`:
#: a delta-chunk zstd-compresses to 0.549 of its raw size, and on average
#: 0.64 of a recurrent image is dirty (the rest dedups against the previous
#: snapshot).  The blended per-image coefficient is
#: ``frac * ratio + (1 - frac)`` — dirty chunks move at the delta ratio,
#: clean chunks still cost their (tiny) dedup-index entry ~ full weight.
MEASURED_DELTA_ZSTD = 0.549
MEASURED_DELTA_FRAC = 0.64


def measured_delta_num(ratio: float = MEASURED_DELTA_ZSTD,
                       frac: float = MEASURED_DELTA_FRAC) -> int:
    """Quantize the blended recurrent-save coefficient to the /256 grid.

    With the measured defaults: 0.64 * 0.549 + 0.36 = 0.71136 -> 182.
    Pass the result as ``CRCostModel(delta_num=..., delta_den=256)``.
    This is a float->grid calibration boundary like `from_measured`; the
    models themselves stay integer-only.
    """
    eff = frac * ratio + (1.0 - frac)
    return max(0, min(256, int(round(eff * 256))))


@dataclass(frozen=True)
class TieredCRCostModel:
    """A bank of per-tier C/R cost models with capacities — mem vs. disk.

    Mirrors the real checkpoint subsystem (`checkpoint.manager`): tier 0 is
    the fast tier (MemTier, capacity-bounded like DCPMM), the last tier is
    the durable spill target (DiskTier, unbounded).  Each eviction *places*
    the victim's snapshot on a tier — greedy cheapest-feasible, see
    ``choose_tier`` — and the chosen tier prices both the save (charged at
    eviction) and the later restore (charged at restart).  This replaces
    the single-tier assumption of `SchedulerConfig.cr_cost` when set as
    ``SchedulerConfig.cr_tiers`` (which then takes precedence).

    Determinism rules (cross-backend bit-equality, same as `CRCostModel`):

    * ``capacity_mib`` entries are integers on the same whole-MiB grid as
      ``state_mib_of``; negative = ``UNBOUNDED``, 0 = holds nothing;
    * occupancy of a tier is the sum of ``state_mib`` over jobs currently
      *holding* a snapshot there (evicted-and-pending); a restore consumes
      the snapshot (the slot frees when the job restarts);
    * placement is greedy in victim order: earlier victims claim capacity
      first, later ones spill — both backends walk victims in the same
      order, so placements agree by construction.

    Hashable (frozen, tuple fields) on purpose: it rides `SchedulerConfig`,
    a static jit argument and compilation-cache key.
    """

    tiers: Tuple[CRCostModel, ...]
    capacity_mib: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.tiers) >= 1
        assert len(self.tiers) == len(self.capacity_mib), \
            "one capacity per tier"
        assert all(isinstance(m, CRCostModel) for m in self.tiers)
        assert self.capacity_mib[-1] < 0, \
            "the last tier is the spill target and must be UNBOUNDED (<0)"

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    def save_cost(self, tier: int, state_mib):
        return self.tiers[tier].save_cost(state_mib)

    def recurrent_save_cost(self, tier: int, state_mib):
        return self.tiers[tier].recurrent_save_cost(state_mib)

    def restore_cost(self, tier: int, state_mib):
        return self.tiers[tier].restore_cost(state_mib)

    def feasible(self, tier: int, state_mib: int, occupied_mib: int) -> bool:
        cap = self.capacity_mib[tier]
        return cap < 0 or occupied_mib + state_mib <= cap

    def choose_tier(self, state_mib: int, occupied_mib: Sequence[int],
                    recurrent: bool = False) -> int:
        """Greedy cheapest-feasible placement for one eviction.

        Among tiers with room for ``state_mib`` on top of ``occupied_mib``,
        pick the one with the lowest save cost (ties break toward the
        lower/faster tier index).  If nothing fits, spill to the last tier
        (always feasible by the UNBOUNDED invariant).  ``recurrent`` prices
        the placement with the delta coefficient — a warm job shops for a
        tier with its real (smaller) write in hand."""
        cost = (self.recurrent_save_cost if recurrent else self.save_cost)
        best = self.n_tiers - 1
        best_cost = cost(best, state_mib)
        for k in range(self.n_tiers - 1):
            if not self.feasible(k, state_mib, occupied_mib[k]):
                continue
            c = cost(k, state_mib)
            if c < best_cost or (c == best_cost and k < best):
                best, best_cost = k, c
        return best

    @classmethod
    def from_stats(cls, tier_stats: Sequence[Any], *, tick_seconds: float,
                   capacity_mib: Sequence[int],
                   compress_ratio: float = 1.0,
                   cap_ticks: int = DEFAULT_CAP_TICKS,
                   delta_ratio: float = 1.0) -> "TieredCRCostModel":
        """Calibrate one model per measured tier (mirrors
        `CheckpointManager`'s MemTier/DiskTier stats pair).

        ``tier_stats`` is a sequence of TierStats-shaped objects, fastest
        tier first; a tier with no measured save traffic inherits the
        fastest *measured* tier's model (conservative: never prices an
        unmeasured tier as free).  ``capacity_mib[-1]`` is forced to
        UNBOUNDED — the durable tier is the spill target."""
        models = []
        fallback = None
        for st in tier_stats:
            saved = getattr(st, "bytes_saved", None)
            if saved is None:
                saved = getattr(st, "bytes_written", 0)
            if saved and getattr(st, "save_seconds", 0.0) > 0:
                m = CRCostModel.from_stats(
                    st, tick_seconds=tick_seconds,
                    compress_ratio=compress_ratio, cap_ticks=cap_ticks,
                    delta_ratio=delta_ratio)
                if fallback is None:
                    fallback = m
            else:
                m = None
            models.append(m)
        if fallback is None:
            raise ValueError("no tier has measured save traffic")
        tiers = tuple(m if m is not None else fallback for m in models)
        caps = tuple(int(c) for c in capacity_mib[:-1]) + (UNBOUNDED,)
        return cls(tiers=tiers, capacity_mib=caps)
