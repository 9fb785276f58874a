"""OMFS driving *real* training jobs: the paper's mechanism end to end (the
twin of ``src/repro/cluster/executor.py``).

``ClusterExecutor`` is a thin adapter over `core.engine.tick_python`, the
same tick the simulator uses, with real work: every RUNNING job advances
``steps_per_tick`` real optimizer steps on its device (the engine's
``work_fn`` hook); any Python policy decides admission and eviction; the
engine's transition report drives the C/R hooks.  Eviction of a
checkpointable job takes a **fast-tier checkpoint** (params, optimizer,
RNG, data cursor) and a restart restores it **transparently**: the user's
train loop (`TrainJob`) holds no checkpoint logic of its own, the DMTCP
property the paper builds on.

A job that is not running holds **no device memory**: ``release()`` drops
the state and turns the model's parameters into meta tensors, and the next
start allocates them again (``cold_start``) or takes the restored
snapshot's tensors as the parameters (``restore_state``), without a copy.
So the card holds the state of the running jobs only.

The executor is cooperative and single-process; scheduler accounting runs
on each job's declared ``cpus``, so the schedule is the one a fleet would
produce.  With ``tick_seconds`` set, every real checkpoint and restore is
timed and charged to the job's ``overhead`` in whole ticks
(`CRCostModel.ticks_from_seconds`); the first real snapshot feeds its
measured ``state_bytes`` back into the descriptor; and ``calibrate()``
turns the fleet's measured `CheckpointService` traffic into a cost model
for what-if simulation at fleet scale.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.service import CheckpointService, CRStats
from repro_torch.checkpoint.tiers import TierStats
from repro_torch.core import engine
from repro_torch.core.crcost import UNBOUNDED, CRCostModel, TieredCRCostModel
from repro_torch.core.omfs import scheduler_pass
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.core.types import ClusterState, Job, JobState, SchedulerConfig, User
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.models.model import Model, resolve_frontend
from repro_torch.obs.bus import EventBus
from repro_torch.train.state import (
    TrainState,
    bind_state,
    init_train_state,
    train_state_shapes,
)
from repro_torch.train.steps import TrainConfig, make_train_step


class TrainJob:
    """A user training job — *unmodified* train loop; no checkpoint code.

    ``model`` gives the architecture; the job keeps its parameters on
    ``device`` only while it holds a state (the model is released at
    construction).  The VLM and the audio model feed every step
    ``frontend`` (``data_cfg.global_batch`` rows on ``device``), by
    default the reference launchers' stub of zeros, made for each step so
    that a released job holds no tensor."""

    def __init__(self, model: Model, tcfg: TrainConfig, data_cfg: DataConfig,
                 seed: int = 0, device="cuda", frontend=None):
        self.model = model.release()
        self.device = resolve_device(device)
        # a given frontend is checked here; the stub is made for each step
        self.frontend = (None if frontend is None else resolve_frontend(
            model.cfg, frontend, 0, self.device))
        self.tcfg = tcfg
        self.data = SyntheticLM(data_cfg)
        self.seed = seed
        self._step_fn = make_train_step(self.model, tcfg)
        self.state: Optional[TrainState] = None
        self.losses: List[float] = []

    # -- the four hooks the adapter exposes to the cluster -------------------
    def cold_start(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model.materialise(self.device).init(gen)
        self.state = init_train_state(self.model.params(), self.seed)

    def run_step(self) -> float:
        cursor = int(self.state.data_cursor)        # a host tensor
        batch = shard_batch(self.data.batch_at(cursor), self.device)
        frontend = resolve_frontend(self.model.cfg, self.frontend,
                                    self.data.cfg.global_batch, self.device)
        if frontend is not None:
            batch["frontend"] = frontend
        self.state, metrics = self._step_fn(self.state, batch)
        loss = float(metrics["loss"])               # the step's host sync
        self.losses.append(loss)
        return loss

    def snapshot_state(self) -> TrainState:
        return self.state

    def restore_state(self, state: TrainState) -> None:
        self.state = bind_state(self.model, state)

    def release(self) -> None:
        self.state = None
        self.model.release()


@dataclasses.dataclass
class ManagedJob:
    descriptor: Job               # the scheduler-visible job (cpus, class, ...)
    train_job: TrainJob
    # CheckpointManager or CheckpointService — same save/restore duck type;
    # the service additionally exposes stats() for calibration
    ckpt: CheckpointManager
    restores: int = 0
    checkpoints: int = 0
    measured_cr_ticks: int = 0    # wall-time-derived overhead actually charged

    def template(self):
        return train_state_shapes(self.train_job.model, self.train_job.seed)

    def restore(self):
        """The latest snapshot on the job's device: (state, name)."""
        device = self.train_job.device
        if isinstance(self.ckpt, CheckpointService):
            if self.ckpt.device != device:
                raise ValueError(f"the service restores onto "
                                 f"{self.ckpt.device}, the job runs on "
                                 f"{device}")
            return self.ckpt.restore(self.template())
        return self.ckpt.restore(self.template(), device=device)


class ClusterExecutor:
    def __init__(
        self,
        users: List[User],
        config: SchedulerConfig,
        *,
        steps_per_tick: int = 1,
        policy: Callable = scheduler_pass,
        tick_seconds: Optional[float] = None,
    ):
        """``tick_seconds`` turns on measured C/R accounting: each real
        checkpoint save / restore is timed and its wall time, converted to
        whole ticks through `CRCostModel.ticks_from_seconds`, is charged to
        the job's ``overhead`` — the executed-on-hardware analogue of the
        simulator's predicted `cr_cost` charge (use a zero `cfg.cr_cost`
        with it, or the job pays both the prediction and the measurement).
        ``None`` (default) keeps accounting purely predictive."""
        self.state = ClusterState(config=config, users={u.name: u for u in users})
        self.jobs: Dict[int, ManagedJob] = {}
        self.steps_per_tick = steps_per_tick
        self.policy = policy
        self.tick_seconds = tick_seconds
        self.events: List[str] = []
        # typed lifecycle log: the same per-tick diff schema the simulator
        # backends record (repro_torch.obs), so executor runs feed the same
        # metrics registry / trace exporter as simulations
        self.bus = EventBus()

    def submit(self, mj: ManagedJob) -> None:
        d = mj.descriptor
        d.state = JobState.UNSUBMITTED
        self.state.jobs[d.id] = d
        self.jobs[d.id] = mj

    # -- one tick ---------------------------------------------------------------
    def tick(self) -> None:
        """One engine tick: real work rides the ``work_fn`` hook, C/R rides
        the transition report — the tick loop itself lives in core.engine."""
        st = self.state
        t = st.time

        def work_fn(d: Job) -> None:
            mj = self.jobs[d.id]
            for _ in range(self.steps_per_tick):
                mj.train_job.run_step()

        def on_complete(d: Job) -> None:
            self.events.append(f"t={t} job{d.id} DONE")
            self.jobs[d.id].train_job.release()

        self.bus.snapshot(st.jobs)
        _, transitions = engine.tick_python(
            st, self.policy, work_fn=work_fn, on_complete=on_complete)
        self.bus.record_tick(st.jobs, t)

        for d, was, now in transitions:
            mj = self.jobs[d.id]
            if was == JobState.RUNNING and now in (JobState.PENDING, JobState.KILLED):
                # evicted: transparent checkpoint if the class allows it
                if now == JobState.PENDING and mj.train_job.state is not None:
                    t0 = time.perf_counter()
                    mj.ckpt.save(int(mj.train_job.state.step),
                                 mj.train_job.snapshot_state())
                    self._charge_measured(mj, time.perf_counter() - t0)
                    mj.checkpoints += 1
                    # feed the real image size back into the descriptor so
                    # the scheduler's predictive cost model sees measured
                    # bytes from the first checkpoint on
                    measured = getattr(
                        getattr(mj.ckpt, "manager", mj.ckpt),
                        "last_save_bytes", 0)
                    if measured and d.state_bytes == 0:
                        d.state_bytes = measured
                    self.events.append(f"t={t} job{d.id} CHECKPOINTED+EVICTED")
                else:
                    self.events.append(f"t={t} job{d.id} KILLED")
                mj.train_job.release()
            elif was != JobState.RUNNING and now == JobState.RUNNING:
                # (re)started: restore transparently if a snapshot exists
                if mj.ckpt.latest_step() is not None:
                    # drain pending async durable writes untimed — they are
                    # save-side I/O, not part of the restore being charged
                    mj.ckpt.drain()
                    t0 = time.perf_counter()
                    state, name = mj.restore()
                    self._charge_measured(mj, time.perf_counter() - t0)
                    mj.train_job.restore_state(state)
                    mj.restores += 1
                    self.events.append(f"t={t} job{d.id} RESTORED {name}")
                elif mj.train_job.state is None:
                    mj.train_job.cold_start()
                    self.events.append(f"t={t} job{d.id} COLD START")
        st.time += 1

    def _charge_measured(self, mj: ManagedJob, seconds: float) -> None:
        """Measured C/R wall time -> work units on the job, via the model's
        unit conversion, so real and simulated accounting agree."""
        if self.tick_seconds is None:
            return
        ticks = CRCostModel.ticks_from_seconds(seconds, self.tick_seconds)
        mj.descriptor.overhead += ticks
        mj.measured_cr_ticks += ticks

    def run(self, horizon: int) -> None:
        for _ in range(horizon):
            self.tick()

    # -- measured-cost introspection -----------------------------------------
    def cr_stats(self) -> CRStats:
        """Aggregate measured C/R traffic over every managed job whose
        checkpoint backend is a `CheckpointService`."""
        agg = CRStats()
        for mj in self.jobs.values():
            if isinstance(mj.ckpt, CheckpointService):
                s = mj.ckpt.stats()
                agg.saves += s.saves
                agg.restores += s.restores
                agg.bytes_saved += s.bytes_saved
                agg.bytes_restored += s.bytes_restored
                agg.save_seconds += s.save_seconds
                agg.restore_seconds += s.restore_seconds
        return agg

    def calibrate(self, tick_seconds: Optional[float] = None, *,
                  tiers: Optional[Sequence[str]] = None, **kw):
        """A cost model from the fleet's measured save/restore traffic —
        run real jobs under the executor, calibrate, then drive what-if
        sweeps with simulation and execution agreeing on the cost units.
        ``tiers=None`` prices the service-level aggregate into a flat
        `CRCostModel`; ``tiers`` as tier names from ``tier_stats()``
        (fastest first, e.g. ``("mem", "disk")``) returns the
        `TieredCRCostModel` lattice, with the fast-tier capacity the
        smallest MemTier across managed jobs (conservative: the simulator
        never places more than the tightest real host holds)."""
        ts = tick_seconds if tick_seconds is not None else self.tick_seconds
        if not ts:
            raise ValueError("calibrate() needs tick_seconds")
        if tiers is None:
            return CRCostModel.from_stats(self.cr_stats(), tick_seconds=ts,
                                          **kw)
        caps = [mj.ckpt.manager.fast_capacity_mib
                for mj in self.jobs.values()
                if isinstance(mj.ckpt, CheckpointService)]
        if not caps:
            raise ValueError("no managed CheckpointService to calibrate from")
        stats = self.tier_stats()
        cap_of = {"mem": min(caps), "disk": UNBOUNDED}
        return TieredCRCostModel.from_stats(
            [stats[name] for name in tiers], tick_seconds=ts,
            capacity_mib=[cap_of.get(name, UNBOUNDED) for name in tiers],
            **kw)

    def tier_stats(self) -> Dict[str, TierStats]:
        """Fleet-wide per-tier traffic: every managed `CheckpointService`'s
        MemTier/DiskTier counters summed (the split ``calibrate(tiers=...)``
        prices the tiers from)."""
        agg = {"mem": TierStats(), "disk": TierStats()}
        for mj in self.jobs.values():
            if isinstance(mj.ckpt, CheckpointService):
                for key, st in mj.ckpt.tier_stats().items():
                    a = agg[key]
                    for f in dataclasses.fields(TierStats):
                        setattr(a, f.name,
                                getattr(a, f.name) + getattr(st, f.name))
        return agg

    def calibrate_tiered(self, tick_seconds: Optional[float] = None,
                         **kw) -> TieredCRCostModel:
        """Deprecated shim: use ``calibrate(tiers=("mem", "disk"))``."""
        warnings.warn(
            "ClusterExecutor.calibrate_tiered is deprecated; use "
            "calibrate(tiers=('mem', 'disk'))", DeprecationWarning,
            stacklevel=2)
        return self.calibrate(tick_seconds, tiers=("mem", "disk"), **kw)


def small_train_job(tmpdir: Path, *, arch_cfg, vocab=None, seq=64, batch=8,
                    lr=1e-3, seed=0, device="cuda",
                    frontend=None) -> TrainJob:
    """Convenience: a small real TrainJob on the smoke config of an arch,
    on ``device`` (``frontend``: `TrainJob`'s)."""
    model = Model(arch_cfg, device="meta", q_chunk=32, kv_chunk=32)
    tcfg = TrainConfig(lr=lr, warmup_steps=10, total_steps=1000)
    dcfg = DataConfig(vocab=arch_cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
    return TrainJob(model, tcfg, dcfg, seed=seed, device=device,
                    frontend=frontend)
