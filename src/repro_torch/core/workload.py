"""Synthetic workload generation for scheduler benchmarks.

The port's own copy of ``repro.core.workload``: the same `WorkloadSpec`
gives field-for-field the same jobs as the reference (ids aside).

Models the regimes the paper cares about: bursty per-user demand (a user
suddenly needs its entitlement back), long-tailed job durations, mixed job
classes, jobs larger than their owner's whole entitlement (§II: "an
entity can use it to run a single job that is larger than its whole
entitlement"), and — the C/R cost axis — heterogeneous lognormal
checkpoint image sizes plus `thrashing_scenario`, where the size-aware
cost model materially changes the schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.crcost import MAX_STATE_MIB, MIB
from repro_torch.core.types import Job, JobClass, User


@dataclass(frozen=True)
class WorkloadSpec:
    n_users: int = 4
    horizon: int = 2_000
    cpu_total: int = 256
    arrival_rate: float = 0.05       # jobs per tick per user
    burstiness: float = 0.0          # 0 = Poisson; >0 = on/off bursts
    mean_work: float = 120.0         # mean job duration in ticks (lognormal)
    sigma_work: float = 1.0
    max_cpu_frac: float = 0.5        # max job size as a fraction of cpu_total
    oversub_prob: float = 0.02       # prob. a job exceeds its user entitlement
    class_mix: Sequence[float] = (0.2, 0.2, 0.6)  # non-preempt, preempt, ckpt
    equal_shares: bool = True
    seed: int = 0
    # checkpoint image sizes (heterogeneous C/R cost axis): lognormal MiB
    mean_state_mib: float = 512.0
    sigma_state: float = 1.2


def make_users(spec: WorkloadSpec, rng: Optional[np.random.Generator] = None) -> List[User]:
    rng = rng or np.random.default_rng(spec.seed)
    if spec.equal_shares:
        share = 100.0 / spec.n_users
        return [User(f"u{i}", share) for i in range(spec.n_users)]
    raw = rng.dirichlet(np.ones(spec.n_users) * 2.0) * 100.0
    return [User(f"u{i}", float(p)) for i, p in enumerate(raw)]


def make_jobs(spec: WorkloadSpec, users: List[User]) -> List[Job]:
    rng = np.random.default_rng(spec.seed + 1)
    jobs: List[Job] = []
    classes = [JobClass.NON_PREEMPTIBLE, JobClass.PREEMPTIBLE, JobClass.CHECKPOINTABLE]
    for u in users:
        entitled = max(1, int(u.percent / 100.0 * spec.cpu_total))
        # on/off burst modulation of the Poisson rate
        t = 0
        phase_on = True
        while t < spec.horizon:
            rate = spec.arrival_rate * (1 + spec.burstiness if phase_on else
                                        1 / (1 + spec.burstiness))
            gap = max(1, int(rng.exponential(1.0 / max(rate, 1e-9))))
            t += gap
            if t >= spec.horizon:
                break
            if rng.random() < 0.02:
                phase_on = not phase_on
            work = max(1, int(rng.lognormal(np.log(spec.mean_work), spec.sigma_work)))
            if rng.random() < spec.oversub_prob:
                # a job larger than the user's whole entitlement (paper §II)
                cpus = int(min(spec.cpu_total * spec.max_cpu_frac, entitled * 2))
            else:
                cpus = int(2 ** rng.integers(0, max(1, int(np.log2(entitled)) + 1)))
            cpus = max(1, min(cpus, int(spec.cpu_total * spec.max_cpu_frac)))
            job_class = classes[rng.choice(3, p=np.asarray(spec.class_mix))]
            jobs.append(Job(
                user=u.name, cpus=cpus, work=work,
                priority=int(rng.integers(0, 4)),
                job_class=job_class, submit_time=t,
            ))
    # Checkpoint image sizes, long-tailed like real training jobs.  Drawn
    # from a SEPARATE stream so the arrival/size/class draws above — and
    # therefore every schedule under a free cost model — stay bit-identical
    # to pre-cost-model workloads.
    rng_state = np.random.default_rng(spec.seed + 2)
    for job in jobs:
        mib = rng_state.lognormal(np.log(spec.mean_state_mib),
                                  spec.sigma_state)
        job.state_bytes = int(min(max(mib, 1.0), MAX_STATE_MIB)) * MIB
    return jobs


def arrival_stream(jobs: Iterable[Job]) -> Iterator[Job]:
    """Yield ``jobs`` in ascending ``(submit_time, id)`` order — the feed
    contract of `core.engine.simulate_stream` (the streaming engine pulls
    arrivals due before each segment's end, so the feed must be sorted)."""
    yield from sorted(jobs, key=lambda j: (j.submit_time, j.id))


def endless_arrivals(spec: WorkloadSpec,
                     users: Optional[List[User]] = None) -> Iterator[Job]:
    """Unbounded arrival stream for the streaming engine: epoch ``e`` draws
    a fresh `make_jobs` batch (seed ``spec.seed + 1000 * e``) and shifts its
    submit times by ``e * spec.horizon``, so arrivals flow forever in sorted
    order while only one epoch of Job objects is materialized at a time —
    the generator side of the bounded-memory story (the table side is
    `simulate_stream`'s fixed capacity)."""
    users = users if users is not None else make_users(spec)
    epoch = 0
    while True:
        batch = make_jobs(replace(spec, seed=spec.seed + 1000 * epoch), users)
        shift = epoch * spec.horizon
        for job in sorted(batch, key=lambda j: (j.submit_time, j.id)):
            job.submit_time += shift
            yield job
        epoch += 1


def reclaim_scenario(cpu_total: int = 256, quantum: int = 10):
    """The paper's headline scenario: user A idles while user B floods the
    machine with checkpointable jobs; A then submits an entitled job and
    must get its CPUs back ~immediately (memorylessness).

    Returns (users, jobs, the reclaiming job id)."""
    users = [User("A", 50.0), User("B", 50.0)]
    jobs = [
        Job(user="B", cpus=cpu_total // 4, work=10_000, priority=0,
            job_class=JobClass.CHECKPOINTABLE, submit_time=0)
        for _ in range(4)
    ]
    # NOTE: the claim is CHECKPOINTABLE, not NON_PREEMPTIBLE: Algorithm 1
    # line 23 uses ``>=``, so a non-preemptible job *exactly* equal to the
    # entitlement is always rejected (quirk kept faithfully; see DESIGN.md
    # and tests/test_omfs.py::test_line23_exact_entitlement_quirk).
    claim = Job(user="A", cpus=cpu_total // 2, work=200, priority=0,
                job_class=JobClass.CHECKPOINTABLE, submit_time=quantum + 50)
    jobs.append(claim)
    return users, jobs, claim.id


def oversub_scenario(cpu_total: int = 256):
    """A single job larger than its owner's whole entitlement must run when
    the machine is otherwise idle (paper §II, line 26)."""
    users = [User("A", 25.0), User("B", 75.0)]
    big = Job(user="A", cpus=int(cpu_total * 0.75), work=300,
              job_class=JobClass.CHECKPOINTABLE, submit_time=1)
    return users, [big], big.id


def thrashing_scenario(cpu_total: int = 64, quantum: int = 5,
                       n_claims: int = 12, state_gib: int = 64,
                       state_gibs: Optional[Sequence[int]] = None):
    """C/R cost materially changes the schedule (paper §III thrashing).

    User B fills the machine with long checkpointable jobs carrying *huge*
    checkpoint images; user A submits a periodic stream of short entitled
    claims, each of which evicts B's jobs.  Under a free cost model the
    eviction ping-pong is harmless; under a calibrated model every bounce
    charges B save+restore work proportional to ``state_gib``, so B's
    completions slide, later admissions see a different machine, and
    goodput drops — the schedules (not just the metrics) diverge.

    ``state_gibs`` (one GiB size per flood job, default four equal
    ``state_gib`` jobs) makes the flood heterogeneous — the regime where
    tiered eviction placement (snapshots compete for fast-tier capacity)
    and size-aware victim selection (`omfs_cheap_victim` prefers the
    cheap-to-checkpoint victims) change the schedule.

    Deterministic by construction (no RNG).  Returns ``(users, jobs)``;
    B's flood jobs are the ones with ``state_bytes > 0``."""
    users = [User("A", 50.0), User("B", 50.0)]
    if state_gibs is None:
        state_gibs = (state_gib,) * 4
    jobs = [
        Job(user="B", cpus=cpu_total // 4, work=300,
            job_class=JobClass.CHECKPOINTABLE, submit_time=0,
            state_bytes=gib << 30)
        for gib in state_gibs
    ]
    period = max(2 * quantum, 4)
    for i in range(n_claims):
        jobs.append(Job(
            user="A", cpus=cpu_total // 2, work=max(quantum, 4),
            job_class=JobClass.CHECKPOINTABLE,
            submit_time=quantum + 1 + i * period,
        ))
    return users, jobs
