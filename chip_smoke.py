"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, drives the main path (the OMFS tick
engine, `repro_torch.core.engine.simulate`) on a 100k-job, 16,384-CPU fleet
with a T=4 checkpoint hierarchy, checks that it went through the kernel
and matches the eager "torch" backend column for column, and runs the
launcher.  Every phase prints one line; any failure raises.  The last two
lines are the kernels' JSON record and the device record.

Exits non-zero without a result where no CUDA device is visible.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import engine, omfs_torch  # noqa: E402
from repro_torch.core.crcost import (  # noqa: E402
    UNBOUNDED,
    CRCostModel,
    TieredCRCostModel,
    measured_delta_num,
)
from repro_torch.core.types import SchedulerConfig  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    WorkloadSpec,
    make_jobs,
    make_users,
)
from repro_torch.kernels.sched_select import ops as sched_ops  # noqa: E402
from repro_torch.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_ref,
)
from repro_torch.launch import cluster_sim  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
#: H100 SXM data-sheet peaks (dense): HBM bytes/s and the non-tensor-core
#: scalar rate used for the comparison count of a sort
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# the fleet: bench_sched_scale.py's scale generator and T=4 lattice
FLEET_JOBS = 100_000
FLEET_CPUS = 16_384
FLEET_TENANTS = 16
FLEET_QUANTUM = 10
FLEET_DEPTH = 32
FLEET_HORIZON = 100


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# sched_select inputs, bytes and timing
# ---------------------------------------------------------------------------


def random_case(rng, j, n_tiers, bounded):
    """Random int32 columns; lattice values from a narrow range so the
    placement argmin meets ties."""
    save_lat = rng.integers(0, 6, (j, n_tiers)).astype(np.int32)
    evictable = rng.random(j) < 0.5
    cpus = rng.integers(1, 8, j).astype(np.int32)
    cap = rng.integers(0, 256, n_tiers).astype(np.int32)
    cap[rng.random(n_tiers) < 0.3] = -1
    cap[-1] = -1
    if not bounded:
        cap[:] = -1
    total = int(cpus[evictable].sum())
    cols = dict(
        prio=rng.integers(0, 5, j).astype(np.int32),
        run_start=rng.integers(-1, 40, j).astype(np.int32),
        jid=rng.permutation(j).astype(np.int32),
        key_cost=np.ascontiguousarray(save_lat[:, 0]),
        evictable=evictable,
        cpus=cpus,
        state_mib=rng.integers(0, 64, j).astype(np.int32),
        is_ckpt=rng.random(j) < 0.7,
        save_lat=save_lat,
    )
    cols = {k: torch.from_numpy(v).to(DEV) for k, v in cols.items()}
    scal = dict(idle=int(rng.integers(0, 20)),
                cpus_needed=int(rng.integers(0, max(2, total // 4))),
                occ=torch.from_numpy(
                    rng.integers(0, 128, n_tiers).astype(np.int32)).to(DEV),
                cap=[int(c) for c in cap])
    return cols, scal


def plan_bytes(cols, n_tiers, cheap, tiered):
    """Bytes the plan must move: each input it reads once, each output
    written once."""
    j = cols["prio"].shape[0]
    read = 3 * 4 * j + j + 4 * j + 4 * (2 + n_tiers)  # keys, evict, cpus, scal
    if cheap:
        read += 4 * j
    if tiered:
        read += 4 * j + j + 4 * j * n_tiers             # mib, ckpt, lattice
    return read + j + 4 * j + 1                         # planned, tier, enough


def plan_bound_ms(cols, n_tiers, cheap, tiered):
    j = cols["prio"].shape[0]
    byte_s = plan_bytes(cols, n_tiers, cheap, tiered) / HBM_BYTES_PER_S
    ops_s = j * max(1, int(np.ceil(np.log2(max(j, 2))))) / SCALAR_OPS_PER_S
    return 1e3 * max(byte_s, ops_s), ("bytes" if byte_s >= ops_s
                                      else "operations")


def time_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_plan(cols, scal, **flags):
    """Kernel against the plain version on the same card inputs; returns
    the largest absolute difference over the three outputs."""
    got = sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                         **flags)
    torch.cuda.synchronize()
    want = plan_evictions_ref(*cols.values(), *scal.values(), **flags)
    err = 0
    for name, g, w in zip(("planned", "enough", "tier"), got, want):
        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if d != 0:
            raise AssertionError(f"sched_select {name} differs from its plain "
                                 f"version by {d} ({flags}, "
                                 f"J={cols['prio'].shape[0]})")
        err = max(err, d)
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    smi = nvidia_smi_line()
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(),
        capability=torch.cuda.get_device_capability(0), nvidia_smi=repr(smi))
    return smi


def phase_build():
    built = sched_ops.build()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    log("build", library=built.path.name, seconds=f"{built.seconds:.2f}")
    for ln in ptxas:
        print(f"  ptxas: {ln}")


def phase_kernel_compare():
    rng = np.random.default_rng(SEED)
    cases = 0
    err = 0
    t0 = time.perf_counter()
    for j in (1, 127, 129, 4097, 100_000, 262_144):
        for n_tiers in (1, 2, 4):
            for cheap in (False, True):
                for tiered, bounded in ((False, False), (True, False),
                                        (True, True)):
                    cols, scal = random_case(rng, j, n_tiers, bounded)
                    err = max(err, compare_plan(cols, scal, cheap=cheap,
                                                tiered=tiered,
                                                bounded=bounded))
                    cases += 1
    log("kernel-vs-plain", cases=cases, max_abs_err=err,
        seconds=f"{time.perf_counter() - t0:.1f}")
    # the bounded placement walks the planned prefix on one thread, so
    # time each size with and without it; the prefix length is printed
    for j in (100_000, 262_144):
        cols, scal = random_case(rng, j, 4, True)
        victims = int(plan_evictions_ref(*cols.values(), *scal.values(),
                                         tiered=True)[0].sum())
        for bounded in (False, True):
            flags = dict(cheap=False, tiered=True, bounded=bounded)
            sc = scal if bounded else dict(scal, cap=[-1] * 4)
            ms = time_ms(lambda c=cols, s=sc, f=flags:
                         sched_ops.plan_evictions_fused(
                             *c.values(), *s.values(), **f), iters=100)
            bound, _ = plan_bound_ms(cols, 4, False, True)
            log("kernel-time", J=j, T=4, bounded=bounded, victims=victims,
                ms=f"{ms:.4f}", bytes=plan_bytes(cols, 4, False, True),
                bound_ms=f"{bound:.5f}", share_of_bound=f"{bound / ms:.5f}")
    return err


def fleet_workload():
    """bench_sched_scale's scale generator: enough arrivals to reach
    FLEET_JOBS rows, 0.5 jobs per tick per tenant, mean work 60."""
    gen_horizon = max(200, int(1.5 * FLEET_JOBS / (FLEET_TENANTS * 0.5)))
    spec = WorkloadSpec(n_users=FLEET_TENANTS, horizon=gen_horizon,
                        cpu_total=FLEET_CPUS, seed=1, arrival_rate=0.5,
                        mean_work=60)
    users = make_users(spec)
    jobs = make_jobs(spec, users)[:FLEET_JOBS]
    assert len(jobs) == FLEET_JOBS, len(jobs)
    return users, jobs


def fleet_config(backend):
    """The T=4 HBM/DRAM/NVMe/object lattice with delta 182/256: 4/16/64
    GiB bounded tiers plus an unbounded spill tier."""
    d = measured_delta_num()
    return SchedulerConfig(
        cpu_total=FLEET_CPUS, quantum=FLEET_QUANTUM, kernel_backend=backend,
        cr_tiers=TieredCRCostModel(
            tiers=(CRCostModel(save_mib_per_tick=8192,
                               restore_mib_per_tick=16384,
                               delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=4096,
                               restore_mib_per_tick=8192, save_base=1,
                               delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=512,
                               restore_mib_per_tick=1024, save_base=1,
                               restore_base=1, delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=64,
                               restore_mib_per_tick=128, save_base=2,
                               restore_base=2, delta_num=d, delta_den=256)),
            capacity_mib=(4 << 10, 16 << 10, 64 << 10, UNBOUNDED)))


def assert_same_run(a, b, what):
    for f in omfs_torch.JobTable._fields:
        x, y = getattr(a.table, f).cpu(), getattr(b.table, f).cpu()
        if f == "jid":
            # two workload builds draw ids from one counter: same order,
            # shifted by the number of jobs built in between
            x, y = x - x[:1], y - y[:1]
        if x.dtype != torch.int32 or not torch.equal(x, y):
            raise AssertionError(f"{what}: column {f} differs")
    if not np.array_equal(a.busy_series(), b.busy_series()):
        raise AssertionError(f"{what}: busy series differ")


def phase_fleet():
    t0 = time.perf_counter()
    users, jobs = fleet_workload()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    # the main path: every kernel count starts at 0 here
    sched_ops.LAUNCHES = 0
    for policy in ("omfs", "omfs_cheap_victim"):
        runs[policy, "cuda"] = engine.simulate(
            users, jobs, fleet_config("cuda"), FLEET_HORIZON, policy,
            pass_depth=FLEET_DEPTH, device=DEV)
    launches = sched_ops.LAUNCHES
    branches = sum(runs[p, "cuda"].stats.evict_branches
                   for p in ("omfs", "omfs_cheap_victim"))
    if launches != branches or launches == 0:
        raise AssertionError(f"sched_select launches {launches} != eviction "
                             f"branches {branches} (must be > 0)")
    for policy in ("omfs", "omfs_cheap_victim"):
        runs[policy, "torch"] = engine.simulate(
            users, jobs, fleet_config("torch"), FLEET_HORIZON, policy,
            pass_depth=FLEET_DEPTH, device=DEV)
    if sched_ops.LAUNCHES != launches:
        raise AssertionError("the torch backend launched sched_select")
    peak = torch.cuda.max_memory_allocated()
    for policy in ("omfs", "omfs_cheap_victim"):
        cu, to = runs[policy, "cuda"], runs[policy, "torch"]
        assert_same_run(cu, to, f"fleet {policy}")
        s = cu.summary()
        if s["preemptions"] <= 0 or s["spills"] <= 0:
            raise AssertionError(f"fleet {policy} exercised no eviction or "
                                 f"no spill: {s}")
        log("fleet", policy=policy, J=FLEET_JOBS, cpus=FLEET_CPUS, T=4,
            horizon=FLEET_HORIZON, pass_depth=FLEET_DEPTH,
            ticks_per_s_cuda=f"{FLEET_HORIZON / cu.seconds['ticks']:.3f}",
            ticks_per_s_torch=f"{FLEET_HORIZON / to.seconds['ticks']:.3f}",
            build_s=f"{cu.seconds['build']:.2f}",
            host_syncs_per_tick=f"{cu.stats.host_syncs / FLEET_HORIZON:.2f}",
            evict_branches=cu.stats.evict_branches,
            launches=cu.stats.evict_branches,
            preemptions=s["preemptions"], spills=s["spills"],
            utilization=f"{s['utilization']:.4f}",
            goodput=f"{s['goodput']:.4f}", done=s["done"],
            identical_to_torch_backend=True)
    log("fleet-memory", max_memory_allocated=peak,
        workload_gen_s=f"{gen_s:.2f}")
    return runs["omfs", "cuda"], launches


def phase_fleet_profile():
    """Device busy share of the tick loop: the fleet's `omfs` run under
    torch.profiler, device time summed over all kernels (and over the
    sched_select kernels) against the host wall time of the ticks."""
    from torch.profiler import ProfilerActivity, profile

    users, jobs = fleet_workload()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = engine.simulate(users, jobs, fleet_config("cuda"),
                              FLEET_HORIZON, "omfs", pass_depth=FLEET_DEPTH,
                              device=DEV)
    ours = ("build_keys", "bitonic_", "gather_freed", "scan_tiles",
            "scan_sums", "plan(", "place_bounded")
    dev_us = sched_us = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        dev_us += us
        if any(k in ev.key for k in ours):
            sched_us += us
    ticks_s = res.seconds["ticks"]
    log("fleet-profile", ticks=FLEET_HORIZON, ticks_wall_s=f"{ticks_s:.4f}",
        device_busy_ms=f"{dev_us / 1e3:.3f}",
        sched_select_ms=f"{sched_us / 1e3:.3f}",
        device_busy_share=(f"{dev_us / 1e6 / ticks_s:.4f}" if dev_us
                           else "not measured"),
        evict_branches=res.stats.evict_branches,
        host_syncs=res.stats.host_syncs)


def phase_kernel_on_fleet(final):
    """Time the kernel and its plain version on the plan a main-path
    eviction would make from the fleet's final table (J=100k, T=4)."""
    cfg = fleet_config("cuda")
    tbl = final.table
    t = FLEET_HORIZON - 1
    evictable = ((tbl.state == omfs_torch.RUNNING)
                 & (tbl.jclass != omfs_torch.NONP)
                 & ((t - tbl.run_start) >= cfg.quantum))
    eff = omfs_torch.effective_save_lat(tbl)
    cols = dict(prio=tbl.priority, run_start=tbl.run_start, jid=tbl.jid,
                key_cost=eff[:, 0].contiguous(), evictable=evictable,
                cpus=tbl.cpus, state_mib=tbl.state_mib,
                is_ckpt=tbl.jclass == omfs_torch.CKPT, save_lat=eff)
    scal = dict(idle=0, cpus_needed=FLEET_CPUS // FLEET_TENANTS,
                occ=omfs_torch.tier_occupancy(tbl, 4),
                cap=list(cfg.cr_tiers.capacity_mib))
    flags = dict(cheap=False, tiered=True, bounded=True)
    err = compare_plan(cols, scal, **flags)
    victims = int(plan_evictions_ref(*cols.values(), *scal.values(),
                                     **flags)[0].sum())
    saved = sched_ops.LAUNCHES
    ms = time_ms(lambda: sched_ops.plan_evictions_fused(
        *cols.values(), *scal.values(), **flags), iters=200)
    plain_ms = time_ms(lambda: plan_evictions_ref(
        *cols.values(), *scal.values(), **flags), iters=20, warmup=2)
    sched_ops.LAUNCHES = saved
    bound, bound_by = plan_bound_ms(cols, 4, False, True)
    log("kernel-on-fleet", J=FLEET_JOBS, T=4,
        victims=victims,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.5f}",
        share_of_bound=f"{bound / ms:.4f}", max_abs_err=err)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


def phase_launcher():
    argv = ["--fast-tier-cap-mib", "4096"]
    t0 = time.perf_counter()
    res = cluster_sim.main(argv + ["--device", "cuda"])
    cuda_s = time.perf_counter() - t0
    ref = cluster_sim.main(argv + ["--device", "cpu"])
    assert_same_run(res, ref, "launcher cuda vs cpu")
    log("launcher", ticks=len(res.busy_series()),
        seconds_cuda=f"{cuda_s:.2f}", identical_to_cpu_plain=True)


def main():
    smi = phase_env()
    phase_build()
    err = phase_kernel_compare()
    final, launches = phase_fleet()
    timing = phase_kernel_on_fleet(final)
    phase_fleet_profile()
    phase_launcher()
    record = {"kernels": [{
        "name": "sched_select",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sched_select/csrc/sched_select.cu",
        "replaces": "src/repro/kernels/sched_select/kernel.py:59",
        "launches": launches,
        "max_abs_err": max(err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
