"""Cluster-simulation launcher: any registered policy on a synthetic fleet,
on either engine backend (the port of ``src/repro/launch/cluster_sim.py``).

  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --policy omfs \
      --chips 1024 --tenants 6 --horizon 800 [--backend torch|python] \
      [--device cpu]

``--backend torch`` (the default; the reference's ``jax``) runs the tensor
pass on ``--device``, the card unless ``cpu`` is asked for, and ``python``
the host reference (``engine.tick_python``).  The summary line is the
reference's for each backend: the engine's summary for ``torch``,
`core.metrics.compute_metrics` (with Jain's fairness) for ``python``.
"""
import argparse

from repro_torch.core import engine
from repro_torch.core.crcost import UNBOUNDED, CRCostModel, TieredCRCostModel
from repro_torch.core.metrics import compute_metrics
from repro_torch.core.types import SchedulerConfig
from repro_torch.core.workload import WorkloadSpec, make_jobs, make_users


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="omfs", choices=sorted(engine.POLICIES))
    ap.add_argument("--backend", default="torch", choices=["torch", "python"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the job table (cuda or cpu)")
    ap.add_argument("--chips", type=int, default=1024)
    ap.add_argument("--tenants", type=int, default=6)
    ap.add_argument("--horizon", type=int, default=800)
    ap.add_argument("--quantum", type=int, default=20)
    ap.add_argument("--cr-overhead", type=int, default=2)
    ap.add_argument("--save-mib-per-tick", type=int, default=0,
                    help="size-aware C/R: tier write bandwidth (0 = free)")
    ap.add_argument("--restore-mib-per-tick", type=int, default=0,
                    help="size-aware C/R: tier read bandwidth (0 = free)")
    ap.add_argument("--fast-tier-cap-mib", type=int, default=None,
                    help="enable tiered eviction placement: fast-tier "
                         "capacity in MiB (-1 = unbounded); the "
                         "--*-mib-per-tick bandwidths price the fast tier")
    ap.add_argument("--spill-save-mib-per-tick", type=int, default=2048,
                    help="durable spill tier write bandwidth")
    ap.add_argument("--spill-restore-mib-per-tick", type=int, default=4096,
                    help="durable spill tier read bandwidth")
    ap.add_argument("--pass-depth", type=int, default=64,
                    help="per-tick queue sweep bound on the torch backend")
    ap.add_argument("--arrival-rate", type=float, default=0.08)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", action="store_true",
                    help="record the typed lifecycle event log "
                         "(repro_torch.obs) and print its reconciliation "
                         "summary")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="write a Perfetto/Chrome trace of the schedule "
                         "(implies --events)")
    ap.add_argument("--metrics-out", metavar="PATH", default=None,
                    help="write the metrics-registry JSON snapshot "
                         "(implies --events)")
    args = ap.parse_args(argv)
    record = bool(args.events or args.trace_out or args.metrics_out)

    spec = WorkloadSpec(n_users=args.tenants, horizon=args.horizon,
                        cpu_total=args.chips, seed=args.seed,
                        arrival_rate=args.arrival_rate)
    users = make_users(spec)
    jobs = make_jobs(spec, users)
    fast = CRCostModel(save_mib_per_tick=args.save_mib_per_tick,
                       restore_mib_per_tick=args.restore_mib_per_tick)
    tiers = None
    if args.fast_tier_cap_mib is not None:
        tiers = TieredCRCostModel(
            tiers=(fast, CRCostModel(
                save_mib_per_tick=args.spill_save_mib_per_tick,
                restore_mib_per_tick=args.spill_restore_mib_per_tick)),
            capacity_mib=(args.fast_tier_cap_mib, UNBOUNDED))
    cfg = SchedulerConfig(
        cpu_total=args.chips, quantum=args.quantum,
        cr_overhead=args.cr_overhead, cr_cost=fast, cr_tiers=tiers)
    print(f"{len(jobs)} jobs, {args.tenants} tenants, {args.chips} chips, "
          f"policy={args.policy}, backend={args.backend}, "
          f"device={args.device}")

    torch_backend = args.backend == "torch"
    res = engine.simulate(
        users, jobs, cfg, args.horizon, policy=args.policy,
        backend=args.backend,
        pass_depth=args.pass_depth if torch_backend else None,
        device=args.device, record_events=record)

    if record:
        import json

        from repro_torch.core.metrics import event_summary
        from repro_torch.obs import registry_from_result, trace_from_result
        ev = event_summary(res.events)
        print(f"events: {len(res.events)} recorded, "
              f"{res.events_dropped_total()} dropped | starts "
              f"{ev['jobs_started']} | restores {ev['restores']} | evicts "
              f"{ev['preemptions']} | saves {ev['checkpoints']} | spills "
              f"{ev['spilled_checkpoints']} | done {ev['jobs_done']}")
        if args.metrics_out:
            reg = registry_from_result(res, users=users)
            with open(args.metrics_out, "w") as fh:
                json.dump(reg.to_json(), fh, indent=2)
            print(f"metrics snapshot -> {args.metrics_out}")
        if args.trace_out:
            trace = trace_from_result(res, users=users)
            with open(args.trace_out, "w") as fh:
                json.dump(trace, fh)
            print(f"perfetto trace -> {args.trace_out} "
                  f"(open in ui.perfetto.dev or chrome://tracing)")
    if torch_backend:
        s = res.summary()
        print(f"utilization {s['utilization']:.3f} | goodput "
              f"{s['goodput']:.3f} | wasted {s['wasted_frac']:.3f} | wait "
              f"{s['mean_wait']:.1f} | preemptions {s['preemptions']} | "
              f"checkpoints {s['checkpoints']} | killed {s['killed']} | "
              f"done {s['done']}")
        return res
    m = compute_metrics(res.sim)
    print(f"utilization {m.utilization:.3f} | goodput {m.goodput:.3f} | "
          f"wasted {m.wasted_work_frac:.3f} | jain {m.jain_fairness:.3f} | "
          f"wait {m.mean_wait:.1f} | preemptions {m.preemptions} | "
          f"checkpoints {m.checkpoints} | killed {m.killed_jobs}")
    return res


if __name__ == "__main__":
    main()
