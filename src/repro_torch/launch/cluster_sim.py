"""Cluster-simulation launcher for the torch engine: an OMFS policy on a
synthetic fleet, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.cluster_sim --policy omfs \
      --chips 1024 --tenants 6 --horizon 800
"""
import argparse

from repro_torch.core import engine
from repro_torch.core.crcost import UNBOUNDED, CRCostModel, TieredCRCostModel
from repro_torch.core.types import SchedulerConfig
from repro_torch.core.workload import WorkloadSpec, make_jobs, make_users


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="omfs", choices=sorted(engine.POLICIES))
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
                    help="per-tick queue sweep bound")
    ap.add_argument("--arrival-rate", type=float, default=0.08)
    ap.add_argument("--seed", type=int, default=0)
    for flag in ("--events", "--trace-out", "--metrics-out"):
        ap.add_argument(flag, default=None, nargs="?", const=True,
                        help="not available yet: event capture is not "
                             "ported to the torch engine")
    args = ap.parse_args(argv)
    for name in ("events", "trace_out", "metrics_out"):
        if getattr(args, name) is not None:
            ap.error(f"--{name.replace('_', '-')} needs the lifecycle event "
                     "capture, which the torch engine does not have yet")

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
          f"policy={args.policy}, device={args.device}")

    res = engine.simulate(users, jobs, cfg, args.horizon, policy=args.policy,
                          pass_depth=args.pass_depth, device=args.device)
    s = res.summary()
    print(f"utilization {s['utilization']:.3f} | goodput "
          f"{s['goodput']:.3f} | wasted {s['wasted_frac']:.3f} | wait "
          f"{s['mean_wait']:.1f} | preemptions {s['preemptions']} | "
          f"checkpoints {s['checkpoints']} | killed {s['killed']} | "
          f"done {s['done']}")
    return res


if __name__ == "__main__":
    main()
