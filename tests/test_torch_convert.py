"""State carried from the JAX reference into the torch port: a JAX table
through numpy equals the port's own build, a run handed over mid-way
finishes exactly as the JAX run does, and the two launchers print the same
summary line."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401
import torch  # noqa: E402

from repro.core import crcost as jcr  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import omfs_jax  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro.launch import cluster_sim as jlaunch  # noqa: E402
from repro_torch.core import convert, omfs_torch  # noqa: E402
from repro_torch.core import crcost as tcr  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.launch import cluster_sim as tlaunch  # noqa: E402


def _workload(seed=5):
    spec = jwl.WorkloadSpec(n_users=3, horizon=100, cpu_total=32, seed=seed,
                            arrival_rate=0.15, mean_work=25,
                            class_mix=(0.15, 0.35, 0.5))
    users = jwl.make_users(spec)
    return users, jwl.make_jobs(spec, users)[:40]


def _tiers(cr):
    return cr.TieredCRCostModel(
        tiers=(cr.CRCostModel(save_mib_per_tick=256, restore_mib_per_tick=256,
                              delta_num=182, delta_den=256),
               cr.CRCostModel(save_mib_per_tick=32, restore_mib_per_tick=32,
                              save_base=1, restore_base=1)),
        capacity_mib=(64, cr.UNBOUNDED))


def _configs(backend="cuda"):
    kw = dict(cpu_total=32, quantum=3, cr_overhead=1)
    return (jtypes.SchedulerConfig(cr_tiers=_tiers(jcr), **kw),
            ttypes.SchedulerConfig(cr_tiers=_tiers(tcr), kernel_backend=backend,
                                   **kw))


def _numpy_table(tbl):
    return {f: np.asarray(getattr(tbl, f)) for f in omfs_jax.JobTable._fields}


def test_jax_table_through_numpy_equals_port_build():
    users, jobs = _workload()
    jcfg, tcfg = _configs()
    jt, _ = omfs_jax.table_from_jobs(jobs, users, 32, jcfg)
    carried = convert.table_from_numpy(_numpy_table(jt), device="cpu")
    tu, tj = convert.jobs_from_reference(users, jobs)
    own, _ = omfs_torch.table_from_jobs(tj, tu, 32, tcfg, device="cpu")
    for f in omfs_torch.JobTable._fields:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    assert [j.id for j in tj] == [j.id for j in jobs]


def test_table_from_numpy_rejects_bad_columns():
    users, jobs = _workload()
    jt, _ = omfs_jax.table_from_jobs(jobs, users, 32, _configs()[0])
    cols = _numpy_table(jt)
    with pytest.raises(TypeError, match="int32"):
        convert.table_from_numpy({**cols, "cpus": cols["cpus"] * 1.0},
                                 device="cpu")
    with pytest.raises(KeyError, match="n_spill"):
        convert.table_from_numpy({k: v for k, v in cols.items()
                                  if k != "n_spill"}, device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("policy", ["omfs", "omfs_cheap_victim"])
def test_mid_run_handoff_equals_full_jax_run(policy, backend):
    """JAX runs k ticks, the table crosses through numpy, the port's
    `tick_torch` runs the rest: the final table and busy series equal the
    JAX run over the whole horizon."""
    users, jobs = _workload()
    jcfg, tcfg = _configs(backend)
    horizon, k = 90, 37
    full = jengine.simulate(users, jobs, jcfg, horizon, policy=policy,
                            backend="jax")
    head = jengine.simulate(users, jobs, jcfg, k, policy=policy,
                            backend="jax")
    tbl = convert.table_from_numpy(_numpy_table(head.table), device="cpu")
    ent = omfs_torch.entitlements(users, 32, device="cpu")
    pass_fn = tengine.POLICIES[policy].torch_factory(None)
    busy = list(head.busy_series())
    for t in range(k, horizon):
        tbl = tengine.tick_torch(tcfg, ent, tbl, t, pass_fn)
        busy.append(int(torch.where(tbl.state == omfs_torch.RUNNING,
                                    tbl.cpus, 0).sum()))
    got = convert.table_to_numpy(tbl)
    want = _numpy_table(full.table)
    for f in omfs_jax.JobTable._fields:
        assert np.array_equal(got[f], want[f]), f
    assert busy == full.busy_series().tolist()
    assert int(want["n_preempt"].sum()) > 0


@pytest.mark.parametrize("policy", ["omfs", "omfs_cheap_victim"])
def test_launchers_print_same_summary(policy):
    args = ["--policy", policy, "--chips", "64", "--tenants", "3",
            "--horizon", "120", "--quantum", "5", "--pass-depth", "16",
            "--save-mib-per-tick", "512", "--restore-mib-per-tick", "512",
            "--fast-tier-cap-mib", "1024", "--arrival-rate", "0.1"]
    lines = []
    for main, extra in ((jlaunch.main, ["--backend", "jax"]),
                        (tlaunch.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(args + extra)
        lines.append(buf.getvalue().strip().splitlines())
    assert lines[0][-1] == lines[1][-1]
    assert lines[0][-1].startswith("utilization ")
    assert "preemptions 0 " not in lines[1][-1]


def test_launcher_refuses_event_flags_and_default_device_without_cuda():
    # the event flags that write a file need its path
    for flag in ("--trace-out", "--metrics-out"):
        with pytest.raises(SystemExit):
            tlaunch.main(["--device", "cpu", flag])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--chips", "32", "--tenants", "2", "--horizon", "5"])
