"""The port's cluster executor (`repro_torch.cluster.executor`): OMFS
preempting real training jobs on the CPU, transparently.  The three cases
of ``tests/test_e2e_train.py`` on the port, its events and EventBus log
equal to the JAX executor's on the same scenario, a released job holding
no tensors, measured C/R charging and calibration, and the train launcher
resuming bit-exactly."""
import gc

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import ManagerConfig as JConfig  # noqa: E402
from repro.cluster.executor import ClusterExecutor as JExecutor  # noqa: E402
from repro.cluster.executor import ManagedJob as JManagedJob  # noqa: E402
from repro.cluster.executor import small_train_job as jsmall  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, ManagerConfig  # noqa: E402
from repro_torch.checkpoint.service import CheckpointService  # noqa: E402
from repro_torch.cluster import executor as executor_mod  # noqa: E402
from repro_torch.cluster.executor import (  # noqa: E402
    ClusterExecutor,
    ManagedJob,
    small_train_job,
)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.crcost import CRCostModel, TieredCRCostModel  # noqa: E402
from repro_torch.core.types import JobState, SchedulerConfig  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.train.state import train_state_shapes  # noqa: E402

ARCH = "internlm2-1.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the smoke model's
    ops are small, and under a loaded parallel test run a pool of threads
    spends far more time waiting for each other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(tmp, seed):
    return small_train_job(tmp, arch_cfg=get_smoke_config(ARCH), seq=32,
                           batch=4, seed=seed, device="cpu")


def _scenario(types, mk_job, mk_mgr, executor, tmp, **kw):
    """test_e2e_train's preemption scenario: B (12 CPUs, 30 units) runs
    alone until A (8 CPUs) arrives at t=5 and OMFS evicts B."""
    users = [types.User("A", 50.0), types.User("B", 50.0)]
    ex = executor(users, types.SchedulerConfig(cpu_total=16, quantum=3),
                  steps_per_tick=2, **kw)
    jb = types.Job(user="B", cpus=12, work=30, submit_time=0, id=0,
                   job_class=types.JobClass.CHECKPOINTABLE)
    ja = types.Job(user="A", cpus=8, work=6, submit_time=5, id=1,
                   job_class=types.JobClass.CHECKPOINTABLE)
    managed = [(jb, mk_job(tmp, 1), mk_mgr(tmp / "b")),
               (ja, mk_job(tmp, 2), mk_mgr(tmp / "a"))]
    return ex, managed


def _held_tensors(obj, seen=None):
    """Tensors with storage (not meta) reachable from ``obj`` through
    attributes, containers and module parameters."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float,
                                           np.ndarray)):
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [] if obj.device.type == "meta" else [obj]
    if isinstance(obj, torch.nn.Module):
        return [t for t in list(obj.parameters()) + list(obj.buffers())
                if t.device.type != "meta"]
    if isinstance(obj, dict):
        kids = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        kids = list(obj)
    elif hasattr(obj, "__dict__"):
        kids = list(vars(obj).values())
    else:
        return []
    return [t for k in kids for t in _held_tensors(k, seen)]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    ex, managed = _scenario(
        ttypes, _mk,
        lambda root: CheckpointManager(ManagerConfig(root=root,
                                                     durable_every=100)),
        ClusterExecutor, tmp)
    mjs = [ManagedJob(d, job, mgr) for d, job, mgr in managed]
    for mj in mjs:
        ex.submit(mj)
    ex.run(6)                # B was evicted at t=5
    evicted = (mjs[0].descriptor.state, mjs[0].train_job.state,
               len(_held_tensors(mjs[0].train_job)))
    ex.run(74)
    return ex, mjs, evicted, tmp


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    ex, managed = _scenario(
        jtypes, lambda t, seed: jsmall(t, arch_cfg=jsmoke(ARCH), seq=32,
                                       batch=4, seed=seed),
        lambda root: JManager(JConfig(root=root, durable_every=100)),
        JExecutor, tmp)
    for d, job, mgr in managed:
        ex.submit(JManagedJob(d, job, mgr))
    ex.run(80)
    return ex


def test_preempted_run_is_bitwise_transparent(port_run):
    ex, (mb, ma), _, tmp = port_run
    assert mb.descriptor.state == JobState.DONE
    assert ma.descriptor.state == JobState.DONE
    assert mb.checkpoints >= 1 and mb.restores >= 1, ex.events
    # uninterrupted twin of job B
    ref = _mk(tmp, 1)
    ref.cold_start()
    ref_losses = [ref.run_step() for _ in range(len(mb.train_job.losses))]
    assert len(ref_losses) == 60
    assert (np.asarray(ref_losses) == np.asarray(mb.train_job.losses)).all(), \
        "preempted run diverged from the uninterrupted run"


def test_events_and_bus_log_equal_the_jax_executors(port_run, jax_run):
    ex = port_run[0]
    assert ex.events == jax_run.events
    assert "t=11 job0 RESTORED step_00000010" in ex.events
    ours = [tuple(e) for e in ex.bus.events]
    theirs = [tuple(e) for e in jax_run.bus.events]
    assert ours == theirs and ours
    assert [(j.id, j.state_bytes, j.finish_time, j.n_preemptions)
            for j in ex.state.jobs.values()] == [
        (j.id, j.state_bytes, j.finish_time, j.n_preemptions)
        for j in jax_run.state.jobs.values()]


def test_released_job_holds_no_tensors(port_run):
    _, mjs, (state_at_evict, train_state, held_at_evict), _ = port_run
    assert state_at_evict == JobState.PENDING
    assert train_state is None and held_at_evict == 0
    for mj in mjs:                      # both DONE, so both released
        assert mj.train_job.state is None
        assert all(p.device.type == "meta"
                   for p in mj.train_job.model.parameters())
        assert _held_tensors(mj.train_job) == []
    # a running job does hold its state
    job = _mk(port_run[3], 3)
    job.cold_start()
    assert len(_held_tensors(job)) > 0
    job.release()
    gc.collect()
    assert _held_tensors(job) == []


def test_release_frees_the_state_without_the_cycle_collector(tmp_path):
    """No tensor of a step or of the state is left in a reference cycle, so
    a released job's memory is free at once, not when Python's cyclic
    collector next runs (on the card, gigabytes)."""
    job = _mk(tmp_path, 4)
    job.cold_start()
    job.run_step()
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        job.run_step()
        job.release()
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if was:
            gc.enable()
    assert cyclic == []


def test_loss_decreases_on_synthetic_data(tmp_path):
    job = _mk(tmp_path, 0)
    job.cold_start()
    losses = [job.run_step() for _ in range(30)]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)


def test_node_failure_recovery_from_durable_tier(tmp_path):
    """Kill the job (and its fast tier) mid-run; restart resumes from the
    durable tier at the last durable step."""
    mgr = CheckpointManager(ManagerConfig(root=tmp_path / "ck",
                                          durable_every=1, async_durable=False))
    job = _mk(tmp_path, 5)
    job.cold_start()
    for _ in range(4):
        job.run_step()
    mgr.save(int(job.state.step), job.snapshot_state())
    losses_before_crash = [job.run_step() for _ in range(3)]

    # simulated node failure: new process = new manager over the same root
    mgr2 = CheckpointManager(ManagerConfig(root=tmp_path / "ck",
                                           durable_every=1, async_durable=False))
    job2 = _mk(tmp_path, 5)
    template = train_state_shapes(job2.model, job2.seed)
    state, name = mgr2.restore(template, device="cpu")
    assert name == "step_00000004"
    job2.restore_state(state)
    losses_after_restart = [job2.run_step() for _ in range(3)]
    assert (np.asarray(losses_before_crash) == np.asarray(losses_after_restart)).all()
    mgr.close(); mgr2.close()


def test_snapshot_is_not_changed_by_later_steps(tmp_path):
    """The fast tier copies the state to the host before save returns, so
    the in-place steps after it leave the snapshot as it was (also with an
    async durable write in flight)."""
    mgr = CheckpointManager(ManagerConfig(root=tmp_path / "ck",
                                          durable_every=1, async_durable=True))
    job = _mk(tmp_path, 6)
    job.cold_start()
    job.run_step()
    name = mgr.save(1, job.snapshot_state())
    before = {k: v.copy() for k, v in mgr.restore_leaves(name).items()}
    for _ in range(2):
        job.run_step()
    mgr.drain()
    after = mgr.restore_leaves(name)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    assert not np.array_equal(before[".params['embed']"],
                              job.state.params["embed"].detach().numpy())
    mgr.close()


class _StepClock:
    """A ``time`` stand-in whose ``perf_counter`` advances a fixed step
    per call, so that every measured save and restore costs the same
    ticks whatever the machine's load."""

    def __init__(self, step: float):
        self.step, self.now = step, 0.0

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


def test_measured_cr_is_charged_and_calibrates(tmp_path, monkeypatch):
    monkeypatch.setattr(executor_mod, "time", _StepClock(2.5e-4))
    ex, managed = _scenario(
        ttypes, _mk,
        lambda root: CheckpointService(ManagerConfig(root=root,
                                                     durable_every=100),
                                       device="cpu"),
        ClusterExecutor, tmp_path, tick_seconds=1e-4)
    mjs = [ManagedJob(d, job, svc) for d, job, svc in managed]
    for mj in mjs:
        ex.submit(mj)
    ex.run(60 + 200)
    mb = mjs[0]
    assert all(mj.descriptor.state == JobState.DONE for mj in mjs)
    assert mb.checkpoints >= 1 and mb.restores >= 1
    assert mb.measured_cr_ticks > 0
    assert mb.descriptor.overhead == mb.measured_cr_ticks
    assert mb.descriptor.state_bytes == mb.ckpt.manager.last_save_bytes > 0
    stats = ex.cr_stats()
    assert stats.saves == mb.checkpoints and stats.restores == mb.restores
    flat = ex.calibrate()
    assert isinstance(flat, CRCostModel)
    tiered = ex.calibrate(tiers=("mem", "disk"))
    assert isinstance(tiered, TieredCRCostModel) and tiered.n_tiers == 2
    with pytest.warns(DeprecationWarning):
        shim = ex.calibrate_tiered()
    assert shim == tiered
    with pytest.raises(ValueError, match="tick_seconds"):
        ClusterExecutor([], SchedulerConfig()).calibrate()
    for mj in mjs:
        mj.ckpt.close()


def test_launcher_trains_on_cpu_and_resumes_bit_exactly(tmp_path, capsys):
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq", "32",
            "--batch", "4", "--ckpt-every", "2", "--lr", "1e-3"]
    straight = train_launcher.main(
        base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    first = train_launcher.main(
        base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    second = train_launcher.main(
        base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step_00000003 (step 3)" in out
    assert second.resumed_from == "step_00000003" and second.start_step == 3
    assert first.losses + second.losses == straight.losses
    assert int(second.state.step) == 6 and int(second.state.data_cursor) == 6
    np.testing.assert_array_equal(second.state.rng.numpy(),
                                  straight.state.rng.numpy())
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    # MLA trains too (tests/test_torch_mla_vlm_audio.py holds it to JAX)
    mla = train_launcher.main(["--arch", "minicpm3-4b", "--smoke",
                               "--device", "cpu", "--steps", "1",
                               "--seq", "8", "--batch", "2",
                               "--ckpt-dir", str(tmp_path / "c")])
    assert len(mla.losses) == 1 and np.isfinite(mla.losses[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "1",
                                 "--ckpt-dir", str(tmp_path / "d")])
