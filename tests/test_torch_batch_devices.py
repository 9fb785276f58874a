"""`engine.simulate_batch(devices=n)` of the port: the batch cut into n
contiguous groups, padded with replicas of the last cell, each group run
on its own device (here n groups one after another on the CPU), equals
``devices=1`` bit for bit for every registered policy, with and without
event capture."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.core import workload as jwl  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402

HORIZON = 60


def _cells():
    out = []
    for seed in (0, 1):
        spec = jwl.WorkloadSpec(n_users=3, horizon=HORIZON, cpu_total=32,
                                seed=seed, arrival_rate=0.15, mean_work=20,
                                class_mix=(0.15, 0.35, 0.5))
        users = jwl.make_users(spec)
        tu, tj = convert.jobs_from_reference(
            users, jwl.make_jobs(spec, users)[:24 + 4 * seed])
        for name in sorted(tengine.POLICIES):
            out.append(tengine.BatchCell(users=tu, jobs=tj, policy=name,
                                         pass_depth=None if seed else 6))
    return out


def _same(a, b, what):
    for f, x, y in zip(a.table._fields, a.table, b.table):
        assert torch.equal(x, y), f"{what}: {f}"
    assert np.array_equal(a.busy, b.busy), what
    assert a.policy == b.policy and a.signature() == b.signature(), what
    if a.events is not None:
        assert a.events == b.events, what
        assert np.array_equal(a.event_counts, b.event_counts), what


@pytest.mark.parametrize("record_events", [False, True])
def test_devices_split_equals_one_device(record_events):
    cells = _cells()
    cfg = ttypes.SchedulerConfig(cpu_total=32, quantum=3, cr_overhead=1)
    kw = dict(record_events=record_events, device="cpu")
    one = tengine.simulate_batch(cells, cfg, HORIZON, devices=1, **kw)
    assert sorted({r.policy for r in one}) == sorted(tengine.POLICIES)
    for n in (2, 3):
        got = tengine.simulate_batch(cells, cfg, HORIZON, devices=n, **kw)
        assert len(got) == len(cells)
        for i, (a, b) in enumerate(zip(got, one)):
            _same(a, b, f"devices={n} cell {i} ({b.policy})")
    # the CPU is one device: devices=None is devices=1
    none = tengine.simulate_batch(cells[:3], cfg, HORIZON, **kw)
    for a, b in zip(none, one[:3]):
        _same(a, b, "devices=None")


def test_padding_replicas_are_dropped():
    cells = _cells()[:5]
    cfg = ttypes.SchedulerConfig(cpu_total=32)
    got = tengine.simulate_batch(cells, cfg, HORIZON, devices=3,
                                 device="cpu")
    one = tengine.simulate_batch(cells, cfg, HORIZON, device="cpu")
    assert len(got) == 5
    for a, b in zip(got, one):
        _same(a, b, b.policy)


def test_groups_run_on_the_cards_from_the_given_one(monkeypatch):
    """Which card each group is built on, with four cards stood in for
    (the tables themselves are built on the CPU): ``devices=None`` and 1
    keep the given card, ``devices=n`` takes n cards from it on, and cards
    past the last are refused."""
    from repro_torch.core import omfs_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    real, seen = omfs_torch.table_from_jobs, []

    def record(jobs, users, cpu_total, config, device):
        seen.append(str(device))
        return real(jobs, users, cpu_total, config, "cpu")

    monkeypatch.setattr(omfs_torch, "table_from_jobs", record)
    cells = _cells()[:4]           # one workload: one table per group
    cfg = ttypes.SchedulerConfig(cpu_total=32)
    one = tengine.simulate_batch(cells, cfg, HORIZON, device="cpu")
    for devices, device, want in ((None, "cuda:1", ["cuda:1"]),
                                  (1, "cuda:2", ["cuda:2"]),
                                  (None, "cuda", ["cuda"]),
                                  (2, "cuda:1", ["cuda:1", "cuda:2"]),
                                  (3, "cuda", ["cuda:0", "cuda:1",
                                               "cuda:2"])):
        seen.clear()
        got = tengine.simulate_batch(cells, cfg, HORIZON, devices=devices,
                                     device=device)
        assert seen == want, (devices, device)
        for a, b in zip(got, one):
            _same(a, b, f"devices={devices} from {device}")
    with pytest.raises(ValueError, match="devices=2 from cuda:3"):
        tengine.simulate_batch(cells, cfg, HORIZON, devices=2,
                               device="cuda:3")
