"""The port's fused victim-select/placement plan (`repro_torch.kernels.
sched_select`) against the JAX reference: its plain version equals the JAX
lexsort/scan oracle and the Pallas kernel (interpret mode) bit for bit over
all six static variants; the wrapper takes the plain version on CPU
tensors without counting a launch; the CUDA kernel equals the plain
version on a Hopper card (skipped elsewhere)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401
import torch  # noqa: E402

from repro.kernels.sched_select.ops import (  # noqa: E402
    plan_evictions_fused as jax_fused,
)
from repro.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_ref as jax_ref,
)
from repro_torch.kernels.sched_select import ops  # noqa: E402
from repro_torch.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_ref,
)

VARIANTS = [(cheap, tiered, bounded) for cheap in (False, True)
            for tiered, bounded in ((False, False), (True, False),
                                    (True, True))]


def _case(seed, j, n_tiers, bounded):
    """numpy-seeded columns; lattice values 0..3 and some all-equal rows
    force argmin ties."""
    rng = np.random.default_rng(seed)
    save_lat = rng.integers(0, 4, (j, n_tiers)).astype(np.int32)
    save_lat[rng.random(j) < 0.2] = 2
    evictable = rng.random(j) < 0.5
    cpus = rng.integers(1, 8, j).astype(np.int32)
    cap = rng.integers(0, 256, n_tiers).astype(np.int32)
    cap[rng.random(n_tiers) < 0.3] = -1
    cap[-1] = -1
    if not bounded:
        cap[:] = -1
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
    total = int(cpus[evictable].sum())
    scal = dict(idle=int(rng.integers(0, 20)),
                cpus_needed=int(rng.integers(0, total + 20)),
                occ=rng.integers(0, 128, n_tiers).astype(np.int32),
                cap=cap)
    return cols, scal


def _torch_args(cols, scal, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in cols.items()}
    s = dict(idle=scal["idle"], cpus_needed=scal["cpus_needed"],
             occ=torch.from_numpy(scal["occ"]).to(device),
             cap=[int(c) for c in scal["cap"]])
    return list(t.values()) + list(s.values())


def _assert_same(got, want, what):
    for name, g, w in zip(("planned", "enough", "tier"), got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert np.array_equal(np.asarray(g), np.asarray(w)), f"{name} {what}"
    assert got[0].dtype == torch.bool and got[2].dtype == torch.int32


@pytest.mark.parametrize("n_tiers", [1, 2, 3, 4])
@pytest.mark.parametrize("j", [1, 127, 128, 129, 300])
def test_plain_version_matches_jax_reference(j, n_tiers):
    for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
        cols, scal = _case(1000 * j + 10 * n_tiers + k, j, n_tiers, bounded)
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        want = jax_ref(*cols.values(), *scal.values(), **flags)
        got = plan_evictions_ref(*_torch_args(cols, scal), **flags)
        _assert_same(got, want, f"{flags} J={j} T={n_tiers}")


@pytest.mark.parametrize("j,n_tiers", [(1, 1), (129, 3), (300, 4)])
def test_plain_version_matches_pallas_interpret(j, n_tiers):
    for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
        cols, scal = _case(7 + j + k, j, n_tiers, bounded)
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        want = jax_fused(*cols.values(), *scal.values(), interpret=True,
                         **flags)
        got = plan_evictions_ref(*_torch_args(cols, scal), **flags)
        _assert_same(got, want, f"{flags} J={j} T={n_tiers}")


@pytest.mark.parametrize("j", [1, 129, 300])
def test_wrapper_on_cpu_tensors_runs_plain_version_without_launch(j):
    launches = ops.LAUNCHES
    for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
        cols, scal = _case(31 * j + k, j, 4, bounded)
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        got = ops.plan_evictions_fused(*_torch_args(cols, scal), **flags)
        want = plan_evictions_ref(*_torch_args(cols, scal), **flags)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ops.LAUNCHES == launches


def test_placement_prefers_faster_tier_on_ties_and_spills_when_full():
    """Hand-checked bounded greedy: equal costs go to tier 0 until its
    capacity is used, then the cheapest feasible later tier."""
    j = 4
    cols = dict(prio=np.zeros(j, np.int32), run_start=np.zeros(j, np.int32),
                jid=np.arange(j, dtype=np.int32),
                key_cost=np.zeros(j, np.int32),
                evictable=np.ones(j, bool), cpus=np.ones(j, np.int32),
                state_mib=np.full(j, 10, np.int32), is_ckpt=np.ones(j, bool),
                save_lat=np.tile(np.array([[5, 5, 1]], np.int32), (j, 1)))
    cols["save_lat"][:2] = 5           # rows 0, 1: a three-way tie
    scal = dict(idle=0, cpus_needed=4, occ=np.zeros(3, np.int32),
                cap=np.array([10, 100, -1], np.int32))
    planned, enough, tier = plan_evictions_ref(
        *_torch_args(cols, scal), tiered=True, bounded=True)
    assert planned.all() and bool(enough)
    assert tier.tolist() == [0, 1, 2, 2]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    for j in (1, 127, 129, 4097, 100_000):
        for n_tiers in (1, 2, 4):
            for k, (cheap, tiered, bounded) in enumerate(VARIANTS):
                cols, scal = _case(j + n_tiers + k, j, n_tiers, bounded)
                flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
                args = _torch_args(cols, scal, "cuda")
                got = ops.plan_evictions_fused(*args, **flags)
                want = plan_evictions_ref(*args, **flags)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (flags, j, n_tiers)
