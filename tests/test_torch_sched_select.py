"""The port's fused victim-select/placement plan (`repro_torch.kernels.
sched_select`) against the JAX reference: its plain version equals the JAX
lexsort/scan oracle and the Pallas kernel (interpret mode) bit for bit over
all six static variants, with the non-candidate rows' values randomised
(the kernel sorts the evictable rows alone), on tied and extreme keys and
at the edges (no candidate, every row a candidate, nothing needed, a cap
of 0, one tier and eight); a numpy model of the kernel's warp-round
placement walk equals the sequential greedy on adversarial placements;
the wrapper takes the plain version on CPU tensors without counting a
launch and refuses other devices; the CUDA kernel equals the plain version
on a Hopper card on each of its paths (skipped elsewhere)."""
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
    MASK,
    greedy_place,
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


def _jax_both(cols, scal, flags, pallas):
    """The JAX oracle's plan and, when ``pallas``, the Pallas kernel's."""
    out = [jax_ref(*cols.values(), *scal.values(), **flags)]
    if pallas:
        out.append(jax_fused(*cols.values(), *scal.values(), interpret=True,
                             **flags))
    return out


def _check_all(cols, scal, what, pallas=True):
    """Plain version against the JAX oracle (and the Pallas kernel) over the
    six variants; returns the plain version's outputs by variant."""
    got_all = {}
    for cheap, tiered, bounded in VARIANTS:
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        sc = dict(scal, cap=scal["cap"] if bounded
                  else np.full_like(scal["cap"], -1))
        got = plan_evictions_ref(*_torch_args(cols, sc), **flags)
        for want in _jax_both(cols, sc, flags, pallas):
            _assert_same(got, want, f"{flags} {what}")
        got_all[cheap, tiered, bounded] = got
    return got_all


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_non_candidate_rows_change_nothing(seed):
    """The kernel sorts and scans the evictable rows alone: random keys,
    CPUs, sizes, checkpoint flags and lattice rows on the other rows leave
    every output unchanged, in both packages."""
    j, n_tiers = 257, 3
    cols, scal = _case(500 + seed, j, n_tiers, bounded=True)
    base = _check_all(cols, scal, "base", pallas=seed == 0)
    jax_base = {v: jax_ref(*cols.values(), *dict(
        scal, cap=scal["cap"] if v[2] else np.full_like(scal["cap"], -1)
    ).values(), cheap=v[0], tiered=v[1], bounded=v[2]) for v in VARIANTS}
    rng = np.random.default_rng(900 + seed)
    off = ~cols["evictable"]
    noisy = {k: v.copy() for k, v in cols.items()}
    for name in ("prio", "run_start", "jid", "key_cost", "cpus", "state_mib"):
        noisy[name][off] = rng.integers(-5, 1000, int(off.sum()))
    noisy["is_ckpt"][off] = rng.random(int(off.sum())) < 0.5
    noisy["save_lat"][off] = rng.integers(0, 9, (int(off.sum()), n_tiers))
    got = _check_all(noisy, scal, "noisy", pallas=seed == 0)
    for v in VARIANTS:
        for a, b in zip(got[v], base[v]):
            assert torch.equal(a, b), v
        sc = dict(scal, cap=scal["cap"] if v[2]
                  else np.full_like(scal["cap"], -1))
        jax_noisy = jax_ref(*noisy.values(), *sc.values(), cheap=v[0],
                            tiered=v[1], bounded=v[2])
        for a, b in zip(jax_noisy, jax_base[v]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), v


def _tied_extreme_case(seed, j, n_tiers):
    """Key tuples drawn from two values each (so whole tuples repeat and
    the row decides), with INT32_MAX and -1 among them, and a lattice that
    holds INT32_MAX (a feasible tier at MASK never wins)."""
    cols, scal = _case(seed, j, n_tiers, bounded=True)
    rng = np.random.default_rng(seed + 1)
    for name in ("prio", "run_start", "jid", "key_cost"):
        cols[name] = rng.choice(np.array([-1, MASK], np.int32), j)
    cols["save_lat"] = rng.choice(np.array([0, 3, MASK], np.int32),
                                  (j, n_tiers))
    cols["key_cost"] = np.ascontiguousarray(cols["save_lat"][:, 0])
    return cols, scal


@pytest.mark.parametrize("j,n_tiers", [(64, 2), (300, 4)])
def test_tied_and_extreme_keys(j, n_tiers):
    cols, scal = _tied_extreme_case(41 + j, j, n_tiers)
    _check_all(cols, scal, f"ties J={j} T={n_tiers}")


def _edge_case(name):
    j = 200
    n_tiers = {"one_tier": 1, "eight_tiers": 8}.get(name, 4)
    cols, scal = _case(77 + len(name), j, n_tiers, bounded=True)
    total = int(cols["cpus"][cols["evictable"]].sum())
    if name == "no_candidate":
        cols["evictable"][:] = False
    elif name == "all_candidates":
        cols["evictable"][:] = True
        scal["cpus_needed"] = int(cols["cpus"].sum()) // 2
    elif name == "nothing_needed":
        scal["cpus_needed"] = scal["idle"] - 3
    elif name == "cap_zero":
        scal["cap"] = np.array([0, 0, 0, -1], np.int32)
        scal["occ"] = np.zeros(n_tiers, np.int32)
        cols["state_mib"][::3] = 0       # these still fit a full tier
        scal["cpus_needed"] = total
    else:
        scal["cap"][-1] = -1
        scal["cpus_needed"] = total // 2
    return cols, scal


@pytest.mark.parametrize("name", ["no_candidate", "all_candidates",
                                  "nothing_needed", "cap_zero", "one_tier",
                                  "eight_tiers"])
def test_edge_cases(name):
    cols, scal = _edge_case(name)
    got = _check_all(cols, scal, name)
    planned = got[False, True, True][0]
    if name == "no_candidate":
        assert not planned.any()
    if name in ("all_candidates", "cap_zero", "eight_tiers"):
        assert planned.sum() > 1
    if name == "nothing_needed":
        assert not planned.any() and bool(got[False, False, False][1])


def warp_round_place(mib, lat, occ, cap, width=128):
    """numpy model of the kernel's placement walk (csrc/sched_select.cu,
    step 4; four warps, a victim a lane: 128 a round): each round, the
    next ``width`` victims each take the cheapest tier feasible at the
    round's starting occupancy; a choice stands iff its tier is still
    feasible at the occupancy the earlier victims' choices leave (or
    nothing was feasible: tier 0); the victims before the first that fails
    commit, a negative size ends the round after its victim.  Returns the
    tiers and the number of rounds."""
    n, n_tiers = lat.shape
    occ = [int(v) for v in occ]
    tier = np.zeros(n, np.int32)
    p = rounds = 0
    while p < n:
        choice = []
        for i in range(p, min(p + width, n)):
            m, best_c, best_t = int(mib[i]), MASK, 0
            for k in range(n_tiers):
                feasible = cap[k] < 0 or occ[k] + m <= cap[k]
                c = int(lat[i, k]) if feasible else MASK
                if c < best_c:
                    best_c, best_t = c, k
            choice.append((best_c, best_t, m))
        run = [0] * n_tiers
        f = len(choice)
        for lane, (c, t, m) in enumerate(choice):
            if not (c == MASK or cap[t] < 0 or occ[t] + run[t] + m <= cap[t]):
                f = lane
                break
            run[t] += m
            if m < 0:
                f = lane + 1
                break
        assert f >= 1
        for lane, (_, t, m) in enumerate(choice[:f]):
            tier[p + lane] = t
            occ[t] += m
        p += f
        rounds += 1
    return tier, rounds


def _placement_case(name, rng):
    n, n_tiers = 300, 3
    lat = np.tile(np.array([[1, 2, 3]], np.int32), (n, 1))
    occ = np.zeros(n_tiers, np.int32)
    cap = np.array([100, 50, -1])
    if name == "at_the_edge":       # sizes that fill tier 0 exactly, then 1
        mib = np.full(n, 10, np.int32)
        mib[rng.random(n) < 0.2] = 11
        occ[:] = (1, 9, 0)
    elif name == "alternating":
        mib = np.tile(np.array([60, 1], np.int32), n // 2)
        cap = np.array([1000, 500, -1])
    elif name == "zero_sizes":      # full tiers still take size 0
        mib = np.where(rng.random(n) < 0.5, 0, 7).astype(np.int32)
        occ[:] = (95, 50, 0)
    elif name == "unbounded":
        mib = rng.integers(0, 64, n).astype(np.int32)
        lat = rng.integers(0, 4, (n, n_tiers)).astype(np.int32)
        cap = np.array([-1, -1, -1])
    elif name == "over_capacity":   # occupancy past a cap; MASK costs
        mib = rng.integers(0, 30, n).astype(np.int32)
        lat = rng.choice(np.array([0, 2, MASK], np.int32), (n, n_tiers))
        occ[:] = (120, 10, 0)
        cap = np.array([100, 400, 600])
    elif name == "negative_sizes":
        mib = rng.integers(-20, 40, n).astype(np.int32)
        cap = np.array([150, 300, -1])
    else:                           # random ties near small caps
        mib = rng.integers(0, 64, n).astype(np.int32)
        lat = rng.integers(0, 3, (n, n_tiers)).astype(np.int32)
        cap = np.array([256, 512, -1])
    return mib, lat, occ, cap


@pytest.mark.parametrize("width", [128, 32, 4])
@pytest.mark.parametrize("name", ["at_the_edge", "alternating", "zero_sizes",
                                  "unbounded", "over_capacity",
                                  "negative_sizes", "random_ties"])
def test_warp_round_walk_equals_sequential_greedy(name, width):
    mib, lat, occ, cap = _placement_case(name, np.random.default_rng(3))
    n = mib.shape[0]
    want = greedy_place(torch.ones(n, dtype=torch.bool),
                        torch.from_numpy(mib), torch.from_numpy(lat),
                        torch.from_numpy(occ), [int(c) for c in cap])
    got, rounds = warp_round_place(mib, lat, occ, cap, width)
    assert np.array_equal(got, want.numpy()), name
    assert rounds <= n
    if name == "unbounded":
        assert rounds == -(-n // width)   # nothing ever fails


def test_wrapper_refuses_other_devices():
    cols, scal = _case(5, 16, 2, bounded=True)
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _torch_args(cols, scal)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.plan_evictions_fused(*args, tiered=True, bounded=True)


def test_phase_probe_still_stamps_the_kernel(tmp_path, monkeypatch):
    """tools/probe_sched_phases.py writes its stamped copy from the
    kernel's source (it raises if a line it stamps after has changed):
    every phase slot, the round and record counters, the readers, and
    the header it includes."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "probe_sched_phases.py"
    spec = importlib.util.spec_from_file_location("probe_sched_phases", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    monkeypatch.setattr(probe, "OUT_DIR", tmp_path)
    text = probe.variant_source().read_text()
    for _, slot, _ in probe.STAMPS:
        assert f"  STAMP({slot});\n" in text
    assert f"g_probe[{probe.ROUNDS}] += 1;" in text
    assert f"g_probe[{probe.RECORDS}] = W;" in text
    assert 'extern "C" int probe_read(' in text
    header = text.split('#include "', 2)[1].split('"', 1)[0]
    assert header.endswith("hopper.cuh") and Path(header).is_file()


def _needs_hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")


def _card_equal(cols, scal, flags, scalars_on_card=False):
    args = _torch_args(cols, scal, "cuda")
    if scalars_on_card:
        args[9] = torch.tensor(args[9], dtype=torch.int32, device="cuda")
        args[10] = torch.tensor(args[10], dtype=torch.int32, device="cuda")
    launches = ops.LAUNCHES
    got = ops.plan_evictions_fused(*args, **flags)
    want = plan_evictions_ref(*args, **flags)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == launches + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w), flags
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["no_candidate", "one_cta", "few_tiles",
                                  "across_ctas", "walk_past_one_tile",
                                  "eight_tiers", "ties_and_extremes",
                                  "scalars_on_card"])
def test_cuda_kernel_paths_on_card(path):
    """Each device path of the one launch: no candidate; E <= 512 sorted
    and walked by one CTA; E ~ 3,000 over six tiles and three merge
    levels; E ~ 131k across the grid; a bounded walk over more records
    than one shared-memory buffer holds (1,280 at T = 4, 832 at T = 8);
    idle and cpus_needed by pointer."""
    _needs_hopper()
    j = {"no_candidate": 100_000, "one_cta": 100_000,
         "few_tiles": 100_000}.get(path, 262_144)
    n_tiers = 8 if path == "eight_tiers" else 4
    if path == "ties_and_extremes":
        cols, scal = _tied_extreme_case(9, j, n_tiers)
    else:
        cols, scal = _case(11 + len(path), j, n_tiers, bounded=True)
    if path == "no_candidate":
        cols["evictable"][:] = False
    if path in ("one_cta", "few_tiles"):
        e = 400 if path == "one_cta" else 3000
        cols["evictable"][:] = False
        cols["evictable"][np.random.default_rng(1).choice(j, e, False)] = True
    total = int(cols["cpus"][cols["evictable"]].sum())
    scal["cpus_needed"] = total // 3
    for cheap, tiered, bounded in VARIANTS:
        flags = dict(cheap=cheap, tiered=tiered, bounded=bounded)
        sc = dict(scal, cap=scal["cap"] if bounded
                  else np.full_like(scal["cap"], -1))
        planned = _card_equal(cols, sc, flags,
                              scalars_on_card=path == "scalars_on_card")[0]
        if path in ("walk_past_one_tile", "eight_tiers") and bounded:
            assert int(planned.sum()) > 2 * 1280


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_on_card():
    _needs_hopper()
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
