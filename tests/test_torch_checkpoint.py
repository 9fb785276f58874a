"""The port's checkpoint subsystem (`repro_torch.checkpoint`) on torch state,
and against the JAX reference `repro.checkpoint`.

The first half reruns the cases of ``tests/test_checkpoint.py`` on a tree
of CPU tensors (bitwise round trips, corruption, tiers, delta, async
writer, manager policy, write-through, the decodable delta chain).  The
second half holds the two packages to each other on a real JAX
``TrainState`` of the internlm2-1.8b smoke config after one train step,
carried across by `convert.tree_from_reference`: the same leaf keys, byte
for byte the same disk checkpoints (each package restores the other's),
the same delta blobs, the same manager decisions, the same calibrated
cost models, and the port's shape table of the state at the published
widths."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint import serialize as jser  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import ManagerConfig as JConfig  # noqa: E402
from repro.checkpoint.reshard import save_global as jsave_global  # noqa: E402
from repro.checkpoint.service import CheckpointService as JService  # noqa: E402
from repro.checkpoint.service import CRStats as JCRStats  # noqa: E402
from repro.checkpoint.tiers import DiskTier as JDiskTier  # noqa: E402
from repro.checkpoint.tiers import TierStats as JTierStats  # noqa: E402
from repro.configs import get_config, get_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM, shard_batch  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.train.state import init_train_state, train_state_shapes  # noqa: E402
from repro.train.steps import TrainConfig, make_train_step  # noqa: E402
from repro_torch.checkpoint import delta as delta_mod  # noqa: E402
from repro_torch.checkpoint import serialize  # noqa: E402
from repro_torch.checkpoint.async_writer import AsyncCheckpointer  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    CheckpointManager,
    ManagerConfig,
)
from repro_torch.checkpoint.reshard import (  # noqa: E402
    restore_resharded,
    save_global,
)
from repro_torch.checkpoint.service import (  # noqa: E402
    CheckpointService,
    CRStats,
)
from repro_torch.checkpoint.tiers import (  # noqa: E402
    DiskTier,
    MemTier,
    TieredStore,
    TierStats,
)
from repro_torch.core import convert  # noqa: E402
from repro_torch.train.state import (  # noqa: E402
    INTERNLM2_1_8B,
    dense_state_template,
)


def _state(seed=0):
    """The reference test's state: fp32 weights, a bf16 bias, an int32
    step — as CPU tensors from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
                       rng.standard_normal((16, 8)).astype(np.float32)),
                   "b": torch.zeros(8, dtype=torch.bfloat16)},
        "opt": {"m": torch.from_numpy(
                    rng.standard_normal((16, 8)).astype(np.float32)),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _template(state):
    return serialize.map_with_path(
        lambda _k, t: torch.empty_like(t, device="meta"), state)


def _leaves(tree):
    return [t for _, t in serialize.leaf_paths(tree)]


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and bytes(serialize.to_numpy(a).tobytes())
            == bytes(serialize.to_numpy(b).tobytes()))


def _assert_same_tree(a, b):
    ka = [k for k, _ in serialize.leaf_paths(a)]
    kb = [k for k, _ in serialize.leaf_paths(b)]
    assert ka == kb
    for x, y in zip(_leaves(a), _leaves(b)):
        assert _same(x, y)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on torch state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compress", [None, 3])
def test_serialize_roundtrip_bitwise(tmp_path, compress):
    state = _state()
    serialize.save_tree(state, tmp_path / "ck", compress=compress)
    leaves = serialize.load_leaves(tmp_path / "ck")
    rebuilt = serialize.fill_template(_template(state), leaves)
    _assert_same_tree(state, rebuilt)
    assert rebuilt["params"]["b"].dtype == torch.bfloat16


def test_serialize_detects_corruption(tmp_path):
    m = serialize.save_tree(_state(), tmp_path / "ck")
    victim = next(iter(m["leaves"].values()))["file"]
    p = tmp_path / "ck" / victim
    raw = bytearray(p.read_bytes())
    raw[0] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        serialize.load_leaves(tmp_path / "ck")


def test_fill_template_raises_on_missing_leaf_and_shape_mismatch():
    state = _state()
    leaves = save_global(state)
    missing = dict(leaves)
    missing.pop("['opt']['m']")
    with pytest.raises(KeyError, match="missing leaf"):
        serialize.fill_template(_template(state), missing)
    bad = dict(leaves, **{"['opt']['m']": np.zeros((8, 16), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        serialize.fill_template(_template(state), bad)


@pytest.mark.parametrize("over", [False, True])
def test_mem_tier_lru_and_oversized_rejection(over):
    tier = MemTier(capacity_bytes=3000)
    big = {"x": np.ones((300,), np.float32)}     # 1200 bytes each
    tier.save_leaves("a", dict(big))
    if over:
        # rejected with the store untouched: no eviction, no admission
        with pytest.raises(ValueError, match="exceeds MemTier capacity"):
            tier.save_leaves("big", {"x": np.ones((2000,), np.float32)})
        assert "a" in tier and "big" not in tier
        assert tier.stats.evictions == 0
        return
    tier.save_leaves("b", dict(big))
    tier.save_leaves("c", dict(big))             # evicts "a"
    assert "a" not in tier and "b" in tier and "c" in tier
    assert tier.stats.evictions == 1


def test_mem_tier_save_snapshots_a_tree():
    tier = MemTier(1 << 20)
    state = _state(1)
    tier.save("s", state)
    got = tier.restore("s")
    assert got.keys() == save_global(state).keys()
    assert got["['params']['b']"].dtype == serialize.BFLOAT16_BITS


@pytest.mark.parametrize("case", ["promotion", "fastest_tier", "idempotent"])
def test_tiered_store(tmp_path, case):
    store = TieredStore(MemTier(1 << 20), DiskTier(tmp_path / "disk"))
    leaves = save_global(_state(2))
    store.mem.save_leaves("s", leaves)
    store.promote("s")
    assert "s" in store.mem and "s" in store.disk
    if case == "promotion":
        got = store.disk.restore("s")
    elif case == "fastest_tier":
        before = store.disk.stats.restores
        got = store.restore_leaves("s")
        assert store.mem.stats.restores >= 1
        assert store.disk.stats.restores == before     # disk never touched
    else:
        store.promote("s")          # second promote must be a no-op
        assert store.disk.stats.saves == 1
        return
    assert set(got) == set(leaves)
    for k in leaves:
        assert (got[k] == leaves[k]).all()


def test_tiered_store_oversized_writes_through_to_disk(tmp_path):
    store = TieredStore(MemTier(capacity_bytes=100),
                        DiskTier(tmp_path / "disk"))
    state = {"w": torch.arange(1024, dtype=torch.float32)}     # 4 KiB > 100 B
    store.save("big", state)
    assert "big" not in store.mem and "big" in store.disk
    (arr,) = store.restore_leaves("big").values()
    assert (arr == state["w"].numpy()).all()


def test_tier_stats_byte_accounting(tmp_path):
    """bytes_written / bytes_read against known array sizes."""
    a = np.ones((256,), np.float32)      # 1024 B
    b = np.ones((128,), np.float64)      # 1024 B
    expected = a.nbytes + b.nbytes
    mem = MemTier(1 << 20)
    mem.save_leaves("s", {"a": a, "b": b})
    assert mem.stats.bytes_written == expected
    mem.restore("s")
    assert mem.stats.bytes_read == expected
    disk = DiskTier(tmp_path / "d", compress=None)
    disk.save_leaves("s", {"a": a, "b": b})
    assert disk.stats.bytes_written == expected    # raw: stored == nbytes
    disk.restore("s")
    assert disk.stats.bytes_read == expected


def test_delta_roundtrip_and_compression_win():
    base = {"w": np.random.default_rng(0).normal(size=4096).astype(np.float32)}
    new = {"w": base["w"].copy()}
    new["w"][:100] += 1e-3                        # tiny change
    blobs, sizes = delta_mod.encode_snapshot(new, base)
    out = delta_mod.decode_snapshot(blobs, base, {"w": ("float32", (4096,))})
    assert (out["w"] == new["w"]).all()
    assert blobs["w"].is_delta
    full, _ = delta_mod.encode_snapshot(new, None)
    assert sizes["w"] < len(full["w"].data)       # delta strictly smaller


def test_async_writer_overlap_and_barrier(tmp_path):
    tier = DiskTier(tmp_path / "d")
    ck = AsyncCheckpointer(tier.save_leaves)
    fut = ck.save("s1", _state())
    ck.wait()
    assert fut.done() and "s1" in tier
    ck.close()


def test_manager_policy_and_restore(tmp_path):
    mgr = CheckpointManager(ManagerConfig(
        root=tmp_path / "ck", durable_every=2, keep_last=2, async_durable=True))
    states = [_state(i) for i in range(5)]
    for i, s in enumerate(states):
        mgr.save(i, s)
    mgr._async.wait()
    # saves 0..4 -> durable at i=1 and i=3 (every 2nd); keep_last=2
    assert len(mgr.disk.names()) == 2
    restored, name = mgr.restore(_template(states[-1]), device="cpu")
    assert name == "step_00000004"
    _assert_same_tree(states[-1], restored)
    # without device=, a tensor template's own device is the target
    restored, _ = mgr.restore(states[0])
    _assert_same_tree(states[-1], restored)
    with pytest.raises(ValueError, match="pass device="):
        mgr.restore(_template(states[-1]))
    mgr.close()


def test_manager_oversized_snapshot_writes_through(tmp_path):
    mgr = CheckpointManager(ManagerConfig(
        root=tmp_path / "ck", mem_capacity_bytes=100, durable_every=100))
    s = _state(1)
    mgr.save(3, s)
    assert mgr.mem.names() == [] and mgr.disk.names() == ["step_00000003"]
    restored, name = mgr.restore(_template(s), device="cpu")
    assert name == "step_00000003"
    _assert_same_tree(s, restored)
    mgr.close()


def test_manager_delta_chain_bounded(tmp_path):
    mgr = CheckpointManager(ManagerConfig(
        root=tmp_path / "ck", durable_every=100, delta_keep_last=4,
        use_delta=True, async_durable=False))
    for i in range(12):
        mgr.save(i, _state(i))
    assert len(mgr._delta_chain) == 4      # bounded, oldest GC'd
    assert list(mgr._delta_chain) == [f"step_{i:08d}" for i in (8, 9, 10, 11)]
    mgr.close()


def test_manager_restore_after_many_evictions_decodes_chain(tmp_path):
    """The fast tier forgets (LRU), the durable tier holds sparse fulls —
    a mid-chain snapshot is rebuilt by XOR-decoding forward from the
    nearest durable full snapshot."""
    states = [_state(i) for i in range(6)]
    snap_bytes = sum(serialize.to_numpy(t).nbytes
                     for t in _leaves(states[0]))
    mgr = CheckpointManager(ManagerConfig(
        root=tmp_path / "ck",
        mem_capacity_bytes=snap_bytes + 16,    # fast tier holds ONE snapshot
        durable_every=2, keep_last=2, delta_keep_last=8,
        use_delta=True, async_durable=False))
    for i, s in enumerate(states):
        mgr.save(i, s)
    assert mgr.mem.names() == ["step_00000005"]
    assert mgr.disk.names() == ["step_00000003", "step_00000005"]
    restored, name = mgr.restore(_template(states[4]), name="step_00000004",
                                 device="cpu")
    assert name == "step_00000004"
    _assert_same_tree(states[4], restored)
    # a snapshot whose chain base was GC'd everywhere raises cleanly
    with pytest.raises(FileNotFoundError):
        mgr.restore(_template(states[2]), name="step_00000002", device="cpu")
    mgr.close()


def test_manager_restore_from_disk_after_mem_loss(tmp_path):
    """Node failure: the fast tier dies with the host; restore falls back
    to the durable tier."""
    mgr = CheckpointManager(ManagerConfig(
        root=tmp_path / "ck", durable_every=1, keep_last=3, async_durable=False))
    s = _state(3)
    mgr.save(11, s)
    mgr.mem = MemTier(1 << 20)                    # fresh process: empty fast tier
    restored, name = mgr.restore(_template(s), device="cpu")
    assert name == "step_00000011"
    _assert_same_tree(s, restored)
    mgr.close()


def test_restore_copies_and_refuses_shardings(tmp_path):
    """A restored tensor never aliases the snapshot it came from (torch
    tensors are mutable); a ``shardings`` tree that does not place every
    leaf of the template is refused, never filled in with whole copies
    (sharded restore itself is held in tests/test_torch_distributed.py)."""
    state = _state(4)
    leaves = save_global(state)
    restored = restore_resharded(leaves, _template(state), device="cpu")
    restored["opt"]["m"].add_(1.0)
    assert (leaves["['opt']['m']"] == state["opt"]["m"].numpy()).all()
    with pytest.raises(ValueError, match="no placement for"):
        restore_resharded(leaves, _template(state), shardings={},
                          device="cpu")


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointService(ManagerConfig(root=tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.tree_from_reference({"w": np.zeros(3)})
    svc = CheckpointService(ManagerConfig(root=tmp_path / "ck"),
                            device="cpu")
    svc.save(0, _state())
    restored, _ = svc.restore(_template(_state()))
    _assert_same_tree(_state(), restored)
    svc.close()


# ---------------------------------------------------------------------------
# the port against the reference, on a real TrainState
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_states():
    """Two consecutive JAX TrainStates of the internlm2-1.8b smoke config
    (init and one train step)."""
    cfg = get_smoke_config("internlm2-1.8b")
    model = build_model(cfg, q_chunk=64, kv_chunk=64)
    state = init_train_state(model.init(jax.random.PRNGKey(0)))
    step = jax.jit(make_train_step(model, TrainConfig()))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    new, _ = step(state, shard_batch(data.batch_at(0)))
    return state, new


def _jax_template(state):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        state)


def _jax_equal(a, b):
    return all(np.asarray(x).dtype == np.asarray(y).dtype
               and np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_tree_conversion_keeps_structure_and_dtypes(train_states):
    _, js = train_states
    ts = convert.tree_from_reference(js, device="cpu")
    assert type(ts).__name__ == "TrainState" and ts._fields == js._fields
    assert type(ts.opt).__name__ == "AdamWState"
    assert ts.opt._fields == js.opt._fields
    assert isinstance(ts.params, dict) and ts.rng.dtype == torch.uint32
    for (jk, jl), (tk, tl) in zip(
            jax.tree_util.tree_flatten_with_path(js)[0],
            serialize.leaf_paths(ts)):
        assert jax.tree_util.keystr(jk) == tk
        assert np.asarray(jl).tobytes() == serialize.to_numpy(tl).tobytes()
    back = convert.tree_to_numpy(ts)
    assert type(back).__name__ == "TrainState"
    assert _jax_equal(js, back)
    mixed = convert.tree_from_reference(
        {"l": [jnp.ones(2, jnp.bfloat16), (jnp.int32(3),)]}, device="cpu")
    assert isinstance(mixed["l"], list) and isinstance(mixed["l"][1], tuple)
    assert mixed["l"][0].dtype == torch.bfloat16


def test_leaf_paths_equal_keystr_in_order(train_states):
    _, js = train_states
    ts = convert.tree_from_reference(js, device="cpu")
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [k for k, _ in serialize.leaf_paths(ts)] == want
    assert ".opt.m['blocks']['ffn']['w_down']" in want
    # the same for the test state with a bf16 leaf and a plain dict
    state = _state()
    jstate = jax.tree.map(lambda t: jnp.asarray(serialize.to_numpy(t))
                          if t.dtype != torch.bfloat16
                          else jnp.zeros(t.shape, jnp.bfloat16), state)
    assert [k for k, _ in jser.leaf_paths(jstate)] == \
        [k for k, _ in serialize.leaf_paths(state)]


@pytest.mark.parametrize("compress", [None, 3])
def test_disk_checkpoints_are_byte_identical_and_restore_across(
        tmp_path, train_states, compress):
    _, js = train_states
    ts = convert.tree_from_reference(js, device="cpu")
    JDiskTier(tmp_path / "jax", compress=compress).save("s", js)
    DiskTier(tmp_path / "torch", compress=compress).save("s", ts)
    jdir, tdir = tmp_path / "jax" / "s", tmp_path / "torch" / "s"
    assert (jdir / "manifest.json").read_text() == \
        (tdir / "manifest.json").read_text()
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in tdir.iterdir())
    for name in files:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes()
    # the port restores what JAX wrote, JAX restores what the port wrote
    got = serialize.fill_template(_template(ts), serialize.load_leaves(jdir))
    _assert_same_tree(ts, got)
    jgot = jser.fill_template(_jax_template(js), jser.load_leaves(tdir))
    assert _jax_equal(js, jgot)


def test_bf16_checkpoint_restores_across(tmp_path):
    state = _state(5)
    state["params"]["b"] = torch.linspace(-3, 3, 8).to(torch.bfloat16)
    jstate = jax.tree.map(jnp.asarray, convert.tree_to_numpy(
        {k: v for k, v in state.items()}))
    jstate["params"]["b"] = jnp.asarray(
        serialize.to_numpy(state["params"]["b"]).view(jnp.bfloat16))
    serialize.save_tree(state, tmp_path / "t")
    jser.save_tree(jstate, tmp_path / "j")
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "j" / "manifest.json").read_text())
    got = serialize.fill_template(_template(state),
                                  serialize.load_leaves(tmp_path / "j"))
    _assert_same_tree(state, got)
    jgot = jser.fill_template(_jax_template(jstate),
                              jser.load_leaves(tmp_path / "t"))
    assert _jax_equal(jstate, jgot)


def test_delta_blobs_equal(train_states):
    j0, j1 = train_states
    t0, t1 = (convert.tree_from_reference(s, device="cpu") for s in (j0, j1))
    jb, js = jdelta.encode_snapshot(jsave_global(j1), jsave_global(j0))
    tb, tsz = delta_mod.encode_snapshot(save_global(t1), save_global(t0))
    assert list(jb) == list(tb) and js == tsz
    for k in jb:
        assert (jb[k].data, jb[k].is_delta, jb[k].nbytes_raw) == \
            (tb[k].data, tb[k].is_delta, tb[k].nbytes_raw)


def _perturbed(js, i):
    """The i-th of a run of distinct JAX states: every float leaf moved."""
    return jax.tree.map(
        lambda a: a + 0.01 * i if jnp.issubdtype(a.dtype, jnp.floating)
        else a, js)


@pytest.mark.parametrize("mem_capacity", ["one_snapshot", "oversized"])
def test_manager_decisions_and_restores_equal(tmp_path, train_states,
                                              mem_capacity):
    _, js = train_states
    jstates = [_perturbed(js, i) for i in range(6)]
    snap = sum(np.asarray(a).nbytes for a in jax.tree.leaves(js))
    cap = snap + 16 if mem_capacity == "one_snapshot" else snap // 2
    kw = dict(mem_capacity_bytes=cap, durable_every=2, keep_last=2,
              delta_keep_last=3, use_delta=True, async_durable=False)
    jm = JManager(JConfig(root=tmp_path / "jax", **kw))
    tm = CheckpointManager(ManagerConfig(root=tmp_path / "torch", **kw))
    tstates = []
    for i, s in enumerate(jstates):
        t = convert.tree_from_reference(s, device="cpu")
        tstates.append(t)
        assert jm.save(i, s) == tm.save(i, t)
    assert jm.names() == tm.names()
    assert jm.mem.names() == tm.mem.names()
    assert jm.disk.names() == tm.disk.names()
    assert jm.mem.stats.evictions == tm.mem.stats.evictions
    assert list(jm._delta_chain) == list(tm._delta_chain)
    if mem_capacity == "oversized":
        assert tm.mem.names() == [] and len(tm.disk.names()) == 2
    for name in tm.names():
        try:
            jl = jm.restore_leaves(name)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                tm.restore_leaves(name)
            continue
        tl = tm.restore_leaves(name)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert jl[k].tobytes() == tl[k].tobytes()
    i = int(tm.names()[-1].split("_")[1])
    restored, name = tm.restore(_template(tstates[i]), device="cpu")
    jrestored, jname = jm.restore(_jax_template(jstates[i]))
    assert name == jname
    _assert_same_tree(tstates[i], restored)
    assert _jax_equal(jrestored, convert.tree_to_numpy(restored))
    jm.close()
    tm.close()


def _fields(model):
    return dataclasses.asdict(model)


@pytest.mark.parametrize("tiers", [None, ("mem", "disk")])
def test_calibration_equal_under_equal_stats(tmp_path, tiers):
    stats = dict(saves=3, restores=2, bytes_saved=3 << 30,
                 bytes_restored=2 << 30, save_seconds=1.7,
                 restore_seconds=0.4)
    mem = dict(saves=3, restores=2, bytes_written=3 << 30,
               bytes_read=2 << 30, save_seconds=0.05, restore_seconds=0.01)
    disk = dict(saves=1, restores=0, bytes_written=1 << 30,
                save_seconds=2.5)
    kw = dict(tick_seconds=0.1, tiers=tiers, delta_ratio=0.7)
    jsvc = JService(JConfig(root=tmp_path / "j", mem_capacity_bytes=3 << 30))
    tsvc = CheckpointService(ManagerConfig(
        root=tmp_path / "t", mem_capacity_bytes=3 << 30), device="cpu")
    jsvc._stats, tsvc._stats = JCRStats(**stats), CRStats(**stats)
    jsvc.manager.mem.stats, tsvc.manager.mem.stats = (JTierStats(**mem),
                                                      TierStats(**mem))
    jsvc.manager.disk.stats, tsvc.manager.disk.stats = (JTierStats(**disk),
                                                        TierStats(**disk))
    jmodel, tmodel = jsvc.calibrate(**kw), tsvc.calibrate(**kw)
    assert type(jmodel).__name__ == type(tmodel).__name__
    assert _fields(jmodel) == _fields(tmodel)
    if tiers is not None:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            shim = tsvc.calibrate_tiered(0.1)
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
        assert _fields(shim) == _fields(
            jsvc.calibrate(tick_seconds=0.1, tiers=("mem", "disk")))
    jsvc.close()
    tsvc.close()


@pytest.mark.parametrize("n_layers", [24, 1])
def test_internlm2_state_shapes_equal_reference(n_layers):
    cfg = get_config("internlm2-1.8b")
    assert INTERNLM2_1_8B == {k: getattr(cfg, k) for k in INTERNLM2_1_8B}
    shapes = train_state_shapes(build_model(cfg.replace(n_layers=n_layers)))
    want = [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    template = dense_state_template(**dict(INTERNLM2_1_8B,
                                           n_layers=n_layers))
    got = [(k, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in serialize.leaf_paths(template)]
    assert got == want
    assert serialize.tree_bytes(template) == jser.tree_bytes(shapes)
    if n_layers == 24:
        assert len(got) == 39
        assert serialize.tree_bytes(template) == 22_669_320_208  # 21.11 GiB
