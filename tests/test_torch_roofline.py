"""The port's roofline arithmetic (`repro_torch.roofline`) and cost counter
against the reference's (`repro.roofline.analysis`), on the CPU.

* `model_flops_per_step` equals the reference's for all ten archs, four
  shapes and both modes;
* ``tests/test_roofline.py``'s four cases on the port's `analyze`, a
  `counting.Costs` record in place of ``FakeCompiled``: the same raw
  costs give the reference's FLOPs, bytes, collective bytes and
  ``model_flops_ratio``, and each term is the raw value over the H100's
  constant (`launch/mesh.py`);
* `analyze_extrapolated` equals the reference's on the same cost dicts;
* the live-bytes counter on a hand sequence of ops;
* under `costing`, each of the four kernel wrappers on meta inputs
  returns its plain version's output shapes and dtypes and records
  exactly its package's ``cost``; outside it, meta still raises.
"""
import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models.model import model_flops_per_step as ref_mflops  # noqa: E402
from repro.roofline import analysis as ref_rl  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import cost as flash_cost  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import visible  # noqa: E402
from repro_torch.kernels.mlstm_scan import cost as mlstm_cost  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import cost as gmm_cost  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import cost as ssm_cost  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model, model_flops_per_step  # noqa: E402
from repro_torch.roofline import analysis as rl  # noqa: E402
from repro_torch.roofline import counting  # noqa: E402
from repro_torch.train.state import bind_state, train_state_shapes  # noqa: E402

#: the same counts as ``tests/test_roofline.py``'s HLO_SAMPLE: an
#: all-gather of bf16[2048, 256] plus one of bf16[99], an all-reduce of
#: f32[1024] (raw result bytes: the port weighs them)
COLL = {"all-gather": 2048 * 256 * 2 + 99 * 2, "all-reduce": 1024 * 4}
HLO = """
ENTRY main {
  %ag = bf16[2048,256]{1,0} all-gather(%p), dimensions={0}
  %ag2 = bf16[99]{0} all-gather-start(%w), dimensions={0}
  %agd = bf16[99]{0} all-gather-done(%ag2)
  %ar = f32[1024]{0} all-reduce(%x), to_apply=%add
}
"""


class FakeCompiled:
    def __init__(self, flops, nbytes):
        self.flops, self.nbytes = flops, nbytes

    def cost_analysis(self):
        return {"flops": self.flops, "bytes accessed": self.nbytes}

    def as_text(self):
        return HLO


def _costs(flops, nbytes, coll=COLL):
    # the raw costs split over the two sources the port sums
    return counting.Costs(matmul_flops=flops * 0.75, kernel_flops=flops * 0.25,
                          op_bytes=nbytes * 0.5, kernel_bytes=nbytes * 0.5,
                          coll=dict(coll))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_per_step_is_the_reference(arch):
    for shape, ref_shape in zip(SHAPES, REF_SHAPES):
        assert shape.name == ref_shape.name
        for backward in (True, False):
            assert model_flops_per_step(get_config(arch), shape, backward) \
                == ref_mflops(ref_config(arch), ref_shape, backward)


def test_tensor_bytes_of_torch_dtypes():
    assert rl.tensor_bytes((128, 256), torch.bfloat16) == 128 * 256 * 2
    assert rl.tensor_bytes((1024,), torch.float32) == 4096
    assert rl.tensor_bytes((2, 2), torch.bfloat16) \
        + rl.tensor_bytes((3,), torch.float32) == 8 + 12
    assert rl.tensor_bytes((), torch.bool) == 1
    assert rl.tensor_bytes((16,), torch.uint8) == 16
    assert rl.tensor_bytes((2,), torch.uint32) == 8


def test_collective_bytes_weighted_as_the_reference():
    got = rl.collective_bytes(COLL)
    want = ref_rl.collective_bytes(HLO)
    assert got == want
    assert got["all-reduce"] == 1024 * 4 * 2             # x2 ring RS+AG


def test_roofline_terms_and_bottleneck():
    flops, nbytes = 197e12, 819e9 / 2
    rf = rl.analyze(_costs(flops, nbytes), n_devices=4,
                    model_flops=flops * 2)
    ref = ref_rl.analyze(FakeCompiled(flops, nbytes), n_devices=4,
                         model_flops=flops * 2)
    assert rf.flops_per_device == ref.flops_per_device
    assert rf.bytes_per_device == ref.bytes_per_device
    assert rf.coll_breakdown == ref.coll_breakdown
    assert rf.coll_bytes_per_device == ref.coll_bytes_per_device
    assert rf.model_flops_ratio == ref.model_flops_ratio == 0.5
    assert rf.compute_s == flops / tmesh.PEAK_FLOPS_BF16
    assert rf.memory_s == nbytes / tmesh.HBM_BW
    assert rf.collective_s == ref.coll_bytes_per_device / (
        tmesh.NVLINK_LINKS * tmesh.NVLINK_BW_PER_LINK)
    assert rf.bottleneck == "compute"
    assert set(rf.row()) == set(ref.row())
    # a byte-heavy step is memory-bound on the H100 as on the TPU
    mem = rl.analyze(_costs(1e9, 1e12), n_devices=1)
    assert mem.bottleneck == "memory"


def test_cost_scale_applies_to_all_terms():
    r1 = rl.analyze(_costs(1e12, 1e9), n_devices=1)
    r4 = rl.analyze(_costs(1e12, 1e9), n_devices=1, cost_scale=4.0)
    for term in ("compute_s", "memory_s", "collective_s"):
        assert abs(getattr(r4, term) / getattr(r1, term) - 4.0) < 1e-9
    ref4 = ref_rl.analyze(FakeCompiled(1e12, 1e9), n_devices=1,
                          cost_scale=4.0)
    assert r4.flops_per_device == ref4.flops_per_device
    assert r4.coll_breakdown == ref4.coll_breakdown


def test_analyze_extrapolated_is_the_reference():
    a = {"flops": 3e12, "bytes": 2e10,
         "coll": {"all-gather": 1e8, "all-reduce": 4e7}}
    b = {"flops": 5e12, "bytes": 3.5e10,
         "coll": {"all-gather": 1.8e8, "all-reduce": 3e7}}   # shrinks: clamp
    for scale in (1.0, 4.0):
        got = rl.analyze_extrapolated(a, b, 2, 4, 24, n_devices=256,
                                      model_flops=1e15, cost_scale=scale)
        ref = ref_rl.analyze_extrapolated(a, b, 2, 4, 24, n_devices=256,
                                          model_flops=1e15, cost_scale=scale)
        assert got.flops_per_device == ref.flops_per_device
        assert got.bytes_per_device == ref.bytes_per_device
        assert got.coll_breakdown == ref.coll_breakdown
        assert got.model_flops_ratio == ref.model_flops_ratio
        assert got.compute_s == got.flops_per_device / tmesh.PEAK_FLOPS_BF16


def test_raw_costs_and_memory_stats():
    c = _costs(4e12, 8e9)
    assert rl.raw_costs(c) == {"flops": 4e12, "bytes": 8e9,
                               "coll": rl.collective_bytes(COLL)}
    c = dataclasses.replace(c, peak_bytes=1000, argument_bytes=5000,
                            output_bytes=300, alias_bytes=200)
    m = rl.memory_stats(c)
    assert m == {"argument_bytes": 5000, "output_bytes": 300,
                 "temp_bytes": 900, "alias_bytes": 200,
                 "peak_estimate_bytes": 6000}       # arguments + peak


def test_live_bytes_peak_of_a_hand_sequence():
    n = 1000
    with counting.costing() as c:
        a = torch.empty(n, device="meta")
        b = a * 2
        del a
        d = b + 1
    assert c.peak_bytes == 2 * n * 4
    assert c.live_bytes == 2 * n * 4
    del b, d
    # on real tensors alike; a view and an in-place op make no storage
    with counting.costing() as c:
        a = torch.zeros(n)
        v = a[: n // 2]
        a.add_(1)
        w = v * 3
    assert c.peak_bytes == n * 4 + n // 2 * 4
    assert c.op_bytes == n * 4 + 2 * n * 4 + 2 * (n // 2) * 4
    del a, v, w


def test_matmul_flops_forward_and_backward():
    with counting.costing() as c:
        x = torch.empty(64, 128, device="meta", requires_grad=True)
        w = torch.empty(128, 32, device="meta", requires_grad=True)
        torch.autograd.grad((x @ w).sum(), [x, w])
    assert c.matmul_flops == 3 * 2 * 64 * 128 * 32
    assert c.flops == c.matmul_flops and c.kernel_flops == 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _like_cpu(t):
    return torch.zeros(t.shape, dtype=t.dtype)


def _same_meta(got, want):
    got, want = counting.tensors(got), counting.tensors(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype


def _wrapper_cases():
    b, s, h, kvh, d = 2, 24, 4, 2, 16
    q = _meta(b, s, h, d, dtype=torch.bfloat16)
    k = _meta(b, s, kvh, d, dtype=torch.bfloat16)
    v = _meta(b, s, kvh, 8, dtype=torch.bfloat16)
    di, ds = 12, 4
    ssm_args = (_meta(b, s, di), _meta(b, s, ds), _meta(b, s, ds),
                _meta(b, s, di), _meta(di, ds), _meta(b, di, ds))
    bh, dh = 3, 8
    ml = (_meta(bh, s, dh), _meta(bh, s, dh), _meta(bh, s, dh),
          _meta(bh, s), _meta(bh, s))
    state = (_meta(bh, dh, dh), _meta(bh, dh), _meta(bh))
    e, cap, dm, f = 4, 8, 16, 24
    x = _meta(e, cap, dm, dtype=torch.bfloat16)
    wg, wd = _meta(e, dm, f), _meta(e, f, dm)
    counts = _meta(e, dtype=torch.int32)
    return [
        ("flash_attention",
         lambda: flash_ops.flash_attention(q, k, v, window=5, n_meta=2),
         lambda a: flash_ops.flash_attention(*a, window=5, n_meta=2),
         (q, k, v),
         [flash_cost.cost(b, s, h, kvh, d, 2, skv=s, dv=8, window=5,
                          n_meta=2)]),
        ("ssm_scan", lambda: ssm_ops.selective_scan(*ssm_args),
         lambda a: ssm_ops.selective_scan(*a), ssm_args,
         [ssm_cost.cost(b, s, di, ds)]),
        ("mlstm_scan",
         lambda: mlstm_ops.mlstm_scan(*ml, state, chunk=16),
         lambda a: mlstm_ops.mlstm_scan(*a[:5], a[5:], chunk=16),
         ml + state, [mlstm_cost.cost(bh, s, dh, 16, carried=True)]),
        ("moe_gmm",
         lambda: gmm_ops.expert_swiglu(x, wg, wg, wd, counts, pairs=20),
         lambda a: gmm_ops.expert_swiglu(*a),
         (x, wg, wg, wd, counts),
         [gmm_cost.cost(x, wg, pairs=20), gmm_cost.cost(x, wg, pairs=20),
          gmm_cost.cost(_meta(e, cap, f, dtype=torch.bfloat16), wd,
                        pairs=20)]),
    ]


@pytest.mark.parametrize("case", range(4), ids=["flash_attention", "ssm_scan",
                                                "mlstm_scan", "moe_gmm"])
def test_wrappers_cost_meta_without_launching(case):
    name, on_meta, plain, args, costs = _wrapper_cases()[case]
    launches = {m: (m.LAUNCHES, getattr(m, "WGMMA_LAUNCHES", 0))
                for m in (flash_ops, ssm_ops, mlstm_ops, gmm_ops)}
    with counting.costing() as c:
        got = on_meta()
    want = plain(tuple(_like_cpu(t) for t in args))
    _same_meta(got, want)
    assert c.kernels == {name: {
        "calls": len(costs), "flop": sum(x["flop"] for x in costs),
        "bytes": sum(x["bytes"] for x in costs)}}
    assert c.kernel_flops == sum(x["flop"] for x in costs)
    assert c.kernel_bytes == sum(x["bytes"] for x in costs)
    assert {m: (m.LAUNCHES, getattr(m, "WGMMA_LAUNCHES", 0))
            for m in launches} == launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        on_meta()


def test_plain_versions_are_not_counted_twice():
    """On CPU tensors a wrapper runs its plain version; the count holds
    the kernel's cost, not the plain version's ops."""
    q = torch.zeros(1, 32, 2, 16)
    with counting.costing() as c:
        flash_ops.flash_attention(q, q, q)
    assert c.matmul_flops == 0
    assert c.kernel_flops == flash_cost.cost(1, 32, 2, 2, 16, 4)["flop"]


@pytest.mark.parametrize("sq,skv,causal,window,n_meta", [
    (7, 7, True, 0, 0), (6, 9, False, 0, 0), (9, 6, True, 0, 0),
    (12, 12, True, 4, 0), (12, 12, True, 4, 3), (10, 14, False, 3, 2),
    (1, 40, True, 0, 0), (33, 33, True, 1, 5)])
def test_visible_pairs_counts_the_mask(sq, skv, causal, window, n_meta):
    want = int(visible(sq, skv, causal=causal, window=window,
                       n_meta=n_meta).sum())
    assert flash_cost.visible_pairs(sq, skv, causal=causal, window=window,
                                    n_meta=n_meta) == want


def test_moe_capacity_on_meta_is_a_uniform_routers():
    cfg = get_config("deepseek-moe-16b").moe
    t = 4096
    counts = _meta(cfg.n_routed, dtype=torch.int64)
    with counting.costing() as c:
        cap = tmoe.capacity(t, counts, cfg.top_k)
    tile = gmm_ops.ROW_TILE
    uniform = math.ceil(1.25 * t * cfg.top_k / cfg.n_routed)
    assert cap == -(-uniform // tile) * tile and cap % tile == 0
    assert c.notes == {"moe_capacity": [cap]}
    with pytest.raises(ValueError):
        with counting.costing():
            tmoe.capacity(t, counts)               # top_k is needed
    # small T needs no read, on meta or not
    assert tmoe.capacity(tile, counts) == tile


def test_meta_state_binds_and_steps_without_allocating():
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.steps import TrainConfig, make_train_step

    model = Model(get_smoke_config("internlm2-1.8b"), device="meta")
    state = bind_state(model, train_state_shapes(model))
    assert state.data_cursor.is_meta
    batch = {k: torch.empty(2, 16, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with counting.costing() as c:
        new, metrics = make_train_step(model, TrainConfig())(state, batch)
    assert new.opt.step.is_meta and metrics["loss"].is_meta
    assert c.matmul_flops > 0 and c.peak_bytes > 0
    assert np.isfinite(c.op_bytes)


def test_ring_write_on_meta_keeps_what_an_empty_cache_keeps():
    """A prefill longer than a sliding window's ring: the write reads no
    mask back (it writes the pinned candidates and the last ring, a
    dropped candidate as a second copy of the last entry), so on meta it
    runs as on the card, with or without a costing, assuming nothing, and
    writes what a write from an empty cache keeps (the pinned entries and
    the last ring)."""
    from repro_torch.models.attention import _scatter, ring_slots

    size, n_pinned, n_new = 8, 2, 13
    kept = int((ring_slots(0, n_new, size, n_pinned) < size).sum())
    cache = torch.empty(1, size, 2, 4, device="meta")
    new = torch.empty(1, n_new, 2, 4, device="meta")
    with counting.costing() as c:
        out = _scatter(cache, new, torch.zeros((), dtype=torch.int32,
                                               device="meta"), n_pinned)
    assert out.shape == cache.shape and out.is_meta
    assert c.notes == {}
    # the index_copy_ read the kept rows of `new` and the slots: its bytes
    assert c.op_bytes >= kept * 2 * 4 * 4
    out = _scatter(cache, new, torch.zeros((), dtype=torch.int32,
                                           device="meta"), n_pinned)
    assert out.shape == cache.shape and out.is_meta
    # on real tensors the same write equals the reference's drop rule
    base = torch.randn(1, size, 2, 4)
    vals = torch.randn(1, n_new, 2, 4)
    for cursor in (0, 1, 5):
        slots = ring_slots(cursor, n_new, size, n_pinned)
        keep = slots < size
        want = base.clone().index_copy_(1, slots[keep].long(), vals[:, keep])
        got = _scatter(base.clone(), vals, torch.tensor(cursor,
                                                        dtype=torch.int32),
                       n_pinned)
        assert torch.equal(got, want), cursor
