"""The port's grouped expert matmul against the JAX reference: the plain
version (what a CPU tensor runs) against the Pallas kernel in interpret
mode and against the jnp oracle, on the reference's cases; the count-skip
contract; fp32 weights under bf16 x; the wrapper's contract; the kernel
against its plain version on the card (marked ``cuda``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.moe_gmm.kernel import (  # noqa: E402
    grouped_matmul as jax_grouped_matmul,
)
from repro.kernels.moe_gmm.ops import (  # noqa: E402
    expert_swiglu as jax_expert_swiglu,
)
from repro.kernels.moe_gmm.ops import (  # noqa: E402
    expert_swiglu_ref as jax_expert_swiglu_ref,
)
from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    expert_swiglu_ref,
    grouped_matmul_ref,
)

# tests/test_kernels.py's shapes (E, C, d, f)
SHAPES = [(4, 96, 160, 224), (2, 128, 64, 64), (8, 32, 48, 96),
          (1, 256, 512, 128)]
IDS = [f"E{s[0]}-C{s[1]}-d{s[2]}-f{s[3]}" for s in SHAPES]
DTYPES = ["float32", "bfloat16"]
#: the reference's own bars (tests/test_kernels.py)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(shape, seed=0):
    """x, w_gate, w_up, w_down as float32 numpy, scaled as the reference
    test draws them."""
    e, c, d, f = shape
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s, scale in (((e, c, d), 0.3), ((e, d, f), 0.05),
                             ((e, d, f), 0.05), ((e, f, d), 0.05))]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_expert_swiglu_matches_jax_kernel_and_oracle(shape, dtype):
    arrs = _inputs(shape)
    out = ops.expert_swiglu(*_torch(arrs, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == shape[:3]
    jarrs = _jax(arrs, dtype)
    for want in (jax_expert_swiglu(*jarrs, interpret=True),
                 jax_expert_swiglu_ref(*jarrs)):
        np.testing.assert_allclose(_np(out), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_grouped_matmul_matches_jax_kernel(dtype):
    """One product alone, with a ragged row and column tile for the TPU
    kernel's 128-row blocks (C = 96) and 512-column blocks (f = 224)."""
    x, w, _, _ = _inputs(SHAPES[0], seed=1)
    got = ops.grouped_matmul(*_torch([x, w], dtype))
    want = jax_grouped_matmul(*_jax([x, w], dtype), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


def test_counts_skip_rows_past_each_count():
    """Zero rows in, zero rows out: with x zero past each expert's count
    (as the capacity dispatch fills it), the counted product equals the
    uncounted one exactly; with anything else there, those rows still come
    out zero."""
    e, c, d, f = SHAPES[0]
    x, w, wu, wd = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=2))
    counts = torch.tensor([0, 1, 65, c], dtype=torch.int32)
    past = torch.arange(c)[None, :] >= counts[:, None]
    zeroed = x.masked_fill(past[..., None], 0.0)
    torch.testing.assert_close(ops.grouped_matmul(zeroed, w, counts),
                               ops.grouped_matmul(zeroed, w), rtol=0, atol=0)
    got = ops.grouped_matmul(x, w, counts)
    assert bool((got[past] == 0).all())
    torch.testing.assert_close(got[~past], ops.grouped_matmul(x, w)[~past],
                               rtol=0, atol=0)
    swi = ops.expert_swiglu(zeroed, w, wu, wd, counts)
    assert bool((swi[past] == 0).all())
    torch.testing.assert_close(swi, ops.expert_swiglu(zeroed, w, wu, wd),
                               rtol=0, atol=0)


def test_fp32_weights_under_bf16_x_round_as_the_reference_casts():
    x, w, wu, wd = _inputs(SHAPES[2], seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w32 = torch.from_numpy(w)
    got = ops.grouped_matmul(xb, w32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ops.grouped_matmul(
        xb, w32.to(torch.bfloat16)), rtol=0, atol=0)
    want = jax_grouped_matmul(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(w).astype(jnp.bfloat16),
                              interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL["bfloat16"])
    ws = [torch.from_numpy(a) for a in (w, wu, wd)]
    torch.testing.assert_close(
        ops.expert_swiglu(xb, *ws),
        expert_swiglu_ref(xb, *(a.to(torch.bfloat16) for a in ws)),
        rtol=0, atol=0)


def test_wrapper_contract_raises_without_a_card():
    """Each check is reached on the CPU, so a wrapper that silently took
    the plain version for an input the kernel refuses would fail here."""
    x, w, _, _ = (torch.from_numpy(a) for a in _inputs(SHAPES[1]))
    counts = torch.tensor([3, 128], dtype=torch.int32)
    before = ops.LAUNCHES
    ops.grouped_matmul(x, w, counts)
    assert ops.LAUNCHES == before                # the CPU launches nothing
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.grouped_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.grouped_matmul(x, w.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.launch(x, w, counts, "simt")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.grouped_matmul(x.double(), w.double())
    with pytest.raises(TypeError, match="w has dtype"):
        ops.grouped_matmul(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="int32"):
        ops.grouped_matmul(x, w, counts.long())
    with pytest.raises(ValueError, match="expected"):
        ops.grouped_matmul(x[0], w[0])
    with pytest.raises(ValueError, match="differ"):
        ops.grouped_matmul(x, w[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        ops.grouped_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="outside"):
        ops.grouped_matmul(x, w, torch.tensor([3, 129], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        ops.grouped_matmul(x, w, torch.tensor([-1, 0], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cuda_kernel_matches_plain_version_on_card(shape, dtype):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    arrs = [a.cuda() for a in _torch(_inputs(shape), dtype)]
    e, c = shape[:2]
    counts = torch.tensor([c // (i + 2) for i in range(e)], dtype=torch.int32,
                          device="cuda")
    before = (ops.LAUNCHES, ops.WGMMA_LAUNCHES)
    for cnt in (None, counts):
        out = ops.expert_swiglu(*arrs, counts=cnt)
        torch.cuda.synchronize()
        want = expert_swiglu_ref(*arrs, counts=cnt)
        np.testing.assert_allclose(_np(out.cpu()), _np(want.cpu()),
                                   atol=TOL[dtype])
    tc = ops.kernel_route(arrs[0], arrs[1]) == "wgmma"
    assert (ops.LAUNCHES, ops.WGMMA_LAUNCHES) == (
        before[0] + (0 if tc else 6), before[1] + (6 if tc else 0))
    if dtype == "bfloat16":                      # fp32 weights under bf16 x
        w32 = torch.from_numpy(_inputs(shape)[1]).cuda()
        got = ops.grouped_matmul(arrs[0], w32, counts)
        torch.cuda.synchronize()
        want = grouped_matmul_ref(arrs[0], w32, counts)
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                   atol=TOL[dtype])


# -- the two kernels on the card: dispatch, refusals, the tensor-core one --

ROUTE_CASES = [("bfloat16", "bfloat16", 160, 224, "wgmma"),
               ("bfloat16", "float32", 2048, 1408, "wgmma"),
               ("bfloat16", "bfloat16", 48, 96, "wgmma"),
               ("bfloat16", "bfloat16", 32, 16, "wgmma"),
               ("bfloat16", "bfloat16", 36, 64, "simt"),
               ("bfloat16", "float32", 64, 20, "simt"),
               ("float32", "float32", 64, 64, "simt")]


@pytest.mark.parametrize("xdt,wdt,d,f,route", ROUTE_CASES,
                         ids=[f"{c[0]}-{c[1]}-d{c[2]}-f{c[3]}"
                              for c in ROUTE_CASES])
def test_kernel_route_rule(xdt, wdt, d, f, route):
    """bf16 x with d and f multiples of 8 takes the tensor-core kernel;
    everything else the SIMT one."""
    x = torch.empty((2, 4, d), dtype=getattr(torch, xdt), device="meta")
    w = torch.empty((2, d, f), dtype=getattr(torch, wdt), device="meta")
    assert ops.kernel_route(x, w) == route


class _Calls:
    """Stands in for the library: records each launch function called."""

    def __init__(self, fail=False):
        self.names, self.fail = [], fail

    def __call__(self, x, fn, *args):
        self.names.append(fn)
        if self.fail:
            raise RuntimeError(f"{fn} failed: error 1 (stand-in)")


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "float32")])
def test_dispatch_takes_one_kernel_and_never_falls_back(monkeypatch, xdt,
                                                         wdt):
    """The kernel the rule names is the one launched, its own count moves,
    and a failed launch raises without trying the other kernel."""
    x = torch.zeros((2, 8, 64), dtype=getattr(torch, xdt))
    w = torch.zeros((2, 64, 32), dtype=getattr(torch, wdt))
    want = ops.kernel_route(x, w)
    fn = {"wgmma": "moe_gmm_wgmma_launch", "simt": "moe_gmm_launch"}[want]
    calls = _Calls()
    monkeypatch.setattr(ops, "_call", calls)
    before = (ops.LAUNCHES, ops.WGMMA_LAUNCHES)
    ops.launch(x, w, None, want)
    assert calls.names == [fn]
    assert (ops.LAUNCHES - before[0], ops.WGMMA_LAUNCHES - before[1]) == (
        (1, 0) if want == "simt" else (0, 1))
    failing = _Calls(fail=True)
    monkeypatch.setattr(ops, "_call", failing)
    with pytest.raises(RuntimeError, match="stand-in"):
        ops.launch(x, w, None, want)
    assert failing.names == [fn]                 # no second kernel tried
    assert (ops.LAUNCHES - before[0], ops.WGMMA_LAUNCHES - before[1]) == (
        (1, 0) if want == "simt" else (0, 1))


def test_tensor_core_kernel_refusals(monkeypatch):
    """The tensor-core kernel, asked for by name, refuses fp32 x, widths
    that are not multiples of 8 and a tensor that does not start on 16
    bytes, before anything is launched."""
    calls = _Calls()
    monkeypatch.setattr(ops, "_call", calls)
    w = torch.zeros((2, 64, 32))
    with pytest.raises(TypeError, match="bfloat16 x"):
        ops.launch(torch.zeros((2, 8, 64)), w, None, "wgmma")
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.launch(torch.zeros((2, 8, 60), dtype=torch.bfloat16),
                   torch.zeros((2, 60, 32)), None, "wgmma")
    buf = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(2, 8, 64)             # contiguous, 2 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16 bytes"):
        ops.launch(shifted, w, None, "wgmma")
    with pytest.raises(ValueError, match="route"):
        ops.launch(shifted, w, None, "tensor")
    assert calls.names == []


@pytest.mark.cuda
@pytest.mark.parametrize("wdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_cuda_tensor_core_kernel_matches_plain_version(shape, wdt):
    """The tensor-core kernel, by name, on bf16 x with bf16 or fp32
    weights, with and without counts, at the reference's bf16 bar."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    x, w = (t.cuda() for t in _torch(_inputs(shape)[:2], "bfloat16"))
    w = w.to(getattr(torch, wdt))
    e, c = shape[:2]
    counts = torch.tensor([c // (i + 2) for i in range(e)], dtype=torch.int32,
                          device="cuda")
    before = ops.WGMMA_LAUNCHES
    for cnt in (None, counts):
        got = ops.launch(x, w, cnt, "wgmma")
        torch.cuda.synchronize()
        want = grouped_matmul_ref(x, w, cnt)
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                   atol=TOL["bfloat16"])
    assert ops.WGMMA_LAUNCHES == before + 2
