"""The port's flash attention against the JAX reference: the plain version
(what a CPU tensor runs) against the Pallas kernel in interpret mode and
against the jnp oracle, on the reference's own cases; the kernel against
its plain version on the card (marked ``cuda``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention,
)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_reference as jax_flash_reference,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_attention_ref,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    flash_attention_ref,
    visible,
)

# tests/test_kernels.py::FLASH_CASES, plus the smoke configs' head dim 8
# B, S, H, KVH, D, causal, window, meta, bq, bk, dtype
FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0, 0, 64, 64, "float32"),
    (1, 200, 4, 4, 32, True, 0, 0, 64, 64, "float32"),
    (2, 256, 8, 2, 64, False, 0, 0, 128, 128, "float32"),
    (1, 256, 4, 1, 64, True, 64, 16, 64, 64, "float32"),
    (1, 72, 2, 2, 16, True, 0, 0, 64, 64, "float32"),
    (2, 96, 4, 2, 128, True, 48, 8, 32, 32, "float32"),
    (1, 128, 4, 2, 64, True, 0, 0, 64, 64, "bfloat16"),
    (2, 12, 4, 2, 8, True, 0, 0, 64, 64, "float32"),
]
#: the reference's own bar (tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
IDS = [f"B{c[0]}-S{c[1]}-H{c[2]}x{c[3]}-D{c[4]}-{'c' if c[5] else 'nc'}"
       f"-w{c[6]}-m{c[7]}-{c[10]}" for c in FLASH_CASES]


def _inputs(case, seed=0):
    """q, k, v as numpy float32, rounded to the case's dtype."""
    b, s, h, kvh, d = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]
    if case[10] == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_plain_version_matches_jax_kernel_and_oracle(case):
    _, _, _, _, _, causal, win, meta, bq, bk, dtype = case
    q, k, v = _inputs(case)
    got = ops.flash_attention(_torch(q, dtype), _torch(k, dtype),
                              _torch(v, dtype), causal=causal, window=win,
                              n_meta=meta)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == q.shape
    kw = dict(causal=causal, window=win, n_meta=meta)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    kernel = jax_flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                 interpret=True, **kw)
    oracle = jax_flash_reference(jq, jk, jv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TOL[dtype])


def test_kernel_layout_oracle_matches_model_layout():
    """`attention_ref` over [B*H, S, D] is the same function as the model
    layout's `flash_attention_ref`, with ragged Sq != Skv (top-left)."""
    rng = np.random.default_rng(3)
    b, sq, skv, h, kvh, d = 2, 40, 72, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, skv, kvh, d)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, kvh, d)).astype(
        np.float32))
    got = flash_attention_ref(q, k, v, causal=True)
    flat = attention_ref(q.transpose(1, 2).reshape(b * h, sq, d),
                         k.transpose(1, 2).reshape(b * kvh, skv, d),
                         v.transpose(1, 2).reshape(b * kvh, skv, d),
                         group=h // kvh, causal=True)
    torch.testing.assert_close(got, flat.reshape(b, h, sq, d).transpose(1, 2),
                               rtol=0, atol=0)
    flat_in = (jnp.asarray(x.transpose(1, 2).reshape(-1, x.shape[1], d)
                           .numpy()) for x in (q, k, v))
    want = jax_attention_ref(*flat_in, group=h // kvh, causal=True)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_checks_and_cpu_path_launches_nothing():
    before = ops.LAUNCHES
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, k, k)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.zeros(1, 8, 3, 16), k, k)
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.flash_attention(q, k, k.to(torch.bfloat16))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, _, _, _, causal, win, meta, _, _, dtype = case
    q, k, v = (_torch(a, dtype).cuda() for a in _inputs(case))
    before = (ops.LAUNCHES, ops.WGMMA_LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, window=win, n_meta=meta)
    torch.cuda.synchronize()
    tc = ops.kernel_route(q) == "wgmma"
    assert (ops.LAUNCHES, ops.WGMMA_LAUNCHES) == (
        before[0] + (not tc), before[1] + tc)
    want = flash_attention_ref(q, k, v, causal=causal, window=win,
                               n_meta=meta)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               atol=TOL[dtype])


# -- the two kernels on the card: dispatch, refusals, the hi/lo split -----

ROUTE_CASES = [("bfloat16", 16, "wgmma"), ("bfloat16", 64, "wgmma"),
               ("bfloat16", 128, "wgmma"), ("bfloat16", 8, "simt"),
               ("bfloat16", 40, "simt"), ("float32", 64, "simt"),
               ("float32", 128, "simt")]


@pytest.mark.parametrize("dtype,d,route", ROUTE_CASES,
                         ids=[f"{c[0]}-d{c[1]}" for c in ROUTE_CASES])
def test_kernel_route_rule(dtype, d, route):
    """bf16 with a head dim that is a multiple of 16 takes the tensor-core
    kernel; everything else the SIMT one."""
    q = torch.empty((1, 4, 2, d), dtype=getattr(torch, dtype), device="meta")
    assert ops.kernel_route(q) == route


class _Calls:
    """Stands in for the library: records each launch function called."""

    def __init__(self, fail=False):
        self.names, self.fail = [], fail

    def __call__(self, x, fn, *args):
        self.names.append(fn)
        if self.fail:
            raise RuntimeError(f"{fn} failed: error 1 (stand-in)")


@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 8),
                                     ("float32", 64)])
def test_dispatch_takes_one_kernel_and_never_falls_back(monkeypatch, dtype,
                                                         d):
    """The kernel the rule names is the one launched, its own count moves,
    and a failed launch raises without trying the other kernel."""
    q = torch.zeros((1, 8, 4, d), dtype=getattr(torch, dtype))
    k = torch.zeros((1, 8, 2, d), dtype=getattr(torch, dtype))
    want = ops.kernel_route(q)
    fn = {"wgmma": "flash_attention_fwd_wgmma_launch",
          "simt": "flash_attention_fwd_launch"}[want]
    moved = (1, 0) if want == "simt" else (0, 1)
    calls = _Calls()
    monkeypatch.setattr(ops, "_call", calls)
    before = (ops.LAUNCHES, ops.WGMMA_LAUNCHES)
    out = ops.launch(q, k, k, want, causal=True)
    assert out.shape == q.shape and calls.names == [fn]
    assert (ops.LAUNCHES - before[0], ops.WGMMA_LAUNCHES - before[1]) == moved
    failing = _Calls(fail=True)
    monkeypatch.setattr(ops, "_call", failing)
    with pytest.raises(RuntimeError, match="stand-in"):
        ops.launch(q, k, k, want, causal=True)
    assert failing.names == [fn]                 # no second kernel tried
    assert (ops.LAUNCHES - before[0], ops.WGMMA_LAUNCHES - before[1]) == moved


def test_tensor_core_kernel_refusals(monkeypatch):
    """The tensor-core kernel, asked for by name, refuses fp32, a head dim
    that is not a multiple of 16, and a tensor that does not start on 16
    bytes, before anything is launched; TMA's stride rule holds for any
    tensor."""
    calls = _Calls()
    monkeypatch.setattr(ops, "_call", calls)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.launch(torch.zeros((1, 8, 4, 64)), kv.float(), kv.float(),
                   "wgmma")
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.launch(torch.zeros((1, 8, 4, 24), dtype=torch.bfloat16),
                   kv[..., :24].contiguous(), kv[..., :24].contiguous(),
                   "wgmma")
    with pytest.raises(ValueError, match="up to 128"):
        ops.launch(torch.zeros((1, 8, 4, 144), dtype=torch.bfloat16),
                   torch.zeros((1, 8, 2, 144), dtype=torch.bfloat16),
                   torch.zeros((1, 8, 2, 144), dtype=torch.bfloat16),
                   "wgmma")
    buf = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(1, 8, 4, 64)          # contiguous, 2 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16 bytes"):
        ops.launch(shifted, kv, kv, "wgmma")
    assert calls.names == []
    # strides of 30 and 10 bytes: not multiples of 16
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        _build.check_tma("x", torch.zeros((2, 3, 5), dtype=torch.bfloat16))
    _build.check_tma("x", torch.zeros((2, 3, 8), dtype=torch.bfloat16))


def split_p_attention(q, k, v, *, group, causal, window, n_meta):
    """A plain model of the tensor-core kernel's arithmetic, over
    [BH, S, d]: fp32 scores of the bf16 inputs, P = exp(s - max) in fp32,
    P·V as P_hi·V + P_lo·V with P_hi = bf16(P) and P_lo = bf16(P - P_hi),
    divided by the fp32 row sum; also returns max |P - P_hi - P_lo| / P
    over the visible entries."""
    d = q.shape[-1]
    kr = k.repeat_interleave(group, dim=0).float()
    vr = v.repeat_interleave(group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr) * d ** -0.5
    vis = visible(q.shape[1], k.shape[1], causal=causal, window=window,
                  n_meta=n_meta)
    s = torch.where(vis[None], s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    out = (torch.einsum("bqk,bkd->bqd", hi, vr)
           + torch.einsum("bqk,bkd->bqd", lo, vr)) / p.sum(-1, keepdim=True)
    rel = ((p - hi - lo).abs() / p.clamp_min(1e-30))[vis.expand_as(p)]
    return out.to(q.dtype), float(rel.max())


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[4] % 16 == 0],
                         ids=[i for c, i in zip(FLASH_CASES, IDS)
                              if c[4] % 16 == 0])
def test_hi_lo_split_of_p_keeps_the_function(case):
    """The split that the tensor-core kernel makes of fp32 P leaves at most
    2^-16 of P out (bf16 keeps 8 bits, the two halves 16 or more), and its
    plain model, on the case's inputs rounded to bf16, agrees with the JAX
    Pallas kernel in interpret mode at the reference's bf16 bar."""
    b, s, h, kvh, d, causal, win, meta, bq, bk, _ = case
    q, k, v = _inputs(case[:10] + ("bfloat16",))
    tq, tk, tv = (_torch(a, "bfloat16") for a in (q, k, v))
    flat = [t.transpose(1, 2).reshape(-1, s, d) for t in (tq, tk, tv)]
    got, rel = split_p_attention(*flat, group=h // kvh, causal=causal,
                                 window=win, n_meta=meta)
    assert rel <= 2.0 ** -16
    got = got.reshape(b, h, s, d).transpose(1, 2)
    kernel = jax_flash_attention(*(_jax(a, "bfloat16") for a in (q, k, v)),
                                 block_q=bq, block_k=bk, interpret=True,
                                 causal=causal, window=win, n_meta=meta)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + [
    (1, 200, 4, 2, 32, True, 0, 0, 0, 0, "bfloat16", 72),
    (2, 40, 4, 2, 16, False, 0, 0, 0, 0, "bfloat16", 72)],
    ids=IDS + ["ragged-200x72", "ragged-40x72"])
def test_cuda_tensor_core_kernel_matches_plain_version(case):
    """The tensor-core kernel, by name, on each case's inputs in bf16 (the
    cases with a head dim it takes), ragged Sq != Skv included."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    if case[4] % 16:
        pytest.skip(f"head dim {case[4]} goes to the SIMT kernel")
    b, s, h, kvh, d, causal, win, meta = case[:8]
    skv = case[11] if len(case) > 11 else s
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16).cuda()
        for shape in ((b, s, h, d), (b, skv, kvh, d), (b, skv, kvh, d)))
    before = ops.WGMMA_LAUNCHES
    got = ops.launch(q, k, v, "wgmma", causal=causal, window=win,
                     n_meta=meta)
    torch.cuda.synchronize()
    assert ops.WGMMA_LAUNCHES == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=win,
                               n_meta=meta)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               atol=TOL["bfloat16"])
