"""The port's int8 block checkpoint codec (`repro_torch.kernels.ckpt_codec`)
against the JAX reference: on CPU tensors the wrapper runs the plain
version, which must equal the reference's compiled `quantize_array` /
`dequantize_array` (the Pallas kernels in interpret mode) bit for bit —
codes, scales, and fp32 and bf16 round trips — and keep the round trip
within the reference's error bounds; the CUDA kernels equal the plain
version on a Hopper card (skipped elsewhere)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ckpt_codec import ops as jops  # noqa: E402
from repro.kernels.ckpt_codec.ref import quantize_ref as jquantize_ref  # noqa: E402
from repro_torch.kernels.ckpt_codec import ops  # noqa: E402
from repro_torch.kernels.ckpt_codec.ref import (  # noqa: E402
    LANE,
    dequantize_array_ref,
    dequantize_ref,
    quantize_array_ref,
    quantize_ref,
)

# tests/test_kernels.py's codec shapes, plus the one-element and
# one-past-a-row tails
SHAPES = [(1000, 33), (128,), (7, 5, 9), (2048, 128), (1,), (129,)]


def _normal(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 3.0
            ).astype(np.float32)


def _halfway_rows():
    """An all-zero row (the 1e-12 floor) and rows whose codes are exact
    half-way cases: an absmax of 127 * 2^m makes the compiled scale
    exactly 2^m (127 * fl32(1/127) rounds to 1), so (k + 0.5) * 2^m
    divides to k + 0.5, which must round to even."""
    rows = [np.zeros(LANE, np.float32)]
    for m in (-20, -3, 0, 5):
        assert (np.float32(127 * 2.0**m) * np.float32(1 / 127)
                == np.float32(2.0**m))
        for ks in (np.arange(-126, 1), np.arange(0, 127)):
            rows.append(np.concatenate([[127.0], ks + 0.5]) * 2.0**m)
    return np.stack(rows).astype(np.float32)


CASES = {f"{shape}": (lambda s=shape: _normal(s)) for shape in SHAPES}
CASES["zero_and_halfway_rows"] = _halfway_rows
CASES["halfway_rows_in_data"] = lambda: np.concatenate(
    [_halfway_rows().reshape(-1), _normal((3000,), seed=1)])


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else
                  {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_equals_compiled_reference_bit_for_bit(case, dtype):
    x = CASES[case]()
    q, s = ops.quantize_array(torch.from_numpy(x))
    jq, js = jops.quantize_array(jnp.asarray(x), interpret=True)
    assert q.shape == jq.shape and s.shape == js.shape
    assert (q.numpy() == np.asarray(jq)).all()
    assert (_bits(s.numpy()) == _bits(np.asarray(js))).all()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y = ops.dequantize_array(q, s, shape=x.shape, dtype=tdt)
    jy = jops.dequantize_array(jq, js, shape=x.shape, dtype=jdt,
                               interpret=True)
    assert y.dtype == tdt and tuple(y.shape) == x.shape
    assert (_torch_bits(y) == _bits(np.asarray(jy))).all()


@pytest.mark.parametrize("case", ["(2048, 128)", "(7, 5, 9)",
                                  "zero_and_halfway_rows"])
def test_codes_equal_eager_reference(case):
    """The eager oracle divides by 127 where the compiled path multiplies
    by fl32(1/127); its scales may differ by an ulp, its codes did not on
    these inputs.  If they ever do, the compiled path is the reference."""
    x = CASES[case]()
    flat = np.pad(x.reshape(-1), (0, -x.size % LANE)).reshape(-1, LANE)
    q, _ = ops.quantize_array(torch.from_numpy(x))
    jq, _ = jquantize_ref(jnp.asarray(flat))
    assert (q.numpy() == np.asarray(jq)).all()


@pytest.mark.parametrize("shape", [(1000, 33), (128,), (7, 5, 9),
                                   (2048, 128)])
def test_roundtrip_error_bounds(shape):
    x = torch.from_numpy(_normal(shape, seed=2))
    q, s = ops.quantize_array(x)
    y = ops.dequantize_array(q, s, shape=shape)
    # per-block absmax int8: error <= scale/2 <= absmax/254
    assert float((y - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6
    assert ops.roundtrip_error(x) < 1e-2


def test_zero_row_takes_the_floor_scale():
    q, s = ops.quantize_array(torch.zeros(3 * LANE))
    assert (q == 0).all()
    floor = np.float32(1e-12) * np.float32(1 / 127)
    assert (s.numpy() == floor).all()


def test_block_api_equals_plain_version():
    x = torch.from_numpy(_normal((64, LANE), seed=3))
    q, s = ops.quantize_blocks(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    y = ops.dequantize_blocks(q, s, out_dtype=torch.bfloat16)
    assert torch.equal(y, dequantize_ref(q, s, torch.bfloat16))
    with pytest.raises(ValueError, match="must be"):
        ops.quantize_blocks(x.view(-1))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = dict(ops.LAUNCHES)
    x = torch.from_numpy(_normal((300,), seed=4))
    q, s = ops.quantize_array(x)
    ops.dequantize_array(q, s, shape=x.shape)
    ops.roundtrip_error(x)
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.quantize_array(torch.empty(256, device="meta"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_version_on_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    for name in sorted(CASES):
        x = torch.from_numpy(CASES[name]()).cuda()
        q, s = ops.quantize_array(x)
        qr, sr = quantize_array_ref(x)
        assert torch.equal(q, qr) and torch.equal(s, sr), name
        for dtype in (torch.float32, torch.bfloat16):
            y = ops.dequantize_array(q, s, shape=x.shape, dtype=dtype)
            yr = dequantize_array_ref(q, s, x.shape, dtype)
            torch.cuda.synchronize()
            assert torch.equal(y, yr), (name, dtype)
