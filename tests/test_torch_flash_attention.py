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
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    flash_attention_ref,
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
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=win, n_meta=meta)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=win,
                               n_meta=meta)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               atol=TOL[dtype])
