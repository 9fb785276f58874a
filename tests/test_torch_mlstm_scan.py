"""The port's chunkwise mLSTM against the JAX reference: the plain version
(what a CPU tensor runs) against the Pallas kernel in interpret mode and
against the sequential jnp oracle, on the reference's cases (ragged S
included), and from a carried state against the reference model's chunk
function looped over padded chunks; the wrapper's contract, the state's
included; the kernel against its plain version on the card, from the zero
and from a carried state (marked ``cuda``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models.xlstm import _mlstm_chunk as jax_mlstm_chunk  # noqa: E402

from repro.kernels.mlstm_scan.ops import (  # noqa: E402
    mlstm_chunked as jax_mlstm_chunked,
)
from repro.kernels.mlstm_scan.ops import (  # noqa: E402
    mlstm_reference as jax_mlstm_reference,
)
from repro_torch.kernels.mlstm_scan import ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    NEG_BIG,
    mlstm_chunk,
    mlstm_scan_ref,
    zero_state,
)

# tests/test_kernels.py's cases (BH, S, dh, chunk), plus xlstm-350m-smoke's
# mLSTM heads (dh 32) over a 12-token prompt
CASES = [(3, 80, 32, 32), (1, 64, 16, 32), (2, 100, 64, 64), (1, 37, 16, 16),
         (4, 12, 32, 256)]
IDS = [f"BH{c[0]}-S{c[1]}-dh{c[2]}-L{c[3]}" for c in CASES]
# the carried-state cases: CASES and a decode step (T = 1, chunk 1)
STATE_CASES = CASES + [(3, 1, 32, 1)]
STATE_IDS = [f"BH{c[0]}-S{c[1]}-dh{c[2]}-L{c[3]}" for c in STATE_CASES]
#: the reference's own bars (tests/test_kernels.py): h, then C, n and m
H_TOL, STATE_TOL = 2e-4, 1e-5


def _inputs(case, seed=0):
    """q, k, v, lf, li as float32 numpy, distributed as the reference test
    draws them (k pre-scaled, forget gates biased open)."""
    bh, s, dh = case[:3]
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    f = normal(bh, s) + 3.0
    lf = -np.log1p(np.exp(-f))                      # log_sigmoid
    return [x.astype(np.float32) for x in (
        normal(bh, s, dh), normal(bh, s, dh) / np.sqrt(dh), normal(bh, s, dh),
        lf, normal(bh, s))]


def _state(bh, dh, seed=9):
    """A carried (C0, n0, m0) as float32 numpy: C and n at a prefill's
    scale, m finite."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((bh, dh, dh)) * 0.3).astype(np.float32),
        (rng.standard_normal((bh, dh)) * 0.3).astype(np.float32),
        rng.uniform(-1.0, 2.0, (bh,)).astype(np.float32))


def _jax_chunks(q, k, v, lf, li, state, chunk):
    """The reference model's chunk function looped over the chunks, with
    its mlstm_forward's padding (src/repro/models/xlstm.py:168-173): h
    [BH, S, dh] and (C, n, m [BH, 1]) as numpy."""
    t = q.shape[1]
    chunk = min(chunk, t)
    pad = -(-t // chunk) * chunk - t
    q, k, v = (np.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (q, k, v))
    lf = np.pad(lf, ((0, 0), (0, pad)))
    li = np.pad(li, ((0, 0), (0, pad)), constant_values=NEG_BIG)
    # [BH, ...] as the reference's [B=1, H=BH, ...]
    carry = tuple(jnp.asarray(a)[None] for a in state)
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        h, carry = jax_mlstm_chunk(
            *(jnp.asarray(a[:, sl])[None] for a in (q, k, v, lf, li)),
            carry)
        hs.append(np.asarray(h[0]))
    c, n, m = (np.asarray(a[0]) for a in carry)
    return np.concatenate(hs, axis=1)[:, :t], (c, n, m[:, None])


def _check(got, want):
    h, (c, n, m) = got
    hw, (cw, nw, mw) = want
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), atol=H_TOL)
    for g, w in ((c, cw), (n, nw), (m, mw)):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STATE_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_matches_jax_kernel_and_oracle(case):
    arrs = _inputs(case)
    chunk = case[3]
    got = ops.mlstm_scan(*map(torch.from_numpy, arrs), chunk=chunk)
    assert all(t.dtype == torch.float32 for t in (got[0], *got[1]))
    jarrs = [jnp.asarray(a) for a in arrs]
    _check(got, jax_mlstm_chunked(*jarrs, chunk=chunk, interpret=True))
    _check(got, jax_mlstm_reference(*jarrs))


@pytest.mark.parametrize("case", STATE_CASES, ids=STATE_IDS)
def test_plain_version_from_a_carried_state_matches_jax(case):
    """mlstm_scan(..., state) against the reference model's chunk loop
    from the same carried state, at the reference's bars."""
    arrs = _inputs(case, seed=3)
    state = _state(case[0], case[2])
    got = ops.mlstm_scan(*map(torch.from_numpy, arrs),
                         tuple(map(torch.from_numpy, state)), chunk=case[3])
    _check(got, _jax_chunks(*arrs, state, case[3]))


@pytest.mark.parametrize("case", STATE_CASES, ids=STATE_IDS)
def test_no_state_is_the_zero_state_bit_for_bit(case):
    arrs = [torch.from_numpy(a) for a in _inputs(case)]
    h, st = ops.mlstm_scan(*arrs, chunk=case[3])
    hz, stz = ops.mlstm_scan(*arrs, zero_state(case[0], case[2], "cpu"),
                             chunk=case[3])
    assert torch.equal(h, hz)
    assert all(torch.equal(a, b) for a, b in zip(st, stz))


def test_wrapper_refuses_a_bad_state():
    """Shape, dtype, contiguity and device of each of C, n and m."""
    arrs = [torch.from_numpy(a) for a in _inputs(CASES[0])]
    good = tuple(torch.from_numpy(a) for a in _state(CASES[0][0],
                                                     CASES[0][2]))
    ops.mlstm_scan(*arrs, good, chunk=32)
    for i in range(3):
        bad = list(good)
        bad[i] = good[i][..., :-1] if good[i].dim() > 1 else good[i][:-1]
        with pytest.raises(ValueError, match="shape"):
            ops.mlstm_scan(*arrs, tuple(bad))
        bad[i] = good[i].double()
        with pytest.raises(TypeError, match="float32"):
            ops.mlstm_scan(*arrs, tuple(bad))
        bad[i] = good[i].to("meta")
        with pytest.raises(ValueError, match="different devices"):
            ops.mlstm_scan(*arrs, tuple(bad))
    bad = list(good)
    bad[0] = good[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_scan(*arrs, tuple(bad))
    bad[1] = good[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_scan(*arrs, (good[0], bad[1], good[2]))
    with pytest.raises(ValueError, match=r"\(C, n, m\)"):
        ops.mlstm_scan(*arrs, good[:2])


def test_chunk_from_a_carried_state_continues_the_scan():
    """The chunk function from the first half's state gives the second
    half of a one-shot scan."""
    q, k, v, lf, li = map(torch.from_numpy, _inputs(CASES[2], seed=1))
    h, (c, n, m) = mlstm_scan_ref(q, k, v, lf, li, chunk=64)
    _, (c1, n1, m1) = mlstm_scan_ref(q[:, :64], k[:, :64], v[:, :64],
                                     lf[:, :64], li[:, :64], chunk=64)
    h2, (c2, n2, m2) = mlstm_chunk(q[:, 64:], k[:, 64:], v[:, 64:],
                                   lf[:, 64:], li[:, 64:], (c1, n1, m1[:, 0]))
    np.testing.assert_allclose(h2.numpy(), h[:, 64:].numpy(), atol=H_TOL)
    for g, w in ((c2, c), (n2, n), (m2[:, None], m)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=STATE_TOL)
    assert float(m1.min()) > NEG_BIG


def test_wrapper_contract_raises_without_a_card():
    """Each check is reached on the CPU, so a wrapper that silently took
    the plain version for an input the kernel refuses would fail here."""
    arrs = [torch.from_numpy(a) for a in _inputs(CASES[3])]
    before = ops.LAUNCHES
    ops.mlstm_scan(*arrs, chunk=16)
    assert ops.LAUNCHES == before                # the CPU launches nothing
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.mlstm_scan(*(a.to("meta") for a in arrs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops._launch(*arrs, 16)
    for i in range(len(arrs)):
        wrong = list(arrs)
        wrong[i] = arrs[i].to(torch.bfloat16)
        with pytest.raises(TypeError, match="float32"):
            ops.mlstm_scan(*wrong)
    strided = list(arrs)
    strided[1] = arrs[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mlstm_scan(*strided)
    with pytest.raises(ValueError, match="shape"):
        ops.mlstm_scan(*arrs[:3], arrs[3][:, :5], arrs[4])


def _on_card(arrs, state, chunk):
    """The kernel and the plain version on the same card tensors, compared
    on the host at the reference's bars; one launch."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = [torch.from_numpy(a).cuda() for a in arrs]
    state = (None if state is None
             else tuple(torch.from_numpy(a).cuda() for a in state))
    before = ops.LAUNCHES
    got = ops.mlstm_scan(*arrs, state, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = mlstm_scan_ref(*arrs, state, chunk=chunk)
    _check((got[0].cpu(), tuple(t.cpu() for t in got[1])),
           (want[0].cpu().numpy(), tuple(t.cpu().numpy() for t in want[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATE_CASES + [(2, 300, 64, 256),
                                                (1, 1, 512, 256),
                                                (2, 70, 33, 16)],
                         ids=STATE_IDS + ["BH2-S300-dh64-L256",
                                          "BH1-S1-dh512-L256",
                                          "BH2-S70-dh33-L16"])
def test_cuda_kernel_from_a_carried_state_on_card(case):
    """Carried states at T = 1 and at ragged T, and a head dim that is
    not a multiple of 4."""
    _on_card(_inputs(case, seed=4), _state(case[0], case[2], seed=6),
             case[3])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrs = [torch.from_numpy(a).cuda() for a in _inputs(case)]
    before = ops.LAUNCHES
    got = ops.mlstm_scan(*arrs, chunk=case[3])
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = mlstm_scan_ref(*arrs, chunk=case[3])
    _check(tuple([got[0].cpu(), tuple(t.cpu() for t in got[1])]),
           (want[0].cpu().numpy(), tuple(t.cpu().numpy() for t in want[1])))
