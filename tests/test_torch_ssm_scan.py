"""The port's selective scan against the JAX reference: the plain version
(what a CPU tensor runs) against the Pallas kernel in interpret mode and
against the jnp oracle, on the reference's cases, a decode step from a
nonzero state and the hymba smoke shape; the wrapper's contract; the kernel
against its plain version on the card (marked ``cuda``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssm_scan.ops import (  # noqa: E402
    selective_scan as jax_selective_scan,
)
from repro.kernels.ssm_scan.ops import (  # noqa: E402
    selective_scan_ref as jax_selective_scan_ref,
)
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402

# tests/test_kernels.py's cases (B, S, di, ds, chunk, block_d), a decode
# step (S = 1) from a nonzero state, and hymba-1.5b-smoke's SSM branch
# (d_inner 64, d_state 4) over a 12-token prompt plus 4 meta tokens
CASES = [(2, 100, 64, 8, 32, 32), (1, 64, 32, 16, 16, 32),
         (3, 33, 16, 4, 16, 16), (2, 1, 64, 16, 1, 32),
         (2, 16, 64, 4, 128, 512)]
IDS = [f"B{c[0]}-S{c[1]}-di{c[2]}-ds{c[3]}" for c in CASES]
#: the reference's own bar (tests/test_kernels.py)
TOL = 1e-5


def _inputs(case, seed=0):
    """delta, b, c, x, a, h0 as float32 numpy, distributed as the
    reference test draws them."""
    bsz, s, di, ds = case[:4]
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    delta = np.log1p(np.exp(normal(bsz, s, di))) * 0.1
    a = -np.exp(normal(di, ds) * 0.3)
    return [x.astype(np.float32) for x in (
        delta, normal(bsz, s, ds), normal(bsz, s, ds), normal(bsz, s, di),
        a, normal(bsz, di, ds) * 0.1)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_matches_jax_kernel_and_oracle(case):
    arrs = _inputs(case)
    y, h = ops.selective_scan(*map(torch.from_numpy, arrs))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == arrs[0].shape and h.shape == arrs[5].shape
    chunk, bd = case[4:]
    jarrs = [jnp.asarray(a) for a in arrs]
    yk, hk = jax_selective_scan(*jarrs, chunk=chunk, block_d=bd,
                                interpret=True)
    yr, hr = jax_selective_scan_ref(*jarrs)
    for want_y, want_h in ((yk, hk), (yr, hr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=TOL)


def test_scan_splits_at_any_step():
    """Two scans, the second from the first's final state, are one scan."""
    arrs = [torch.from_numpy(a) for a in _inputs(CASES[0], seed=1)]
    delta, b, c, x, a, h0 = arrs
    y, h = ssm_scan_ref(*arrs)
    y1, h1 = ops.selective_scan(delta[:, :37].contiguous(),
                                b[:, :37].contiguous(), c[:, :37].contiguous(),
                                x[:, :37].contiguous(), a, h0)
    y2, h2 = ops.selective_scan(delta[:, 37:].contiguous(),
                                b[:, 37:].contiguous(), c[:, 37:].contiguous(),
                                x[:, 37:].contiguous(), a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)


def test_wrapper_contract_raises_without_a_card():
    """Each check is reached on the CPU, so a wrapper that silently took
    the plain version for an input the kernel refuses would fail here."""
    arrs = [torch.from_numpy(a) for a in _inputs(CASES[2])]
    before = ops.LAUNCHES
    ops.selective_scan(*arrs)
    assert ops.LAUNCHES == before                # the CPU launches nothing
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.selective_scan(*(a.to("meta") for a in arrs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops._launch(*arrs)
    for i in range(len(arrs)):
        wrong = list(arrs)
        wrong[i] = arrs[i].double()
        with pytest.raises(TypeError, match="float32"):
            ops.selective_scan(*wrong)
    strided = list(arrs)
    strided[0] = arrs[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.selective_scan(*strided)
    with pytest.raises(ValueError, match="shape"):
        ops.selective_scan(*arrs[:4], arrs[4][:, :2], arrs[5])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    arrs = [torch.from_numpy(a).cuda() for a in _inputs(case)]
    before = ops.LAUNCHES
    y, h = ops.selective_scan(*arrs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    yr, hr = ssm_scan_ref(*arrs)
    np.testing.assert_allclose(y.cpu().numpy(), yr.cpu().numpy(), atol=TOL)
    np.testing.assert_allclose(h.cpu().numpy(), hr.cpu().numpy(), atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ds", [4, 8, 16])
@pytest.mark.parametrize("steps", [1, 33, 2176])
def test_cuda_kernel_lanes_over_states_on_card(steps, ds):
    """d_state spread over a channel's lanes (fewer states than lanes
    included), a prefill-long scan and a decode step, at a width that is
    not a multiple of a block's channels; 1e-5 times max(1, max|output|),
    as the serving shapes are held."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    arrs = [torch.from_numpy(a).cuda()
            for a in _inputs((2, steps, 200, ds), seed=steps + ds)]
    y, h = ops.selective_scan(*arrs)
    torch.cuda.synchronize()
    yr, hr = ssm_scan_ref(*arrs)
    for got, want in ((y, yr), (h, hr)):
        bar = TOL * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= bar


def _probe():
    """tools/probe_ssm_lanes.py, loaded as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / \
        "probe_ssm_lanes.py"
    spec = importlib.util.spec_from_file_location("probe_ssm_lanes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", [(4, True), (8, True), (16, True),
                                     (2, True), (4, False)],
                         ids=["G4-ex2", "G8-ex2", "G16-ex2", "G2-ex2",
                              "G4-expf"])
def test_lane_probe_still_rewrites_the_kernel(variant, tmp_path,
                                              monkeypatch):
    """The lane probe writes each of its variants from the kernel's source
    (it raises if the lines it rewrites have changed): the lanes it names,
    the header it includes, and expf in place of ex2.approx where asked."""
    probe = _probe()
    assert variant in probe.VARIANTS
    monkeypatch.setattr(probe, "OUT_DIR", tmp_path)
    lanes, ex2 = variant
    text = probe.variant_source(lanes, ex2).read_text()
    assert f"constexpr int kLanes = {lanes};" in text
    header = text.split('#include "', 2)[1].split('"', 1)[0]
    assert header.endswith("hopper.cuh") and \
        (tmp_path / header).resolve().is_file()
    assert ('asm("ex2.approx' in text) == ex2
    assert ("return expf(dl * a);" in text) == (not ex2)
