"""The flash kernels at the shapes that minicpm3-4b, llama-3.2-vision-11b
and whisper-base add, on the card against the plain version (the CPU
tests hold the plain version against JAX): d 96 with Dv 64 (MLA; the
wrapper pads V), non-causal Sq != Skv (cross-attention) and non-causal
square (the encoder), through each kernel that takes them.  Bars: the
reference's kernel-test tolerances, 2e-5 in fp32 and 2e-2 in bf16, and,
scaled to the output (a mean over many keys is small), the RMS of the
difference within 2e-5 (fp32) and 2^-9 (bf16) of the output's RMS, the
bars of `chip_smoke.py`'s `ATTN_REL_RMS`.  The
non-causal shapes run again with V zero but on the keys past the last
64-key tile, so a kernel that drops that tail returns zeros."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)

SHAPES = [  # B, Sq, Skv, H, KVH, Dk, Dv, causal
    (2, 300, 300, 4, 4, 96, 64, True),
    (2, 200, 650, 8, 2, 128, 128, False),
    (1, 150, 150, 4, 4, 64, 64, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_new_flash_shapes_on_card_match_the_plain_version(shape):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    b, sq, skv, h, kvh, dk, dv, causal = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, routes, tol, rel_tol in (
            (torch.float32, ("simt",), 2e-5, 2e-5),
            (torch.bfloat16, ("simt", "wgmma"), 2e-2, 2.0 ** -9)):
        q = torch.randn((b, sq, h, dk), generator=gen, device="cuda")
        k = torch.randn((b, skv, kvh, dk), generator=gen, device="cuda")
        v = torch.randn((b, skv, kvh, dv), generator=gen, device="cuda")
        q, k, v = (x.to(dtype) for x in (q, k, v))
        tail_v = v.clone()
        tail_v[:, :skv - skv % 64] = 0
        for vv in ((v, tail_v) if not causal and skv % 64 else (v,)):
            want = flash_attention_ref(q, k, vv, causal=causal).float()
            for route in routes:
                got = flash_ops.launch(q, k, vv, route,
                                       causal=causal).float()
                assert got.shape == want.shape
                assert float((got - want).abs().max()) <= tol
                rel = (got - want).pow(2).mean().sqrt() \
                    / want.pow(2).mean().sqrt()
                assert float(rel) <= rel_tol
