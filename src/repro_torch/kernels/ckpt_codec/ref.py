"""Plain PyTorch version of the int8 block codec for the fast checkpoint
tier (the twin of ``src/repro/kernels/ckpt_codec/ref.py``).

The wrapper in ``ops.py`` runs it for CPU tensors, and ``chip_smoke.py``
holds the CUDA kernels against it on the card.  Nothing on the CUDA path
calls it.

The scale is ``max(absmax, 1e-12) * fl32(1/127)``, a multiply by the fp32
reciprocal: that is what the reference's compiled ``quantize_array``
computes (XLA rewrites the division by the constant), and the port is
held to the compiled function bit for bit.  The reference's eager oracle
divides, which differs by one ulp in a few percent of rows.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LANE = 128
#: fl32(1/127), the reciprocal XLA multiplies by
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_ref(x: torch.Tensor):
    """x [R, 128] -> (int8 [R, 128], fp32 scales [R])."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp(min=1e-12) * INV_127.to(xf.device)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """int8 [R, 128] and fp32 [R] -> ``q * scale`` in ``out_dtype``."""
    return (q.to(torch.float32) * scales[:, None]).to(out_dtype)


def quantize_array_ref(x: torch.Tensor):
    """Any-shape tensor -> `quantize_ref` of its flat fp32 values padded
    with zeros to ``[ceil(n / 128), 128]``, as the reference pads."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    return quantize_ref(F.pad(flat, (0, -n % LANE)).view(-1, LANE))


def dequantize_array_ref(q: torch.Tensor, scales: torch.Tensor, shape,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The first ``prod(shape)`` values of `dequantize_ref`, in ``shape``."""
    n = math.prod(shape)
    return dequantize_ref(q, scales, out_dtype).reshape(-1)[:n].reshape(shape)
