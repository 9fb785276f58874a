"""Plain PyTorch version of the grouped expert matmul, the port of
``src/repro/kernels/moe_gmm/ref.py`` and of ``ops.py:31
expert_swiglu_ref``.

``out[e] = x[e] @ w[e]`` for x ``[E, C, d]`` and w ``[E, d, f]``: w rounded
to x's dtype (the reference's ``w.astype(x.dtype)``), products and sums in
fp32, the result cast to x's dtype.  With per-expert ``counts`` [E], the
rows at or past ``counts[e]`` of expert e are zero in the output (the
capacity dispatch zero-fills those rows of x, so this is the same function
on its inputs).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [E, C, d], w [E, d, f] (x's dtype, or fp32) -> [E, C, f] in x's
    dtype."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.to(x.dtype).float())
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        past = rows[None, :] >= counts[:, None].to(x.device)
        out = out.masked_fill_(past[..., None], 0.0)
    return out.to(x.dtype)


def swiglu_gate(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in the inputs' dtype, computed into ``gate``'s
    storage (the capacity buffers are large; nothing else reads ``gate``)."""
    return F.silu(gate, inplace=True).mul_(up)


def expert_swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``down(silu(gate) * up)`` over capacity buffers x [E, C, d] with
    w_gate, w_up [E, d, f] and w_down [E, f, d] -> [E, C, d] in x's
    dtype."""
    h = swiglu_gate(grouped_matmul_ref(x, w_gate, counts),
                    grouped_matmul_ref(x, w_up, counts))
    return grouped_matmul_ref(h, w_down, counts)
