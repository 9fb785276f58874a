"""Plain PyTorch version of the selective-scan kernel: a loop over time,
the port of ``src/repro/kernels/ssm_scan/ref.py``.

Per step, in fp32: ``h = exp(delta_t * a) * h + (delta_t * x_t) B_t``
(broadcast over channels and states), ``y_t = h . C_t``.  Returns y in
delta's dtype and the final h in fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssm_scan_ref(delta: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 x: torch.Tensor, a: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, x [B, S, di]; b, c [B, S, ds]; a [di, ds]; h0 [B, di, ds]
    -> (y [B, S, di], h [B, di, ds] fp32)."""
    s = delta.shape[1]
    a = a.float()
    h = h0.float()
    y = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    for t in range(s):
        dl = delta[:, t].float()
        decay = torch.exp(dl[:, :, None] * a)
        h = decay * h + (dl * x[:, t].float())[:, :, None] * b[:, t, None, :]
        y[:, t] = torch.einsum("bds,bs->bd", h, c[:, t].float())
    return y.to(delta.dtype), h
