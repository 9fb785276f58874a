"""Mamba-style selective SSM branch of the Hymba hybrid blocks: the port of
``src/repro/models/ssm.py``.

The reference runs the recurrence (``ssm.py:122-139``) as a nested,
checkpointed ``lax.scan`` over time chunks; here it is one call of
`repro_torch.kernels.ssm_scan.ops.selective_scan` (the kernel on the card,
its plain version on the CPU), for a whole prefill and for each decode step
alike.  The reference's ``chunk`` only bounded its scan's memory; the
function does not depend on it, so it is gone.

The state is ``SSMState(h [B, d_inner, d_state] fp32, conv [B, d_conv - 1,
d_inner])``.  ``delta``, ``B``, ``C`` and the conv output enter the scan in
fp32; ``y`` returns to the compute dtype only before the ``silu(z)`` gate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.models.layers import (
    causal_conv,
    dense_init,
    ones_init,
    zeros_init,
)


def _a_log_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """S4D-real init: A = -[1 .. d_state] per channel, as log(1 .. d_state)
    (stacked [L, ...] too).  The logs are rounded once from float64: XLA's
    CPU log is within 1 ulp of that (it is 1 ulp above at log 7)."""
    del generator
    d_state = t.shape[-1]
    logs = np.log(np.arange(1, d_state + 1, dtype=np.float64))
    with torch.no_grad():
        return t.copy_(torch.from_numpy(logs.astype(np.float32)).expand(
            t.shape))


def _dt_bias_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A bias so that softplus(dt) starts in [1e-3, 1e-1] (the mamba
    reference init): the inverse softplus of a log-uniform draw."""
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32,
                   device=t.device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    with torch.no_grad():
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))


def ssm_params_spec(d_model: int, ssm: SSMConfig, dtype) -> dict:
    d_inner = ssm.expand * d_model
    dt_rank = ssm.dt_rank or -(-d_model // 16)
    return {
        "w_in": ((d_model, 2 * d_inner), dense_init, dtype),
        "conv_w": ((ssm.d_conv, d_inner), dense_init, dtype),
        "conv_b": ((d_inner,), zeros_init, dtype),
        "w_xproj": ((d_inner, dt_rank + 2 * ssm.d_state), dense_init, dtype),
        "w_dt": ((dt_rank, d_inner), dense_init, dtype),
        "dt_bias": ((d_inner,), _dt_bias_init, torch.float32),
        "a_log": ((d_inner, ssm.d_state), _a_log_init, torch.float32),
        "d_skip": ((d_inner,), ones_init, torch.float32),
        "w_out": ((d_inner, d_model), dense_init, dtype),
    }


class SSMState(NamedTuple):
    h: torch.Tensor       # [B, d_inner, d_state] float32
    conv: torch.Tensor    # [B, d_conv - 1, d_inner] trailing conv window

    @staticmethod
    def init(batch: int, d_model: int, ssm: SSMConfig, dtype=torch.float32,
             device="cpu"):
        d_inner = ssm.expand * d_model
        return SSMState(
            h=torch.zeros((batch, d_inner, ssm.d_state), dtype=torch.float32,
                          device=device),
            conv=torch.zeros((batch, ssm.d_conv - 1, d_inner), dtype=dtype,
                             device=device),
        )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold (torch's
    ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dbc(ssm: SSMConfig, dt_rank: int, params: dict, xc: torch.Tensor):
    """delta [.., d_inner], B [.., d_state], C [.., d_state], all fp32 and
    contiguous."""
    proj = xc @ params["w_xproj"].to(xc.dtype)
    dt = proj[..., :dt_rank]
    b = proj[..., dt_rank:dt_rank + ssm.d_state].float().contiguous()
    c = proj[..., dt_rank + ssm.d_state:].float().contiguous()
    delta = softplus((dt @ params["w_dt"].to(xc.dtype)).float()
                     + params["dt_bias"])
    return delta, b, c


def ssm_forward(ssm: SSMConfig, params: dict, x: torch.Tensor,
                state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Selective scan over x [B, T, d_model] from ``state``.  Returns (y
    [B, T, d_model], the final state)."""
    d_model = x.shape[-1]
    dt_rank = ssm.dt_rank or -(-d_model // 16)
    a = -torch.exp(params["a_log"])                  # [d_inner, d_state] f32

    xz = x @ params["w_in"].to(x.dtype)
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_tail = causal_conv(xi, params["conv_w"], params["conv_b"],
                                state.conv)
    xc = F.silu(xc)
    delta, bmat, cmat = _dbc(ssm, dt_rank, params, xc)
    xf = xc.float().contiguous()
    y, h = selective_scan(delta, bmat, cmat, xf, a.contiguous(),
                          state.h.contiguous())
    y = y + params["d_skip"] * xf
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"].to(x.dtype)
    return out, SSMState(h=h, conv=conv_tail)


def ssm_decode_step(ssm: SSMConfig, params: dict, x: torch.Tensor,
                    state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrence.  x [B, 1, d_model] -> (y [B, 1, d_model],
    state)."""
    return ssm_forward(ssm, params, x, state)
