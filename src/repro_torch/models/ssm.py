"""Mamba-style selective SSM branch of the Hymba hybrid blocks: the port of
``src/repro/models/ssm.py``.

The reference runs the recurrence (``ssm.py:122-139``) as a nested,
checkpointed ``lax.scan`` over time chunks; here it is one call of
`repro_torch.kernels.ssm_scan.ops.selective_scan` (the kernel on the card,
its plain version on the CPU), for a whole prefill and for each decode step
alike.  The reference's ``chunk`` only bounded its scan's memory; the
function does not depend on it, so it is gone.

Training (`ssm_forward_train`) cannot use the kernel, which is forward
only: it runs the reference's recurrence in plain torch with autograd,
128 steps a chunk, each chunk under ``torch.utils.checkpoint`` (the
reference's ``@jax.checkpoint chunk_body``), so that backward keeps one
chunk's ``[B, chunk, d_inner, d_state]`` states at a time.  It is a loop
of one op a step in forward (``addcmul``) and a few in backward, and costs
the card far more host time than work (ROADMAP Queue 3).

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
from torch.utils.checkpoint import checkpoint

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


def _scan_inputs(ssm: SSMConfig, params: dict, x: torch.Tensor,
                 state: SSMState):
    """The scan's inputs from x [B, T, d_model]: a [d_inner, d_state],
    delta, B, C and the conv output (fp32), the gate z and the new conv
    window."""
    d_model = x.shape[-1]
    dt_rank = ssm.dt_rank or -(-d_model // 16)
    a = -torch.exp(params["a_log"])                  # [d_inner, d_state] f32
    xz = x @ params["w_in"].to(x.dtype)
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_tail = causal_conv(xi, params["conv_w"], params["conv_b"],
                                state.conv)
    xc = F.silu(xc)
    delta, bmat, cmat = _dbc(ssm, dt_rank, params, xc)
    return a, delta, bmat, cmat, xc.float().contiguous(), z, conv_tail


def _ssm_out(params: dict, x: torch.Tensor, y: torch.Tensor,
             xf: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y + params["d_skip"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["w_out"].to(x.dtype)


def ssm_forward(ssm: SSMConfig, params: dict, x: torch.Tensor,
                state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """Selective scan over x [B, T, d_model] from ``state``.  Returns (y
    [B, T, d_model], the final state)."""
    a, delta, bmat, cmat, xf, z, conv_tail = _scan_inputs(ssm, params, x,
                                                          state)
    y, h = selective_scan(delta, bmat, cmat, xf, a.contiguous(),
                          state.h.contiguous())
    return _ssm_out(params, x, y, xf, z), SSMState(h=h, conv=conv_tail)


def _scan_chunk(h: torch.Tensor, a: torch.Tensor, delta: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, xf: torch.Tensor):
    """The reference's ``step`` over one chunk: h [B, di, ds] and delta,
    xf [B, L, di], B, C [B, L, ds] -> (h after the chunk, y [B, L, di]).
    The decays and inputs of the chunk are formed at once; the loop is
    ``h = decay * h + delta x B`` a step."""
    decay = torch.exp(delta[..., None] * a)          # [B, L, di, ds]
    drive = (delta * xf)[..., None] * bmat[:, :, None, :]
    hs = []
    for dec, inp in zip(decay.unbind(1), drive.unbind(1)):
        h = torch.addcmul(inp, dec, h)
        hs.append(h)
    y = (torch.stack(hs, dim=1) * cmat[:, :, None, :]).sum(-1)
    return h, y


def chunked_scan(h: torch.Tensor, a: torch.Tensor, delta: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, xf: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_scan_chunk` over [B, T, ...] inputs, ``chunk`` steps at a time,
    each under ``torch.utils.checkpoint``: (h after T steps, y [B, T,
    di])."""
    ys = []
    for lo in range(0, delta.shape[1], chunk):
        sl = slice(lo, lo + chunk)
        h, y = checkpoint(_scan_chunk, h, a, delta[:, sl], bmat[:, sl],
                          cmat[:, sl], xf[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


def ssm_forward_train(ssm: SSMConfig, params: dict, x: torch.Tensor, *,
                      chunk: int = 128) -> Tuple[torch.Tensor, SSMState]:
    """`ssm_forward`'s train form from the zero state, with autograd and
    no kernel: the reference's nested scan (``src/repro/models/ssm.py:
    122-142``), ``chunk`` steps a chunk, each under ``torch.utils.
    checkpoint``; the ragged tail runs as a shorter chunk (the reference
    pads it with delta = 0 steps, which leave the state as it was).  x
    [B, T, d_model] -> (y [B, T, d_model], the final state)."""
    b, _, d_model = x.shape
    state = SSMState.init(b, d_model, ssm, device=x.device)
    a, delta, bmat, cmat, xf, z, conv_tail = _scan_inputs(ssm, params, x,
                                                          state)
    h, y = chunked_scan(state.h, a, delta, bmat, cmat, xf, chunk)
    return _ssm_out(params, x, y, xf, z), SSMState(h=h, conv=conv_tail)


def ssm_decode_step(ssm: SSMConfig, params: dict, x: torch.Tensor,
                    state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrence.  x [B, 1, d_model] -> (y [B, 1, d_model],
    state)."""
    return ssm_forward(ssm, params, x, state)
