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

Under a mesh the hybrid stack runs `ssm_forward_tp` (and its train twin
`ssm_forward_train_tp`): the scan on the rank's ``d_inner / TP``
channels, from its part of the state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import collectives as col
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


def _dbc(ssm: SSMConfig, dt_rank: int, params: dict, xc: torch.Tensor,
         total=None):
    """delta [.., d_inner], B [.., d_state], C [.., d_state], all fp32 and
    contiguous.  ``total`` (if given) makes the whole projection from a
    rank's partial one (`ssm_forward_tp`)."""
    proj = xc @ params["w_xproj"].to(xc.dtype)
    if total is not None:
        proj = total(proj)
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


# ---------------------------------------------------------------------------
# Tensor-parallel forms: each rank runs its d_inner / TP channels
# ---------------------------------------------------------------------------


def local_params(params: dict, mesh) -> dict:
    """A layer's SSM weights for this rank's channels ``[r * di / TP, (r +
    1) * di / TP)`` of ``mesh``'s model axis, as the reference's rules
    place them (`distributed.sharding`): ``w_in``'s model box (contiguous
    over its ``2 * d_inner`` columns, so half a rank's xi and z columns
    lie elsewhere: `_scan_inputs_tp` exchanges the products instead),
    ``conv_w``, ``conv_b`` and ``w_dt`` by channel columns, ``w_out`` by
    channel rows; ``w_xproj`` (its output width does not divide the model
    axis), ``a_log`` (placed with d_state over it), ``dt_bias`` and
    ``d_skip`` (replicated) whole, their gradients summed over the model
    axis (`collectives.copy_to_tp`: each rank reads its rows only), and
    cut to the rank's rows."""
    n, r = col.tp_size(mesh), col.tp_rank(mesh)
    di = params["w_out"].shape[-2]
    rows = slice(r * di // n, (r + 1) * di // n)
    out = {k: col.tp_local(params[k], -1, mesh)
           for k in ("w_in", "conv_w", "conv_b", "w_dt")}
    out["w_out"] = col.tp_local(params["w_out"], -2, mesh)
    for k in ("w_xproj", "a_log", "dt_bias", "d_skip"):
        out[k] = col.copy_to_tp(col.full(params[k]), mesh)[rows]
    return out


def _scan_inputs_tp(ssm: SSMConfig, lp: dict, x: torch.Tensor,
                    state: SSMState, mesh):
    """`_scan_inputs` on the rank's channels (``lp``: `local_params`), x
    [B, T, d_model] replicated over the model axis.  The in-projection's
    products on the rank's box of ``w_in`` are all-gathered and the
    rank's xi and z columns cut from them (`collectives.gather_summed`:
    the ranks read different columns, so the gradient is summed and cut);
    the x-projection's partial sums over the rank's channels are summed
    over the model axis in fp32, forward and (as every rank's channels
    read dt, B and C) backward alike."""
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    dt_rank = ssm.dt_rank or -(-x.shape[-1] // 16)
    dl = lp["conv_w"].shape[-1]
    a = -torch.exp(lp["a_log"])                      # [dl, d_state] f32
    xz = col.gather_summed(col.copy_to_tp(x, mesh)
                           @ lp["w_in"].to(x.dtype), grp, -1)
    xi = xz.narrow(-1, r * dl, dl)
    z = xz.narrow(-1, n * dl + r * dl, dl)
    xc, conv_tail = causal_conv(xi, lp["conv_w"], lp["conv_b"], state.conv)
    xc = F.silu(xc)

    def total(part):
        whole = col.reduce_from_tp(part.float(), mesh).to(part.dtype)
        return col.copy_to_tp(whole, mesh)

    delta, bmat, cmat = _dbc(ssm, dt_rank, lp, xc, total)
    return a, delta, bmat, cmat, xc.float().contiguous(), z, conv_tail


def _reduced_out(lp: dict, x: torch.Tensor, y: torch.Tensor,
                 xf: torch.Tensor, z: torch.Tensor, mesh) -> torch.Tensor:
    """`_ssm_out` on the rank's channels: the row-parallel ``w_out``'s
    partial sums reduced in fp32, rounded to x's dtype once."""
    part = _ssm_out(lp, x, y, xf, z)
    return col.reduce_from_tp(part.float(), mesh).to(x.dtype)


def ssm_forward_tp(ssm: SSMConfig, params: dict, x: torch.Tensor,
                   state: SSMState, mesh) -> Tuple[torch.Tensor, SSMState]:
    """`ssm_forward` over ``mesh``'s model axis: the scan (the kernel on
    the card) on this rank's ``d_inner / TP`` channels from its part of
    the state (h [B, d_inner / TP, d_state], conv [B, d_conv - 1, d_inner
    / TP]).  Returns (y [B, T, d_model], whole on every rank; the rank's
    new state)."""
    lp = local_params(params, mesh)
    a, delta, bmat, cmat, xf, z, conv_tail = _scan_inputs_tp(ssm, lp, x,
                                                             state, mesh)
    y, h = selective_scan(delta, bmat, cmat, xf, a.contiguous(),
                          state.h.contiguous())
    return (_reduced_out(lp, x, y, xf, z, mesh),
            SSMState(h=h, conv=conv_tail))


def ssm_forward_train_tp(ssm: SSMConfig, params: dict, x: torch.Tensor,
                         mesh, *, chunk: int = 128
                         ) -> Tuple[torch.Tensor, SSMState]:
    """`ssm_forward_train` on the rank's channels (`ssm_forward_tp`'s
    split, on the same local-channel weights), from the zero state, with
    autograd and no kernel."""
    lp = local_params(params, mesh)
    b, dl = x.shape[0], lp["conv_w"].shape[-1]
    state = SSMState(
        h=torch.zeros((b, dl, ssm.d_state), dtype=torch.float32,
                      device=x.device),
        conv=torch.zeros((b, ssm.d_conv - 1, dl), dtype=torch.float32,
                         device=x.device))
    a, delta, bmat, cmat, xf, z, conv_tail = _scan_inputs_tp(ssm, lp, x,
                                                             state, mesh)
    h, y = chunked_scan(state.h, a, delta, bmat, cmat, xf, chunk)
    return (_reduced_out(lp, x, y, xf, z, mesh),
            SSMState(h=h, conv=conv_tail))


def ssm_decode_step(ssm: SSMConfig, params: dict, x: torch.Tensor,
                    state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrence.  x [B, 1, d_model] -> (y [B, 1, d_model],
    state)."""
    return ssm_forward(ssm, params, x, state)
