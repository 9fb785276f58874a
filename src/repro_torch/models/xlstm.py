"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory): the port
of ``src/repro/models/xlstm.py``.

* **mLSTM** runs in chunked-parallel form (the reference's
  ``_mlstm_chunk`` is ``kernels/mlstm_scan/ref.mlstm_chunk``, its chunk
  loop ``ref.mlstm_chunks``) through one route:
  `repro_torch.kernels.mlstm_scan.ops.mlstm_scan` from the block's carried
  state, for every T (a prefill into a fresh cache or onto a carried
  state, and every decode step), one launch per mLSTM block on the card
  and its plain version on the CPU.  q, k and v go to it upcast to fp32
  (exact for bf16), so that h comes back in fp32, where the reference
  keeps it until after the per-head norm.
* **sLSTM** reads h_{t-1} in its gates, so it has no parallel form and no
  TPU kernel: a plain loop over tokens (the reference's nested scan).
* **Training** reaches no kernel (the mLSTM kernel has no backward):
  `mlstm_forward_train` runs the plain ``mlstm_chunk`` and
  `slstm_forward_train` the same sLSTM loop, with autograd, each chunk
  under ``torch.utils.checkpoint``, and ``xlstm_stack_apply(mode=
  "train")`` checkpoints each pair, as the reference's ``remat`` does.

* **Under a mesh** (``xlstm_stack_apply(mesh=)``) each block runs on the
  rank's ``H / TP`` heads where the model axis divides them: the mLSTM's
  scan on the rank's heads (`mlstm_forward_tp`), the sLSTM's input
  products, norm and FFN split and its recurrence whole on every rank
  (`slstm_forward_tp` says why); elsewhere whole blocks from gathered
  weights.

States are NamedTuples of the reference's names and fields; the stacked
``XLSTMStackState`` of a model cache holds ``[P, ...]`` tensors that
``xlstm_stack_apply`` writes in place, pair by pair.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import XLSTMConfig
from repro_torch.distributed import collectives as col
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import NEG_BIG, mlstm_chunk, pad_chunks
from repro_torch.models.layers import (
    causal_conv,
    dense_init,
    ones_init,
    rms_norm,
    zeros_init,
)

def _linspace_3_6(n: int) -> torch.Tensor:
    """linspace(3, 6, n) in fp32, rounded once from float64.  jnp.linspace
    on the CPU is within 1 ulp of it: XLA rewrites its division into a
    product by 1/(n-1) and contracts into FMAs differently in the
    vectorised body and the tail."""
    return torch.from_numpy(np.linspace(3.0, 6.0, n).astype(np.float32))


def _fgate_bias_init(t: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Positive forget-gate bias, linspace 3..6 over the last axis (the
    xLSTM reference init)."""
    del generator
    with torch.no_grad():
        return t.copy_(_linspace_3_6(t.shape[-1]).expand(t.shape))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_params_spec(d_model: int, n_heads: int, xl: XLSTMConfig,
                      dtype) -> dict:
    di = int(xl.proj_factor_mlstm * d_model)
    return {
        "norm": ((d_model,), ones_init, torch.float32),
        "w_up": ((d_model, 2 * di), dense_init, dtype),
        "conv_w": ((xl.conv_width, di), dense_init, dtype),
        "conv_b": ((di,), zeros_init, dtype),
        "w_q": ((di, di), dense_init, dtype),
        "w_k": ((di, di), dense_init, dtype),
        "w_v": ((di, di), dense_init, dtype),
        "w_i": ((di, n_heads), dense_init, torch.float32),
        "b_i": ((n_heads,), zeros_init, torch.float32),
        "w_f": ((di, n_heads), dense_init, torch.float32),
        "b_f": ((n_heads,), _fgate_bias_init, torch.float32),
        "gn": ((di,), ones_init, torch.float32),
        "w_down": ((di, d_model), dense_init, dtype),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor      # [B, H, dh, dh] f32 matrix memory
    n: torch.Tensor      # [B, H, dh] f32 normaliser
    m: torch.Tensor      # [B, H] f32 max-stabiliser
    conv: torch.Tensor   # [B, W-1, di] conv window

    @staticmethod
    def init(batch, d_model, n_heads, xl: XLSTMConfig, dtype=torch.float32,
             device="cpu", tp: int = 1):
        """The zero state; with ``tp`` a rank's ``H / tp`` heads and
        ``d_inner / tp`` conv channels."""
        di = int(xl.proj_factor_mlstm * d_model)
        dh = di // n_heads
        h_loc = n_heads // tp
        f32 = dict(dtype=torch.float32, device=device)
        return MLSTMState(
            c=torch.zeros((batch, h_loc, dh, dh), **f32),
            n=torch.zeros((batch, h_loc, dh), **f32),
            m=torch.full((batch, h_loc), NEG_BIG, **f32),
            conv=torch.zeros((batch, xl.conv_width - 1, di // tp),
                             dtype=dtype, device=device),
        )


def _head_norm(h: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head RMS norm of [B, T, d] with unit scale (the reference's
    ``rms_norm(h.reshape(b, t, H, dh), ones(dh))``)."""
    b, t, d = h.shape
    ones = torch.ones((d // n_heads,), dtype=torch.float32, device=h.device)
    return rms_norm(h.reshape(b, t, n_heads, d // n_heads), ones).reshape(
        b, t, d)


def _mlstm_inputs(xl: XLSTMConfig, n_heads: int, params: dict,
                  x: torch.Tensor, conv: torch.Tensor):
    """The mLSTM's scan inputs from x [B, T, d_model]: q, k, v [B, H, T,
    dh] in x's dtype (k scaled by 1/sqrt(dh)), lf, li [B, H, T] fp32, the
    gate z and the new conv window."""
    b_sz, t, d_model = x.shape
    di = int(xl.proj_factor_mlstm * d_model)
    dh = di // n_heads
    xin = rms_norm(x, params["norm"])
    up = xin @ params["w_up"].to(x.dtype)
    xi, z = up.chunk(2, dim=-1)
    xc, conv_tail = causal_conv(xi, params["conv_w"], params["conv_b"], conv)
    xc = F.silu(xc)

    def heads(a):                    # [B, T, di] -> [B, H, T, dh]
        return a.reshape(b_sz, t, n_heads, dh).transpose(1, 2)

    q = heads(xc @ params["w_q"].to(x.dtype))
    k = heads(xc @ params["w_k"].to(x.dtype)) / math.sqrt(dh)
    v = heads(xi @ params["w_v"].to(x.dtype))
    xcf = xc.float()
    li = (xcf @ params["w_i"] + params["b_i"]).transpose(1, 2)
    lf = F.logsigmoid((xcf @ params["w_f"] + params["b_f"]).transpose(1, 2))
    return q, k, v, lf, li, z, conv_tail


def _mlstm_out(n_heads: int, params: dict, x: torch.Tensor, h: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """h [B, H, T, dh] fp32 -> the block's output [B, T, d_model]: per-head
    norm, the gate and the down projection."""
    b_sz, _, t, dh = h.shape
    h = _head_norm(h.transpose(1, 2).reshape(b_sz, t, n_heads * dh), n_heads)
    h = h * params["gn"]
    h = h.to(x.dtype) * F.silu(z)
    return h @ params["w_down"].to(x.dtype)


def _scan(n_heads: int, q, k, v, lf, li, state: MLSTMState, chunk: int):
    """The scan (`mlstm_scan`: the kernel on the card) of q, k, v [B, H, T,
    dh], lf, li [B, H, T] from ``state``'s (c, n, m): (h [B, H, T, dh]
    fp32, the final c, n, m)."""
    b_sz, _, t, dh = q.shape

    def flat(a):                     # [B, H, ...] -> [B * H, ...] fp32
        return a.float().reshape(b_sz * n_heads, *a.shape[2:]).contiguous()

    h, (c_f, n_f, m_f) = mlstm_scan(
        flat(q), flat(k), flat(v), flat(lf), flat(li),
        (flat(state.c), flat(state.n), flat(state.m)), chunk=chunk)
    return (h.reshape(b_sz, n_heads, t, dh),
            (c_f.reshape(b_sz, n_heads, dh, dh),
             n_f.reshape(b_sz, n_heads, dh), m_f.reshape(b_sz, n_heads)))


def _scan_train(q, k, v, lf, li, state: MLSTMState, chunk: int):
    """`_scan`'s train form: the plain ``mlstm_chunk`` ``chunk`` steps at a
    time, each chunk under ``torch.utils.checkpoint``, the ragged tail
    padded so that it writes nothing (li = -1e30)."""
    t = q.shape[-2]
    chunk = min(chunk, t)
    q, k, v, lf, li = pad_chunks(q, k, v, lf, li, chunk)
    carry = (state.c, state.n, state.m)
    hs = []
    for lo in range(0, q.shape[-2], chunk):
        sl = slice(lo, lo + chunk)
        h, carry = checkpoint(
            mlstm_chunk, q[..., sl, :], k[..., sl, :], v[..., sl, :],
            lf[..., sl], li[..., sl], carry, use_reentrant=False,
            preserve_rng_state=False)
        hs.append(h)
    return torch.cat(hs, dim=-2)[..., :t, :], carry


def mlstm_forward(xl: XLSTMConfig, n_heads: int, params: dict,
                  x: torch.Tensor, state: MLSTMState, *, chunk: int = 256
                  ) -> Tuple[torch.Tensor, MLSTMState]:
    """x [B, T, d_model] from ``state`` -> (out [B, T, d_model], state)."""
    q, k, v, lf, li, z, conv_tail = _mlstm_inputs(xl, n_heads, params, x,
                                                  state.conv)
    h, carry = _scan(n_heads, q, k, v, lf, li, state, chunk)
    return _mlstm_out(n_heads, params, x, h, z), MLSTMState(
        *carry, conv=conv_tail)


def mlstm_forward_train(xl: XLSTMConfig, n_heads: int, params: dict,
                        x: torch.Tensor, state: MLSTMState, *,
                        chunk: int = 256) -> Tuple[torch.Tensor, MLSTMState]:
    """`mlstm_forward`'s train form, with autograd and no kernel: the
    reference's chunkwise form (``src/repro/models/xlstm.py:156-191``),
    `_scan_train`."""
    q, k, v, lf, li, z, conv_tail = _mlstm_inputs(xl, n_heads, params, x,
                                                  state.conv)
    h, carry = _scan_train(q, k, v, lf, li, state, chunk)
    return _mlstm_out(n_heads, params, x, h, z), MLSTMState(
        *carry, conv=conv_tail)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_bias_init(t: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
    """Gate biases laid out [i | f | z | o]: zeros, the forget block
    linspace 3..6."""
    del generator
    d4 = t.shape[-1] // 4
    bias = torch.zeros((4, d4), dtype=torch.float32)
    bias[1] = _linspace_3_6(d4)
    with torch.no_grad():
        return t.copy_(bias.reshape(-1).expand(t.shape))


def slstm_params_spec(d_model: int, n_heads: int, xl: XLSTMConfig,
                      dtype) -> dict:
    dh = d_model // n_heads
    dff = int(xl.proj_factor_slstm * d_model)
    return {
        "norm": ((d_model,), ones_init, torch.float32),
        "conv_w": ((xl.conv_width, d_model), dense_init, dtype),
        "conv_b": ((d_model,), zeros_init, dtype),
        "w_gates": ((d_model, 4 * d_model), dense_init, dtype),   # i,f,z,o
        "r_gates": ((n_heads, dh, 4 * dh), dense_init, dtype),    # per head
        "b_gates": ((4 * d_model,), _slstm_bias_init, torch.float32),
        "gn": ((d_model,), ones_init, torch.float32),
        "w_up": ((d_model, 2 * dff), dense_init, dtype),
        "w_down": ((dff, d_model), dense_init, dtype),
    }


class SLSTMState(NamedTuple):
    h: torch.Tensor      # [B, d]
    c: torch.Tensor      # [B, d]
    n: torch.Tensor      # [B, d]
    m: torch.Tensor      # [B, d]
    conv: torch.Tensor   # [B, W-1, d]

    @staticmethod
    def init(batch, d_model, xl: XLSTMConfig, dtype=torch.float32,
             device="cpu", tp: int = 1):
        """The zero state; with ``tp`` a rank's ``d_model / tp`` units."""
        d = d_model // tp
        f32 = dict(dtype=torch.float32, device=device)
        return SLSTMState(
            h=torch.zeros((batch, d), **f32),
            c=torch.zeros((batch, d), **f32),
            n=torch.zeros((batch, d), **f32),
            m=torch.full((batch, d), NEG_BIG, **f32),
            conv=torch.zeros((batch, xl.conv_width - 1, d), dtype=dtype,
                             device=device),
        )


def _slstm_inputs(params: dict, x: torch.Tensor, conv: torch.Tensor):
    """The gates' input contributions [B, T, 4d] fp32 (i, f from the conv
    path, z, o raw) and the new conv window."""
    d_model = x.shape[-1]
    xin = rms_norm(x, params["norm"])
    xc, conv_tail = causal_conv(xin, params["conv_w"], params["conv_b"], conv)
    xc = F.silu(xc)
    w_gates = params["w_gates"].to(x.dtype)
    wx = xc @ w_gates[:, :2 * d_model]
    wzo = xin @ w_gates[:, 2 * d_model:]
    return torch.cat([wx, wzo], dim=-1).float(), conv_tail


def _slstm_steps(n_heads: int, r: torch.Tensor, bias: torch.Tensor,
                 gates_x: torch.Tensor, h, c, n, m):
    """The recurrence over gates_x [B, L, 4d] from (h, c, n, m) [B, d]:
    (hs [B, L, d], h, c, n, m).  The per-head recurrent weights r [H, dh,
    4dh] act as one block-diagonal [d, 4d] product, which lands in the
    gates' [i | f | z | o] layout over units directly, so that a step is
    one ``addmm`` and the gates' elementwise ops, each launched once."""
    r_full = torch.block_diag(*r.unbind(0))
    hs = []
    for gx in (gates_x + bias).unbind(1):
        pre = torch.addmm(gx, h, r_full)
        pi, pf, pz, po = pre.chunk(4, dim=-1)
        lfm = F.logsigmoid(pf) + m
        m_new = torch.maximum(lfm, pi)
        i_g = torch.exp(pi - m_new)
        f_g = torch.exp(lfm - m_new)
        c = torch.addcmul(f_g * c, i_g, torch.tanh(pz))
        n = torch.addcmul(i_g, f_g, n)
        h = torch.sigmoid(po) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), h, c, n, m


def _slstm_out(n_heads: int, params: dict, x: torch.Tensor,
               hs: torch.Tensor) -> torch.Tensor:
    """hs [B, T, d] -> the block's output: per-head norm, then the gated
    up/down projection."""
    out_h = _head_norm(hs, n_heads)
    out_h = (out_h * params["gn"]).to(x.dtype)
    u, g = (out_h @ params["w_up"].to(x.dtype)).chunk(2, dim=-1)
    return (u * F.gelu(g, approximate="tanh")) @ params["w_down"].to(x.dtype)


def slstm_forward(xl: XLSTMConfig, n_heads: int, params: dict,
                  x: torch.Tensor,
                  state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """x [B, T, d_model] from ``state`` -> (out [B, T, d_model], state); one
    recurrence step per token."""
    gates_x, conv_tail = _slstm_inputs(params, x, state.conv)
    hs, h, c, n, m = _slstm_steps(n_heads, params["r_gates"].float(),
                                  params["b_gates"], gates_x, state.h,
                                  state.c, state.n, state.m)
    return _slstm_out(n_heads, params, x, hs), SLSTMState(
        h=h, c=c, n=n, m=m, conv=conv_tail)


def slstm_chunked(n_heads: int, r: torch.Tensor, bias: torch.Tensor,
                  gates_x: torch.Tensor, h, c, n, m, chunk: int):
    """`_slstm_steps` ``chunk`` steps at a time, each under
    ``torch.utils.checkpoint``: (hs [B, T, d], h, c, n, m)."""
    hs = []
    for lo in range(0, gates_x.shape[1], chunk):
        out, h, c, n, m = checkpoint(
            _slstm_steps, n_heads, r, bias, gates_x[:, lo:lo + chunk], h, c,
            n, m, use_reentrant=False, preserve_rng_state=False)
        hs.append(out)
    return (torch.cat(hs, dim=1), h, c, n, m)


def slstm_forward_train(xl: XLSTMConfig, n_heads: int, params: dict,
                        x: torch.Tensor, state: SLSTMState, *,
                        chunk: int = 64) -> Tuple[torch.Tensor, SLSTMState]:
    """`slstm_forward`'s train form: the same recurrence with autograd,
    ``chunk`` steps at a time, each chunk under ``torch.utils.checkpoint``
    (the reference's ``slstm_chunk=64``).  The ragged tail runs as a
    shorter chunk: the reference pads it and its ``valid`` mask keeps the
    state over the padded steps, which is the same."""
    gates_x, conv_tail = _slstm_inputs(params, x, state.conv)
    hs, h, c, n, m = slstm_chunked(n_heads, params["r_gates"].float(),
                                   params["b_gates"], gates_x, state.h,
                                   state.c, state.n, state.m, chunk)
    return _slstm_out(n_heads, params, x, hs), SLSTMState(
        h=h, c=c, n=n, m=m, conv=conv_tail)


# ---------------------------------------------------------------------------
# Tensor-parallel forms: each rank runs its H / TP heads
# ---------------------------------------------------------------------------


def heads_split(n_heads: int, mesh) -> bool:
    """Whether the blocks run on a rank's ``H / TP`` heads under ``mesh``
    (the model axis divides the heads; so it divides d_inner and d_model
    too).  Elsewhere every rank runs whole blocks from gathered weights:
    ROADMAP Queue 1, item 1."""
    return mesh is not None and n_heads % col.tp_size(mesh) == 0


def _whole(params: dict) -> dict:
    return {k: col.full(v) for k, v in params.items()}


def mlstm_local_params(params: dict, mesh) -> dict:
    """A layer's mLSTM weights for this rank's heads, as the reference's
    rules place them (`distributed.sharding`): ``w_up``'s model box
    (contiguous over its ``[xi | z]`` columns, so a rank's xi and z
    columns lie in other ranks' boxes: `mlstm_inputs_tp` exchanges the
    products), ``conv_w``, ``conv_b``, ``gn`` by channel, ``w_q``,
    ``w_k``, ``w_v`` by the heads' columns, ``w_i``, ``w_f``, ``b_i``,
    ``b_f`` by heads, ``w_down`` by the heads' rows; ``norm`` whole."""
    lp = {k: col.tp_local(params[k], -1, mesh)
          for k in ("w_up", "conv_w", "conv_b", "w_q", "w_k", "w_v", "w_i",
                    "w_f", "b_i", "b_f", "gn")}
    lp["w_down"] = col.tp_local(params["w_down"], -2, mesh)
    lp["norm"] = params["norm"]
    return lp


def mlstm_inputs_tp(h_loc: int, lp: dict, x: torch.Tensor,
                    conv: torch.Tensor, mesh):
    """`_mlstm_inputs` on the rank's ``h_loc`` heads (``lp``:
    `mlstm_local_params`), x [B, T, d_model] replicated over the model
    axis.  The products of the rank's ``w_up`` box are all-gathered
    (`collectives.gather_summed`: the ranks read different columns of
    them) into the whole ``[xi | z]``; the conv and SiLU run on the rank's
    channels of xi with its part of the conv window, and their output is
    all-gathered the same way, because the column-parallel ``w_q``,
    ``w_k``, ``w_i`` and ``w_f`` read every channel (gathering ``xc`` moves
    what gathering xi would, and keeps the conv's weights and window
    split).  Returns q, k, v [B, h_loc, T, dh], lf, li [B, h_loc, T], the
    rank's z columns and its conv window."""
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    b_sz, t, _ = x.shape
    dl = lp["conv_w"].shape[-1]
    dh = dl // h_loc
    xin = col.copy_to_tp(rms_norm(x, lp["norm"]), mesh)
    up = col.gather_summed(xin @ lp["w_up"].to(x.dtype), grp, -1)
    xi = up[..., :n * dl]
    z = up.narrow(-1, (n + r) * dl, dl)
    xc, conv_tail = causal_conv(xi.narrow(-1, r * dl, dl), lp["conv_w"],
                                lp["conv_b"], conv)
    xc = col.gather_summed(F.silu(xc), grp, -1)

    def heads(a):                    # [B, T, dl] -> [B, h_loc, T, dh]
        return a.reshape(b_sz, t, h_loc, dh).transpose(1, 2)

    q = heads(xc @ lp["w_q"].to(x.dtype))
    k = heads(xc @ lp["w_k"].to(x.dtype)) / math.sqrt(dh)
    v = heads(xi @ lp["w_v"].to(x.dtype))
    xcf = xc.float()
    li = (xcf @ lp["w_i"] + lp["b_i"]).transpose(1, 2)
    lf = F.logsigmoid((xcf @ lp["w_f"] + lp["b_f"]).transpose(1, 2))
    return q, k, v, lf, li, z, conv_tail


def _reduced(part: torch.Tensor, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product's partial sums reduced over the model axis
    in fp32, rounded to x's dtype once."""
    return col.reduce_from_tp(part.float(), mesh).to(x.dtype)


def mlstm_forward_tp(xl: XLSTMConfig, n_heads: int, params: dict,
                     x: torch.Tensor, state: MLSTMState, mesh, *,
                     chunk: int = 256, train: bool = False
                     ) -> Tuple[torch.Tensor, MLSTMState]:
    """`mlstm_forward` (``train``: `mlstm_forward_train`) over ``mesh``'s
    model axis: the scan (the kernel on the card; the plain chunks with
    autograd in train mode) on the rank's ``H / TP`` heads, ``[B * H / TP,
    T, dh]``, from its part of the state (c [B, H / TP, dh, dh], n [B,
    H / TP, dh], m [B, H / TP], conv [B, W - 1, d_inner / TP]); the
    per-head norm, ``gn`` and the z gate on the rank's channels,
    ``w_down`` row-parallel.  Returns (out [B, T, d_model], whole on every
    rank; the rank's new state)."""
    h_loc = n_heads // col.tp_size(mesh)
    lp = mlstm_local_params(params, mesh)
    q, k, v, lf, li, z, conv_tail = mlstm_inputs_tp(h_loc, lp, x,
                                                    state.conv, mesh)
    if train:
        h, carry = _scan_train(q, k, v, lf, li, state, chunk)
    else:
        h, carry = _scan(h_loc, q, k, v, lf, li, state, chunk)
    return (_reduced(_mlstm_out(h_loc, lp, x, h, z), x, mesh),
            MLSTMState(*carry, conv=conv_tail))


def ffn_split(dff: int, mesh) -> bool:
    """Whether the sLSTM's FFN runs on a rank's ``d_ff / TP`` rows (the
    model axis divides d_ff, as the reference's rules then split
    ``w_down``)."""
    n = col.tp_size(mesh)
    return dff % n == 0 and dff >= n


def slstm_local_params(params: dict, mesh) -> dict:
    """A layer's sLSTM weights on the rank, as the reference places them:
    ``conv_w``, ``conv_b`` and ``gn`` by unit, ``w_gates``'s model box
    (contiguous over its ``[i | f | z | o]`` columns: a rank holds gate
    columns of every unit), the FFN's ``w_up`` box (contiguous over ``[u
    | g]``) and ``w_down``'s rows where the model axis divides d_ff (else
    both whole); ``norm`` whole.  ``r_gates`` (placed over each head's
    ``4 dh`` columns) and ``b_gates`` (replicated) whole: every rank runs
    the whole recurrence (`slstm_forward_tp`), reading its units' part of
    the output, so their gradients sum over the model axis
    (`collectives.copy_to_tp`)."""
    lp = {k: col.tp_local(params[k], -1, mesh)
          for k in ("conv_w", "conv_b", "gn", "w_gates")}
    lp["norm"] = params["norm"]
    for k in ("r_gates", "b_gates"):
        lp[k] = col.copy_to_tp(col.full(params[k]), mesh)
    if ffn_split(params["w_down"].shape[-2], mesh):
        lp["w_up"] = col.tp_local(params["w_up"], -1, mesh)
        lp["w_down"] = col.tp_local(params["w_down"], -2, mesh)
    else:
        lp["w_up"], lp["w_down"] = (col.full(params[k])
                                    for k in ("w_up", "w_down"))
    return lp


def slstm_inputs_tp(lp: dict, x: torch.Tensor, conv: torch.Tensor, mesh):
    """`_slstm_inputs` over the model axis: the conv and SiLU on the
    rank's units with its part of the window, all-gathered (the gate
    columns of a rank's box read every unit); the products of the rank's
    ``w_gates`` box (its columns below ``2 d`` read the conv path, the
    rest the normed input) all-gathered into the whole ``[i | f | z | o]``
    gate inputs [B, T, 4d] fp32 (`collectives.gather_summed`: each rank's
    recurrence feeds its units only).  Returns them and the rank's conv
    window."""
    r, grp = col.tp_rank(mesh), col.tp_group(mesh)
    d = x.shape[-1]
    dl = lp["conv_w"].shape[-1]
    xin = col.copy_to_tp(rms_norm(x, lp["norm"]), mesh)
    xc, conv_tail = causal_conv(xin.narrow(-1, r * dl, dl), lp["conv_w"],
                                lp["conv_b"], conv)
    xc = col.gather_summed(F.silu(xc), grp, -1)
    w = lp["w_gates"].to(x.dtype)
    cut = min(max(2 * d - r * w.shape[-1], 0), w.shape[-1])
    # both products on every rank, one of them empty where the box lies
    # on one side of 2d: each rank's backward then runs xc's collective
    box = torch.cat([xc @ w[:, :cut], xin @ w[:, cut:]], dim=-1)
    return col.gather_summed(box, grp, -1).float(), conv_tail


def _slstm_out_tp(h_loc: int, dff: int, lp: dict, x: torch.Tensor,
                  hs: torch.Tensor, mesh) -> torch.Tensor:
    """`_slstm_out` from the rank's units of hs [B, T, d / TP]: the
    per-head norm and ``gn`` on them, the normed output all-gathered; with
    the FFN split, the products of the rank's ``w_up`` box all-gathered
    and its u and g columns cut for ``w_down``'s rows (row-parallel, the
    partial sums reduced in fp32), else the whole FFN on every rank."""
    n, r, grp = col.tp_size(mesh), col.tp_rank(mesh), col.tp_group(mesh)
    out_h = (_head_norm(hs, h_loc) * lp["gn"]).to(x.dtype)
    fl = lp["w_down"].shape[-2]
    if not ffn_split(dff, mesh):
        out_h = col.gather(out_h, grp, -1)
        u, g = (out_h @ lp["w_up"].to(x.dtype)).chunk(2, dim=-1)
        return (u * F.gelu(g, approximate="tanh")) @ lp["w_down"].to(x.dtype)
    out_h = col.gather_summed(out_h, grp, -1)
    ug = col.gather_summed(out_h @ lp["w_up"].to(x.dtype), grp, -1)
    u, g = ug.narrow(-1, r * fl, fl), ug.narrow(-1, (n + r) * fl, fl)
    part = (u * F.gelu(g, approximate="tanh")) @ lp["w_down"].to(x.dtype)
    return _reduced(part, x, mesh)


def slstm_forward_tp(xl: XLSTMConfig, n_heads: int, params: dict,
                     x: torch.Tensor, state: SLSTMState, mesh, *,
                     train: bool = False, chunk: int = 64
                     ) -> Tuple[torch.Tensor, SLSTMState]:
    """`slstm_forward` (``train``: `slstm_forward_train`) over ``mesh``'s
    model axis, from the rank's part of the state (h, c, n, m [B, d / TP],
    its heads' units; conv [B, W - 1, d / TP]).

    The reference's recurrent term (``einsum("bhd,hdg->bhg", h, r)
    .reshape(b, 4d)``) lays each head's ``4 dh`` outputs over the ``[i |
    f | z | o]`` gate columns of the whole ``d`` units, so unit u's gate g
    reads the previous output of head ``(g d + u) // (4 dh)``: every
    unit's step reads every head's, and a split of the recurrence by heads
    would need a collective a token.  So every rank runs the whole
    recurrence (a [B, d] x [d, 4d] product and the gates' elementwise ops
    a token) from the state all-gathered once a call, and keeps its units:
    the gate inputs' product (``w_gates``, 4 d^2 a token), the conv, the
    per-head norm, ``gn`` and the FFN are split.  Returns (out [B, T,
    d_model], whole on every rank; the rank's new state)."""
    r, grp = col.tp_rank(mesh), col.tp_group(mesh)
    h_loc = n_heads // col.tp_size(mesh)
    lp = slstm_local_params(params, mesh)
    gates_x, conv_tail = slstm_inputs_tp(lp, x, state.conv, mesh)
    dl = lp["conv_w"].shape[-1]
    whole = col.all_gather(torch.stack([state.h, state.c, state.n,
                                        state.m]), grp, -1)
    run = slstm_chunked if train else _slstm_steps
    more = (chunk,) if train else ()
    hs, *carry = run(n_heads, lp["r_gates"].float(), lp["b_gates"], gates_x,
                     *whole.unbind(0), *more)
    mine = [a.narrow(-1, r * dl, dl) for a in (hs, *carry)]
    dff = int(xl.proj_factor_slstm * x.shape[-1])
    return (_slstm_out_tp(h_loc, dff, lp, x, mine[0], mesh),
            SLSTMState(*mine[1:], conv=conv_tail))


# ---------------------------------------------------------------------------
# Stack driver: alternating (mLSTM, sLSTM) residual block pairs
# ---------------------------------------------------------------------------


def xlstm_pair_count(n_layers: int, xl: XLSTMConfig) -> int:
    assert n_layers % xl.slstm_every == 0
    return n_layers // xl.slstm_every


class XLSTMStackState(NamedTuple):
    """Stacked states for the whole trunk ([P, ...] per pair)."""

    m: MLSTMState
    s: SLSTMState

    @staticmethod
    def init(n_pairs, batch, d_model, n_heads, xl: XLSTMConfig,
             dtype=torch.float32, device="cpu", tp: int = 1):
        """The zero state; with ``tp`` a rank's heads and their units
        (`heads_split`)."""
        def stack(st):
            return type(st)(*(a.expand((n_pairs,) + a.shape).clone()
                              for a in st))

        return XLSTMStackState(
            m=stack(MLSTMState.init(batch, d_model, n_heads, xl, dtype,
                                    device, tp)),
            s=stack(SLSTMState.init(batch, d_model, xl, dtype, device, tp)),
        )


def _write(stacked: NamedTuple, i: int, new: NamedTuple) -> None:
    for dst, src in zip(stacked, new):
        dst[i].copy_(src)


def _mlstm(xl, n_heads, p, x, st, mesh, *, chunk, train):
    """The mLSTM block on the rank's heads (`mlstm_forward_tp`) where the
    model axis of ``mesh`` divides them, else whole from gathered
    weights."""
    if heads_split(n_heads, mesh):
        return mlstm_forward_tp(xl, n_heads, p, x, st, mesh, chunk=chunk,
                                train=train)
    fwd = mlstm_forward_train if train else mlstm_forward
    return fwd(xl, n_heads, _whole(p), x, st, chunk=chunk)


def _slstm(xl, n_heads, p, x, st, mesh, *, train):
    """The sLSTM block, split as `slstm_forward_tp` splits it where the
    model axis of ``mesh`` divides the heads, else whole from gathered
    weights."""
    if heads_split(n_heads, mesh):
        return slstm_forward_tp(xl, n_heads, p, x, st, mesh, train=train)
    fwd = slstm_forward_train if train else slstm_forward
    return fwd(xl, n_heads, _whole(p), x, st)


def _pair(xl, n_heads, p_m, p_s, x, st_m, st_s, chunk, mesh):
    """One (mLSTM, sLSTM) residual pair in train form, its weights
    gathered here (`collectives.gather_layer`)."""
    p_m, p_s = col.gather_layer(p_m), col.gather_layer(p_s)
    out_m, _ = _mlstm(xl, n_heads, p_m, x, st_m, mesh, chunk=chunk,
                      train=True)
    x = x + out_m
    out_s, _ = _slstm(xl, n_heads, p_s, x, st_s, mesh, train=True)
    return x + out_s


def xlstm_stack_apply(xl: XLSTMConfig, n_heads: int, params: dict,
                      x: torch.Tensor, state: XLSTMStackState, *,
                      mode: str = "serve", chunk: int = 256, mesh=None
                      ) -> Tuple[torch.Tensor, XLSTMStackState]:
    """The pairs in order, each an mLSTM then an sLSTM residual block;
    under ``mesh`` (the ambient one, `transformer.spmd_mesh`) each block
    on the rank's heads where the model axis divides them (``state``
    then the rank's part), else whole.

    ``mode="serve"`` (prefill and decode) writes ``state``'s tensors in
    place.  ``mode="train"`` runs each block's train form with autograd
    from ``state``'s values (a fresh `XLSTMStackState` in `Model.loss`),
    each pair under ``torch.utils.checkpoint`` (the reference's
    ``remat``), writes nothing and returns ``(h, None)``."""
    n_pairs = params["m_blocks"]["norm"].shape[0]
    for i in range(n_pairs):
        p_m = {k: v[i] for k, v in params["m_blocks"].items()}
        p_s = {k: v[i] for k, v in params["s_blocks"].items()}
        st_m = MLSTMState(*(a[i] for a in state.m))
        st_s = SLSTMState(*(a[i] for a in state.s))
        if mode == "train":
            x = checkpoint(_pair, xl, n_heads, p_m, p_s, x, st_m, st_s,
                           chunk, mesh, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        out_m, st_m = _mlstm(xl, n_heads, p_m, x, st_m, mesh, chunk=chunk,
                             train=False)
        x = x + out_m
        _write(state.m, i, st_m)
        out_s, st_s = _slstm(xl, n_heads, p_s, x, st_s, mesh, train=False)
        x = x + out_s
        _write(state.s, i, st_s)
    return x, (None if mode == "train" else state)
