"""Shared model primitives: initialisers, norms, rotary and sinusoidal
position embeddings, MLPs.

The port of ``src/repro/models/layers.py``.
Layers are functions ``(params, x, ...) -> y`` over nested dicts of
tensors, as in the reference.  Parameter *structure* helpers return spec
dicts ``{name: (shape, init, dtype) | subdict}`` that `models.model.Model`
materialises as ``nn.Parameter``s.

Initialisers draw from an explicit ``torch.Generator``: a truncated normal
at ±2σ with a fan-in std, and N(0, 0.02).  They cannot give JAX's bits, so
tests carry the reference's weights across instead
(`repro_torch.core.convert.load_reference_params`).
"""
from __future__ import annotations

import math

import numpy as np

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initialisers.  Each fills a tensor in place from a generator.
# ---------------------------------------------------------------------------


def dense_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init for weights laid out [..., in, out];
    stacked per-layer weights [L, in, out] too: fan-in is always the
    second-to-last axis."""
    fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
    std = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                           generator=generator)


def embed_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, 0.02, generator=generator)


def zeros_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    del generator
    with torch.no_grad():
        return t.zero_()


def ones_init(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    del generator
    with torch.no_grad():
        return t.fill_(1.0)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with a bias (Whisper), computed in fp32, output in
    x.dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for RoPE, shape [head_dim // 2], float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta rounded to float32, as a scalar operand: a tensor made from it
    # on the card would be a host-to-device copy, a host sync per call
    return 1.0 / torch.pow(float(np.float32(theta)), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding with fp32 angles and split halves.

    x: [..., seq, heads, head_dim]; positions: [..., seq] integer
    (broadcastable against x's batch/seq leading dims)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq        # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_positions: int, dim: int,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal positional embedding [n, dim], fp32:
    sines then cosines of ``pos * exp(-i log(10^4) / (dim/2 - 1))``."""
    half = dim // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    pos = (torch.arange(n_positions, dtype=torch.float32,
                        device=device)[:, None] * inv[None, :])
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


# ---------------------------------------------------------------------------
# Depthwise causal convolution (the SSM and xLSTM blocks)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                prefix: torch.Tensor):
    """Depthwise causal conv over time (the reference's ``ssm._causal_conv``
    and ``xlstm._conv1d``): x [B, T, C], conv_w [W, C], prefix [B, W-1, C]
    the trailing window of the previous call.  Returns (out [B, T, C], the
    new trailing window), in x's dtype."""
    w = conv_w.shape[0]
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + xp[:, i:i + x.shape[1]] * conv_w[i].to(x.dtype)
    return out + conv_b.to(x.dtype), xp[:, -(w - 1):] if w > 1 else prefix


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SwiGLU MLP: params {w_gate [d,f], w_up [d,f], w_down [f,d]};
    weights cast to x's dtype at each use, as the reference does."""
    gate = x @ params["w_gate"].to(x.dtype)
    up = x @ params["w_up"].to(x.dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(x.dtype)


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain tanh-GELU MLP (Whisper): params {w_in [d,f], b_in, w_out
    [f,d], b_out}, weights and biases cast to x's dtype at each use."""
    h = x @ params["w_in"].to(x.dtype)
    h = F.gelu(h + params["b_in"].to(x.dtype), approximate="tanh")
    return h @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)


def swiglu_params(d_model: int, d_ff: int, dtype) -> dict:
    """Shape/init spec for a SwiGLU MLP."""
    return {
        "w_gate": ((d_model, d_ff), dense_init, dtype),
        "w_up": ((d_model, d_ff), dense_init, dtype),
        "w_down": ((d_ff, d_model), dense_init, dtype),
    }


def gelu_mlp_params(d_model: int, d_ff: int, dtype) -> dict:
    """Shape/init spec for a GELU MLP with biases."""
    return {
        "w_in": ((d_model, d_ff), dense_init, dtype),
        "b_in": ((d_ff,), zeros_init, dtype),
        "w_out": ((d_ff, d_model), dense_init, dtype),
        "b_out": ((d_model,), zeros_init, dtype),
    }


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a nested dict of stacked ``[L, ...]`` tensors (a
    stack's weights or cache): views, so that a write into one writes the
    stack."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def stack_specs(spec: dict, n: int) -> dict:
    """Prepend a leading stack dimension of size n to every leaf of a spec."""
    if isinstance(spec, dict):
        return {k: stack_specs(v, n) for k, v in spec.items()}
    shape, init, dtype = spec
    return ((n,) + tuple(shape), init, dtype)
