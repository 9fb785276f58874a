"""AdamW on trees of tensors (the twin of ``src/repro/optim/adamw.py``).

The state is `train.state.AdamWState`: a scalar int32 ``step`` and ``m``,
``v`` trees shaped like the parameters, in fp32.  The update runs the
reference's operations in the reference's order, in fp32 whatever the
parameter dtype, but **in place**: the parameters (a model's own tensors),
the moments and the gradients are overwritten, so that a step at full
width holds one copy of each and a checkpoint of the state is the model
itself.  Every scalar that depends on the step (the bias corrections, the
learning rate) is computed on the step's device: a step reads nothing
back to the host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.checkpoint.serialize import leaf_paths
from repro_torch.train.state import AdamWState


def _leaves(tree):
    return [leaf for _, leaf in leaf_paths(tree)]


def init(params) -> AdamWState:
    """Zero moments in fp32 beside each parameter, step 0 (int32), all on
    the parameters' devices."""
    def zeros(tree):
        return {k: (zeros(v) if isinstance(v, dict) else torch.zeros(
            v.shape, dtype=torch.float32, device=v.device))
            for k, v in tree.items()}

    first = _leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      m=zeros(params), v=zeros(params))


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr: torch.Tensor,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place on ``params``, ``state.m`` and ``state.v``;
    returns (params, the state with the new step)."""
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state.m),
                          _leaves(state.v), strict=True):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        mhat = m / c1
        vhat = v / c2
        pf = p.float()
        delta = mhat / (vhat.sqrt() + eps) + weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, on device."""
    return torch.sqrt(sum(torch.sum(x.float().square())
                          for x in _leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in _leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm


# -- schedules -----------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up then cosine decay; the returned function maps an int
    step tensor to an fp32 learning rate on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
