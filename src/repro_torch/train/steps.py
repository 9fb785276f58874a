"""Training and serving step functions, the units the scheduler preempts
at (the twin of ``src/repro/train/steps.py``).

``make_train_step`` builds ``(state, batch) -> (state, metrics)``: the loss
and its gradients (accumulated in fp32 over ``grad_accum`` microbatches
when it is above 1), clipping by the global norm, AdamW, the key folded
with 1 and the data cursor advanced; the model computes in the config's
``compute_dtype``, the master weights and moments stay fp32.  The step
updates the state's parameters (the model's own tensors) and moments **in
place** and returns the state with its new step, key and cursor.  Every
metric is a device scalar: the step reads nothing back to the host.

Bitwise transparency needs every run of a step on the same inputs to give
the same bits, so the step runs under ``torch.use_deterministic_algorithms
(True)`` (`deterministic`): on the card the backward of the embedding
lookup and of the cross-entropy's gather otherwise sum with atomics.  On
the card the process must set ``CUBLAS_WORKSPACE_CONFIG`` before its
first cuBLAS call; the step raises without it.

``make_prefill_step`` / ``make_decode_step`` are the serving entry points.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict

import torch

from repro_torch.checkpoint.serialize import leaf_paths, map_with_path
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.state import TrainState, fold_in

#: what cuBLAS needs for reproducible results under deterministic mode; it
#: must be in the environment before the process's first cuBLAS call
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1            # microbatches per step


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` for the block, the
    previous setting restored after it.  On CUDA it raises unless
    ``CUBLAS_WORKSPACE_CONFIG`` is in the environment: cuBLAS sizes its
    workspace at its first call, so setting it here could come too late
    and would only look like determinism."""
    if (torch.device(device).type == "cuda"
            and "CUBLAS_WORKSPACE_CONFIG" not in os.environ):
        raise RuntimeError(
            "a deterministic train step on CUDA needs CUBLAS_WORKSPACE_CONFIG"
            f"={CUBLAS_WORKSPACE_CONFIG} in the environment before the "
            "process's first cuBLAS call: set it at process start")
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    lr_fn = adamw.cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

    def value_and_grad(params, batch):
        paths, leaves = zip(*leaf_paths(params))
        loss, metrics = model.loss(batch, params=params)
        # a leaf the loss never reads (the audio model's norm_f: its
        # decoder ends in its own LayerNorm) gets a zero gradient, as under
        # jax.grad
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(paths, grads)))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        accum = tcfg.grad_accum
        params = state.params
        with deterministic(state.opt.step.device):
            if accum == 1:
                loss, metrics, grads = value_and_grad(params, batch)
            else:
                # split the global batch into `accum` microbatches;
                # gradients accumulate in fp32
                micro = {k: v.reshape(accum, v.shape[0] // accum,
                                      *v.shape[1:])
                         for k, v in batch.items()}
                grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in leaf_paths(params)}
                loss = torch.zeros((), device=state.opt.step.device)
                aux = torch.zeros((), device=state.opt.step.device)
                for i in range(accum):
                    loss_i, metrics_i, g = value_and_grad(
                        params, {k: v[i] for k, v in micro.items()})
                    grads = {k: grads[k] + g[k].float() for k in grads}
                    loss = loss + loss_i
                    aux = aux + metrics_i["aux_loss"]
                grads = {k: g / accum for k, g in grads.items()}
                loss = loss / accum
                metrics = {"ce_loss": loss, "aux_loss": aux / accum}
            grads = map_with_path(lambda k, _p: grads[k], params)
            grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.clip_norm)
            lr = lr_fn(state.opt.step)
            new_params, new_opt = adamw.update(
                params, grads, state.opt, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                weight_decay=tcfg.weight_decay)
            del grads
            new_state = TrainState(params=new_params, opt=new_opt,
                                   rng=fold_in(state.rng, 1),
                                   data_cursor=state.data_cursor + 1)
        out_metrics = {
            "loss": loss, "grad_norm": gnorm, "lr": lr,
            "step": new_opt.step.float(),
            **{k: v for k, v in metrics.items() if k != "tokens"},
        }
        return new_state, out_metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch, cache):
        return model.prefill(batch, cache)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return decode_step
