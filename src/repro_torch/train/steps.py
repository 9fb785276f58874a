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

Under an ambient mesh (`distributed.collectives.use_mesh`) the step is
sharded: the parameters (DTensors placed by
`distributed.sharding.shard_model`) and AdamW's m and v (`shard_opt`)
stay in their shards.  A stacked ``[L, ...]`` leaf that the data axes
shard (every layer weight) stays so: the step differentiates against the
rank's box (`collectives.Stacked`), and the stack gathers each layer over
the data axes inside the layer's checkpointed function
(`collectives.gather_layer`), again in backward's recompute, its gradient
summed over the data axes and cut to the rank's box as each layer's
backward runs; so at most one layer's gathered weights are alive at once
(`collectives.LAYER_GATHER`).  With ``grad_accum > 1`` each microbatch's
layer gradients are reduced as they come: the data-axis all-reduce of the
stacked leaves runs once a microbatch, not once a step, and no unreduced
whole-layer gradient outlives its layer's backward.  Every other leaf
(embed, unembed, ``norm_f``, ``vision_proj``, the stacked norms) is
gathered over the data axes once a step (an explicit all-gather) into the
view the loss is differentiated against, and its gradient summed over the
data axes and cut to the rank's shard after the last microbatch.  The
model takes the global batch and each rank its rows over the data axes
(`models.model.Model.loss`), the MoE layers through the expert-parallel
dispatch in train mode; the clip's global norm sums every shard once (a
leaf replicated over a mesh axis counted once); and AdamW updates each
rank's shards in place.  Each gradient's sums run in a fixed order, so
two runs of a step give the same bits.

``make_prefill_step`` / ``make_decode_step`` are the serving entry points.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict

import torch

from repro_torch.checkpoint.serialize import leaf_paths, map_with_path
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
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


def shard_opt(params) -> adamw.AdamWState:
    """Zero AdamW moments placed as their parameters (DTensors) are: each
    rank allocates only its box, in fp32; step 0."""
    from torch.distributed.tensor import DTensor

    def zeros(_key, p):
        loc = torch.zeros(p.to_local().shape, dtype=torch.float32,
                          device=p.to_local().device)
        return DTensor.from_local(loc, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())

    first = leaf_paths(params)[0][1].to_local()
    return adamw.AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=map_with_path(zeros, params), v=map_with_path(zeros, params))


def _sharded_grads(grads: dict, storage: dict, mesh) -> dict:
    """Each view's gradient summed over the data axes and cut to the
    rank's box of its storage leaf: plain local tensors."""
    grp = col.dp_group(mesh)
    out = {}
    for k, g in grads.items():
        st = storage[k]
        g = g.to_local() if col._is_dtensor(g) else g
        g = col.all_reduce(g.float(), grp)
        # the view holds the model-axis shard; cut the data-axis box, the
        # outer mesh dim first (a dim split over (pod, data) is pod-major)
        names = st.device_mesh.mesh_dim_names
        coord, sizes = shd.mesh_coord(mesh), shd.axis_sizes(mesh)
        for i in range(len(names)):
            pl = st.placements[i]
            if pl.is_shard() and names[i] != "model":
                n, r = sizes[names[i]], coord[names[i]]
                step = g.shape[pl.dim] // n
                g = g.narrow(pl.dim, r * step, step)
        out[k] = g.contiguous()
    return out


#: the parameter tree's stacked [L, ...] subtrees
_STACKS = ("['blocks']", "['cross']", "['m_blocks']", "['s_blocks']")


def _in_stack(key: str) -> bool:
    """Whether a leaf path (`leaf_paths`' key) lies in a layer stack."""
    return any(s in key for s in _STACKS)


def _sharded_norm(grads: dict, storage: dict, mesh) -> torch.Tensor:
    """The global norm over every shard: each rank's sum of squares,
    divided by the number of ranks that hold the same box, summed over
    the world."""
    sizes = shd.axis_sizes(mesh)
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(grads.values())).device)
    for k, g in grads.items():
        copies = 1
        for a, pl in zip(storage[k].device_mesh.mesh_dim_names,
                         storage[k].placements):
            if pl.is_replicate():
                copies *= sizes[a]
        total = total + g.float().square().sum() / copies
    for a in mesh.mesh_dim_names:
        total = col.all_reduce(total, mesh.get_group(a))
    return torch.sqrt(total)


def _grads(objective, leaves: dict, batch, accum: int):
    """Over ``accum`` equal microbatches of ``batch``: ``objective(mb)`` ->
    (the scalar differentiated, its metrics).  Returns the gradients with
    respect to ``leaves`` (path -> tensor; a DTensor's as its local
    tensor) and the detached metrics, each the mean over the microbatches;
    with more than one, the gradients accumulate in fp32.  A leaf the
    objective never reads (the audio model's norm_f: its decoder ends in
    its own LayerNorm) gets a zero gradient, as under jax.grad."""
    keys = list(leaves)
    n = next(iter(batch.values())).shape[0] // accum
    grads, metrics = None, {}
    for i in range(accum):
        mb = batch if accum == 1 else {k: v[i * n:(i + 1) * n]
                                       for k, v in batch.items()}
        value, m = objective(mb)
        g = torch.autograd.grad(value, [leaves[k] for k in keys],
                                allow_unused=True, materialize_grads=True)
        g = [gi.to_local() if col._is_dtensor(gi) else gi for gi in g]
        m = {k: v.detach() for k, v in m.items()}
        if accum == 1:
            return dict(zip(keys, g)), m
        if grads is None:
            grads = [torch.zeros(gi.shape, dtype=torch.float32,
                                 device=gi.device) for gi in g]
        grads = [a + b.float() for a, b in zip(grads, g)]
        metrics = {k: metrics.get(k, 0) + v for k, v in m.items()}
    return ({k: g / accum for k, g in zip(keys, grads)},
            {k: v / accum for k, v in metrics.items()})


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    lr_fn = adamw.cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)

    def sharded_step(state: TrainState, batch, mesh):
        storage = dict(leaf_paths(state.params))
        layered = {k for k, p in storage.items()
                   if _in_stack(k) and col.layer_dp_dim(p) > 0}
        views = {k: (p.to_local() if k in layered else col.dp_replicated(p)
                     ).detach().requires_grad_()
                 for k, p in storage.items()}

        def tree():
            # made anew for each microbatch: a Stacked leaf's layers are
            # views of its box in that microbatch's graph
            return map_with_path(
                lambda k, p: col.Stacked(views[k], p) if k in layered
                else views[k], state.params)

        grads, metrics = _grads(lambda mb: model.loss(mb, params=tree()),
                                views, batch, tcfg.grad_accum)
        reduced = _sharded_grads({k: g.float() for k, g in grads.items()
                                  if k not in layered}, storage, mesh)
        grads = {k: reduced[k] if k not in layered else grads[k].float()
                 for k in storage}
        del views
        gnorm = _sharded_norm(grads, storage, mesh)
        scale = torch.clamp(tcfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        lr = lr_fn(state.opt.step)
        local = {k: p.to_local() for k, p in storage.items()}
        loc = lambda tree: map_with_path(lambda k, t: t.to_local(), tree)
        opt_local = adamw.AdamWState(step=state.opt.step,
                                     m=loc(state.opt.m), v=loc(state.opt.v))
        adamw.update(map_with_path(lambda k, _p: local[k], state.params),
                     map_with_path(lambda k, _p: grads[k], state.params),
                     opt_local, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
                     weight_decay=tcfg.weight_decay)
        new_opt = adamw.AdamWState(step=state.opt.step + 1, m=state.opt.m,
                                   v=state.opt.v)
        return (TrainState(params=state.params, opt=new_opt,
                           rng=fold_in(state.rng, 1),
                           data_cursor=state.data_cursor + 1),
                metrics["loss"], gnorm, lr,
                {k: metrics[k] for k in ("ce_loss", "aux_loss")})

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        accum = tcfg.grad_accum
        params = state.params
        mesh = col.current_mesh()
        if mesh is not None:
            with deterministic(state.opt.step.device):
                new_state, loss, gnorm, lr, metrics = sharded_step(
                    state, batch, mesh)
            return new_state, {
                "loss": loss, "grad_norm": gnorm, "lr": lr,
                "step": new_state.opt.step.float(), **metrics}

        def objective(mb):
            loss, metrics = model.loss(mb, params=params)
            return loss, dict(metrics, loss=loss)

        with deterministic(state.opt.step.device):
            grads, metrics = _grads(objective, dict(leaf_paths(params)),
                                    batch, accum)
            loss = metrics.pop("loss")
            if accum > 1:
                metrics = {"ce_loss": loss, "aux_loss": metrics["aux_loss"]}
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
