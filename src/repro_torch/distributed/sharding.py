"""Per-architecture sharding rules (the twin of
``src/repro/distributed/sharding.py``): DP/FSDP on the (pod, data) mesh
axes, TP/EP on the model axis.

The rules are *path + shape* driven and divisibility-aware: a dimension
that does not divide by its mesh axes is replicated instead (kv_heads = 2
on a 16-way model axis falls back to head_dim), so one rule set serves
all ten archs on the (16, 16) and (2, 16, 16) production meshes.

Conventions (the reference's):

* default (column-parallel) 2D weight [..., in, out]: in -> FSDP, out -> TP
* row-parallel weights ({w_o, w_down, w_out}): in -> TP, out -> FSDP
* MoE expert stacks [L, E, in, out]: E -> TP (expert parallelism), in -> FSDP
* 1D / norm / scalar leaves: replicated
* token tables (embed, meta): d over TP only
* activations/batch: batch dim -> (pod, data)
* KV caches: batch -> (pod, data); kv_heads -> TP if divisible else
  head_dim; with ``decode_kv_shard`` the sequence axis -> TP

The rules come in two steps.  `leaf_spec` (and the cache and batch
rules) map (path names, shape, mesh axis sizes) to a per-dim tuple of mesh
axes, the ``PartitionSpec``'s twin: pure, and testable with no ranks.
`to_placements` then turns a spec into one DTensor placement per mesh dim:
a tensor dim given to ("pod", "data") takes ``Shard(d)`` on both mesh dims,
which DTensor nests in mesh-dim order, pod-major as JAX splits it.
`local_box` is the slice of the global tensor that a mesh coordinate
holds.  ``mesh`` is a `DeviceMesh` or any object with the JAX mesh's
``shape`` (axis name -> size) and ``axis_names``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

ROW_PARALLEL = {"w_o", "w_down", "w_out"}
REPLICATED = {"gate_attn", "gate_ffn", "b_gates", "dt_bias", "d_skip"}

#: one tensor dim's mesh axes (None: replicated)
DimSpec = Optional[Tuple[str, ...]]
Spec = Tuple[DimSpec, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_axes(sizes) -> Tuple[Tuple[str, ...], str]:
    """(dp_axes, tp_axis) for our mesh conventions; ``sizes`` is a mesh or
    its `axis_sizes`."""
    names = sizes if isinstance(sizes, dict) else axis_sizes(sizes)
    if "pod" in names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def _axis_size(sizes: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([sizes[a] for a in axes]))


def fits(dim: int, n: int) -> bool:
    """Whether ``n`` devices split ``dim`` (else the rules replicate it)."""
    return dim % n == 0 and dim >= n


def _fits(dim: int, sizes: Dict[str, int], axes) -> bool:
    return fits(dim, _axis_size(sizes, axes))


def _one(axes) -> DimSpec:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def leaf_spec(path_names: Sequence[str], shape, sizes) -> Spec:
    """The sharding rule for one parameter leaf: a per-dim tuple of mesh
    axes (None: replicated)."""
    sizes = sizes if isinstance(sizes, dict) else axis_sizes(sizes)
    dp, tp = mesh_axes(sizes)
    name = path_names[-1] if path_names else ""
    rank = len(shape)
    spec: list = [None] * rank

    if rank <= 1 or name in REPLICATED:
        return tuple(spec)

    if name in ("embed", "meta"):
        # token-gather tables: d over TP only, so the gather is shard-local
        if _fits(shape[-1], sizes, tp):
            spec[-1] = _one(tp)
        return tuple(spec)

    in_dim, out_dim = rank - 2, rank - 1
    is_expert = (rank >= 4 and any(p == "ffn" or "moe" in p
                                   for p in path_names)
                 and name in ("w_gate", "w_up", "w_down"))
    if is_expert:
        # [L, E, in, out]: experts over TP
        e_dim = rank - 3
        if _fits(shape[e_dim], sizes, tp):
            spec[e_dim] = _one(tp)
        fsdp = out_dim if name in ROW_PARALLEL else in_dim
        if _fits(shape[fsdp], sizes, dp):
            spec[fsdp] = _one(dp)
        return tuple(spec)

    if name.startswith("conv"):
        # depthwise conv [L, W, C]: channels over TP
        if _fits(shape[out_dim], sizes, tp):
            spec[out_dim] = _one(tp)
        return tuple(spec)

    tp_dim, dp_dim = ((in_dim, out_dim) if name in ROW_PARALLEL
                      else (out_dim, in_dim))
    if _fits(shape[tp_dim], sizes, tp):
        spec[tp_dim] = _one(tp)
    if _fits(shape[dp_dim], sizes, dp):
        spec[dp_dim] = _one(dp)
    return tuple(spec)


def batch_spec(shape, sizes) -> Spec:
    """A batch leaf: its leading dim over (pod, data) where it divides."""
    sizes = sizes if isinstance(sizes, dict) else axis_sizes(sizes)
    dp, _ = mesh_axes(sizes)
    spec: list = [None] * len(shape)
    if len(shape) >= 1 and _fits(shape[0], sizes, dp):
        spec[0] = _one(dp)
    return tuple(spec)


def cache_spec(path_names: Sequence[str], shape, sizes, *,
               decode_kv_shard: bool = False) -> Spec:
    """A KV or state cache leaf: [L, B, S, heads, hd] -> batch over DP,
    heads (or head_dim, the latent dim, the channels) over TP; with
    ``decode_kv_shard`` K and V on their sequence axis."""
    sizes = sizes if isinstance(sizes, dict) else axis_sizes(sizes)
    dp, tp = mesh_axes(sizes)
    name = path_names[-1] if path_names else ""
    rank = len(shape)
    spec: list = [None] * rank
    if rank == 0 or name == "length":
        return tuple(spec)
    if name == "pos":                            # [B, S]
        if _fits(shape[0], sizes, dp):
            spec[0] = _one(dp)
        return tuple(spec)
    if rank >= 2 and _fits(shape[1], sizes, dp):  # stacked [L, B, ...]
        spec[1] = _one(dp)
    if name in ("k", "v", "xk", "xv") and rank == 5:
        if decode_kv_shard and name in ("k", "v") \
                and _fits(shape[2], sizes, tp):
            spec[2] = _one(tp)                   # sequence-sharded
        elif _fits(shape[3], sizes, tp):         # kv heads
            spec[3] = _one(tp)
        elif _fits(shape[4], sizes, tp):         # head_dim
            spec[4] = _one(tp)
    elif name in ("ckv", "kr") and rank == 4:
        if _fits(shape[3], sizes, tp):           # latent dim
            spec[3] = _one(tp)
    elif name in ("ssm_h", "ssm_conv") and rank == 4:
        d = -1 if name == "ssm_conv" else 2
        if _fits(shape[d], sizes, tp):
            spec[d] = _one(tp)
    elif name == "c" and rank == 5:              # mLSTM memory [P,B,H,dh,dh]
        if _fits(shape[2], sizes, tp):
            spec[2] = _one(tp)
        elif _fits(shape[3], sizes, tp):
            spec[3] = _one(tp)
    elif rank >= 3:
        # generic states ([P,B,H,dh] mlstm n, [P,B,d] slstm, conv tails)
        for d in range(rank - 1, 1, -1):
            if _fits(shape[d], sizes, tp):
                spec[d] = _one(tp)
                break
    return tuple(spec)


# ---------------------------------------------------------------------------
# Specs -> placements, local boxes, placed tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The twin of ``NamedSharding`` (a leaf of a tree of shardings): the
    mesh, the per-dim spec and the DTensor placements (one per mesh dim)
    it converts to."""
    mesh: Any
    spec: Spec
    placements: tuple


def to_placements(spec: Spec, sizes) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the spec gives
    tensor dim d that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(sizes if isinstance(sizes, dict) else axis_sizes(sizes))
    out = []
    for a in names:
        dims = [d for d, axes in enumerate(spec) if axes and a in axes]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_box(shape, spec: Spec, sizes, coord: Dict[str, int]
              ) -> Tuple[slice, ...]:
    """The slices of a global ``shape`` that the mesh coordinate ``coord``
    (axis name -> index) holds under ``spec``: a dim over several axes is
    split major to minor in the spec's order."""
    sizes = sizes if isinstance(sizes, dict) else axis_sizes(sizes)
    box = []
    for dim, axes in zip(shape, spec):
        if not axes:
            box.append(slice(None))
            continue
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[a]
            n *= sizes[a]
        step = dim // n
        box.append(slice(idx * step, (idx + 1) * step))
    return tuple(box)


def mesh_coord(mesh) -> Dict[str, int]:
    """This rank's coordinate on a `DeviceMesh`, by axis name."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _sharding(mesh, spec: Spec) -> Sharding:
    return Sharding(mesh, spec, to_placements(spec, axis_sizes(mesh)))


def _path_walk(tree, names, fn):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_path_walk(getattr(tree, f), names + (f,), fn)
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _path_walk(v, names + (str(k),), fn)
                for k, v in tree.items()}
    if tree is None:
        return None
    return fn(names, tree)


def map_with_names(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path names, leaf)``."""
    return _path_walk(tree, (), fn)


def param_shardings(cfg, param_shapes, mesh):
    """A `Sharding` tree matching the parameter (or m / v) tree; the leaves
    of ``param_shapes`` need only a ``shape``."""
    sizes = axis_sizes(mesh)
    return map_with_names(
        lambda names, leaf: _sharding(mesh, leaf_spec(names, leaf.shape,
                                                      sizes)),
        param_shapes)


def batch_shardings(cfg, batch_shapes, mesh):
    sizes = axis_sizes(mesh)
    return map_with_names(
        lambda names, leaf: _sharding(mesh, batch_spec(leaf.shape, sizes)),
        batch_shapes)


def cache_shardings(cfg, cache_shapes, mesh):
    sizes = axis_sizes(mesh)
    shard_kv = bool(getattr(cfg, "decode_kv_shard", False))
    return map_with_names(
        lambda names, leaf: _sharding(mesh, cache_spec(
            names, leaf.shape, sizes, decode_kv_shard=shard_kv)),
        cache_shapes)


def replicated(mesh, tree):
    return map_with_names(
        lambda names, leaf: _sharding(mesh, (None,) * len(leaf.shape)), tree)


def place(value, sharding: Sharding, *, device=None, dtype=None):
    """A DTensor of the global ``value`` (a tensor or a numpy array, the
    same on every rank) under ``sharding``: this rank slices its own box
    and copies only that to ``device``, never the whole leaf."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    box = local_box(value.shape, sharding.spec, axis_sizes(mesh),
                    mesh_coord(mesh))
    part = value[box]
    if isinstance(part, np.ndarray):
        from repro_torch.checkpoint.serialize import host_tensor
        part = host_tensor(np.ascontiguousarray(part))
    device = torch.device(mesh.device_type) if device is None else device
    local = part.to(device=device, dtype=dtype, copy=True).contiguous()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=tuple(value.shape),
                              stride=_contiguous_stride(value.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def shard_model(model, mesh, *, generator: Optional[torch.Generator] = None,
                source: Optional[dict] = None, device=None):
    """Make every parameter of ``model`` (a `models.model.Model`, its
    parameters on any device, ``meta`` included) a DTensor placed by
    `param_shardings`.  Each leaf's values come from ``source`` (a dict of
    path -> global tensor) or, in the model's sorted init order, from
    ``generator`` drawn on ``device`` (so the values are `Model.init`'s
    bit for bit); each global leaf lives only while this rank slices its
    box from it.  Returns the model."""
    import torch.nn as nn

    shardings = dict(_flat(param_shardings(model.cfg, model.params(), mesh)))
    device = torch.device(mesh.device_type) if device is None else device
    params = dict(model.named_parameters())
    with torch.no_grad():
        for path in sorted(params):
            p = params[path]
            if source is not None:
                full = source[path]
            else:
                full = torch.empty(p.shape, dtype=p.dtype, device=device)
                model._inits[path](full, generator)
            dt = place(full, shardings[path], device=device)
            del full
            owner, _, name = path.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            module._parameters[name] = nn.Parameter(dt, requires_grad=False)
    return model


def _flat(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
