"""Explicit collectives and the ambient mesh (the twin of
``src/repro/distributed/collectives.py``).

The reference's ``shard_map`` bodies become code on each rank's local
tensors, and their collectives ``torch.distributed`` calls on the mesh's
process groups: ``all_reduce`` (SUM, MAX) and ``all_gather``, nothing
else, so that gloo (CPU tests, ranks sharing one card) and NCCL take the
same code.

* `use_mesh` / `current_mesh` / `usable_mesh`: the ambient mesh (the twin
  of ``jax.set_mesh``); the model's hooks are live only under a mesh whose
  model axis has at least 2 ranks.
* `embed_lookup`: the local ``[V, d/TP]`` rows for this rank's tokens.
* `sharded_kv_decode_attention`: flash-decoding over a KV cache split on
  its sequence axis, combined with one MAX and two SUM all-reduces.
* `head_dim_decode_attention`: decode over a KV cache split on head_dim,
  the partial scores summed with one fp32 SUM all-reduce;
  `latent_decode_attention`, its MLA twin over a latent cache split on
  its last dims.
* `vocab_parallel_ce`: the chunked cross-entropy over the rank's vocab
  columns of the unembedding, combined with one MAX and two SUM
  all-reduces a chunk; the unembedding is never gathered.
* `constrain_heads`: heads over TP, else head_dim (a DTensor placement).
* The tensor-parallel conventions of the model's sharded forward (the
  residual stream is replicated over the model axis, values and
  gradients alike): `copy_to_tp` (identity, its gradient summed over the
  model axis) before a column-parallel region, `reduce_from_tp` (a SUM
  all-reduce, identity gradient) after a row-parallel one, `gather`
  (all-gather, its gradient this rank's slice) where a sharded tensor is
  made whole where every rank consumes it alike, `gather_summed`
  (all-gather, its gradient summed over the group and cut to this rank's
  part: a reduce-scatter) where the ranks consume it differently, and
  `dp_mean` (the mean over the data axes, its gradient divided by their
  size).  The head_dim attention's `column_parallel_qkv` and
  `kv_group_sum` sum their partial gradients in fp32 and round them once,
  where the one-device step rounds, so that a sharded bf16 step rounds as
  one device does.  ``torch.distributed.nn.functional.all_reduce``
  differentiates to a SUM of the gradients, which is right only where the
  loss is a sum over ranks; the forms here give the gradient of one loss
  that every rank of a model group computes alike.

* `Stacked` / `gather_layer`: the sharded train step's per-layer FSDP
  gather.  A stacked ``[L, ...]`` parameter stays in its shards; a stack
  loop indexes it (`LayerShard`, no collective) and gathers the layer
  over the data axes inside the layer's checkpointed function, so that
  backward gathers it again and its gradient is summed over the data
  axes and cut to this rank's box as it comes.

`COLLECTIVES` counts the calls by kind since the last `reset_counts`, and
`COLLECTIVE_BYTES` the bytes of their results by the reference's HLO
names (``"all-reduce"``, ``"all-gather"``), which
`roofline.counting.costing` reads.  `LAYER_GATHER` holds the bytes of the
per-layer gathered weights alive now and their peak since the last
`reset_counts`: storage that a gather allocated, never an alias.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import Counter
from typing import Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shd

#: collective calls over more than one rank by kind ("all_reduce_sum",
#: "all_reduce_max", "all_gather") and by site ("decode_combine": the
#: sharded decode's three; "score_sum": the head_dim and latent
#: decodes' one;
#: "unembed_gather": the model's unembedding gathered whole, which
#: `vocab_parallel_ce` and the sharded logits never do; "attn_gather": an
#: attention leaf gathered whole over the model axis, which the heads,
#: head_dim and columns forms never do)
COLLECTIVES: Counter = Counter()
#: result bytes of those calls by kind ("all-reduce", "all-gather")
COLLECTIVE_BYTES: Counter = Counter()
#: bytes of the per-layer gathered weights alive now ("live") and the most
#: alive at once since `reset_counts` ("peak"): what `LayerShard.gather`
#: allocates, and a layer's view made whole at a counted site (`full`)
LAYER_GATHER: Counter = Counter()

_MESH = None


def reset_counts() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()
    LAYER_GATHER["peak"] = LAYER_GATHER["live"]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the block (the twin of
    ``jax.set_mesh``)."""
    global _MESH
    was, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = was


def current_mesh():
    return _MESH


def usable_mesh(min_model: int = 2):
    """The ambient mesh if its model axis has at least ``min_model``
    ranks, else None."""
    mesh = _MESH
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    if shd.axis_sizes(mesh)["model"] < min_model:
        return None
    return mesh


def dp_tp_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    return shd.mesh_axes(mesh)


def dp_size(mesh) -> int:
    sizes = shd.axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in shd.mesh_axes(sizes)[0]))


def tp_size(mesh) -> int:
    return shd.axis_sizes(mesh)["model"]


def tp_rank(mesh) -> int:
    return shd.mesh_coord(mesh)["model"]


def dp_rank(mesh) -> int:
    """This rank's index over the data axes, pod-major."""
    sizes, coord = shd.axis_sizes(mesh), shd.mesh_coord(mesh)
    idx = 0
    for a in shd.mesh_axes(sizes)[0]:
        idx = idx * sizes[a] + coord[a]
    return idx


def group(mesh, axes):
    """The process group of this rank over the mesh axes ``axes`` (one
    name or several, flattened major to minor; made once per mesh)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    made = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in made:
        made[axes] = mesh[axes]._flatten().get_group()
    return made[axes]


def dp_group(mesh):
    return group(mesh, shd.mesh_axes(mesh)[0])


def tp_group(mesh):
    return group(mesh, "model")


# ---------------------------------------------------------------------------
# Raw collectives on local tensors
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, grp, op: str = "sum") -> torch.Tensor:
    """A new tensor: the SUM or MAX of ``x`` over ``grp``."""
    out = x.detach().clone().contiguous()
    if dist.get_world_size(grp) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=grp)
        COLLECTIVES[f"all_reduce_{op}"] += 1
        COLLECTIVE_BYTES["all-reduce"] += out.numel() * out.element_size()
    return out


def all_gather(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order."""
    n = dist.get_world_size(grp)
    if n == 1:
        return x.detach()
    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_BYTES["all-gather"] += n * x.numel() * x.element_size()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=grp)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    n = dist.get_world_size(grp)
    r = dist.get_rank(grp)
    step = x.shape[dim] // n
    return x.narrow(dim, r * step, step)


# ---------------------------------------------------------------------------
# Differentiable forms (the tensor-parallel conventions above)
# ---------------------------------------------------------------------------


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.grp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return all_reduce(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.grp, ctx.dim).contiguous(), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return all_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.float(), ctx.grp).to(g.dtype)
        return _slice(total, ctx.grp, ctx.dim).contiguous(), None, None


class _KVGroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, grp, head, n_heads):
        ctx.grp, ctx.head, ctx.n = grp, head, n_heads
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g):
        slots = torch.zeros((ctx.n, *g.shape), dtype=torch.float32,
                            device=g.device)
        slots[ctx.head] = g
        total = all_reduce(slots, ctx.grp)[ctx.head].to(g.dtype)
        return total, None, None, None


class _ColumnQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, wq, wk, wv, grp):
        # m: the K/V input (x itself for self-attention, passed as None)
        ctx.save_for_backward(x, m, wq, wk, wv)
        ctx.grp = grp
        kv_in = x if m is None else m
        return x @ wq, kv_in @ wk, kv_in @ wv

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, m, wq, wk, wv = ctx.saved_tensors
        kv_in = x if m is None else m
        # each path's partial product in fp32, the three summed over the
        # model axis at once, then rounded and added as autograd adds the
        # one-device step's three (v, then k, then q)
        parts = [g.float() @ w.float().T
                 for g, w in ((gv, wv), (gk, wk), (gq, wq))]
        flat = all_reduce(torch.cat([z.reshape(-1) for z in parts]),
                          ctx.grp).to(x.dtype)
        sv, sk, sq = (z.view_as(y) for z, y in zip(
            flat.split([y.numel() for y in parts]), parts))
        rows, kv_rows = (z.reshape(-1, z.shape[-1]).T for z in (x, kv_in))
        dw = (rows @ gq.reshape(-1, gq.shape[-1]),
              *(kv_rows @ g.reshape(-1, g.shape[-1]) for g in (gk, gv)))
        if m is None:
            return (sv + sk) + sq, None, *dw, None
        return sq, sv + sk, *dw, None


class _DPMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.n = dist.get_world_size(grp)
        return all_reduce(x, grp) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, tp_group(mesh))


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp_group(mesh))


def gather(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    return _Gather.apply(x, grp, dim)


def gather_summed(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, for consumers that
    differ by rank: the gradient is the fp32 SUM of the ranks' gradients,
    cut to this rank's part."""
    return _GatherSummed.apply(x, grp, dim)


def kv_group_sum(z: torch.Tensor, mesh, head: int,
                 n_heads: int) -> torch.Tensor:
    """Identity on a chunk of KV head ``head`` (fp32, inside attention):
    its gradient is summed in fp32 over the model ranks whose query heads
    use that head, before attention rounds it to the compute dtype, so the
    head's dK and dV round once, as on one device (one SUM all-reduce of
    ``n_heads`` slots)."""
    return _KVGroupSum.apply(z, tp_group(mesh), head, n_heads)


def column_parallel_qkv(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, mesh, kv_in=None):
    """``(x @ wq, x @ wk, x @ wv)`` for x replicated over the model axis
    and each w the rank's columns; with ``kv_in`` (a cross block's vision
    states, replicated alike) ``(x @ wq, kv_in @ wk, kv_in @ wv)``.  The
    input gradients are summed over the model axis (what `copy_to_tp`
    does) from fp32 partial products, in one SUM all-reduce, each
    projection's sum rounded to its input's dtype once, as the one-device
    step rounds each of its three whole products."""
    return _ColumnQKV.apply(x, kv_in, wq, wk, wv, tp_group(mesh))


def dp_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    return _DPMean.apply(x, dp_group(mesh))


# ---------------------------------------------------------------------------
# Views of a parameter: what a consumer computes with
# ---------------------------------------------------------------------------


def _is_dtensor(w) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(w, DTensor)


def _gather_axes(w, mesh_dims, dtype=None) -> torch.Tensor:
    """``w``'s local part (a DTensor's), cast to ``dtype`` if given, made
    whole over the mesh dims ``mesh_dims`` that shard it, innermost first,
    so that a dim split pod-major is rebuilt in order; differentiable."""
    loc = w.to_local()
    if dtype is not None:
        loc = loc.to(dtype)
    names = w.device_mesh.mesh_dim_names
    for i in sorted(mesh_dims, reverse=True):
        pl = w.placements[i]
        if pl.is_shard():
            loc = gather(loc, w.device_mesh.get_group(names[i]), pl.dim)
    return loc


def full(w, site: str = "") -> torch.Tensor:
    """The whole tensor: a DTensor gathered over every mesh dim that
    shards it (an explicit all-gather), a plain tensor as it is.  With
    ``site``, a gather over the model axis counts in ``COLLECTIVES[site]``
    and, of a layer's view in the sharded train step, in `LAYER_GATHER`."""
    if not _is_dtensor(w):
        return w
    if site:
        t = w.device_mesh.mesh_dim_names.index("model")
        if w.placements[t].is_shard():
            COLLECTIVES[site] += 1
    out = _gather_axes(w, range(w.device_mesh.ndim))
    # a layer's view (`LayerShard.gather`) made whole where the layer runs
    if (site and getattr(w, "_layer_view", False)
            and out.untyped_storage() is not w.to_local().untyped_storage()):
        _track(out)
    return out


def tp_local(w, dim: int, mesh, dtype=None) -> torch.Tensor:
    """This rank's model-axis block of ``w`` along ``dim``, in ``dtype``
    if given: a DTensor is cast, then gathered over the data axes that
    shard it (FSDP), and keeps its model shard, which must lie on
    ``dim``; a plain tensor is the global one, sliced."""
    grp = tp_group(mesh)
    if not _is_dtensor(w):
        part = _slice(w, grp, dim % w.dim())
        return part if dtype is None else part.to(dtype)
    names = w.device_mesh.mesh_dim_names
    t = names.index("model")
    pl = w.placements[t]
    if not (pl.is_shard() and pl.dim == dim % w.dim()):
        raise ValueError(f"expected a model-axis shard on dim {dim}, the "
                         f"tensor holds {w.placements}")
    return _gather_axes(w, [i for i in range(len(names)) if i != t], dtype)


def dp_replicated(w):
    """A DTensor re-placed Replicate on the data axes (its model placement
    kept), without autograd: the compute view a sharded train step
    differentiates against."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    dp = shd.mesh_axes(mesh)[0]
    dims = [i for i, a in enumerate(names) if a in dp]
    with torch.no_grad():
        loc = _gather_axes(w, dims)
    placements = tuple(Replicate() if i in dims else p
                       for i, p in enumerate(w.placements))
    return DTensor.from_local(loc.contiguous(), mesh, placements,
                              run_check=False, shape=w.shape,
                              stride=w.stride())


# ---------------------------------------------------------------------------
# The per-layer FSDP gather of the sharded train step
# ---------------------------------------------------------------------------


def layer_dp_dim(w) -> int:
    """The tensor dim of a stacked ``[L, ...]`` DTensor that the data axes
    shard, or -1 where they shard none or the stack dim itself (a stacked
    vector such as a norm: no layer's box lies on every data rank)."""
    dp = shd.mesh_axes(w.device_mesh)[0]
    dims = {p.dim for a, p in zip(w.device_mesh.mesh_dim_names, w.placements)
            if a in dp and p.is_shard()}
    if len(dims) != 1 or dims == {0}:
        return -1
    return dims.pop()


class Stacked:
    """A stacked ``[L, ...]`` parameter that the sharded train step keeps
    in its shards: ``local`` is this rank's box (the leaf the step
    differentiates against), ``like`` the storage DTensor it is the box
    of; ``whole`` asks `LayerShard.gather` for the whole layer (the model
    shard gathered too) instead of the model shard.  ``stack[i]`` is layer
    i's box, without a collective."""

    def __init__(self, local: torch.Tensor, like, whole: bool = False):
        self.local, self.like, self.whole = local, like, whole
        self._layers = None

    def viewed(self, whole: bool) -> "Stacked":
        return Stacked(self.local, self.like, whole)

    def __getitem__(self, i: int) -> "LayerShard":
        if self._layers is None:
            self._layers = self.local.unbind(0)
        return LayerShard(self._layers[i], self.like, self.whole)


class LayerShard:
    """Layer i's box of a `Stacked` parameter, gathered where the layer
    runs (`gather_layer`)."""

    def __init__(self, local: torch.Tensor, like, whole: bool):
        self.local, self.like, self.whole = local, like, whole

    def gather(self):
        """The layer's compute view: a DTensor whole over the data axes
        that keeps its model placement (what `dp_replicated` gives a whole
        leaf), or with ``whole`` the plain whole tensor.  The data-axis
        gather's gradient is summed over the data axes and cut to this
        rank's box."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh, like = self.like.device_mesh, self.like
        dp = shd.mesh_axes(mesh)[0]
        loc = gather_summed(self.local, dp_group(mesh),
                            layer_dp_dim(like) - 1)
        # over one data rank the gather is an alias of the stacked leaf,
        # which it did not allocate
        if loc.untyped_storage() is not self.local.untyped_storage():
            _track(loc)
        placements = tuple(
            Replicate() if a in dp else (Shard(p.dim - 1) if p.is_shard()
                                         else p)
            for a, p in zip(mesh.mesh_dim_names, like.placements))
        view = DTensor.from_local(loc, mesh, placements, run_check=False,
                                  shape=like.shape[1:],
                                  stride=shd._contiguous_stride(
                                      like.shape[1:]))
        view._layer_view = True     # a counted site's `full` tracks it
        if not self.whole:
            return view
        out = full(view)
        return out if out.untyped_storage() is loc.untyped_storage() \
            else _track(out)


def gather_layer(tree):
    """A layer's parameter tree with each `LayerShard` gathered; any other
    leaf as it is (without a sharded train step: no change)."""
    if isinstance(tree, dict):
        return {k: gather_layer(v) for k, v in tree.items()}
    return tree.gather() if isinstance(tree, LayerShard) else tree


def _track(t: torch.Tensor) -> torch.Tensor:
    """Count ``t``'s storage in `LAYER_GATHER` while it lives: a storage
    that a gather allocated, never an alias of its input."""
    st = t.untyped_storage()
    n = st.nbytes()
    LAYER_GATHER["live"] += n
    LAYER_GATHER["peak"] = max(LAYER_GATHER["peak"], LAYER_GATHER["live"])
    weakref.finalize(st, LAYER_GATHER.subtract, {"live": n})
    return t


# ---------------------------------------------------------------------------
# The reference's explicit regions
# ---------------------------------------------------------------------------


def embed_lookup(table, tokens: torch.Tensor, mesh) -> torch.Tensor:
    """table [V, d] (d over TP: a DTensor, or the global tensor), tokens
    this rank's [B/DP, S] -> this rank's embeddings [B/DP, S, d/TP]; no
    collective."""
    return tp_local(table, -1, mesh)[tokens]


def sharded_kv_decode_attention(
    q: torch.Tensor,          # [B, Tq, H, D] this rank's batch rows
    k_cache: torch.Tensor,    # [B, S/TP, KVH, D] this rank's slots
    v_cache: torch.Tensor,
    k_new: torch.Tensor,      # [B, Tq, KVH, D]
    v_new: torch.Tensor,
    q_pos: torch.Tensor,      # [B, Tq]
    kv_pos: torch.Tensor,     # [B, S/TP]
    cursor: torch.Tensor,     # [] int32 global write position
    mesh,
):
    """Flash-decoding over the model axis: the cache is split on its
    sequence axis, each rank holding slots ``[r * S_loc, (r + 1) *
    S_loc)``.  Each rank writes the new K/V (and positions) only where the
    slot falls in its range, dropping it otherwise; attends over its slice;
    and the partial softmax statistics are combined with a MAX and two SUM
    all-reduces of [B, KVH, G, Tq]-sized tensors instead of moving the
    cache.  Writes the caches in place and returns (out [B, Tq, H, D] in
    q's dtype, k_cache, v_cache, kv_pos).  Full attention only: no window,
    no ring."""
    grp = tp_group(mesh)
    b, tq, h, d = q.shape
    s_loc, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    # 1. localized cache write (a slot on another rank is dropped)
    first = cursor.to(torch.int64) - tp_rank(mesh) * s_loc
    for j in range(tq):
        slot = first + j
        mine = (slot >= 0) & (slot < s_loc)
        idx = slot.clamp(0, s_loc - 1).reshape(1)
        for cache, new in ((k_cache, k_new), (v_cache, v_new),
                           (kv_pos, q_pos)):
            old = cache.index_select(1, idx)
            src = torch.where(mine, new[:, j:j + 1].to(cache.dtype), old)
            cache.index_copy_(1, idx, src)
    # 2. local partial attention
    qr = q.reshape(b, tq, kvh, g, d)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qr.float(),
                      k_cache.float()) * scale
    vis = (kv_pos >= 0)[:, None] & (kv_pos[:, None, :] <= q_pos[..., None])
    sc = torch.where(vis[:, None, None], sc, torch.full_like(sc, -1e30))
    m_loc = sc.amax(dim=-1)                               # [B, KVH, G, Tq]
    p = torch.exp(sc - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    acc_loc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_cache.dtype), v_cache)
    # 3. combine the partial softmax statistics across the model axis
    m = all_reduce(m_loc, grp, "max")
    corr = torch.exp(m_loc - m)
    l_sum = all_reduce(l_loc * corr, grp)
    acc = all_reduce(acc_loc.float() * corr[..., None], grp)
    COLLECTIVES["decode_combine"] += 3
    out = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    return out.to(q.dtype), k_cache, v_cache, kv_pos


def head_dim_decode_attention(
    q: torch.Tensor,          # [B, Tq, H, D] every head, this rank's rows
    k_cache: torch.Tensor,    # [B, S, KVH, D/TP] this rank's head_dim slice
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,      # [B, Tq]
    kv_pos: torch.Tensor,     # [B, S]
    mesh, *, window: int = 0, n_meta: int = 0,
) -> torch.Tensor:
    """`models.attention.decode_attention` over a cache split on head_dim
    (the reference's cache placement where the KV heads do not divide the
    model axis): each rank scores every head over its head_dim slice, the
    partial scores are summed in fp32 with one SUM all-reduce
    (``COLLECTIVES["score_sum"]``), the softmax is taken whole on every
    rank and P.V runs on the local slice.  Returns this rank's head_dim
    slice of every head's output, [B, Tq, H, D/TP] in q's dtype."""
    from repro_torch.models.attention import NEG_INF, visibility_mask

    b, tq, h, d = q.shape
    kvh, d_loc = k_cache.shape[2], k_cache.shape[3]
    qr = q.narrow(-1, tp_rank(mesh) * d_loc, d_loc).reshape(
        b, tq, kvh, h // kvh, d_loc)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), k_cache.float())
    s = all_reduce(s, tp_group(mesh)) * (1.0 / math.sqrt(d))
    COLLECTIVES["score_sum"] += 1
    vis = visibility_mask(q_pos, kv_pos, causal=True, window=window,
                          n_meta=n_meta)
    s = torch.where(vis[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, tq, h, d_loc).to(q.dtype)


def latent_decode_attention(
    q_abs: torch.Tensor,      # [B, Tq, H, r/TP] every head, this rank's slice
    q_rope: torch.Tensor,     # [B, Tq, H, dr/TP]
    ckv_cache: torch.Tensor,  # [B, S, r/TP] this rank's latent columns
    kr_cache: torch.Tensor,   # [B, S, dr/TP]
    q_pos: torch.Tensor,      # [B, Tq]
    kv_pos: torch.Tensor,     # [B, S]
    mesh, *, scale: float,
) -> torch.Tensor:
    """MLA's absorbed decode (`models.mla.mla_attention_decode`) over a
    latent cache split on its last dims (the reference's ``ckv`` / ``kr``
    placement): each rank scores every head over its slices of the latent
    and the rotary key in fp32, the partial scores are summed with one
    SUM all-reduce (``COLLECTIVES["score_sum"]``), the softmax is taken
    whole on every rank, P·c_kv runs on the rank's latent columns and the
    slices are all-gathered.  Returns the whole latent output [B, Tq, H,
    r] in q_abs's dtype, P cast to the cache's dtype first, as on one
    device."""
    from repro_torch.models.attention import NEG_INF, visibility_mask

    grp = tp_group(mesh)
    s = (torch.einsum("bthr,bsr->bhts", q_abs.float(), ckv_cache.float())
         + torch.einsum("bthp,bsp->bhts", q_rope.float(), kr_cache.float()))
    s = all_reduce(s, grp) * scale
    COLLECTIVES["score_sum"] += 1
    vis = visibility_mask(q_pos, kv_pos, causal=True)
    s = torch.where(vis[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bsr->bthr", p.to(ckv_cache.dtype), ckv_cache)
    return all_gather(o.to(q_abs.dtype), grp, -1)


class _VocabCE(torch.autograd.Function):
    """One chunk's CE over the model axis's vocab split: hx [B, c, d]
    replicated over the model axis, w this rank's [d, V / TP] columns in
    hx's dtype, lx [B, c] global ids (-1 = ignore), ``lo`` the first id of
    the rank's columns -> (sum of token losses, token count), fp32."""

    @staticmethod
    def forward(ctx, hx, w, lx, lo, grp):
        logits = hx.float() @ w.float()                    # [B, c, V/TP]
        m = all_reduce(logits.amax(dim=-1), grp, "max")
        lse = m + torch.log(all_reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1), grp))
        idx = lx.long() - lo
        mine = (idx >= 0) & (idx < logits.shape[-1])
        idx = idx.clamp(0, logits.shape[-1] - 1)
        ll = torch.gather(logits, -1, idx[..., None])[..., 0]
        # the label's logit from the rank whose columns hold it
        ll = all_reduce(torch.where(mine, ll, torch.zeros_like(ll)), grp)
        mask = (lx >= 0).float()
        ctx.save_for_backward(hx, w, logits, lse, idx, mine, mask)
        ctx.grp = grp
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return ((lse - ll) * mask).sum(), count

    @staticmethod
    def backward(ctx, g, _g_count):
        hx, w, logits, lse, idx, mine, mask = ctx.saved_tensors
        # (softmax - onehot) on the rank's columns, the upstream applied
        d = torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, idx[..., None], -mine.float()[..., None])
        d = d * (mask * g)[..., None]
        # dh's partial products in fp32, summed over the model axis, then
        # rounded to h's dtype once, where the one-device step rounds
        dh = all_reduce(d @ w.float().T, ctx.grp).to(hx.dtype)
        rows = hx.float().reshape(-1, hx.shape[-1]).T
        dw = (rows @ d.reshape(-1, d.shape[-1])).to(w.dtype)
        return dh, dw, None, None, None


def _vocab_ce_chunk(hx, lx, w, lo, grp):
    return _VocabCE.apply(hx, w.to(hx.dtype), lx, lo, grp)


def vocab_parallel_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      mesh, *, chunk: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked cross-entropy (``models.model.chunked_ce_loss``) over
    the model axis: h [B, T, d] replicated over it, w this rank's [d, V /
    TP] columns of the unembedding, labels [B, T] (-1 = ignore) -> (sum of
    token losses, token count), fp32, the same on every model rank.  Each
    chunk's logits are the rank's columns, the same fp32 products as one
    device's; the row maxima are combined with a MAX all-reduce, the
    exponential sums and the label's logit with SUM all-reduces.  In
    backward dW stays local, and h's gradient is summed over the model
    axis in fp32 before it is rounded to h's dtype.  Each chunk runs under
    ``torch.utils.checkpoint``; the last chunk may be shorter."""
    grp = tp_group(mesh)
    lo = tp_rank(mesh) * w.shape[-1]
    t = h.shape[1]
    chunk = min(chunk, t)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, t, chunk):
        ls, c = checkpoint(_vocab_ce_chunk, h[:, s:s + chunk],
                           labels[:, s:s + chunk], w, lo, grp,
                           use_reentrant=False, preserve_rng_state=False)
        loss_sum = loss_sum + ls
        count = count + c
    return loss_sum, count


def swiglu_tp(params: dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """The SwiGLU MLP over the model axis: column-parallel gate and up,
    row-parallel down, the partial outputs summed in fp32 (one SUM
    all-reduce) and cast to x's dtype.  Where the hidden width does not
    divide by the model axis, the weights are gathered whole and every
    rank computes the whole MLP."""
    import torch.nn.functional as F

    dt = x.dtype
    f, n = params["w_gate"].shape[-1], tp_size(mesh)
    if f % n or f < n:
        w = {k: full(v).to(dt) for k, v in params.items()}
        return (F.silu(x @ w["w_gate"]) * (x @ w["w_up"])) @ w["w_down"]
    xin = copy_to_tp(x, mesh)
    gate = xin @ tp_local(params["w_gate"], -1, mesh).to(dt)
    up = xin @ tp_local(params["w_up"], -1, mesh).to(dt)
    h = (F.silu(gate) * up) @ tp_local(params["w_down"], -2, mesh).to(dt)
    return reduce_from_tp(h.float(), mesh).to(dt)


def heads_spec(shape, mesh, heads_axis: int = 2) -> shd.Spec:
    """The reference's pin for [B, T, H, D] attention tensors: batch over
    DP, heads over TP if divisible, else head_dim over TP."""
    dp, tp = dp_tp_axes(mesh)
    spec: list = [None] * len(shape)
    if shape[0] % dp_size(mesh) == 0:
        spec[0] = dp
    if shape[heads_axis] % tp_size(mesh) == 0:
        spec[heads_axis] = (tp,)
    elif shape[-1] % tp_size(mesh) == 0:
        spec[-1] = (tp,)
    return tuple(spec)


def constrain_heads(x, heads_axis: int = 2):
    """Place a [B, T, H, D] DTensor with heads over TP, else head_dim (the
    reference's sharding constraint); a plain tensor, or no usable mesh,
    is returned as it is.  It changes no value."""
    mesh = usable_mesh()
    if mesh is None or not _is_dtensor(x) or x.dim() < 3:
        return x
    spec = heads_spec(x.shape, mesh, heads_axis)
    return x.redistribute(mesh, shd.to_placements(spec, mesh))
