"""The port's side of ``tests/test_torch_distributed.py``: eight gloo
ranks on a (2, 4) mesh of CPU processes, one torch thread each, meeting
through a ``FileStore`` (no ports).  Every check runs on every rank;
rank 0 writes the results.

  python tests/torch_dist_ranks.py REF.npz OUT.npz

REF.npz holds the reference's 8-device outputs and the parameters and
inputs they were computed from (see the test module).
"""
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def _tree(ref, prefix):
    """{dotted path: tensor} of the reference leaves saved under
    ``prefix``."""
    n = len(prefix)
    return {k[n:]: torch.from_numpy(ref[k].copy()) for k in ref.files
            if k.startswith(prefix)}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _every_rank(ok: bool) -> np.ndarray:
    """Whether ``ok`` holds on every rank (rank 0 writes the results)."""
    from repro_torch.distributed import collectives as col

    bad = col.all_reduce(torch.tensor([0.0 if ok else 1.0]),
                         dist.group.WORLD, "max")
    return np.asarray(float(bad[0]) == 0.0)


def _ep(ref, mesh, out):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.moe_ep import moe_ffn_ep
    from repro_torch.models import moe as moe_mod

    r, n = col.dp_rank(mesh), col.dp_size(mesh)
    moe = MoEConfig(n_routed=8, top_k=2, d_expert=16)
    params = _nest(_tree(ref, "ep.p."))
    x = torch.from_numpy(ref["ep.x"])
    rows = slice(r * x.shape[0] // n, (r + 1) * x.shape[0] // n)
    out["ep.plain"] = moe_mod.moe_ffn(moe, params, x)[0].numpy()
    for cf in (0.5, 1.0, 8.0):
        y, _ = moe_ffn_ep(moe, params, x[rows], mesh, capacity_factor=cf)
        out[f"ep.{cf}"] = col.all_gather(y, col.dp_group(mesh), 0).numpy()

    # gradients of the train mode, drop-free, against moe_ffn_train
    moe = MoEConfig(n_routed=8, top_k=2, d_expert=16, n_shared=1,
                    d_shared=32)
    gen = torch.Generator().manual_seed(3)
    spec = moe_mod.moe_params_spec(24, moe, torch.float32)
    flat = {}
    for k in sorted(spec):
        if isinstance(spec[k], dict):
            for kk in sorted(spec[k]):
                shape, init, dt = spec[k][kk]
                flat[f"{k}.{kk}"] = init(torch.empty(shape, dtype=dt), gen)
        else:
            shape, init, dt = spec[k]
            flat[k] = init(torch.empty(shape, dtype=dt), gen)
    x = torch.randn(4, 6, 24, generator=gen) * 0.5
    cot = torch.randn(4, 6, 24, generator=gen)
    leaves = {k: v.clone().requires_grad_() for k, v in flat.items()}
    xg = x.clone().requires_grad_()
    y1, _ = moe_mod.moe_ffn_train(moe, _nest(leaves), xg)
    g1 = torch.autograd.grad((y1 * cot).sum(), [*leaves.values(), xg])
    leaves2 = {k: v.clone().requires_grad_() for k, v in flat.items()}
    xl = x[rows].clone().requires_grad_()
    y2, _ = moe_ffn_ep(moe, _nest(leaves2), xl, mesh, capacity_factor=8.0,
                       mode="train")
    g2 = torch.autograd.grad((y2 * cot[rows]).sum(), [*leaves2.values(), xl])
    errs = []
    for k, a, b in zip(flat, g1, g2):
        b = col.all_reduce(b, col.dp_group(mesh))
        if k != "router":
            # a rank's experts and its columns of the shared MLP: the
            # model ranks' gradients are disjoint parts of the global one
            b = col.all_reduce(b, col.tp_group(mesh))
        errs.append(float((a - b).abs().max() / max(a.abs().max(), 1.0)))
    errs.append(float((g1[-1][rows] - g2[-1]).abs().max()
                      / max(g1[-1].abs().max(), 1.0)))
    worst = torch.tensor([max(errs)])
    out["ep.grad_err"] = col.all_reduce(worst, dist.group.WORLD,
                                        "max").numpy()
    out["ep.y_train_err"] = col.all_reduce(
        (y1[rows] - y2).abs().max().detach().reshape(1), dist.group.WORLD,
        "max").numpy()[0]


def _reshard(out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.reshard import restore_resharded, save_global
    from repro_torch.distributed import sharding as shd

    m1 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    m2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=gen)
    b = torch.arange(8.0)
    specs = {"w": (("data",), ("model",)), "b": (("model",),)}

    def sh(mesh):
        return {k: shd.Sharding(mesh, s, shd.to_placements(s, mesh))
                for k, s in specs.items()}

    state = {k: shd.place(v, sh(m1)[k], device="cpu")
             for k, v in (("w", w), ("b", b))}
    leaves = save_global(state)
    template = {"w": torch.empty(16, 8, device="meta"),
                "b": torch.empty(8, device="meta")}
    restored = restore_resharded(leaves, template, sh(m2), device="cpu")
    box = shd.local_box((16, 8), specs["w"], shd.axis_sizes(m2),
                        shd.mesh_coord(m2))
    loc = restored["w"].to_local()
    ok = (torch.equal(loc, w[box]) and loc.numel() == w.numel() // 8
          and np.array_equal(save_global(restored)["['w']"], w.numpy()))
    single = restore_resharded(leaves, template, None, device="cpu")
    ok = ok and torch.equal(single["w"], w) and torch.equal(single["b"], b)
    ok = ok and tuple(restored["w"].device_mesh.mesh.shape) == (2, 4)
    out["reshard.ok"] = _every_rank(ok)
    out["reshard.local_numel"] = np.asarray(loc.numel())


def _embed(mesh, out):
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd

    gen = torch.Generator().manual_seed(5)
    table = torch.randn(128, 32, generator=gen)
    tokens = torch.randint(0, 128, (4, 6), generator=gen)
    spec = shd.leaf_spec(("embed",), table.shape, mesh)
    placed = shd.place(table, shd.Sharding(mesh, spec,
                                           shd.to_placements(spec, mesh)),
                       device="cpu")
    r, n = col.dp_rank(mesh), col.dp_size(mesh)
    t = col.tp_rank(mesh)
    rows = slice(r * 2, (r + 1) * 2)
    got = col.embed_lookup(placed, tokens[rows], mesh)
    want = table[tokens][rows][..., t * 8:(t + 1) * 8]
    out["embed.equal"] = _every_rank(torch.equal(got, want))

    # constrain_heads: heads over the model axis where they divide, else
    # head_dim; the values unchanged
    from torch.distributed.tensor import DTensor, Replicate, Shard
    places = []
    with col.use_mesh(mesh):
        for h in (4, 2):
            x = torch.randn(4, 3, h, 8, generator=gen)
            rep = DTensor.from_local(x, mesh, (Replicate(), Replicate()))
            c = col.constrain_heads(rep)
            places.append(c.placements == (Shard(0), Shard(2 if h == 4
                                                          else 3))
                          and torch.equal(c.full_tensor(), x))
        places.append(col.constrain_heads(x) is x)
    out["heads.ok"] = _every_rank(all(places))


def _decode(ref, mesh, out):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model

    base = ModelConfig(name="m", family="dense", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                       compute_dtype="float32")
    src = _tree(ref, "dec.p.")
    tok = torch.from_numpy(ref["dec.tokens"]).int()
    nxt = torch.from_numpy(ref["dec.next"]).int()
    # (name, decode_kv_shard, on the mesh): one process, the sequence
    # split, and the head_dim split the 2 KV heads take without it
    for name, flag, sharded in (("baseline", False, False),
                                ("sharded", True, True),
                                ("hd", False, True)):
        m = Model(base.replace(decode_kv_shard=flag), device="cpu",
                  q_chunk=8, kv_chunk=8)
        m.adopt(_nest(src))
        if sharded:
            shd.shard_model(m, mesh, source=src, device="cpu")
            col.reset_counts()
        logits = []
        with col.use_mesh(mesh if sharded else None):
            cache = m.init_cache(4, 20, dtype=torch.float32)
            cache, first = m.prefill({"tokens": tok}, cache)
            logits.append(first)
            cache, step = m.decode_step(cache, nxt)
            logits.append(step)
            if sharded:
                col.reset_counts()
            cache, step = m.decode_step(cache, nxt)
            logits.append(step)
        if name == "hd":
            for step, lg in zip(("prefill", "decode1", "decode2"), logits):
                out[f"hd.{step}"] = lg.numpy()
            out["hd.layout"] = np.asarray(cache["layout"])
            out["hd.k_local"] = np.asarray(cache["layers"]["k"].shape)
            out["hd.score_sums"] = np.asarray(col.COLLECTIVES["score_sum"])
            continue
        out[f"dec.{name}"] = logits[-1].numpy()
        if name == "baseline":
            for step, lg in zip(("prefill", "decode1", "decode2"), logits):
                out[f"hd.baseline.{step}"] = lg.numpy()
        else:
            out["dec.layout"] = np.asarray(cache["layout"])
            out["dec.combine"] = np.asarray(col.COLLECTIVES["decode_combine"])
            out["dec.k_local"] = np.asarray(cache["layers"]["k"].shape)
    # the same model cut to 2 query heads of 8 (the columns form: half a
    # head a rank) with the sequence split, against one process
    cut = base.replace(n_heads=2, head_dim=8, decode_kv_shard=True)
    shapes = dict(Model(cut, device="meta").named_parameters())
    src = {k: v[tuple(slice(0, n) for n in shapes[k].shape)].clone()
           for k, v in src.items()}
    for sharded in (False, True):
        m = Model(cut, device="cpu", q_chunk=8, kv_chunk=8)
        m.adopt(_nest({k: v.clone() for k, v in src.items()}))
        if sharded:
            shd.shard_model(m, mesh, source=src, device="cpu")
        tag = f"cols.{'sharded' if sharded else 'one'}"
        with col.use_mesh(mesh if sharded else None):
            cache = m.init_cache(4, 20, dtype=torch.float32)
            col.reset_counts()
            cache, lg = m.prefill({"tokens": tok}, cache)
            out[f"{tag}.prefill"] = lg.numpy()
            for i in (1, 2):
                cache, lg = m.decode_step(cache, nxt)
                out[f"{tag}.decode{i}"] = lg.numpy()
        if sharded:
            out["cols.layout"] = np.asarray(cache["layout"])
            out["cols.k_local"] = np.asarray(cache["layers"]["k"].shape)
            out["cols.attn_gathers"] = np.asarray(
                col.COLLECTIVES["attn_gather"])


def _train(ref, mesh, out):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.train import steps
    from repro_torch.train.state import TrainState, init_train_state

    src = _tree(ref, "train.p.")
    batch = {"tokens": torch.from_numpy(ref["train.tokens"]).int(),
             "labels": torch.from_numpy(ref["train.labels"]).int()}
    tcfg = steps.TrainConfig(grad_accum=2, lr=1e-3, warmup_steps=0)

    def cfg(aux):
        return ModelConfig(name="m", family="moe", n_layers=2, d_model=32,
                           n_heads=4, n_kv_heads=2, d_ff=48, vocab=128,
                           moe=MoEConfig(n_routed=8, top_k=2, d_expert=48,
                                         router_aux_coef=aux))

    def sharded(c, factor):
        m = Model(c, device="meta", q_chunk=16, kv_chunk=16)
        shd.shard_model(m, mesh, source=src, device="cpu")
        state = TrainState(params=m.params(), opt=steps.shard_opt(m.params()),
                           rng=torch.zeros(2, dtype=torch.uint32),
                           data_cursor=torch.zeros((), dtype=torch.int32))
        was, moe_ep.EP_CAPACITY_FACTOR = moe_ep.EP_CAPACITY_FACTOR, factor
        col.reset_counts()
        try:
            with col.use_mesh(mesh):
                state, metrics = steps.make_train_step(m, tcfg)(state, batch)
        finally:
            moe_ep.EP_CAPACITY_FACTOR = was
        peak[0] = max(peak[0], col.LAYER_GATHER["peak"])
        out["train.unembed_gathers"] = np.asarray(
            col.COLLECTIVES["unembed_gather"])
        from repro_torch.checkpoint.reshard import save_global
        return save_global(state.params), metrics, m

    # the reference's cell: the default factor and aux coefficient
    peak = [0]
    _, mt, _ = sharded(cfg(0.01), 1.25)
    out["train.loss_ref_cell"] = np.asarray(float(mt["loss"]))
    # drop-free and aux-free against the one-process step
    p2, mt2, m2 = sharded(cfg(0.0), 8.0)
    m1 = Model(cfg(0.0), device="cpu", q_chunk=16, kv_chunk=16)
    m1.adopt(_nest({k: v.clone() for k, v in src.items()}))
    grads = {}
    for i in range(2):
        mb = {k: v[i * 4:(i + 1) * 4] for k, v in batch.items()}
        params = dict(m1.named_parameters())
        loss, _ = m1.loss(mb)
        g = torch.autograd.grad(loss, list(params.values()))
        for k, gi in zip(params, g):
            grads[k] = grads.get(k, 0) + gi / 2
    s1 = init_train_state(m1.params())
    s1, mt1 = steps.make_train_step(m1, tcfg)(s1, batch)
    out["train.loss_sharded"] = np.asarray(float(mt2["loss"]))
    out["train.loss_one"] = np.asarray(float(mt1["loss"]))
    out["train.gnorm_sharded"] = np.asarray(float(mt2["grad_norm"]))
    out["train.gnorm_one"] = np.asarray(float(mt1["grad_norm"]))
    for k, v in dict(m1.named_parameters()).items():
        out[f"train.after_sharded.{k}"] = p2["".join(
            f"[{p!r}]" for p in k.split("."))]
        out[f"train.after_one.{k}"] = v.detach().numpy()
        out[f"train.grad_one.{k}"] = grads[k].numpy()
    local = max(p.to_local().numel() / p.numel() for p in m2.parameters()
                if any(pl.is_shard() for pl in p.placements))
    out["train.largest_local_share"] = np.asarray(local)
    # one layer's weights as the stack gathers them: the model shard of
    # each stacked leaf that the data axes shard, whole over them
    layer = sum(p.to_local()[0].numel() * col.dp_size(mesh)
                * p.element_size() for k, p in m2.named_parameters()
                if k.startswith("blocks.") and col.layer_dp_dim(p) > 0)
    out["train.layer_gathered_bytes"] = np.asarray(layer)
    out["train.gathered_peak"] = np.asarray(peak[0])


def _sharded_step(model, mesh, batch, tcfg):
    """One sharded train step of ``model`` (placed on ``mesh``) on
    ``batch``: its metrics, with the per-step counters read after it."""
    from repro_torch.distributed import collectives as col
    from repro_torch.train import steps
    from repro_torch.train.state import TrainState

    state = TrainState(params=model.params(),
                       opt=steps.shard_opt(model.params()),
                       rng=torch.zeros(2, dtype=torch.uint32),
                       data_cursor=torch.zeros((), dtype=torch.int32))
    col.reset_counts()
    with col.use_mesh(mesh):
        _, metrics = steps.make_train_step(model, tcfg)(state, batch)
    return metrics


VLM_ARCH = "llama-3.2-vision-11b"


def _vlm(ref, mesh, out):
    """The VLM smoke in fp32 on the (2, 4) mesh against the reference's
    8-device run and one process: prefill and two decode steps at 2 KV
    heads (``vlm``: the head_dim form) and 4 (``vlm4``: heads), the
    layout, the local vision cache and the score sums of each decode step;
    then the sharded train step at 2 KV heads."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.train import steps
    from repro_torch.train.state import init_train_state

    tok = torch.from_numpy(ref["vlm.tokens"]).int()
    nxt = torch.from_numpy(ref["vlm.next"]).int()
    fe = torch.from_numpy(ref["vlm.frontend"])
    for name, kvh in (("vlm", 2), ("vlm4", 4)):
        cfg = get_smoke_config(VLM_ARCH).replace(compute_dtype="float32",
                                                 n_kv_heads=kvh)
        src = _tree(ref, f"{name}.p.")
        for sharded in (False, True):
            m = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
            m.adopt(_nest({k: v.clone() for k, v in src.items()}))
            if sharded:
                shd.shard_model(m, mesh, source=src, device="cpu")
            tag = f"{name}.{'sharded' if sharded else 'one'}"
            sums = []
            with col.use_mesh(mesh if sharded else None):
                cache = m.init_cache(4, 8, dtype=torch.float32)
                cache, lg = m.prefill({"tokens": tok, "frontend": fe}, cache)
                out[f"{tag}.prefill"] = lg.numpy()
                for i in (1, 2):
                    col.reset_counts()
                    cache, lg = m.decode_step(cache, nxt)
                    out[f"{tag}.decode{i}"] = lg.numpy()
                    sums.append(col.COLLECTIVES["score_sum"])
            if sharded:
                out[f"{name}.layout"] = np.asarray(cache["layout"])
                out[f"{name}.xk_local"] = np.asarray(
                    cache["layers"]["xk"].shape)
                out[f"{name}.k_local"] = np.asarray(cache["layers"]["k"].shape)
                out[f"{name}.score_sums"] = np.asarray(sums)

    cfg = get_smoke_config(VLM_ARCH).replace(compute_dtype="float32")
    src = _tree(ref, "vlm.p.")
    batch = {k: torch.from_numpy(ref[f"vlm.train.{k}"]).int()
             for k in ("tokens", "labels")}
    batch["frontend"] = fe
    tcfg = steps.TrainConfig(lr=1e-3, warmup_steps=0)
    one = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
    one.adopt(_nest({k: v.clone() for k, v in src.items()}))
    _, m1 = steps.make_train_step(one, tcfg)(init_train_state(one.params()),
                                            batch)
    two = Model(cfg, device="meta", q_chunk=8, kv_chunk=8)
    shd.shard_model(two, mesh, source=src, device="cpu")
    m2 = _sharded_step(two, mesh, batch, tcfg)
    for key, val in (("loss_sharded", m2["loss"]), ("loss_one", m1["loss"]),
                     ("gnorm_sharded", m2["grad_norm"]),
                     ("gnorm_one", m1["grad_norm"])):
        out[f"vlm.train.{key}"] = np.asarray(float(val))
    out["vlm.train.unembed_gathers"] = np.asarray(
        col.COLLECTIVES["unembed_gather"])
    out["vlm.train.largest_local_share"] = np.asarray(max(
        p.to_local().numel() / p.numel() for p in two.parameters()
        if any(pl.is_shard() for pl in p.placements)))


#: (name, arch, config changes) of the MLA and hybrid smokes: the
#: reference's fp32 smokes (``mla``: 4 heads, the heads form; ``hyb``: 4
#: query and 2 KV heads, the head_dim form), its 6-head configs (``mla6``:
#: 6 heads; ``hyb6``: 6 query and 2 KV heads; 1.5 heads a rank of the
#: 4-way model axis, as minicpm3-4b's and hymba's on 16: the columns form)
#: and, against one process only, 2 heads (the columns form on half a head
#: a rank), hymba's 2 query heads and 1 KV head 6 wide (``hybw``: the
#: 4-way axis divides w_q's 12 columns but not w_k's 6, which the rules
#: replicate: every head on every rank from weights gathered whole) and
#: minicpm3's 2 heads with v_head_dim 3 (``mlaw``: w_uv's and w_o's 6 do
#: not divide the axis: every head on every rank from gathered
#: up-projections, the latent cache still split), cut from the
#: reference's 4-head parameters
NEW_FAMILIES = (("mla", "minicpm3-4b", {}), ("hyb", "hymba-1.5b", {}),
                ("mla6", "minicpm3-4b", {"n_heads": 6, "n_kv_heads": 6}),
                ("hyb6", "hymba-1.5b", {"n_heads": 6, "n_kv_heads": 2}),
                ("mla2", "minicpm3-4b", {"n_heads": 2, "n_kv_heads": 2}),
                ("hyb2", "hymba-1.5b", {"n_heads": 2}),
                ("hybw", "hymba-1.5b", {"n_heads": 2, "n_kv_heads": 1,
                                        "head_dim": 6}),
                ("mlaw", "minicpm3-4b", {"n_heads": 2, "n_kv_heads": 2,
                                         "mla": {"v_head_dim": 3}}))


def _new_families(ref, mesh, out):
    """The MLA and hybrid smokes in fp32 on the (2, 4) mesh against the
    reference's 8-device run and one process: prefill and two decode
    steps, the layout, the local cache boxes, the score sums of each
    decode step and the attention leaves gathered whole; then the sharded
    train step against the one-process step.  The ``2`` variants take the
    reference's parameters with their heads cut to two."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.train import steps
    from repro_torch.train.state import init_train_state

    tcfg = steps.TrainConfig(lr=1e-3, warmup_steps=0)
    for name, arch, change in NEW_FAMILIES:
        base = name if name.endswith("6") else name[:3]
        cfg = get_smoke_config(arch)
        if "mla" in change:               # MLA widths changed
            change = {**change, "mla": dataclasses.replace(cfg.mla,
                                                           **change["mla"])}
        cfg = cfg.replace(compute_dtype="float32", **change)
        tok = torch.from_numpy(ref[f"{base}.tokens"]).int()
        nxt = torch.from_numpy(ref[f"{base}.next"]).int()
        shapes = dict(Model(cfg, device="meta").named_parameters())
        # the reference's parameters, cut to the variant's head columns
        src = {k: v[tuple(slice(0, n) for n in shapes[k].shape)].clone()
               for k, v in _tree(ref, f"{base}.p.").items()}
        for sharded in (False, True):
            m = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
            m.adopt(_nest({k: v.clone() for k, v in src.items()}))
            if sharded:
                shd.shard_model(m, mesh, source=src, device="cpu")
            tag = f"{name}.{'sharded' if sharded else 'one'}"
            sums, gathers = [], 0
            with col.use_mesh(mesh if sharded else None):
                cache = m.init_cache(4, tok.shape[1] + 4,
                                     dtype=torch.float32)
                col.reset_counts()
                cache, lg = m.prefill({"tokens": tok}, cache)
                out[f"{tag}.prefill"] = lg.numpy()
                for i in (1, 2):
                    gathers += col.COLLECTIVES["attn_gather"]
                    col.reset_counts()
                    cache, lg = m.decode_step(cache, nxt)
                    out[f"{tag}.decode{i}"] = lg.numpy()
                    sums.append(col.COLLECTIVES["score_sum"])
                gathers += col.COLLECTIVES["attn_gather"]
            if sharded:
                out[f"{name}.layout"] = np.asarray(cache["layout"])
                out[f"{name}.score_sums"] = np.asarray(sums)
                out[f"{name}.serve_attn_gathers"] = np.asarray(gathers)
                for k, v in cache["layers"].items():
                    out[f"{name}.local.{k}"] = np.asarray(v.shape)

        batch = {k: torch.from_numpy(ref[f"{base}.train.{k}"]).int()
                 for k in ("tokens", "labels")}
        one = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
        one.adopt(_nest({k: v.clone() for k, v in src.items()}))
        _, m1 = steps.make_train_step(one, tcfg)(
            init_train_state(one.params()), batch)
        two = Model(cfg, device="meta", q_chunk=8, kv_chunk=8)
        shd.shard_model(two, mesh, source=src, device="cpu")
        m2 = _sharded_step(two, mesh, batch, tcfg)
        for key, val in (("loss_sharded", m2["loss"]),
                         ("loss_one", m1["loss"]),
                         ("gnorm_sharded", m2["grad_norm"]),
                         ("gnorm_one", m1["grad_norm"])):
            out[f"{name}.train.{key}"] = np.asarray(float(val))
        out[f"{name}.train.unembed_gathers"] = np.asarray(
            col.COLLECTIVES["unembed_gather"])
        out[f"{name}.train.attn_gathers"] = np.asarray(
            col.COLLECTIVES["attn_gather"])
        out[f"{name}.train.largest_local_share"] = np.asarray(max(
            p.to_local().numel() / p.numel() for p in two.parameters()
            if any(pl.is_shard() for pl in p.placements)))


#: (name, arch, mesh shape) of the xLSTM and audio smokes' tensor-parallel
#: runs: the xLSTM's 2 heads (d_inner 64, d_ff 42) divide the model axis of
#: (4, 2), whisper's 4 heads (d_ff 64) that of (2, 4)
XLSTM_AUDIO = (("xlstm", "xlstm-350m", (4, 2)),
               ("audio", "whisper-base", (2, 4)))


def _cache_boxes(cache) -> dict:
    """{leaf name: local shape} of a cache's layers (an xLSTM state's
    leaves as ``m.c``, ``s.h``, ...)."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        return {k: tuple(v.shape) for k, v in layers.items()}
    return {f"{part}.{f}": tuple(getattr(getattr(layers, part), f).shape)
            for part in ("m", "s") for f in getattr(layers, part)._fields}


def _serve(m, mesh, batch, nxt, prompt, out, tag):
    """Prefill and two decode steps of ``m`` under ``mesh`` (None: one
    process), the logits under ``tag``; returns the cache."""
    from repro_torch.distributed import collectives as col

    with col.use_mesh(mesh):
        cache = m.init_cache(4, prompt + 4, dtype=torch.float32)
        cache, lg = m.prefill(batch, cache)
        out[f"{tag}.prefill"] = lg.numpy()
        for i in (1, 2):
            cache, lg = m.decode_step(cache, nxt)
            out[f"{tag}.decode{i}"] = lg.numpy()
    return cache


def _xlstm_audio(ref, out):
    """The xLSTM and audio smokes in fp32, tensor-parallel on the meshes of
    XLSTM_AUDIO, against the reference's 8-device runs and one process:
    prefill and two decode steps, the layout, the cache boxes and the
    unembedding gathers; the sharded train step against the one-process
    step; and the xLSTM's split inputs (`models.xlstm.mlstm_inputs_tp`,
    `slstm_inputs_tp`) against the whole computation's."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.train import steps
    from repro_torch.train.state import init_train_state

    tcfg = steps.TrainConfig(lr=1e-3, warmup_steps=0)
    for name, arch, shape in XLSTM_AUDIO:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config(arch).replace(compute_dtype="float32")
        src = _tree(ref, f"{name}.p.")
        tok = torch.from_numpy(ref[f"{name}.tokens"]).int()
        nxt = torch.from_numpy(ref[f"{name}.next"]).int()
        batch = {"tokens": tok}
        if cfg.family == "audio":
            batch["frontend"] = torch.from_numpy(ref[f"{name}.frontend"])
        for sharded in (False, True):
            m = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
            m.adopt(_nest({k: v.clone() for k, v in src.items()}))
            if sharded:
                shd.shard_model(m, mesh, source=src, device="cpu")
            col.reset_counts()
            tag = f"{name}.{'sharded' if sharded else 'one'}"
            cache = _serve(m, mesh if sharded else None, batch, nxt,
                           tok.shape[1], out, tag)
        out[f"{name}.layout"] = np.asarray(cache["layout"])
        out[f"{name}.serve_unembed_gathers"] = np.asarray(
            col.COLLECTIVES["unembed_gather"])
        for k, box in _cache_boxes(cache).items():
            out[f"{name}.local.{k}"] = np.asarray(box)
        if name == "xlstm":
            _xlstm_split_inputs(cfg, src, tok, mesh, out)

        train = {k: torch.from_numpy(ref[f"{name}.train.{k}"]).int()
                 for k in ("tokens", "labels")}
        if "frontend" in batch:
            train["frontend"] = batch["frontend"]
        one = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8)
        one.adopt(_nest({k: v.clone() for k, v in src.items()}))
        _, m1 = steps.make_train_step(one, tcfg)(
            init_train_state(one.params()), train)
        two = Model(cfg, device="meta", q_chunk=8, kv_chunk=8)
        shd.shard_model(two, mesh, source=src, device="cpu")
        m2 = _sharded_step(two, mesh, train, tcfg)
        for key, val in (("loss_sharded", m2["loss"]),
                         ("loss_one", m1["loss"]),
                         ("gnorm_sharded", m2["grad_norm"]),
                         ("gnorm_one", m1["grad_norm"])):
            out[f"{name}.train.{key}"] = np.asarray(float(val))
        out[f"{name}.train.unembed_gathers"] = np.asarray(
            col.COLLECTIVES["unembed_gather"])
        out[f"{name}.train.largest_local_share"] = np.asarray(max(
            p.to_local().numel() / p.numel() for p in two.parameters()
            if any(pl.is_shard() for pl in p.placements)))


def _xlstm_split_inputs(cfg, src, tok, mesh, out):
    """The first pair's split inputs on the rank against the whole
    computation's, in fp32 on the embedded prompt from a seeded conv
    window: the mLSTM's q, k, v, lf, li on the rank's heads and its z
    columns and conv window (the cut of the exchanged ``[xi | z]``), and
    the sLSTM's gate inputs (exchanged whole) and conv window on the
    rank's units.  Writes the largest error and whether each is zero."""
    from repro_torch.distributed import collectives as col
    from repro_torch.models import xlstm as xl_mod

    n, r = col.tp_size(mesh), col.tp_rank(mesh)
    xl, h = cfg.xlstm, cfg.n_heads
    pair = {part: {k[len(part) + 1:]: v[0] for k, v in src.items()
                   if k.startswith(part + ".")}
            for part in ("m_blocks", "s_blocks")}
    x = src["embed"][tok.long()].float()
    gen = torch.Generator().manual_seed(23)
    di = int(xl.proj_factor_mlstm * cfg.d_model)
    convs = {"m": torch.randn((4, xl.conv_width - 1, di), generator=gen),
             "s": torch.randn((4, xl.conv_width - 1, cfg.d_model),
                              generator=gen)}

    def cut(z, dim, parts=n):        # the rank's part of dim
        step = z.shape[dim] // parts
        return z.narrow(dim, r * step, step)

    whole = xl_mod._mlstm_inputs(xl, h, pair["m_blocks"], x, convs["m"])
    lp = xl_mod.mlstm_local_params(pair["m_blocks"], mesh)
    split = xl_mod.mlstm_inputs_tp(h // n, lp, x, cut(convs["m"], -1), mesh)
    want = [cut(a, 1) for a in whole[:5]] + [cut(a, -1) for a in whole[5:]]
    errs = [float((g - w).abs().max()) for g, w in zip(split, want)]
    s_whole = xl_mod._slstm_inputs(pair["s_blocks"], x, convs["s"])
    s_lp = xl_mod.slstm_local_params(pair["s_blocks"], mesh)
    gates, conv = xl_mod.slstm_inputs_tp(s_lp, x, cut(convs["s"], -1), mesh)
    errs += [float((gates - s_whole[0]).abs().max()),
             float((conv - cut(s_whole[1], -1)).abs().max())]
    out["xlstm.split_errs"] = col.all_reduce(
        torch.tensor(errs), dist.group.WORLD, "max").numpy()
    out["xlstm.split_shapes_ok"] = _every_rank(
        split[0].shape[1] == h // n and split[5].shape[-1] == di // n)


def _vocab_ce(mesh, out):
    """`collectives.vocab_parallel_ce` against `chunked_ce_loss` on one
    process (fp32): labels on both sides of every shard boundary, -1
    labels, a last chunk shorter than the rest; then `Model.loss` under
    the mesh at a vocab the model axis divides (128) and one it does not
    (130), against one process, with the unembedding gathers counted."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model, chunked_ce_loss

    gen = torch.Generator().manual_seed(21)
    v, d, n = 128, 32, col.tp_size(mesh)
    h = torch.randn(4, 21, d, generator=gen)
    w = torch.randn(d, v, generator=gen) * 0.2
    labels = torch.randint(0, v, (4, 21), generator=gen, dtype=torch.int32)
    edges = [e for k in range(1, n) for e in (k * v // n - 1, k * v // n)]
    labels[0, :len(edges)] = torch.tensor(edges, dtype=torch.int32)
    labels[1, :4] = torch.tensor([0, v - 1, -1, -1], dtype=torch.int32)
    labels[2, -3:] = -1
    h1, w1 = h.clone().requires_grad_(), w.clone().requires_grad_()
    ls1, c1 = chunked_ce_loss(h1, w1, labels, chunk=8)
    dh1, dw1 = torch.autograd.grad(ls1, [h1, w1])
    r = col.tp_rank(mesh)
    h2 = h.clone().requires_grad_()
    w2 = w[:, r * v // n:(r + 1) * v // n].clone().requires_grad_()
    col.reset_counts()
    ls2, c2 = col.vocab_parallel_ce(h2, w2, labels, mesh, chunk=8)
    dh2, dw2 = torch.autograd.grad(ls2, [h2, w2])
    out["ce.chunk_collectives"] = np.asarray(
        [col.COLLECTIVES["all_reduce_max"], col.COLLECTIVES["all_reduce_sum"]])
    dw2 = col.all_gather(dw2, col.tp_group(mesh), -1)
    errs = [float((ls2 - ls1).detach().abs() / ls1.detach().abs()),
            float((dh2 - dh1).abs().max() / dh1.abs().max()),
            float((dw2 - dw1).abs().max() / dw1.abs().max())]
    out["ce.errs"] = col.all_reduce(torch.tensor(errs), dist.group.WORLD,
                                    "max").numpy()
    out["ce.count_equal"] = _every_rank(float(c1) == float(c2)
                                        == float((labels >= 0).sum()))

    tok = torch.randint(0, 128, (4, 12), generator=gen, dtype=torch.int32)
    for vocab in (128, 130):
        cfg = ModelConfig(name="m", family="dense", n_layers=2, d_model=32,
                          n_heads=4, n_kv_heads=4, d_ff=64, vocab=vocab,
                          compute_dtype="float32")
        one = Model(cfg, device="cpu").init(torch.Generator().manual_seed(22))
        src = {k: p.detach().clone() for k, p in one.named_parameters()}
        batch = {"tokens": tok, "labels": (tok * 7 + 3) % vocab}
        with torch.no_grad():
            _, m1 = one.loss(batch)
        two = Model(cfg, device="meta")
        shd.shard_model(two, mesh, source=src, device="cpu")
        col.reset_counts()
        with col.use_mesh(mesh), torch.no_grad():
            _, m2 = two.loss(batch)
        out[f"ce.model_loss.{vocab}"] = np.asarray(
            [float(m2["ce_loss"]), float(m1["ce_loss"])])
        out[f"ce.unembed_gathers.{vocab}"] = np.asarray(
            col.COLLECTIVES["unembed_gather"])


#: (name, arch, config changes, mesh shape) of the xLSTM and audio smokes
#: with heads that the model axis does not divide (the xLSTM's 2 and
#: whisper's cut from 4 to 2 on (2, 4); whisper's 4 on (1, 8), whose
#: data-axis group of one rank makes each layer's gather of its stacked
#: leaves an alias that `collectives.LAYER_GATHER` must not count): their
#: mixers and attention run every head from weights gathered where the
#: stack runs the layer (whisper's MLP still splits)
WHOLE_ARCHS = (("xlstm-350m", "xlstm-350m", {}, (2, 4)),
               ("whisper-base", "whisper-base",
                {"n_heads": 2, "n_kv_heads": 2}, (2, 4)),
               ("whisper-base-1x8", "whisper-base", {}, (1, 8)))


def _train_whole(out):
    """The sharded train step of WHOLE_ARCHS at smoke widths in fp32
    against the one-process step: loss, grad norm, and the live gathered
    bytes against one layer's (its whole weights and their model shard,
    gathered one after the other); then prefill and two decode steps
    against one process."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.train import steps
    from repro_torch.train.state import init_train_state

    tcfg = steps.TrainConfig(lr=1e-3, warmup_steps=0)
    for name, arch, change, shape in WHOLE_ARCHS:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                             **change)
        one = Model(cfg, device="cpu").init(torch.Generator().manual_seed(7))
        src = {k: v.detach().clone() for k, v in one.named_parameters()}
        gen = torch.Generator().manual_seed(8)
        batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if cfg.family == "audio":
            batch["frontend"] = torch.randn(
                (4, cfg.audio.n_audio_ctx, cfg.d_model), generator=gen).to(
                torch.bfloat16)
        _, m1 = steps.make_train_step(one, tcfg)(
            init_train_state(one.params()), batch)
        two = Model(cfg, device="meta")
        shd.shard_model(two, mesh, source=src, device="cpu")
        m2 = _sharded_step(two, mesh, batch, tcfg)
        # one layer of the largest stack (an xLSTM pair runs both blocks)
        stacks = {}
        for k, p in two.named_parameters():
            if col.layer_dp_dim(p) > 0:
                stack = "pair" if k.startswith(("m_blocks", "s_blocks")) \
                    else k.rsplit(".", 2)[0].split(".")[0]
                if k.startswith(("enc.", "dec.")):
                    stack = k[:3]
                stacks[stack] = stacks.get(stack, 0) + (
                    p.numel() // p.shape[0] * p.element_size())
        layer = max(stacks.values()) * (1 + 1 / col.tp_size(mesh))
        for k, val in (("loss_sharded", m2["loss"]), ("loss_one", m1["loss"]),
                       ("gnorm_sharded", m2["grad_norm"]),
                       ("gnorm_one", m1["grad_norm"])):
            out[f"whole.{name}.{k}"] = np.asarray(float(val))
        out[f"whole.{name}.gathered_peak"] = np.asarray(
            int(col.LAYER_GATHER["peak"]))
        out[f"whole.{name}.layer_bytes"] = np.asarray(layer)
        tok, nxt = batch["tokens"][:, :6], batch["labels"][:, :1]
        serve = {"tokens": tok}
        if "frontend" in batch:
            serve["frontend"] = batch["frontend"].float()
        for sharded in (False, True):
            m = Model(cfg, device="cpu")
            m.adopt(_nest({k: v.clone() for k, v in src.items()}))
            if sharded:
                shd.shard_model(m, mesh, source=src, device="cpu")
            cache = _serve(m, mesh if sharded else None, serve, nxt, 6, out,
                           f"whole.{name}.{'sharded' if sharded else 'one'}")
        out[f"whole.{name}.layout"] = np.asarray(cache["layout"])


def _pod_mesh(out):
    """On a (2, 2, 2) (pod, data, model) mesh: the data-axis group spans
    pod and data, and the train step's gradient cut takes each rank's
    pod-major box of a dim split over (pod, data)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.steps import _sharded_grads

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    spec = (("pod", "data"), ("model",))
    g = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    storage = shd.place(g, shd.Sharding(mesh, spec,
                                        shd.to_placements(spec, mesh)),
                        device="cpu")
    view = col.dp_replicated(storage)            # the model shard, whole over dp
    got = _sharded_grads({"w": view.to_local()}, {"w": storage}, mesh)["w"]
    ok = (col.dp_size(mesh) == 4 and torch.equal(view.to_local(), g[
        :, col.tp_rank(mesh) * 4:(col.tp_rank(mesh) + 1) * 4])
          and torch.equal(got, 4 * storage.to_local()))
    # every rank's box, not only rank 0's (whose offsets are 0 either way)
    out["pod.ok"] = _every_rank(ok)


def _rank(rank, path, ref_path, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, WORLD),
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    ref = np.load(ref_path)
    out = {}
    t0 = time.perf_counter()
    _ep(ref, mesh, out)
    _embed(mesh, out)
    _reshard(out)
    _pod_mesh(out)
    _decode(ref, mesh, out)
    _train(ref, mesh, out)
    _train_whole(out)
    _vlm(ref, mesh, out)
    _new_families(ref, mesh, out)
    _xlstm_audio(ref, out)
    _vocab_ce(mesh, out)
    out["seconds"] = np.asarray(time.perf_counter() - t0)
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def main():
    ref_path, out_path = sys.argv[1], sys.argv[2]
    store = os.path.join(tempfile.mkdtemp(dir=os.path.dirname(out_path)),
                         "store")
    mp.spawn(_rank, args=(store, ref_path, out_path), nprocs=WORLD)


if __name__ == "__main__":
    main()
