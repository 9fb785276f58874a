"""Multi-pod dry run (the twin of ``src/repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: build the full-size
config, place its parameters, cache and batch with the production
shardings on a fake world of 256 or 512 ranks, run the step on ``meta``
tensors under `roofline.counting.costing`, and record the memory per
device, the three roofline terms, the bottleneck and the share of model
FLOPs.  Nothing is allocated and no card is needed: the tensors are meta
by design, and the process group is ``torch.distributed``'s fake backend,
whose collectives move nothing.  This rank is rank 0 of the mesh, and
costs one device's share.

Two passes per cell, as in the reference:

* production: full depth, ``SHAPE_TUNING``'s attention chunks and
  ``grad_accum``; its counted peak gives the memory record;
* costing: attention in one chunk (``q_chunk = kv_chunk = seq``) and one
  microbatch of the global batch, at two depths (2 and 4 layer units),
  extrapolated linearly to the true depth (`roofline.analysis.
  analyze_extrapolated`), its terms scaled by ``grad_accum``.

The records go to ``build/dryrun/`` (``--out``), one JSON file per cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod off
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-350m --shape train_4k --mesh 64x4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --report
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES_BY_NAME,
    ShapeSpec,
    cell_is_applicable,
    get_config,
)
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.model import Model, model_flops_per_step
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import counting
from repro_torch.train.state import bind_state, train_state_shapes
from repro_torch.train.steps import (
    TrainConfig,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    shard_opt,
)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# per-shape attention chunk sizes + grad accumulation (activation-memory knobs)
SHAPE_TUNING = {
    "train_4k": dict(q_chunk=2048, kv_chunk=2048, grad_accum=4),
    "prefill_32k": dict(q_chunk=2048, kv_chunk=2048, grad_accum=1),
    "decode_32k": dict(q_chunk=1024, kv_chunk=1024, grad_accum=1),
    "long_500k": dict(q_chunk=1024, kv_chunk=1024, grad_accum=1),
}


def _layer_unit(cfg):
    """Smallest depth step preserving the arch's layer-group structure."""
    if cfg.family == "vlm":
        return cfg.vision.cross_attn_every
    if cfg.family == "ssm":
        return cfg.xlstm.slstm_every
    return 1


def fake_mesh(shape, names):
    """A `DeviceMesh` of ``shape`` over a fake world of as many ranks,
    this process rank 0: the world is (re)made at that size with
    ``torch.distributed``'s fake backend, which moves nothing."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) production mesh over a fake world."""
    return fake_mesh(*production_mesh_shape(multi_pod=multi_pod))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if col._is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _batch_bytes(batch: dict, mesh) -> int:
    """The bytes of the rank's box of each batch leaf (the port's model
    takes the global batch and slices its rows)."""
    if mesh is None:
        return sum(_nbytes(t) for t in batch.values())
    sizes, coord = shd.axis_sizes(mesh), shd.mesh_coord(mesh)
    total = 0
    for t in batch.values():
        box = shd.local_box(t.shape, shd.batch_spec(t.shape, sizes), sizes,
                            coord)
        total += math.prod(len(range(*s.indices(d)))
                           for s, d in zip(box, t.shape)) * t.element_size()
    return total


@dataclasses.dataclass
class Cell:
    """One built cell: ``run()`` runs the step once (under the caller's
    `counting.costing`) and returns its outputs; ``arguments`` are the
    step's inputs as this rank holds them."""
    run: object
    arguments: tuple
    batch: dict
    mesh: object
    n_devices: int
    model_flops: float
    grad_accum: int


def build_cell(arch: str, shape: Union[str, ShapeSpec], mesh,
               tuning_override=None, costing: bool = False,
               depth_override: Optional[int] = None) -> Cell:
    """One cell's step, placed on ``mesh`` (None: one device), ready to be
    counted.

    * production (``costing=False``): ``SHAPE_TUNING``'s chunks and
      ``grad_accum`` at the config's depth: the deployable step, whose
      counted peak is the memory record;
    * costing (``costing=True``): attention in one chunk and one
      microbatch (global batch / ``grad_accum``, accumulation 1); with
      ``depth_override`` at that many layers, which `run_cell` counts at
      two depths and extrapolates.

    ``shape`` is a name of ``SHAPES_BY_NAME`` or a `ShapeSpec`; for a
    spec that ``SHAPE_TUNING`` does not name, ``tuning_override`` gives
    ``q_chunk``, ``kv_chunk`` and ``grad_accum``.  ``tuning_override``
    updates the tuning; its ``"cfg"`` entry replaces config fields (smoke
    widths in the tests)."""
    cfg = get_config(arch)
    if depth_override is not None:
        cfg = cfg.replace(n_layers=depth_override)
    if isinstance(shape, str):
        shape = SHAPES_BY_NAME[shape]
    tune = dict(SHAPE_TUNING.get(shape.name, {}))
    if tuning_override:
        extra = dict(tuning_override)
        cfg_over = extra.pop("cfg", {})
        if cfg_over:
            cfg = cfg.replace(**cfg_over)
        tune.update(extra)
    accum = tune["grad_accum"] if shape.kind == "train" else 1
    mflops = model_flops_per_step(cfg, shape,
                                  backward=(shape.kind == "train"))
    step_shape = shape
    if costing:
        q_chunk = kv_chunk = shape.seq_len
        if accum > 1:
            step_shape = dataclasses.replace(
                shape, global_batch=shape.global_batch // accum)
    else:
        q_chunk, kv_chunk = tune["q_chunk"], tune["kv_chunk"]
    model = Model(cfg, device="meta", q_chunk=q_chunk, kv_chunk=kv_chunk)
    batch = model.input_specs(step_shape)
    n_dev = 1 if mesh is None else mesh.size()
    if mesh is not None:
        shd.shard_model(model, mesh, source=dict(model.named_parameters()),
                        device="meta")

    if shape.kind == "train":
        tcfg = TrainConfig(grad_accum=1 if costing else accum)
        step = make_train_step(model, tcfg)
        if mesh is None:
            state = bind_state(model, train_state_shapes(model))
        else:
            params = model.params()
            state = train_state_shapes(model)._replace(
                params=params, opt=shard_opt(params))
        args = held = (state, batch)
    else:
        with col.use_mesh(mesh):
            cache = model.init_cache(step_shape.global_batch,
                                     step_shape.seq_len)
        if shape.kind == "prefill":
            step = make_prefill_step(model)
            args = (batch, cache)
        else:
            step = make_decode_step(model)
            args = (cache, batch["tokens"])
            batch = {"tokens": batch["tokens"]}
        # the serving steps read the model's own parameters
        held = (model.params(), *args)

    def run():
        with col.use_mesh(mesh):
            return step(*args)

    return Cell(run=run, arguments=held, batch=batch, mesh=mesh,
                n_devices=n_dev, model_flops=mflops, grad_accum=accum)


def count_cell(cell: Cell, memory_only: bool = False) -> counting.Costs:
    """Run the cell's step once under `counting.costing` (``memory_only``:
    its storage only, the production pass), with its argument, output and
    aliased bytes set: the arguments are this rank's shards of the state
    or the parameters and cache, and its box of the batch; an output
    aliases an argument when it shares its storage (the state or cache
    the step updates in place)."""
    batch_ids = {id(t) for t in cell.batch.values()}
    held = [t for t in counting.tensors(cell.arguments)
            if id(t) not in batch_ids]
    with counting.costing(memory_only) as costs:
        out = cell.run()
    storages = {_local(t).untyped_storage()._cdata for t in held}
    costs.argument_bytes = (sum(_nbytes(t) for t in held)
                            + _batch_bytes(cell.batch, cell.mesh))
    outs = counting.tensors(out)
    costs.output_bytes = sum(_nbytes(t) for t in outs)
    costs.alias_bytes = sum(
        _nbytes(t) for t in outs
        if _local(t).untyped_storage()._cdata in storages)
    del out
    return costs


def _merge_notes(notes: dict, more: dict) -> None:
    for k, values in more.items():
        seen = notes.setdefault(k, [])
        seen.extend(v for v in values if v not in seen)


def _assumed(notes: dict) -> str:
    """What the counts assumed (the MoE layers' capacity and rows on
    meta), for an applicable cell's ``reason``; empty where nothing was."""
    return "; ".join(f"assumed {k} = {v}" for k, v in sorted(notes.items()))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             tuning_override=None, tag: str = "",
             costing: bool = True, mesh_shape=None) -> dict:
    """Count one cell on the production mesh of ``multi_pod``, or on a
    (data, model) mesh of ``mesh_shape``, and write its record to
    ``out_dir``."""
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{cell_id}.json"
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "status": "skipped", "reason": why,
    }
    if not ok:
        out_path.write_text(json.dumps(record, indent=2))
        print(f"SKIP {cell_id}: {why}")
        return record

    t0 = time.time()
    try:
        mesh = (fake_mesh(mesh_shape, ("data", "model")) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod))
        # 1. production pass: the deployable step; its memory record
        cell = build_cell(arch, shape_name, mesh, tuning_override)
        n_dev, mflops, accum = cell.n_devices, cell.model_flops, \
            cell.grad_accum
        prod = count_cell(cell, memory_only=True)
        del cell
        t_prod = time.time() - t0
        mem = roofline.memory_stats(prod)
        notes = {k: list(v) for k, v in prod.notes.items()}
        if not costing:
            # multi-pod cells: the memory record is the deliverable; the
            # roofline table is single-pod only
            record.update({
                "status": "ok", "n_devices": n_dev, "grad_accum": accum,
                "compile_s": round(t_prod, 1), "memory": mem,
                "reason": _assumed(notes),
            })
            print(f"OK   {cell_id}: production={t_prod:.0f}s "
                  f"mem/dev={mem['peak_estimate_bytes']/2**30:.2f}GiB "
                  f"(no costing)")
            out_path.write_text(json.dumps(record, indent=2))
            return record
        # 2. costing passes at depths (a, b), extrapolated linearly to the
        #    true depth L (per-layer costs are depth-independent; the base
        #    is the embedding, the CE loss and the optimizer's scalars)
        t1 = time.time()
        cfg_full = get_config(arch)
        unit = _layer_unit(cfg_full)
        l_full = cfg_full.n_layers
        a = min(2 * unit, l_full)
        b = min(4 * unit, l_full)
        if b <= a:  # very shallow arch: one exact costing pass
            costs = count_cell(build_cell(arch, shape_name, mesh,
                                          tuning_override, costing=True))
            rf = roofline.analyze(costs, n_devices=n_dev, model_flops=mflops,
                                  cost_scale=float(accum))
            _merge_notes(notes, costs.notes)
            extrapolated = False
        else:
            raw = {}
            for depth in (a, b):
                costs = count_cell(build_cell(
                    arch, shape_name, mesh, tuning_override, costing=True,
                    depth_override=depth))
                raw[depth] = roofline.raw_costs(costs)
                _merge_notes(notes, costs.notes)
            rf = roofline.analyze_extrapolated(
                raw[a], raw[b], a, b, l_full, n_devices=n_dev,
                model_flops=mflops, cost_scale=float(accum))
            extrapolated = True
        t_cost = time.time() - t1
        record.update({
            "status": "ok",
            "n_devices": n_dev,
            "grad_accum": accum,
            "costing_extrapolated": extrapolated,
            "compile_s": round(t_prod, 1),
            "costing_compile_s": round(t_cost, 1),
            "memory": mem,
            "roofline": rf.row(),
            "coll_breakdown": rf.coll_breakdown,
        })
        record["reason"] = _assumed(notes)
        print(f"OK   {cell_id}: production={t_prod:.0f}s+costing={t_cost:.0f}s "
              f"mem/dev={mem['peak_estimate_bytes']/2**30:.2f}GiB "
              f"terms(c/m/coll)={rf.compute_s*1e3:.1f}/{rf.memory_s*1e3:.1f}/"
              f"{rf.collective_s*1e3:.1f}ms bottleneck={rf.bottleneck} "
              f"MF%={(rf.model_flops_ratio or 0)*100:.0f}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        record.update({"status": "failed", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
        print(f"FAIL {cell_id}: {type(e).__name__}: {str(e)[:200]}")
    out_path.write_text(json.dumps(record, indent=2))
    return record


def report(out_dir: Path) -> None:
    rows = []
    for p in sorted(out_dir.glob("*.json")):
        rows.append(json.loads(p.read_text()))
    fmt = "{:<22s} {:<12s} {:<8s} {:<8s} {:>9s} {:>8s} {:>8s} {:>8s} {:<10s} {:>6s}"
    print(fmt.format("arch", "shape", "mesh", "status", "mem GiB",
                     "comp ms", "mem ms", "coll ms", "bottleneck", "MF%"))
    for r in rows:
        if r["status"] != "ok":
            print(fmt.format(r["arch"], r["shape"], r["mesh"], r["status"],
                             "-", "-", "-", "-", r.get("reason", r.get("error", ""))[:30], "-"))
            continue
        if "roofline" not in r:
            print(fmt.format(r["arch"], r["shape"], r["mesh"], r["status"],
                             f"{r['memory']['peak_estimate_bytes']/2**30:.2f}",
                             "-", "-", "-", "memory-only", "-"))
            continue
        rf = r["roofline"]
        print(fmt.format(
            r["arch"], r["shape"], r["mesh"], r["status"],
            f"{r['memory']['peak_estimate_bytes']/2**30:.2f}",
            f"{rf['compute_s']*1e3:.1f}", f"{rf['memory_s']*1e3:.1f}",
            f"{rf['collective_s']*1e3:.1f}", rf["bottleneck"],
            f"{(rf['model_flops_ratio'] or 0)*100:.0f}",
        ))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-costing", action="store_true",
                    help="production pass only (multi-pod sweeps)")
    ap.add_argument("--mesh", metavar="DATAxMODEL",
                    help="a (data, model) mesh instead of the production "
                         "one, e.g. 64x4")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)

    args.out.mkdir(parents=True, exist_ok=True)
    if args.report:
        report(args.out)
        return

    meshes = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES_BY_NAME:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    try:
        for arch, shape, mp in cells:
            mesh_name = (args.mesh if mesh_shape
                         else "2x16x16" if mp else "16x16")
            if args.skip_existing:
                p = args.out / f"{arch}__{shape}__{mesh_name}.json"
                if p.exists() and json.loads(p.read_text()).get("status") in ("ok", "skipped"):
                    continue
            run_cell(arch, shape, mp, args.out,
                     costing=not (args.no_costing or mp),
                     mesh_shape=mesh_shape)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
