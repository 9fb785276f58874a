"""C/R cost: the paper's thrashing-cost term, measured on a job's state.

The measurement flow of ``benchmarks/bench_cr_cost.py`` as a library
function: the caller passes two consecutive snapshots of one job (trees of
tensors, the earlier one the delta's parent) and gets back the same rows
under the same names:

  state_bytes_raw   raw bytes of the later snapshot
  mem_save_ms       host-DRAM fast tier (the NVM/DCPMM analogue)
  disk_raw_bytes    durable tier, no compression
  disk_zstd_bytes   durable tier, zstd-3 (raw where zstandard is missing)
  delta_zstd_bytes  XOR-delta vs the earlier snapshot + zstd (zlib where
                    zstandard is missing), with delta_frac
  int8_quant_bytes  the int8 block codec (``kernels/ckpt_codec``) on every
                    fp32 leaf of at least 128 elements, on ``device``
  model_*           a `CheckpointService` save/save/restore cycle on the
                    same state calibrates the scheduler's cost model

plus the timings beside each row, ``compressor`` (the one that ran), the
codec's round trip (``int8_decode_ms``, ``int8_roundtrip_error``), whether
the service's restore equals the later snapshot bit for bit, and the two
calibrated cost models (flat, and the ``("mem", "disk")`` lattice).

  from repro_torch.launch import cr_cost
  rows = cr_cost.measure(prev, cur, tick_seconds=0.1, root=tmpdir)

Host times are wall seconds; device work is synchronised inside each
timed window.  ``device`` defaults to the card and raises where CUDA is
absent.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import delta as delta_mod
from repro_torch.checkpoint import serialize
from repro_torch.checkpoint.manager import ManagerConfig
from repro_torch.checkpoint.reshard import save_global
from repro_torch.checkpoint.service import CheckpointService
from repro_torch.checkpoint.tiers import DiskTier, MemTier
from repro_torch.core.crcost import state_mib_of
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.kernels.ckpt_codec import ops as codec


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _codec_rows(cur, device: torch.device) -> Dict[str, Any]:
    """int8 fast-tier bytes of ``cur``, and its round trip, on ``device``."""
    leaves = [t.to(device) for _, t in serialize.leaf_paths(cur)]
    _sync(device)
    coded = []
    t0 = time.perf_counter()
    for t in leaves:
        if t.dtype == torch.float32 and t.numel() >= 128:
            coded.append((t, codec.quantize_array(t)))
        else:
            coded.append((t, None))
    _sync(device)
    t_q = time.perf_counter() - t0
    q_bytes = sum(t.numel() * t.element_size() if qs is None
                  else qs[0].numel() + qs[1].numel() * 4
                  for t, qs in coded)
    err = 0.0
    t_dq = 0.0
    for t, qs in coded:
        if qs is None:
            continue
        t0 = time.perf_counter()
        y = codec.dequantize_array(*qs, shape=t.shape, dtype=t.dtype)
        _sync(device)
        t_dq += time.perf_counter() - t0
        denom = t.abs().max().clamp(min=1e-12)
        err = max(err, float((y - t).abs().max() / denom))
    return {"int8_quant_bytes": q_bytes, "int8_encode_ms": t_q * 1e3,
            "int8_decode_ms": t_dq * 1e3, "int8_roundtrip_error": err}


def measure(prev, cur, *, tick_seconds: float, root, device="cuda"
            ) -> Dict[str, Any]:
    """The C/R cost rows of one job between snapshots ``prev`` and
    ``cur``; files go under ``root``."""
    dev = resolve_device(device)
    root = Path(root)
    prev_leaves, cur_leaves = save_global(prev), save_global(cur)
    total_raw = sum(a.nbytes for a in cur_leaves.values())
    rows: Dict[str, Any] = {
        "state_bytes_raw": total_raw,
        "compressor": "zlib" if delta_mod.zstd is None else "zstd",
    }

    # mem tier
    tier = MemTier(8 << 30)
    t0 = time.perf_counter()
    tier.save_leaves("s", cur_leaves)
    rows["mem_save_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tier.restore("s")
    rows["mem_restore_ms"] = (time.perf_counter() - t0) * 1e3

    for name, level in (("disk_raw", None), ("disk_zstd", 3)):
        tier = DiskTier(root / name, compress=level)
        t0 = time.perf_counter()
        tier.save_leaves("s", cur_leaves)
        rows[f"{name}_save_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tier.restore("s")
        rows[f"{name}_restore_ms"] = (time.perf_counter() - t0) * 1e3
        rows[f"{name}_bytes"] = tier.stats.bytes_written

    # delta vs previous snapshot
    t0 = time.perf_counter()
    blobs, sizes = delta_mod.encode_snapshot(cur_leaves, prev_leaves)
    rows["delta_encode_ms"] = (time.perf_counter() - t0) * 1e3
    rows["delta_zstd_bytes"] = sum(sizes.values())
    rows["delta_frac"] = float(np.mean([b.is_delta for b in blobs.values()]))

    # int8 quantized fast tier (optimizer moments; error-tolerant)
    rows.update(_codec_rows(cur, dev))

    # calibration: measured TierStats -> scheduler CRCostModel
    svc = CheckpointService(ManagerConfig(
        root=root / "svc", durable_every=1, async_durable=False), device=dev)
    try:
        template = serialize.map_with_path(
            lambda _k, t: torch.empty_like(t, device="meta"), cur)
        svc.save(0, prev)
        svc.save(1, cur)
        restored, _ = svc.restore(template)
        back = save_global(restored)
        rows["restore_bit_equal"] = back.keys() == cur_leaves.keys() and all(
            back[k].dtype == a.dtype and back[k].tobytes() == a.tobytes()
            for k, a in cur_leaves.items())
        # compress_ratio stays 1.0: the service's measured bandwidth is RAW
        # bytes over wall time that already includes compression, i.e. an
        # effective raw throughput — applying the delta ratio on top would
        # discount the cost twice (see CRCostModel.from_measured)
        model = svc.calibrate(tick_seconds=tick_seconds)
        rows["tiered_cost_model"] = svc.calibrate(
            tick_seconds=tick_seconds, tiers=("mem", "disk"))
    finally:
        svc.close()
    mib = state_mib_of(total_raw)
    rows.update(
        cost_model=model, state_mib=mib,
        model_save_mib_per_tick=model.save_mib_per_tick,
        model_restore_mib_per_tick=model.restore_mib_per_tick,
        model_save_ticks=model.save_cost(mib),
        model_restore_ticks=model.restore_cost(mib))
    return rows
