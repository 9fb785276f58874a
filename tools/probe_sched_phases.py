"""Where one eviction plan's time goes on the card, phase by phase.

    PYTHONPATH=src python tools/probe_sched_phases.py

Writes a copy of ``src/repro_torch/kernels/sched_select/csrc/sched_select.cu``
under ``build/probe_sched_phases/`` in which thread 0 of CTA 0 records
``clock64()`` at each phase boundary of the one launch (and counts the
walk's rounds), builds it through ``kernels._build``, and runs the
wrapper on it for: the plan a main-path eviction would make from the
100k-job fleet's final table (``chip_smoke.py``'s fleet, T=4), and
random columns at J = 100,000 and 262,144 (``chip_smoke.random_case``,
seeded), with the bounded walk and without it.  Each plan is checked
against the plain version first.  Prints one JSON line per plan: the
candidates E, the walk's records W and rounds, and the microseconds CTA 0
spent in each phase (SM cycles over ``clocks.sm``, read after the plans),
then the card's name and power limit.  Phases CTA 0 does not run (the
large path's other CTAs) are not seen.  Needs a CUDA device; it changes
nothing in the package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sched_select import ops  # noqa: E402
from repro_torch.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_ref,
)

OUT_DIR = _build.REPO_ROOT / "build" / "probe_sched_phases"
HEADER = _build.REPO_ROOT / "src" / "repro_torch" / "kernels" / "hopper.cuh"

# (anchor, stamp slot, before the anchor?): the phase that ends at a slot
# is named by PHASES
STAMPS = (
    ("  const int need = max((int)((unsigned)cpus_needed - (unsigned)idle), "
     "0);\n", 0, False),
    ("  if (tid == 0) q.counts[cta] = (int)count;\n", 1, False),
    ("  cta_sum_prefix(q.counts, G, cta, &E_u, &off);\n", 2, True),
    ("  grid.sync();\n\n  const bool walks", 3, True),
    ("  const bool walks = q.tiered && q.bounded;\n", 4, True),
    ("    const int n2 = sort_in_smem(q.keys_a, E, sk);\n", 5, False),
    ("walks ? srec : nullptr, 0u, &W);\n", 11, False),
    ("    Key* src = q.keys_a;\n", 5, True),
    ("    // ---- 3, large E: CTA sums", 6, True),
    ("    cta_sum_prefix(q.sums, G, cta, &total, &carry);\n", 7, True),
    ("    if (!walks) return;\n", 8, True),
    ("  if (walks) walk_any(q, (int)W, smem, srec, occ);\n", 9, True),
    ("  if (walks) walk_any(q, (int)W, smem, srec, occ);\n", 10, False),
)
PHASES = {1: "count", 2: "barrier_1", 3: "compact", 4: "barrier_2",
          5: "sort", 6: "merge_levels", 7: "sums_barrier", 8: "plan",
          11: "plan", 9: "records", 10: "walk"}
ROUNDS = 40          # slot of the walk's round count
RECORDS = 41         # slot of W


def variant_source() -> Path:
    """The stamped copy of the kernel's source; raises if the source no
    longer holds a line the probe stamps."""
    src = ops.SOURCE.read_text()
    src = src.replace('#include "../../hopper.cuh"', f'#include "{HEADER}"\n'
                      "__device__ long long g_probe[64];\n"
                      "#define STAMP(i) do { if (blockIdx.x == 0 && "
                      "threadIdx.x == 0) g_probe[i] = clock64(); } while (0)")
    for anchor, slot, before in STAMPS:
        if anchor not in src:
            raise RuntimeError(f"sched_select.cu no longer holds {anchor!r}")
        at = src.index(anchor) + (0 if before else len(anchor))
        src = src[:at] + f"  STAMP({slot});\n" + src[at:]
    for anchor, add in (
            ("    p += f;\n", "    if (blockIdx.x == 0 && threadIdx.x == 0) "
             f"g_probe[{ROUNDS}] += 1;\n"),
            ("  STAMP(9);\n", "  if (blockIdx.x == 0 && threadIdx.x == 0) "
             f"g_probe[{RECORDS}] = W;\n")):
        if anchor not in src:
            raise RuntimeError(f"sched_select.cu no longer holds {anchor!r}")
        at = src.index(anchor) + len(anchor)
        src = src[:at] + add + src[at:]
    src += ('\nextern "C" int probe_read(long long* out) { return (int)'
            "cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe)); }\n"
            'extern "C" int probe_clear() { long long z[64] = {0}; return '
            "(int)cudaMemcpyToSymbol(g_probe, z, sizeof(z)); }\n")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "sched_select_phases.cu"
    path.write_text(src)
    return path


def probe_library():
    """The stamped library, with the wrapper's argument types."""
    real = ops.build().lib
    lib = _build.load("sched_select_phases", [variant_source()]).lib
    for name in ("sched_select_launch", "sched_select_floor",
                 "sched_select_scratch_words", "sched_select_error_string",
                 "sched_select_max_tiers"):
        fn, ref = getattr(lib, name), getattr(real, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    lib.probe_read.argtypes = [ctypes.c_void_p]
    return lib


def fleet_plan(chip_smoke):
    """The columns of the plan a main-path eviction would make from the
    fleet's final table (``chip_smoke.phase_kernel_on_fleet``'s)."""
    users, jobs = chip_smoke.fleet_workload()
    cfg = chip_smoke.fleet_config("cuda")
    tbl = engine.simulate(users, jobs, cfg, chip_smoke.FLEET_HORIZON, "omfs",
                          pass_depth=chip_smoke.FLEET_DEPTH,
                          device=chip_smoke.DEV).table
    return chip_smoke.fleet_plan_columns(tbl)


def stamps(lib, cols, scal, flags):
    """CTA 0's clock64 stamps of one plan, after a check and a warm-up."""
    got = ops.plan_evictions_fused(*cols.values(), *scal.values(), **flags)
    want = plan_evictions_ref(*cols.values(), *scal.values(), **flags)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"the stamped kernel differs ({flags})")
    torch.cuda.synchronize()
    lib.probe_clear()
    ops.plan_evictions_fused(*cols.values(), *scal.values(), **flags)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 64)()
    lib.probe_read(ctypes.addressof(buf))
    return list(buf)


def main():
    import chip_smoke  # exits at once without a CUDA device

    lib = probe_library()
    cases = [("fleet", *fleet_plan(chip_smoke), True)]
    rng = np.random.default_rng(chip_smoke.SEED)
    for j in (100_000, 262_144):
        cols, scal = chip_smoke.random_case(rng, j, 4, True)
        cases.append((f"random J={j}", cols, scal, True))
        cases.append((f"random J={j}", cols, dict(scal, cap=[-1] * 4),
                      False))
    real, ops._lib_handle = ops._lib_handle, lib
    try:
        rows = [(name, cols, bounded, stamps(
            lib, cols, scal, dict(cheap=False, tiered=True, bounded=bounded)))
            for name, cols, scal, bounded in cases]
    finally:
        ops._lib_handle = real
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    for name, cols, bounded, buf in rows:
        seen = sorted((k for k in PHASES if buf[k]), key=lambda k: buf[k])
        phases, last = {}, buf[0]
        for k in seen:
            phases[PHASES[k]] = round((buf[k] - last) / mhz, 3)
            last = buf[k]
        print(json.dumps({
            "probe": "sched_select_phases", "case": name,
            "J": cols["prio"].shape[0], "bounded": bounded,
            "candidates": int(cols["evictable"].sum()),
            "records": buf[RECORDS], "walk_rounds": buf[ROUNDS],
            "cta0_us": round((last - buf[0]) / mhz, 3), "sm_mhz": mhz,
            "phases_us": phases}))
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
