"""Probe of the selective-scan kernel's compile-time shape on the card.

    PYTHONPATH=src python tools/probe_ssm_lanes.py

The kernel (``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu``) fixes
four lanes per (batch, channel) and the decay on ``ex2.approx``.  This
script writes variants of that source under ``build/probe_ssm_lanes/``:
G = 2, 4, 8 and 16 lanes per channel with ex2.approx, and G = 4 with
``expf``.  It builds them in parallel, holds each against the plain
version (1e-5 times max(1, max|output|), as ``chip_smoke.py`` holds the
serving shapes) and times each at hymba-1.5b's prefill (B=4, S=2,176,
di=3,200, ds=16) and at one decode step (S=1), in turns, with
``queued_ms``.  Prints one JSON line per (variant, shape), then the card's
name and power limit.  Needs a CUDA device; it changes nothing in the
package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.timing import queued_ms

SHAPES = {"prefill": (4, 2176, 3200, 16), "decode": (4, 1, 3200, 16)}
#: (lanes, decay on ex2.approx): the kernel's own first
VARIANTS = ((4, True), (8, True), (16, True), (2, True), (4, False))
TOL = 1e-5
OUT_DIR = _build.REPO_ROOT / "build" / "probe_ssm_lanes"

# the kernel's 16-byte read of a lane's four states, and a read of any
# kPer states (float4 where kPer allows, float2, or one float)
LDS_FOUR = """  const float4 v = *reinterpret_cast<const float4*>(row);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
"""
LDS_ANY = """  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int j = 0; j < kPer; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else if constexpr (kPer == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = row[0];
  }
"""
EX2 = """  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(r) : "f"(dl * a));
  return r;
"""
LOG2E = " * 1.44269504088896341f"


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"ssm_scan.cu no longer holds exactly one "
                           f"{old!r}; update the probe")
    return text.replace(old, new)


def variant_source(lanes: int, ex2: bool) -> Path:
    """ssm_scan.cu with ``lanes`` lanes per channel and, unless ``ex2``,
    the decay on expf; written under OUT_DIR."""
    text = ops.SOURCE.read_text()
    header = (ops.SOURCE.parent / "../../hopper.cuh").resolve()
    text = substitute(text, '#include "../../hopper.cuh"',
                      f'#include "{header}"')
    text = substitute(text, "constexpr int kLanes = 4;",
                      f"constexpr int kLanes = {lanes};")
    text = substitute(text, LDS_FOUR, LDS_ANY)
    if not ex2:
        text = substitute(text, EX2, "  return expf(dl * a);\n")
        text = substitute(text, LOG2E, "")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"ssm_scan_g{lanes}_{'ex2' if ex2 else 'expf'}.cu"
    path.write_text(text)
    return path


def build(var) -> ctypes.CDLL:
    lanes, ex2 = var
    lib = _build.load(f"ssm_scan_probe_g{lanes}{'' if ex2 else '_expf'}",
                      [variant_source(lanes, ex2)]).lib
    lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


def launch(lib, delta, b, c, x, a, h0):
    bsz, s, di = delta.shape
    y, h = torch.empty_like(delta), torch.empty_like(h0)
    rc = lib.ssm_scan_launch(
        delta.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, di,
        a.shape[-1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan probe launch failed: CUDA error {rc}")
    return y, h


def inputs(gen, b, s, di, ds, dev):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    delta = torch.nn.functional.softplus(rn(b, s, di)) * 0.1
    a = -torch.exp(rn(di, ds) * 0.3)
    return delta, rn(b, s, ds), rn(b, s, ds), rn(b, s, di), a, \
        rn(b, di, ds) * 0.1


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_ssm_lanes needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    for name, shape in SHAPES.items():
        args = inputs(gen, *shape, dev)
        yr, hr = ssm_scan_ref(*args)
        bar = TOL * max(1.0, float(yr.abs().max()), float(hr.abs().max()))
        rows = {var: [] for var in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):      # in turns
            for var in order:
                y, h = launch(libs[var], *args)
                torch.cuda.synchronize()
                err = max(float((y - yr).abs().max()),
                          float((h - hr).abs().max()))
                if not err <= bar:
                    raise AssertionError(f"{var} {name}: {err} > {bar}")
                ms = queued_ms(lambda lib=libs[var]: launch(lib, *args),
                               iters=20 if shape[1] > 1 else 200)
                rows[var].append((ms, err))
        for var in VARIANTS:
            print(json.dumps({
                "probe": "ssm_scan_lanes", "lanes": var[0],
                "exp": "ex2.approx" if var[1] else "expf", "shape": name,
                "B_S_di_ds": shape,
                "ms_passes": [f"{r[0]:.5f}" for r in rows[var]],
                "ms": f"{sum(r[0] for r in rows[var]) / 2:.5f}",
                "max_abs_err": f"{max(r[1] for r in rows[var]):.3e}"}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip())


if __name__ == "__main__":
    main()
