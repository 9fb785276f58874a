"""Build the port's CUDA kernels at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources in
this checkout into ``<repo>/build/kernels/`` (listed in ``.gitignore``),
named by a hash of its sources and flags so that an edited source never
loads a stale library.  The sources expose a plain C interface, so no
PyTorch header is compiled (seconds, not minutes).  A failed build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    """A loaded kernel library and how it was made."""

    lib: ctypes.CDLL
    path: Path
    seconds: float        # 0.0 when an identical build was already on disk
    log: str              # nvcc/ptxas output (register and smem summary)


_LOADED: Dict[Path, Built] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def load(name: str, sources: Sequence[Path]) -> Built:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless that exact
    build exists, then load it (once per process)."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if path in _LOADED:
        return _LOADED[path]
    seconds, log = 0.0, ""
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, path)      # atomic: concurrent builders never tear
    built = Built(ctypes.CDLL(str(path)), path, seconds, log)
    _LOADED[path] = built
    return built
