"""Build the port's CUDA kernels at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources in
this checkout into ``<repo>/build/kernels/`` (listed in ``.gitignore``),
named by a hash of its sources, the headers they include (``#include
"..."``, followed recursively) and the flags, so that an edited source or
header never loads a stale library.  The sources expose a plain C interface, so no
PyTorch header is compiled (seconds, not minutes).  A failed build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(sources: Sequence[Path]) -> list:
    """The headers that ``sources`` include with ``#include "..."``,
    recursively, resolved against the including file's directory, each
    once, in the order they are first met."""
    found, todo = [], list(sources)
    while todo:
        src = todo.pop(0)
        for name in _INCLUDE.findall(src.read_bytes()):
            hdr = (src.parent / name.decode()).resolve()
            if hdr not in found:
                found.append(hdr)
                todo.append(hdr)
    return found


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


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """``build/kernels/lib<name>-<hash>.so``, the hash over the flags, the
    sources and the headers they include."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *local_headers(sources)]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str, sources: Sequence[Path]) -> Built:
    """Compile ``sources`` into ``library_path(name, sources)`` unless that
    exact build exists, then load it (once per process)."""
    sources = [Path(s) for s in sources]
    path = library_path(name, sources)
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


def check_tma(name: str, x) -> None:
    """The tensor-core kernels read their operands by TMA (``hopper.cuh``),
    which takes a tensor that starts on 16 bytes and whose strides (but the
    innermost) are multiples of 16 bytes; raise ValueError otherwise."""
    size = x.element_size()
    if x.data_ptr() % 16 or any(st * size % 16
                                for st in x.stride()[:-1]):
        raise ValueError(f"{name} must start on 16 bytes with strides that "
                         f"are multiples of 16 bytes for the tensor-core "
                         f"kernel (data_ptr % 16 = {x.data_ptr() % 16}, "
                         f"strides {x.stride()} x {size} bytes)")
