"""Wrapper for the grouped expert matmul kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/moe_gmm/kernel.py:25``
(``_gmm_kernel``, launched by ``grouped_matmul`` at ``:42``) behind the
reference's ``ops.py:18 expert_swiglu``.  The MoE layer's capacity
dispatch (`repro_torch.models.moe.moe_ffn`) calls `expert_swiglu` once per
MoE layer: three launches, on every prefill and decode step.

* ``grouped_matmul(x, w, counts=None)``: ``out[e] = x[e] @ w[e]`` for x
  ``[E, C, d]`` and w ``[E, d, f]``, fp32 products and sums, stored in x's
  dtype.  x is float32 or bfloat16; w is in x's dtype or float32 (then
  rounded to x's dtype as it is read, the reference's
  ``w.astype(x.dtype)``).  With int32 ``counts`` [E], each in ``[0, C]``,
  the rows at or past ``counts[e]`` are zero and are not computed.
* CPU tensors run the plain version (``ref.py``).
* Under an active `roofline.counting.costing` every call records its
  `cost.cost` without reading the counts: its rows are the ``pairs`` the
  caller gives (`models.moe.moe_ffn`: tokens x top_k, every pair kept;
  `distributed.moe_ep`: a uniform router's pairs to the rank's experts),
  or every capacity row where it gives none; meta tensors are taken, and
  the call returns a meta output and launches nothing.  Outside it a
  meta tensor raises.
* CUDA tensors run one of two hand-written kernels in ``csrc/moe_gmm.cu``
  (built for ``sm_90a`` at first use by ``kernels._build``) on the current
  stream, or raise: there is no fallback from one kernel to the other or
  to the plain version.  The rule (`kernel_route`): bfloat16 x with ``d``
  and ``f`` multiples of 8 goes to the tensor-core kernel
  ``moe_gmm_wgmma`` (``"wgmma"``: TMA, mbarriers, wgmma with fp32
  accumulators; fp32 weights rounded to bf16 in shared memory), whose
  tensors must also start on 16 bytes; every other case (float32 x, and
  other widths) goes to the SIMT kernel ``moe_gmm_kernel`` (``"simt"``,
  fp32 on the CUDA cores).  A count outside ``[0, C]`` raises on the CPU;
  on the card either kernel traps, and the next synchronise raises (the
  check costs no host read).
* The TPU wrapper's ``block_c``, ``block_d`` and ``block_f`` were its VMEM
  tiling and do not change the function, so they are gone.

``LAUNCHES`` counts launches of the SIMT kernel and ``WGMMA_LAUNCHES``
those of the tensor-core kernel on the card; the CPU path moves neither.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm.cost import cost
from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref, swiglu_gate
from repro_torch.roofline import counting

#: launches of the SIMT kernel on the card since the count was last reset
LAUNCHES = 0
#: launches of the tensor-core kernel on the card since the last reset
WGMMA_LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gmm.cu"
#: capacity rows per block of the kernel: the capacity dispatch rounds C
#: up to it
ROW_TILE = 64
ROUTES = ("simt", "wgmma")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    built = _build.load("moe_gmm", [SOURCE])
    lib = built.lib
    lib.moe_gmm_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.moe_gmm_launch.restype = _I
    lib.moe_gmm_wgmma_launch.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.moe_gmm_wgmma_launch.restype = _I
    lib.moe_gmm_error_string.argtypes = [_I]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    lib.moe_gmm_row_tile.argtypes = []
    lib.moe_gmm_row_tile.restype = _I
    if lib.moe_gmm_row_tile() != ROW_TILE:
        raise RuntimeError("moe_gmm library disagrees on the row tile")
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _check(x, w, counts):
    """The contract of both versions: ranks and shapes, dtypes, contiguous,
    one cpu or cuda device, and (where it costs no host read) the counts'
    range."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"expected x [E, C, d] and w [E, d, f], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    e, c, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} differ "
                         "in experts or contraction dim")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError("grouped_matmul needs at least one expert, row, "
                         "input and output column")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; grouped_matmul takes "
                        "float32 or bfloat16")
    if w.dtype not in (x.dtype, torch.float32):
        raise TypeError(f"w has dtype {w.dtype}; it must be x's "
                        f"({x.dtype}) or float32")
    named = [("x", x), ("w", w)]
    if counts is not None:
        if counts.shape != (e,) or counts.dtype != torch.int32:
            raise TypeError(f"counts must be int32 [{e}], got "
                            f"{counts.dtype} {tuple(counts.shape)}")
        named.append(("counts", counts))
    for name, t in named:
        if t.device != x.device:
            raise ValueError("the inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda") and not counting.dry(x.device):
        raise ValueError(f"grouped_matmul runs on cpu or cuda tensors, got "
                         f"{x.device}")
    if counts is not None and x.device.type == "cpu" and bool(
            ((counts < 0) | (counts > c)).any()):
        raise ValueError(f"a count lies outside [0, C={c}]: "
                         f"{counts.tolist()}")


def kernel_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bfloat16 x whose
    contraction and output widths are multiples of 8, ``"simt"`` for
    everything else."""
    if x.dtype == torch.bfloat16 and x.shape[2] % 8 == 0 and \
            w.shape[2] % 8 == 0:
        return "wgmma"
    return "simt"


def _call(x: torch.Tensor, fn: str, *args):
    """Launch ``fn`` of the library on x's device and current stream;
    raise on the error code it returns."""
    if x.device.type != "cuda" and not counting.dry(x.device):
        raise ValueError("the moe_gmm kernels take CUDA tensors")
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.moe_gmm_error_string(rc).decode()
        raise RuntimeError(f"moe_gmm {fn} failed: error {rc} ({msg})")


def launch(x, w, counts, route: str) -> torch.Tensor:
    """Run the named kernel (``"simt"`` or ``"wgmma"``) on CUDA tensors
    that `grouped_matmul` has checked; raise if that kernel does not take
    them."""
    global LAUNCHES, WGMMA_LAUNCHES
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if counting.dry(x.device):
        return out
    cnt = None if counts is None else counts.data_ptr()
    if route == "wgmma":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the tensor-core kernel takes bfloat16 x, got "
                            f"{x.dtype}")
        if d % 8 or f % 8:
            raise ValueError(f"the tensor-core kernel takes widths that are "
                             f"multiples of 8, got d={d}, f={f}")
        for name, t in (("x", x), ("w", w), ("out", out)):
            _build.check_tma(name, t)
        _call(x, "moe_gmm_wgmma_launch", x.data_ptr(), w.data_ptr(), cnt,
              out.data_ptr(), _DTYPES[w.dtype], e, c, d, f)
        WGMMA_LAUNCHES += 1
    else:
        _call(x, "moe_gmm_launch", x.data_ptr(), w.data_ptr(), cnt,
              out.data_ptr(), _DTYPES[x.dtype], _DTYPES[w.dtype], e, c, d, f)
        LAUNCHES += 1
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None, *,
                   pairs: Optional[int] = None) -> torch.Tensor:
    """x [E, C, d], w [E, d, f] (x's dtype or float32), optional int32
    counts [E] -> [E, C, f] in x's dtype.  ``pairs``, the routed pairs
    that the counts hold, is read only by the cost record."""
    _check(x, w, counts)
    if counting.active() is not None:
        e, c = x.shape[:2]
        counting.record_kernel("moe_gmm", cost(
            x, w, pairs=e * c if pairs is None else pairs))
        counting.note("moe_gmm_rows", "every capacity row" if pairs is None
                      else "the caller's routed pairs")
    if x.device.type == "cpu":
        with counting.uncounted():
            return grouped_matmul_ref(x, w, counts)
    return launch(x, w, counts, kernel_route(x, w))


def expert_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor,
                  counts: Optional[torch.Tensor] = None, *,
                  pairs: Optional[int] = None) -> torch.Tensor:
    """``down(silu(gate) * up)`` per expert over capacity buffers: x
    [E, C, d], w_gate and w_up [E, d, f], w_down [E, f, d] -> [E, C, d] in
    x's dtype; three grouped matmuls, ``silu(gate) * up`` in x's dtype
    between them (the reference's ``ops.py:17-28``)."""
    h = swiglu_gate(grouped_matmul(x, w_gate, counts, pairs=pairs),
                    grouped_matmul(x, w_up, counts, pairs=pairs))
    return grouped_matmul(h, w_down, counts, pairs=pairs)
