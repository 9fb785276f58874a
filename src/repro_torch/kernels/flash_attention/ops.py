"""Wrapper for the flash-attention forward kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py:34``
(``_fwd_kernel``, launched by ``flash_attention_fwd`` at ``:110``) behind the
reference's ``ops.py:35 flash_attention``.  The model's prefill attention
(`repro_torch.models.attention.prefill_attention`) calls it once per layer.

* Layout: the model's [B, S, H, D] for q, k, v and the output; GQA when
  ``H`` is a multiple of ``KVH``.  The scale is ``D ** -0.5`` of the true
  head dim (``ops.py:52``).  No head-dim padding: the 128-lane padding was
  the TPU's.
* CPU tensors run the plain version (``ref.py``).
* Under an active `roofline.counting.costing` every call records its
  `cost.cost` (the kernel's FLOPs and bytes), and meta tensors are
  taken: the call returns a meta output and launches nothing.  Outside
  it a meta tensor raises.
* CUDA tensors run one of two hand-written kernels in
  ``csrc/flash_attention.cu`` (built for ``sm_90a`` at first use by
  ``kernels._build``) on the current stream, or raise: there is no
  fallback from one kernel to the other or to the plain version.  The
  rule (`kernel_route`): bfloat16 with ``D % 16 == 0`` (and ``D <= 128``)
  goes to the tensor-core kernel ``flash_fwd_wgmma`` (``"wgmma"``: TMA,
  mbarriers, wgmma with fp32 accumulators, P·V as a bf16 hi/lo split of
  fp32 P), whose tensors must also start on 16 bytes with every stride a
  multiple of 16 bytes; every other case (float32, and bfloat16 with
  another head dim) goes to the SIMT kernel ``flash_fwd`` (``"simt"``,
  fp32 on the CUDA cores).  Both take contiguous tensors with
  ``D <= 128``.

* V may be narrower than Q and K (MLA: Dk = 96, Dv = 64).  The kernels
  take one head dim, so the wrapper pads V with zero columns to Dk and
  returns the first Dv columns of the output: the exact function, since a
  zero column of V adds exactly zero to every output column, at the cost
  of the padded copy and of Dk - Dv columns of P.V (`PERF.md` has it).

``LAUNCHES`` counts launches of the SIMT kernel and ``WGMMA_LAUNCHES``
those of the tensor-core kernel on the card; the CPU path moves neither.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.cost import cost
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.roofline import counting

#: launches of the SIMT kernel on the card since the count was last reset
LAUNCHES = 0
#: launches of the tensor-core kernel on the card since the last reset
WGMMA_LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
ROUTES = ("simt", "wgmma")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    built = _build.load("flash_attention", [SOURCE])
    lib = built.lib
    lib.flash_attention_fwd_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
        _I, _P]
    lib.flash_attention_fwd_launch.restype = _I
    lib.flash_attention_fwd_wgmma_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I,
        _P]
    lib.flash_attention_fwd_wgmma_launch.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_max_head_dim.restype = _I
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention library disagrees on the largest "
                           "head dim")
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _check_shapes(q, k, v):
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3] or v.shape[3] > k.shape[3]):
        raise ValueError(f"expected q [B, Sq, H, D], k [B, Skv, KVH, D] and "
                         f"v [B, Skv, KVH, Dv <= D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if q.device.type not in ("cpu", "cuda") and not counting.dry(q.device):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")


def kernel_route(q: torch.Tensor) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bfloat16 with a head
    dim that is a multiple of 16, ``"simt"`` for everything else."""
    d = q.shape[-1]
    if q.dtype == torch.bfloat16 and d % 16 == 0 and d <= MAX_HEAD_DIM:
        return "wgmma"
    return "simt"


def _call(x: torch.Tensor, fn: str, *args):
    """Launch ``fn`` of the library on x's device and current stream;
    raise on the error code it returns."""
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention {fn} failed: error {rc} "
                           f"({msg})")


def launch(q, k, v, route: str, *, causal: bool = True, window: int = 0,
           n_meta: int = 0) -> torch.Tensor:
    """Run the named kernel (``"simt"`` or ``"wgmma"``) on CUDA tensors
    that `flash_attention` has checked; raise if that kernel does not take
    them.  A V narrower than K is padded with zero columns to K's head dim
    and the output cut back to V's."""
    global LAUNCHES, WGMMA_LAUNCHES
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if dv < d:
        v = torch.nn.functional.pad(v, (0, d - dv))
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention needs at least one query and one "
                         "key")
    out = torch.empty_like(q)
    if counting.dry(q.device):
        return out if dv == d else out[..., :dv]
    scale = float(d ** -0.5)
    if route == "wgmma":
        if q.dtype != torch.bfloat16:
            raise TypeError(f"the tensor-core kernel takes bfloat16, got "
                            f"{q.dtype}")
        if d % 16:
            raise ValueError(f"the tensor-core kernel takes head dims that "
                             f"are multiples of 16, got {d}")
        for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
            _build.check_tma(name, x)
        _call(q, "flash_attention_fwd_wgmma_launch", q.data_ptr(),
              k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, h, kvh,
              d, scale, int(causal), int(window), int(n_meta))
        WGMMA_LAUNCHES += 1
    else:
        _call(q, "flash_attention_fwd_launch", q.data_ptr(), k.data_ptr(),
              v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h,
              kvh, d, scale, int(causal), int(window), int(n_meta))
        LAUNCHES += 1
    return out if dv == d else out[..., :dv]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    n_meta: int = 0) -> torch.Tensor:
    """q [B, Sq, H, D], k [B, Skv, KVH, D], v [B, Skv, KVH, Dv <= D] ->
    [B, Sq, H, Dv] in q's dtype; positions are the row and column indices
    (top-left aligned)."""
    _check_shapes(q, k, v)
    if counting.active() is not None:
        b, sq, h, d = q.shape
        counting.record_kernel("flash_attention", cost(
            b, sq, h, k.shape[2], d, q.element_size(), skv=k.shape[1],
            dv=v.shape[3], causal=causal, window=window, n_meta=n_meta))
    if q.device.type == "cpu":
        with counting.uncounted():
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window, n_meta=n_meta)
    return launch(q, k, v, kernel_route(q), causal=causal, window=window,
                  n_meta=n_meta)
