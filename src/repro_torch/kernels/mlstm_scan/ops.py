"""Wrapper for the chunkwise mLSTM kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/mlstm_scan/kernel.py:46``
(``_mlstm_kernel``, launched by ``mlstm_scan`` at ``:127``) behind the
reference's ``ops.py:14 mlstm_chunked``.

The kernel has no initial-state input (the TPU kernel's ``_init`` at
``:59-63`` starts from C = n = 0, m = -1e30), so its domain is a prefill
from a fresh cache: `repro_torch.models.xlstm.mlstm_forward` calls it once
per mLSTM block of such a prefill.  A prefill onto a carried state and
every decode step run the chunk function in torch (``ref.mlstm_chunk``), as
the reference model does; that is the model's choice, not a fallback here.

* CPU tensors run the plain version (``ref.py``).
* CUDA tensors run the hand-written kernel (``csrc/mlstm_scan.cu``, built
  for ``sm_90a`` at first use by ``kernels._build``) on the current stream,
  or raise: there is no fallback to the plain version.
* Both take float32 only, contiguous, on one device (the model upcasts
  bf16 q, k, v, which is exact, so that h comes back in fp32 as the
  reference keeps it); the kernel takes ``chunk <= 256`` and
  ``dh <= 1024``.

``LAUNCHES`` counts kernel launches on the card; the CPU path never moves
it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

#: kernel launches on the card since the count was last reset
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_scan.cu"
MAX_CHUNK = 256
MAX_HEAD_DIM = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    from repro_torch.kernels import _build

    built = _build.load("mlstm_scan", [SOURCE])
    lib = built.lib
    lib.mlstm_scan_launch.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.mlstm_scan_launch.restype = _I
    lib.mlstm_scan_error_string.argtypes = [_I]
    lib.mlstm_scan_error_string.restype = ctypes.c_char_p
    lib.mlstm_scan_limits.argtypes = [_P, _P]
    lib.mlstm_scan_limits.restype = None
    chunk, dh = _I(), _I()
    lib.mlstm_scan_limits(ctypes.byref(chunk), ctypes.byref(dh))
    if (chunk.value, dh.value) != (MAX_CHUNK, MAX_HEAD_DIM):
        raise RuntimeError("mlstm_scan library disagrees on its limits")
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _check(q, k, v, lf, li):
    """The contract of both versions: shapes, float32, contiguous, one cpu
    or cuda device."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v [BH, S, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("lf", lf), ("li", li)):
        if tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape[:2])}")
    if q.numel() == 0:
        raise ValueError("mlstm_scan needs at least one step")
    for name, t in (("q", q), ("k", k), ("v", v), ("lf", lf), ("li", li)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; mlstm_scan takes "
                            "float32")
        if t.device != q.device:
            raise ValueError("the inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_scan runs on cpu or cuda tensors, got "
                         f"{q.device}")


def _launch(q, k, v, lf, li, chunk):
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError("the mlstm_scan kernel takes CUDA tensors")
    bh, s, dh = q.shape
    if chunk > MAX_CHUNK or dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes chunks up to {MAX_CHUNK} and "
                         f"head dims up to {MAX_HEAD_DIM}, got {chunk}, {dh}")
    dev = q.device
    h = torch.empty_like(q)
    c = torch.empty((bh, dh, dh), dtype=torch.float32, device=dev)
    n = torch.empty((bh, dh), dtype=torch.float32, device=dev)
    m = torch.empty((bh, 1), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.mlstm_scan_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
            li.data_ptr(), h.data_ptr(), c.data_ptr(), n.data_ptr(),
            m.data_ptr(), bh, s, dh, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.mlstm_scan_error_string(rc).decode()
        raise RuntimeError(f"mlstm_scan launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return h, (c, n, m)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lf: torch.Tensor, li: torch.Tensor, *, chunk: int = 256
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]]:
    """q, k, v [BH, S, dh] (k pre-scaled by 1/sqrt(dh)); lf, li [BH, S],
    from a zero state -> (h [BH, S, dh], (C [BH, dh(v), dh(k)], n [BH, dh],
    m [BH, 1])), all float32."""
    _check(q, k, v, lf, li)
    chunk = min(chunk, q.shape[1])
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, lf, li, chunk=chunk)
    return _launch(q, k, v, lf, li, chunk)
