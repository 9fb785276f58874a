"""Wrapper for the chunkwise mLSTM kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/mlstm_scan/kernel.py:46``
(``_mlstm_kernel``, launched by ``mlstm_scan`` at ``:127``) behind the
reference's ``ops.py:14 mlstm_chunked``, and takes the carried state that
kernel lacks (its ``_init`` at ``:59-63`` starts from C = n = 0,
m = -1e30, which ``state=None`` stands for).
`repro_torch.models.xlstm.mlstm_forward` calls it once per mLSTM block
for every T: a prefill from a fresh cache, a prefill onto a carried
state, and every decode step (T = 1, chunk 1).

* CPU tensors run the plain version (``ref.py``).
* Under an active `roofline.counting.costing` every call records its
  `cost.cost`, and meta tensors are taken: the call returns meta outputs
  and launches nothing.  Outside it a meta tensor raises.
* CUDA tensors run the hand-written kernel (``csrc/mlstm_scan.cu``, built
  for ``sm_90a`` at first use by ``kernels._build``) on the current stream,
  or raise: there is no fallback to the plain version.
* Both take float32 only, contiguous, on one device (the model upcasts
  bf16 q, k, v, which is exact, so that h comes back in fp32 as the
  reference keeps it), and return the new state out of place; the kernel
  takes ``chunk <= 256`` and ``dh <= 1024``.

``LAUNCHES`` counts the wrapper's calls that launched on the card: one per
call, though a call runs three grids (the gates, the carried states, the
outputs).  The CPU path never moves it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.mlstm_scan.cost import cost
from repro_torch.kernels.mlstm_scan.ref import State, mlstm_scan_ref
from repro_torch.roofline import counting

#: calls that launched on the card (three grids each) since the count was
#: last reset
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
    lib.mlstm_scan_launch.argtypes = [_P] * 16 + [_I] * 4 + [_P]
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


def _check(q, k, v, lf, li, state):
    """The contract of both versions: shapes, float32, contiguous, one cpu
    or cuda device; ``state`` None or (C [BH, dh, dh], n [BH, dh],
    m [BH])."""
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
    named = [("q", q), ("k", k), ("v", v), ("lf", lf), ("li", li)]
    if state is not None:
        if len(state) != 3:
            raise ValueError("state is (C, n, m)")
        bh, _, dh = q.shape
        for name, t, shape in (("C", state[0], (bh, dh, dh)),
                               ("n", state[1], (bh, dh)),
                               ("m", state[2], (bh,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"state {name} has shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            named.append((f"state {name}", t))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; mlstm_scan takes "
                            "float32")
        if t.device != q.device:
            raise ValueError("the inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type not in ("cpu", "cuda") and not counting.dry(q.device):
        raise ValueError(f"mlstm_scan runs on cpu or cuda tensors, got "
                         f"{q.device}")


def _launch(q, k, v, lf, li, chunk, state=None):
    global LAUNCHES
    if q.device.type != "cuda" and not counting.dry(q.device):
        raise ValueError("the mlstm_scan kernel takes CUDA tensors")
    bh, s, dh = q.shape
    if chunk > MAX_CHUNK or dh > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes chunks up to {MAX_CHUNK} and "
                         f"head dims up to {MAX_HEAD_DIM}, got {chunk}, {dh}")
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    nch = -(-s // chunk)
    h = torch.empty_like(q)
    c = torch.empty((bh, dh, dh), **f32)
    n = torch.empty((bh, dh), **f32)
    m = torch.empty((bh, 1), **f32)
    # scratch: the gates, m at every chunk boundary, and C and n at the
    # start of chunks 1 .. nch - 1
    gates = torch.empty((3, bh, s), **f32)
    mst = torch.empty((bh, nch + 1), **f32)
    cs = torch.empty((bh, nch - 1, dh, dh), **f32) if nch > 1 else None
    ns = torch.empty((bh, nch - 1, dh), **f32) if nch > 1 else None
    c0, n0, m0 = state if state is not None else (None, None, None)
    if counting.dry(q.device):
        return h, (c, n, m)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.mlstm_scan_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
            li.data_ptr(), ptr(c0), ptr(n0), ptr(m0), h.data_ptr(),
            c.data_ptr(), n.data_ptr(), m.data_ptr(), gates.data_ptr(),
            mst.data_ptr(), ptr(cs), ptr(ns), bh, s, dh, chunk,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.mlstm_scan_error_string(rc).decode()
        raise RuntimeError(f"mlstm_scan launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES += 1
    return h, (c, n, m)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lf: torch.Tensor, li: torch.Tensor,
               state: Optional[State] = None, *, chunk: int = 256
               ) -> Tuple[torch.Tensor, State]:
    """q, k, v [BH, S, dh] (k pre-scaled by 1/sqrt(dh)); lf, li [BH, S];
    from ``state`` (C0 [BH, dh(v), dh(k)], n0 [BH, dh], m0 [BH]; None is
    the zero state) -> (h [BH, S, dh], (C [BH, dh(v), dh(k)], n [BH, dh],
    m [BH, 1])), all float32."""
    _check(q, k, v, lf, li, state)
    chunk = min(chunk, q.shape[1])
    if counting.active() is not None:
        counting.record_kernel("mlstm_scan", cost(
            *q.shape[:2], q.shape[2], chunk, carried=state is not None))
    if q.device.type == "cpu":
        with counting.uncounted():
            return mlstm_scan_ref(q, k, v, lf, li, state, chunk=chunk)
    return _launch(q, k, v, lf, li, chunk, state)
