"""Wrapper for the Mamba selective-scan kernel on Hopper.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan/kernel.py:25``
(``_ssm_kernel``, launched by ``ssm_scan`` at ``:69``) behind the
reference's ``ops.py:15 selective_scan``.  Hymba's SSM branch
(`repro_torch.models.ssm.ssm_forward`) calls it once per hybrid layer, on
the whole prefill and on every decode step (S = 1), from the layer's
cached state.

* CPU tensors run the plain version (``ref.py``).
* Under an active `roofline.counting.costing` every call records its
  `cost.cost`, and meta tensors are taken: the call returns meta outputs
  and launches nothing.  Outside it a meta tensor raises.
* CUDA tensors run the hand-written kernel (``csrc/ssm_scan.cu``, built for
  ``sm_90a`` at first use by ``kernels._build``) on the current stream, or
  raise: there is no fallback to the plain version.
* Both take float32 only (the model's scan is fp32 throughout), contiguous,
  on one device; the kernel takes ``ds <= 16``, spread over a group of
  lanes per channel (``csrc/ssm_scan.cu`` has the design).  The TPU
  wrapper's ``chunk`` and ``block_d`` were its VMEM tiling and do not
  change the function, so they are gone.

``LAUNCHES`` counts kernel launches on the card; the CPU path never moves
it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan.cost import cost
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.roofline import counting

#: kernel launches on the card since the count was last reset
LAUNCHES = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
MAX_STATE = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    from repro_torch.kernels import _build

    built = _build.load("ssm_scan", [SOURCE])
    lib = built.lib
    lib.ssm_scan_launch.argtypes = [_P] * 8 + [_I] * 4 + [_P]
    lib.ssm_scan_launch.restype = _I
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    lib.ssm_scan_max_state.argtypes = []
    lib.ssm_scan_max_state.restype = _I
    if lib.ssm_scan_max_state() != MAX_STATE:
        raise RuntimeError("ssm_scan library disagrees on the largest state")
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _check(delta, b, c, x, a, h0):
    """The contract of both versions: shapes, float32, contiguous, one cpu
    or cuda device."""
    named = (("delta", delta), ("b", b), ("c", c), ("x", x), ("a", a),
             ("h0", h0))
    if delta.dim() != 3 or x.shape != delta.shape:
        raise ValueError(f"expected delta and x [B, S, di], got "
                         f"{tuple(delta.shape)}, {tuple(x.shape)}")
    bsz, s, di = delta.shape
    ds = a.shape[-1] if a.dim() == 2 else -1
    for name, t, shape in (("b", b, (bsz, s, ds)), ("c", c, (bsz, s, ds)),
                           ("a", a, (di, ds)), ("h0", h0, (bsz, di, ds))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if delta.numel() == 0 or ds == 0:
        raise ValueError("selective_scan needs at least one step, channel "
                         "and state")
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; selective_scan "
                            "takes float32")
        if t.device != delta.device:
            raise ValueError("the inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (delta.device.type not in ("cpu", "cuda")
            and not counting.dry(delta.device)):
        raise ValueError(f"selective_scan runs on cpu or cuda tensors, got "
                         f"{delta.device}")


def _launch(delta, b, c, x, a, h0):
    global LAUNCHES
    if delta.device.type != "cuda" and not counting.dry(delta.device):
        raise ValueError("the ssm_scan kernel takes CUDA tensors")
    bsz, s, di = delta.shape
    ds = a.shape[-1]
    if ds > MAX_STATE:
        raise ValueError(f"the kernel takes d_state up to {MAX_STATE}, "
                         f"got {ds}")
    y = torch.empty_like(delta)
    h = torch.empty_like(h0)
    if counting.dry(delta.device):
        return y, h
    lib = _lib()
    with torch.cuda.device(delta.device):
        rc = lib.ssm_scan_launch(
            delta.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s,
            di, ds, torch.cuda.current_stream(delta.device).cuda_stream)
    if rc != 0:
        msg = lib.ssm_scan_error_string(rc).decode()
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {rc} ({msg})")
    LAUNCHES += 1
    return y, h


def selective_scan(delta: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   x: torch.Tensor, a: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta, x [B, S, di]; b, c [B, S, ds]; a [di, ds] (A = -exp(a_log));
    h0 [B, di, ds] -> (y [B, S, di], h [B, di, ds]), all float32."""
    _check(delta, b, c, x, a, h0)
    if counting.active() is not None:
        counting.record_kernel("ssm_scan", cost(*delta.shape, a.shape[-1]))
    if delta.device.type == "cpu":
        with counting.uncounted():
            return ssm_scan_ref(delta, b, c, x, a, h0)
    return _launch(delta, b, c, x, a, h0)
