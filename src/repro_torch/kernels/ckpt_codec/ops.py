"""Wrappers for the int8 block checkpoint codec on Hopper.

Replaces the TPU kernels ``src/repro/kernels/ckpt_codec/kernel.py:22``
(``_quant_kernel``, launched by ``quantize_blocks`` at ``:42``) and ``:30``
(``_dequant_kernel``, launched by ``dequantize_blocks`` at ``:63``), behind
the reference's ``ops.py`` (``quantize_array`` ``:18``, ``dequantize_array``
``:31``, ``roundtrip_error`` ``:40``).  ``launch.cr_cost.measure`` runs them
on every fp32 leaf of a snapshot; the checkpoint manager does not call
them, as in the reference.

* CPU tensors run the plain version (``ref.py``), which pads the flat
  tensor to ``[R, 128]`` with zeros as ``jnp.pad`` does.
* CUDA tensors run the hand-written kernels (``csrc/ckpt_codec.cu``, built
  for ``sm_90a`` at first use by ``kernels._build``) on the current
  stream, or raise: there is no fallback to the plain version.  The kernel
  reads the tail past ``n`` as zeros, so no padded copy is made.

Bound on the H100: both kernels stream.  Quantize reads ``4n`` bytes and
writes ``128R + 4R``; dequantize to fp32 reads ``128R + 4R`` and writes
``4n`` (``R = ceil(n / 128)``): ~28.5 GB each way for the full
internlm2-1.8b TrainState, ~8.5 ms at 3.35 TB/s.

``LAUNCHES`` counts kernel launches per kernel (``"quantize"``,
``"dequantize"``: one per call on a CUDA tensor that holds at least one
element); the CPU path never moves it.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ckpt_codec.ref import (
    LANE,
    dequantize_array_ref,
    dequantize_ref,
    quantize_array_ref,
    quantize_ref,
)

#: launches of each kernel on the card since the counts were last reset
LAUNCHES = {"quantize": 0, "dequantize": 0}

SOURCE = Path(__file__).resolve().parent / "csrc" / "ckpt_codec.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib_handle: Optional[ctypes.CDLL] = None


def build():
    """Build (or reuse) and load the kernel library; returns the
    `kernels._build.Built` record (path, build seconds, ptxas log)."""
    global _lib_handle
    from repro_torch.kernels import _build

    built = _build.load("ckpt_codec", [SOURCE])
    lib = built.lib
    lib.ckpt_quantize_launch.argtypes = [_P, _L, _P, _P, _P]
    lib.ckpt_quantize_launch.restype = _I
    lib.ckpt_dequantize_launch.argtypes = [_P, _P, _L, _P, _I, _P]
    lib.ckpt_dequantize_launch.restype = _I
    lib.ckpt_codec_error_string.argtypes = [_I]
    lib.ckpt_codec_error_string.restype = ctypes.c_char_p
    lib.ckpt_codec_lane.argtypes = []
    lib.ckpt_codec_lane.restype = _I
    if lib.ckpt_codec_lane() != LANE:
        raise RuntimeError("ckpt_codec library disagrees on the row width")
    _lib_handle = lib
    return built


def _lib() -> ctypes.CDLL:
    if _lib_handle is None:
        build()
    return _lib_handle


def _rows(n: int) -> int:
    return -(-n // LANE)


def _check(name, x, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _device_of(x: torch.Tensor) -> torch.device:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ckpt_codec runs on cpu or cuda tensors, "
                         f"got {x.device}")
    return x.device


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().ckpt_codec_error_string(rc).decode()
        raise RuntimeError(f"ckpt_codec {what} launch failed: CUDA error "
                           f"{rc} ({msg})")


def _quantize_flat(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel launch over a flat fp32 CUDA tensor of n elements."""
    device = flat.device
    _check("x", flat, torch.float32, device)
    n = flat.numel()
    r = _rows(n)
    q = torch.empty((r, LANE), dtype=torch.int8, device=device)
    s = torch.empty((r,), dtype=torch.float32, device=device)
    if r == 0:
        return q, s
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.ckpt_quantize_launch(
            flat.data_ptr(), n, q.data_ptr(), s.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "quantize")
    LAUNCHES["quantize"] += 1
    return q, s


def _dequantize_flat(q: torch.Tensor, s: torch.Tensor, n: int,
                     dtype) -> torch.Tensor:
    """Kernel launch writing the first n of ``q * scale`` in ``dtype``."""
    device = q.device
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ckpt_codec dequantizes to float32 or bfloat16, "
                        f"got {dtype}")
    _check("q", q, torch.int8, device)
    _check("scales", s, torch.float32, device)
    r = _rows(n)
    if q.shape != (r, LANE) or s.shape != (r,):
        raise ValueError(f"q {tuple(q.shape)} and scales {tuple(s.shape)} "
                         f"do not hold {n} elements")
    out = torch.empty((n,), dtype=dtype, device=device)
    if r == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.ckpt_dequantize_launch(
            q.data_ptr(), s.data_ptr(), n, out.data_ptr(),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(rc, "dequantize")
    LAUNCHES["dequantize"] += 1
    return out


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [R, 128] fp32 -> (int8 [R, 128], fp32 scales [R])."""
    if x.dim() != 2 or x.shape[1] != LANE:
        raise ValueError(f"x must be [R, {LANE}], got {tuple(x.shape)}")
    if _device_of(x).type == "cpu":
        return quantize_ref(x)
    return _quantize_flat(x.view(-1))


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    """int8 [R, 128] and fp32 scales [R] -> [R, 128] in ``out_dtype``."""
    if q.dim() != 2 or q.shape[1] != LANE:
        raise ValueError(f"q must be [R, {LANE}], got {tuple(q.shape)}")
    if _device_of(q).type == "cpu":
        return dequantize_ref(q, scales, out_dtype)
    return _dequantize_flat(q, scales, q.numel(), out_dtype).view(q.shape)


def quantize_array(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape floating tensor -> (int8 [R, 128], fp32 scales [R]),
    ``R = ceil(numel / 128)``, round-trippable by `dequantize_array`."""
    if _device_of(x).type == "cpu":
        return quantize_array_ref(x)
    return _quantize_flat(x.reshape(-1).to(torch.float32).contiguous())


def dequantize_array(q: torch.Tensor, s: torch.Tensor, *, shape,
                     dtype=torch.float32) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` that `quantize_array` coded."""
    shape = tuple(shape)
    if _device_of(q).type == "cpu":
        return dequantize_array_ref(q, s, shape, dtype)
    return _dequantize_flat(q, s, math.prod(shape), dtype).view(shape)


def roundtrip_error(x: torch.Tensor) -> float:
    """Max relative error of one quantize/dequantize round trip."""
    q, s = quantize_array(x)
    y = dequantize_array(q, s, shape=x.shape, dtype=x.dtype)
    denom = x.abs().max().to(torch.float32).clamp(min=1e-12)
    return float((y.to(torch.float32) - x.to(torch.float32)).abs().max()  # analysis: ignore[host-read] -- a measurement's result
                 / denom)
