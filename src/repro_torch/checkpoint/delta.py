"""Delta checkpoints: XOR-vs-parent + zstd — recurrent C/R made cheap.

The paper's thrashing cost is dominated by writing the full job image on
every preemption.  Between two checkpoints of the *same* job, most bytes of
the optimizer state barely move: XOR of the raw bit patterns against the
parent snapshot is highly compressible (exponent/sign bytes mostly zero).
We store per leaf whichever is smaller: zstd(xor-delta) or zstd(raw), and
rebuild by XOR-ing back onto the parent chain.

A copy of the reference's ``checkpoint/delta.py`` (numpy only), with the
same zstd-or-zlib choice, so that both packages encode the same blobs.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None       # stdlib zlib below keeps deltas functional


@dataclass
class DeltaBlob:
    data: bytes
    is_delta: bool
    nbytes_raw: int


def _compress(buf: bytes, level: int) -> bytes:
    if zstd is None:
        # zstd unavailable: zlib is slower but the XOR-delta compressibility
        # argument (mostly-zero exponent/sign bytes) holds identically
        return zlib.compress(buf, min(max(level, 1), 9))
    return zstd.ZstdCompressor(level=level).compress(buf)


def _decompress(buf: bytes, nbytes: int) -> bytes:
    if zstd is None:
        return zlib.decompress(buf)
    return zstd.ZstdDecompressor().decompress(buf, max_output_size=nbytes)


def encode_leaf(
    new: np.ndarray, base: Optional[np.ndarray], *, level: int = 3
) -> DeltaBlob:
    raw = new.tobytes()
    raw_c = _compress(raw, level)
    if base is None or base.nbytes != new.nbytes:
        return DeltaBlob(raw_c, False, len(raw))
    x = np.bitwise_xor(
        np.frombuffer(raw, np.uint8),
        np.frombuffer(base.tobytes(), np.uint8),
    ).tobytes()
    x_c = _compress(x, level)
    if len(x_c) < len(raw_c):
        return DeltaBlob(x_c, True, len(raw))
    return DeltaBlob(raw_c, False, len(raw))


def decode_leaf(
    blob: DeltaBlob, base: Optional[np.ndarray], dtype, shape
) -> np.ndarray:
    raw = _decompress(blob.data, blob.nbytes_raw)
    if blob.is_delta:
        assert base is not None
        raw = np.bitwise_xor(
            np.frombuffer(raw, np.uint8),
            np.frombuffer(base.tobytes(), np.uint8),
        ).tobytes()
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def encode_snapshot(
    new_leaves: Dict[str, np.ndarray],
    base_leaves: Optional[Dict[str, np.ndarray]],
    *,
    level: int = 3,
) -> Tuple[Dict[str, DeltaBlob], Dict[str, int]]:
    blobs, sizes = {}, {}
    for k, arr in new_leaves.items():
        base = base_leaves.get(k) if base_leaves else None
        blob = encode_leaf(arr, base, level=level)
        blobs[k] = blob
        sizes[k] = len(blob.data)
    return blobs, sizes


def decode_snapshot(
    blobs: Dict[str, DeltaBlob],
    base_leaves: Optional[Dict[str, np.ndarray]],
    meta: Dict[str, Tuple[str, tuple]],
) -> Dict[str, np.ndarray]:
    out = {}
    for k, blob in blobs.items():
        dtype, shape = meta[k]
        base = base_leaves.get(k) if base_leaves else None
        out[k] = decode_leaf(blob, base, dtype, shape)
    return out
