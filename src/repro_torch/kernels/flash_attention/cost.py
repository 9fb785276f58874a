"""What one flash-attention launch must compute and move, and the least
time the card could take for it: the bound of `PERF.md`'s kernel table,
`chip_smoke.py`'s ``[attn-time]`` and the dry run's kernel count."""
from __future__ import annotations

import numpy as np

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


def visible_pairs(sq: int, skv: int, *, causal: bool = True,
                  window: int = 0, n_meta: int = 0) -> int:
    """The (query, key) pairs of one head that the kernel's mask keeps
    (`ref.visible`'s count, without building the mask): row i sees the
    keys ``j <= i`` (causal) that lie within ``window`` of it or among
    the first ``n_meta``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                    np.int64)
    n = np.maximum(hi - lo + 1, 0)
    if window > 0 and n_meta > 0:
        n += np.maximum(np.minimum(np.minimum(lo, n_meta), hi + 1), 0)
    return int(n.sum())


def cost(b: int, s: int, h: int, kvh: int, d: int, dtype_bytes: int, *,
         skv=None, dv=None, causal: bool = True, window: int = 0,
         n_meta: int = 0) -> dict:
    """FLOP (QK^T, 2d, and PV, 2dv, over the visible pairs only) and bytes
    (q, k, v read once, out written once) of one launch (Sq = s, Skv =
    ``skv``, by default s), and the least time for them on the card."""
    skv, dv = skv or s, dv or d
    pairs = visible_pairs(s, skv, causal=causal, window=window,
                          n_meta=n_meta)
    flop = pairs * b * h * 2 * (d + dv)
    nbytes = dtype_bytes * b * (s * h * (d + dv) + skv * kvh * (d + dv))
    ops_ms, byte_ms = 1e3 * flop / PEAK_FLOPS_BF16, 1e3 * nbytes / HBM_BW
    return dict(pairs_per_head=pairs, flop=flop, bytes=nbytes,
                bound_ms=max(ops_ms, byte_ms),
                bound_by="operations" if ops_ms >= byte_ms else "bytes")
