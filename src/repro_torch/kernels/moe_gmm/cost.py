"""What one grouped expert matmul must compute and move, and the least
time the card could take for it: the bound of `PERF.md`'s kernel table,
`chip_smoke.py`'s ``[moe-time]`` and ``[ep-compare]`` and the dry run's
kernel count."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


def cost(x: torch.Tensor, w: torch.Tensor,
         counts: Optional[torch.Tensor] = None, *,
         pairs: Optional[int] = None) -> dict:
    """Bytes the product must move (the x rows below each count, the
    weights of each expert with a row, counts, and the whole output written
    once), its operations over those rows at the bf16 tensor-core rate
    (the weights are rounded to bf16), and the least time for them.

    The rows are the counts' sum and the experts with a row those whose
    count is above 0 (two reads of ``counts``); given ``pairs`` (the
    routed pairs the counts hold, where the counts cannot or should not be
    read: on meta tensors, or in a step on the card), the rows are
    ``pairs`` and every expert up to ``pairs`` of them has a row."""
    e, c, d = x.shape
    f = w.shape[2]
    if pairs is None:
        rows = int(counts.sum())
        active = int((counts > 0).sum())
    else:
        rows, active = int(pairs), min(e, int(pairs))
    nbytes = (rows * d * x.element_size() + active * d * f * w.element_size()
              + 4 * e + e * c * f * x.element_size())
    flop = 2 * rows * d * f
    times = {"operations": flop / PEAK_FLOPS_BF16,
             "bytes": nbytes / HBM_BW}
    by = max(times, key=times.get)
    return dict(rows=rows, active_experts=active, flop=flop, bytes=nbytes,
                bound_ms=1e3 * times[by], bound_by=by)
