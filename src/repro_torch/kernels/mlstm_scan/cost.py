"""What one chunkwise mLSTM call must compute and move, and the least time
the card could take for it: the bound of `PERF.md`'s kernel table,
`chip_smoke.py`'s ``[mlstm-time]`` and the dry run's kernel count."""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32, PEAK_FLOPS_TF32


def cost(bh: int, s: int, dh: int, chunk: int, carried: bool = False
         ) -> dict:
    """FLOP the function needs (Q K^T and W V over the causal pairs of each
    chunk, Q C0^T from the second chunk on, or from the first when a state
    is carried in, the carry V^T K and k^T wc), bytes (q, k, v, lf, li and
    a carried state read once; h, C, n, m written once), the least time
    (fp32 operations at the CUDA cores' rate against bytes), and the
    design's floor: 3xTF32 makes three tensor-core products of each, at
    the TF32 rate."""
    flop = 0
    for i, c0 in enumerate(range(0, s, chunk)):
        n = min(chunk, s - c0)
        pairs = n * (n + 1) // 2
        flop += 2 * 2 * pairs * dh + 2 * n * dh * dh + 2 * n * dh
        if i or carried:
            flop += 2 * n * dh * dh
    flop *= bh
    state_bytes = 4 * bh * (dh * dh + dh + 1)
    nbytes = (4 * (4 * bh * s * dh + 2 * bh * s) + state_bytes
              + (state_bytes if carried else 0))
    times = {"operations": flop / PEAK_FLOPS_FP32,
             "bytes": nbytes / HBM_BW}
    by = max(times, key=times.get)
    return dict(flop=flop, bytes=nbytes, bound_ms=1e3 * times[by],
                bound_by=by,
                floor_ms=1e3 * max(3 * flop / PEAK_FLOPS_TF32,
                                   times["bytes"]))
