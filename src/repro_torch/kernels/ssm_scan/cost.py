"""What one selective-scan launch must compute and move, and the least
time the card could take for it: the bound of `PERF.md`'s kernel table,
`chip_smoke.py`'s ``[ssm-time]`` and the dry run's kernel count."""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32, SFU_OPS_PER_S


def cost(b: int, s: int, di: int, ds: int) -> dict:
    """Bytes (every input read once, y and h written once), fp32 operations
    and exps of one scan, and the least time for them: the larger of the
    byte time, the fp32 operation time and the exp time."""
    steps = b * s * di * ds
    nbytes = 4 * (3 * b * s * di + 2 * b * s * ds + di * ds + 2 * b * di * ds)
    flop = 6 * steps + b * s * di       # dl*a, decay*h, dx*B, add, y fma
    times = {"bytes": nbytes / HBM_BW,
             "operations": max(flop / PEAK_FLOPS_FP32,
                               steps / SFU_OPS_PER_S)}
    by = max(times, key=times.get)
    return dict(bytes=nbytes, flop=flop, exps=steps,
                bound_ms=1e3 * times[by], bound_by=by)
