"""Device time of a kernel's calls on the card, apart from the host.

``queued_ms`` queues the calls behind a sleep kernel, so that the CUDA
events around them time the card running them back to back and not the
host enqueuing them: a one-step scan takes less time on the card than its
wrapper takes on the host.  ``chip_smoke.py`` and the kernels' probes
time with it.
"""
from __future__ import annotations

import torch

#: cycles of the sleep kernel ahead of the timed calls (~25 ms at the
#: H100's clocks), longer than the host takes to queue them
SLEEP_CYCLES = 50_000_000


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """The card's ms per call of ``fn`` (which launches on the current
    stream); raises if the sleep ended before the host had queued every
    call, which would time the host again."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    starved = start.query()
    torch.cuda.synchronize()
    if starved:
        raise RuntimeError("queued_ms: the card ran dry before the calls "
                           "were queued; time fewer")
    return start.elapsed_time(end) / iters
