"""Negative fixture: correct idioms only — the analyzer must report ZERO
violations for this file."""
import threading

import torch


def branchless(tbl, t: int):
    need = torch.clamp(tbl.cpus - 4, min=0)
    admit = (need > 0) & (tbl.submit <= t)
    tbl.state.masked_fill_(admit, 2)
    return tbl


def static_shapes(tbl, cfg):
    # shape and dtype reads are host metadata; cfg is host data
    if cfg.cpu_total > 8 and tbl.cpus.shape[0] > 0:
        return torch.zeros((tbl.cpus.numel(),), dtype=tbl.cpus.dtype,
                           device=tbl.cpus.device)
    return tbl.cpus


def integer_grid(jobs, JobTable):
    return JobTable(cost_save_lat=(jobs.mib + 255) // 256)


class GuardedCounter:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1

    def read(self):
        with self._lock:
            return self.count
