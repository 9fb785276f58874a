"""Seeded cost-grid violations over torch columns: floats / true division
reaching the /256 integer cost grid (exact lines asserted by the test)."""
import torch


def build(jobs, JobTable):
    cost_save_lat = jobs.mib / 256             # line 7: true division
    return JobTable(
        cost_save_lat=cost_save_lat,
        overhead=jobs.mib * 1.5,               # line 10: float literal
        state_mib=jobs.mib.to(torch.float32),  # line 11: float dtype
    )


def save_cost(mib, rate):
    return float(mib) / rate                   # line 16: float() in grid fn


def fine(jobs, JobTable):
    return JobTable(
        cost_save_lat=(jobs.mib + 255) // 256,   # integer ceil-div: clean
        overhead=jobs.mib // 256,
    )
