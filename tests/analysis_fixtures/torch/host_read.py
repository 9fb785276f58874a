"""Seeded host-read violations in scheduling contexts (functions with a
JobTable parameter, and a pass factory's closure); exact lines asserted by
tests/test_torch_analysis.py."""
import numpy as np
import torch


def reads(tbl, n: int):
    busy = tbl.cpus.sum()
    if busy > 4:                               # line 10: if on a tensor
        n += 1
    k = int(busy)                              # line 12: int()
    flag = bool(tbl.state.any())               # line 13: bool()
    first = tbl.jid[0].item()                  # line 14: .item()
    rows = tbl.state.tolist()                  # line 15: .tolist()
    host = tbl.cpus.cpu()                      # line 16: .cpu()
    arr = tbl.work.numpy()                     # line 17: .numpy()
    same = torch.equal(tbl.cpus, tbl.work)     # line 18: torch.equal
    while tbl.state.max() > 0:                 # line 19: while
        break
    ok = tbl.cpus.any() and n > 0              # line 21: and
    bad = not tbl.state.all()                  # line 22: not
    assert tbl.cpus.min() >= 0                 # line 23: assert
    some = any(tbl.state == 1)                 # line 24: any()
    return k, flag, first, rows, host, arr, same, ok, bad, some


def make_demo_pass(depth=None):
    def pass_fn(cfg, ent, t, table, stats, knobs):
        if ent.sum() > 0:                      # line 30: closure's ent
            return table
        return table

    return pass_fn


def fine(tbl, n: int):
    if tbl.cpus.dim() == 1:                    # a shape: no read
        n += tbl.cpus.shape[0] + tbl.cpus.numel()
    fast, evict = torch.stack([tbl.cpus, tbl.work]).tolist()  # analysis: ignore[host-read] -- fixture: a counted read
    if any(fast):                              # host data: no second read
        n += 1
    host = _to_host(tbl)                       # a function of host returns
    if host["cpus"].any():
        n += 1
    if tbl.cpus.device.type == "cpu" and bool(tbl.cpus.any()):
        n += 1                                 # a CPU tensor: no sync
    if tbl.state is None or "cpus" in host:    # identity / dict lookup
        n += 1
    return n + int(np.float32(2.0))


def _to_host(tbl):
    return {"cpus": np.asarray(tbl.cpus)}
