"""The port's side of ``tests/test_torch_dryrun.py``, run in a subprocess
so that the test process initialises no process group.

``python tests/torch_dryrun_port.py CELLS_JSON OUT_DIR`` counts each cell
(``{"arch", "shape", "mesh": "1" | "2x4" | "4x2", "cfg": {config
fields}}``, ``mla``, ``ssm``, ``xlstm`` and ``audio`` as dicts of their
fields) as `repro_torch.launch.dryrun` costs it (``build_cell(...,
costing=True)``, on one device or on a (2, 4) or (4, 2) mesh of a fake
world of 8 ranks), and
prints one JSON object: per cell the matmul FLOPs, the argument bytes and
the collective bytes by kind (weighted as the roofline weighs them); and
the record that ``run_cell`` writes to ``OUT_DIR`` for the first cell
(on the (16, 16) production mesh).
"""
import json
import sys
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs.base import (
    AudioConfig,
    MLAConfig,
    SSMConfig,
    XLSTMConfig,
)
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis


def config_fields(fields: dict) -> dict:
    """A cell's config fields, its nested ``mla``, ``ssm``, ``xlstm`` and
    ``audio`` dicts made the configs' dataclasses."""
    nested = {"mla": MLAConfig, "ssm": SSMConfig, "xlstm": XLSTMConfig,
              "audio": AudioConfig}
    return {k: nested[k](**v) if k in nested else v
            for k, v in fields.items()}


def main():
    cells, out_dir = json.loads(sys.argv[1]), Path(sys.argv[2])
    got = []
    for c in cells:
        mesh = (None if c["mesh"] == "1" else dryrun.fake_mesh(
            tuple(map(int, c["mesh"].split("x"))), ("data", "model")))
        costs = dryrun.count_cell(dryrun.build_cell(
            c["arch"], c["shape"], mesh, {"cfg": config_fields(c["cfg"])}, costing=True))
        got.append({"matmul_flops": costs.matmul_flops,
                    "kernel_flops": costs.kernel_flops,
                    "argument_bytes": costs.argument_bytes,
                    "coll": analysis.collective_bytes(costs.coll)})
    c = cells[0]
    record = dryrun.run_cell(c["arch"], c["shape"], False, out_dir,
                             {"cfg": config_fields(c["cfg"])}, tag="test")
    dist.destroy_process_group()
    print(json.dumps({"cells": got, "record": record}))


if __name__ == "__main__":
    main()
