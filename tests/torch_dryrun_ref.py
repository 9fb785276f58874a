"""The reference's side of ``tests/test_torch_dryrun.py``, run in a
subprocess: ``repro.launch.dryrun`` forces 512 host devices when it is
imported, so the test process must never import it.

``python tests/torch_dryrun_ref.py CELLS_JSON`` takes a list of cells,
each ``{"arch", "shape", "mesh": "1" | "2x4" | "4x2", "cfg": {config
fields}}`` (``mla``, ``ssm``, ``xlstm`` and ``audio`` as dicts of their
fields), builds each one's costing step (``build_cell(...,
costing=True)``) on one device or on a (2, 4) or (4, 2) mesh of 8 of the
devices, compiles it, and prints
one JSON object: per cell the compiled HLO's ``dot`` FLOPs per device,
``memory_analysis()``'s argument bytes, the collective bytes by kind and
the ``while`` loops of the HLO; and the dry run's tuning table, layer
units and applicability rule.
"""
import json
import re
import sys

import repro.launch.dryrun as dr  # noqa: I001  (sets XLA_FLAGS first)
import jax
import numpy as np

from repro.configs import SHAPES_BY_NAME, cell_is_applicable, get_config
from repro.configs.base import AudioConfig, MLAConfig, SSMConfig, XLSTMConfig
from repro.roofline.analysis import collective_bytes

_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([0-9,]*)\]")
_DOT = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*\w+\[([0-9,]*)\][^=]*?\sdot\("
    r"([^)]*)\)(.*)$")


def _dims(text):
    return [int(d) for d in text.split(",")] if text else []


def dot_flops(hlo: str) -> float:
    """2 * |out| * |contracted| over every ``dot`` of the module.  The
    compiled text names a dot's operands without their shapes, so the lhs
    operand's shape is looked up where it is defined; the contracted dims
    are ``lhs_contracting_dims``, with or without ``lhs_batch_dims``."""
    shapes = {}
    for line in hlo.splitlines():
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = _dims(m.group(2))
    total = 0.0
    for line in hlo.splitlines():
        m = _DOT.match(line)
        if not m:
            continue
        lhs = m.group(2).split(",")[0].split()[-1].lstrip("%")
        contracting = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}",
                                m.group(3))
        k = 1
        for i in _dims(contracting.group(1)):
            k *= shapes[lhs][i]
        total += 2.0 * float(np.prod(_dims(m.group(1)), dtype=np.float64)) * k
    return total


def cost_cell(arch, shape, mesh_name, cfg):
    shape_2d = ((1, 1) if mesh_name == "1"
                else tuple(map(int, mesh_name.split("x"))))
    mesh = jax.make_mesh(shape_2d, ("data", "model"),
                         devices=jax.devices()[:int(np.prod(shape_2d))],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    nested = {"mla": MLAConfig, "ssm": SSMConfig, "xlstm": XLSTMConfig,
              "audio": AudioConfig}
    cfg = {k: nested[k](**v) if k in nested else v for k, v in cfg.items()}
    lowered, _, _, _ = dr.build_cell(arch, shape, mesh, {"cfg": cfg},
                                     costing=True)
    compiled = lowered.compile()
    text = compiled.as_text()
    return {"dot_flops": dot_flops(text),
            "argument_bytes": int(
                compiled.memory_analysis().argument_size_in_bytes),
            "coll": collective_bytes(text),
            "whiles": len(re.findall(r"\swhile\(", text))}


def main():
    cells = json.loads(sys.argv[1])
    print(json.dumps({
        "cells": [cost_cell(c["arch"], c["shape"], c["mesh"], c["cfg"])
                  for c in cells],
        "shape_tuning": dr.SHAPE_TUNING,
        "layer_unit": {a: dr._layer_unit(get_config(a)) for a in dr.ARCH_IDS},
        "applicable": {f"{a}/{s}": list(cell_is_applicable(
            get_config(a), SHAPES_BY_NAME[s]))
            for a in dr.ARCH_IDS for s in SHAPES_BY_NAME},
    }))


if __name__ == "__main__":
    main()
