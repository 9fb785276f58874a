"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`) at smoke widths on the CPU.

Both sides run in subprocesses: importing ``repro.launch.dryrun`` forces
512 JAX host devices for the rest of the process, and the port's dry run
initialises a fake process group; the test process gets neither.  The
cell is internlm2-1.8b at smoke widths (``tuning_override["cfg"]``) at
train_4k and decode_32k, costed on one device and on a (2, 4) mesh:

* the port's matmul FLOPs per device are within 5% of the reference's
  compiled-HLO ``dot`` FLOPs per device (``tests/torch_dryrun_ref.py``
  resolves each dot's operand shape where it is defined);
* its argument bytes equal ``memory_analysis().argument_size_in_bytes``,
  the scalar leaves included (step, rng, cursor: ``SCALAR_LEAVES``);
* on (2, 4) its per-device FLOPs are within 5% of its own one-device
  FLOPs over 8;
* ``SHAPE_TUNING``, ``_layer_unit``, ``cell_is_applicable`` and the
  record's keys are the reference's.

Two configs: ``SMOKE`` is the smoke config's widths, whose 2 KV heads do
not divide the 4-way model axis; ``HEADS`` gives it 4 KV heads.  At
``SMOKE`` on (2, 4) the port computes attention with every head on every
model rank (ROADMAP Queue 1, item 2: the reference splits head_dim), so
its FLOPs per device exceed the reference's; that gap is held here as
the measured defect, and the 5% bars hold at ``HEADS``.  Collective bytes
are no bar: XLA chooses reduce-scatter and all-to-all where the port
all-reduces and all-gathers (`PERF.md` has the two side by side).
"""
import ast
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.configs import SHAPES_BY_NAME  # noqa: E402
from repro.configs import cell_is_applicable as ref_applicable  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import cell_is_applicable, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
SMOKE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=128)
HEADS = dict(SMOKE, n_kv_heads=4)
CELLS = [dict(arch=ARCH, shape=shape, mesh=mesh, cfg=cfg, name=name)
         for name, cfg in (("smoke", SMOKE), ("heads", HEADS))
         for mesh in ("1", "2x4") for shape in ("train_4k", "decode_32k")]
#: the train state's scalar leaves, in both packages: step int32 [],
#: rng uint32 [2], data_cursor int32 []
SCALAR_LEAVES = {"step": 4, "rng": 8, "data_cursor": 4}


def _run(script: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "tests" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cells = json.dumps([{k: c[k] for k in ("arch", "shape", "mesh", "cfg")}
                        for c in CELLS])
    out = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run, "torch_dryrun_ref.py", cells)
        port = pool.submit(_run, "torch_dryrun_port.py", cells, str(out))
        return ref.result(), port.result()


def _pairs(both):
    ref, port = both
    return {(c["name"], c["mesh"], c["shape"]): (r, p) for c, r, p in
            zip(CELLS, ref["cells"], port["cells"])}


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_matmul_flops_per_device_match_reference_dots(both, shape, mesh):
    names = ("smoke", "heads") if mesh == "1" else ("heads",)
    for name in names:
        ref, port = _pairs(both)[name, mesh, shape]
        assert port["kernel_flops"] == 0   # neither step reaches a kernel
        rel = port["matmul_flops"] / ref["dot_flops"] - 1
        assert abs(rel) <= 0.05, (name, port["matmul_flops"],
                                  ref["dot_flops"])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_whole_heads_exceed_reference_where_kv_heads_do_not_divide(
        both, shape):
    """ROADMAP Queue 1, item 2, measured: with 2 KV heads on a 4-way model
    axis every model rank computes every head, where the reference splits
    head_dim, and a decode rank holds its rows' whole KV cache, where the
    reference holds a quarter of head_dim; the port's counts show both.
    When the port splits them as the reference does, this test moves to
    the bars of the others."""
    ref, port = _pairs(both)["smoke", "2x4", shape]
    assert port["matmul_flops"] > 1.05 * ref["dot_flops"]
    if shape == "decode_32k":
        spec = SHAPES_BY_NAME[shape]
        hd = SMOKE["d_model"] // SMOKE["n_heads"]
        kv = (2 * SMOKE["n_layers"] * spec.global_batch // 2 * spec.seq_len
              * SMOKE["n_kv_heads"] * hd * 2)          # k and v, bf16
        assert port["argument_bytes"] - ref["argument_bytes"] == kv * 3 // 4


@pytest.mark.parametrize("name,mesh,shape", [
    (c["name"], c["mesh"], c["shape"]) for c in CELLS
    # the whole-heads KV cache: held exactly by the test above
    if (c["name"], c["mesh"], c["shape"]) != ("smoke", "2x4", "decode_32k")])
def test_argument_bytes_equal_xla(both, name, mesh, shape):
    ref, port = _pairs(both)[name, mesh, shape]
    # the scalar leaves are arguments of the train step in both packages
    # (XLA keeps a replicated scalar whole on every device), so the
    # totals agree with them included
    assert port["argument_bytes"] == ref["argument_bytes"], (
        port["argument_bytes"] - ref["argument_bytes"], SCALAR_LEAVES)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_per_device_flops_split_over_the_mesh(both, shape):
    pairs = _pairs(both)
    one = pairs["heads", "1", shape][1]["matmul_flops"]
    eight = pairs["heads", "2x4", shape][1]["matmul_flops"]
    assert abs(eight / (one / 8) - 1) <= 0.05, (eight, one / 8)


def _reference_record_keys():
    """The keys of an applicable cell's costed record in the reference's
    ``run_cell``, read from its source (the test never imports it)."""
    tree = ast.parse((REPO / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
            if "arch" in names or "costing_extrapolated" in names:
                keys |= names
    return keys


def test_schema_is_the_reference(both):
    ref, port = both
    assert dryrun.SHAPE_TUNING == ref["shape_tuning"]
    for arch in dryrun.ARCH_IDS:
        assert dryrun._layer_unit(get_config(arch)) == ref["layer_unit"][arch]
        for s in SHAPES_BY_NAME:
            want = ref_applicable(ref_config(arch), SHAPES_BY_NAME[s])
            assert list(cell_is_applicable(get_config(arch),
                                           dryrun.SHAPES_BY_NAME[s])) == \
                ref["applicable"][f"{arch}/{s}"] == list(want)
    record = port["record"]
    assert record["status"] == "ok", record
    assert set(record) == _reference_record_keys()
    assert set(record["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_estimate_bytes"}
    rf = record["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rf[term] > 0
    assert record["n_devices"] == 256 and record["costing_extrapolated"]


def test_the_test_process_holds_no_dry_run_state(both):
    assert "repro.launch.dryrun" not in sys.modules
    assert not (torch.distributed.is_available()
                and torch.distributed.is_initialized())
