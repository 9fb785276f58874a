"""The torch port stands alone: it imports neither jax nor anything of the
reference package ``repro``, at run time or in its source."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite imports both frameworks)
import torch  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "repro")


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    # packages and modules: core (6 modules), checkpoint (7), kernels
    # (_build; sched_select, ckpt_codec and flash_attention {ops,ref}),
    # launch (cluster_sim, cr_cost, serve, train), train (state, steps),
    # configs (base + 10 archs), models (layers, attention, transformer,
    # model), data (pipeline), optim (adamw), cluster (executor)
    assert len(names) >= 58, sorted(names)
    for mod in ("configs", "configs.base", "configs.internlm2_1_8b",
                "models.layers", "models.attention", "models.transformer",
                "models.model", "models.moe", "kernels.flash_attention.ops",
                "kernels.flash_attention.ref", "kernels.moe_gmm.ops",
                "kernels.moe_gmm.ref", "launch.serve", "launch.train",
                "data.pipeline", "optim.adamw", "train.state", "train.steps",
                "cluster.executor", "analysis.base",
                "analysis.dispatch_audit", "distributed.sharding",
                "distributed.collectives", "distributed.moe_ep",
                "launch.mesh", "optim.compression", "launch.dryrun",
                "roofline.analysis", "roofline.counting",
                "kernels.flash_attention.cost", "kernels.moe_gmm.cost",
                "kernels.ssm_scan.cost", "kernels.mlstm_scan.cost"):
        assert f"repro_torch.{mod}" in names, mod


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_imports_nothing_of_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"
