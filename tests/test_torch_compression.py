"""`repro_torch.optim.compression` against `repro.optim.compression`: the
dequantised gradients, the residuals and ``compress_ratio``, bit for bit
on fp32 inputs, leaves of fewer than 256 values included."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "big": (rng.standard_normal((3, 700)) * 10).astype(np.float32),
        "exact": rng.standard_normal((2, 256)).astype(np.float32),
        "small": rng.standard_normal((5, 7)).astype(np.float32),
        "nested": {"w": (rng.standard_normal(1000) * 1e-3).astype(np.float32),
                   "zeros": np.zeros(300, np.float32),
                   # halves of the scale: round half to even decides
                   "halves": (np.arange(512, dtype=np.float32) - 255.5)},
    }


def _to(tree, fn):
    return {k: (_to(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_tree_bit_for_bit_over_two_steps(seed):
    grads = _grads(seed)
    jg = _to(grads, jnp.asarray)
    tg = _to(grads, torch.from_numpy)
    jef = jcomp.init_ef(jg)
    tef = tcomp.init_ef(tg)
    for step in range(2):
        jout, jef, jstats = jcomp.compress_tree(jg, jef)
        tout, tef, tstats = tcomp.compress_tree(tg, tef)
        want, got = _flat(jout), _flat(_to(tout, lambda t: t.numpy()))
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == np.float32, k
            assert np.array_equal(got[k], want[k]), (step, k)
        wres = _flat(jef.residual)
        gres = _flat(_to(tef.residual, lambda t: t.numpy()))
        for k in wres:
            assert np.array_equal(gres[k], wres[k]), (step, k)
        assert tstats["compress_ratio"] == jstats["compress_ratio"]
    # a leaf under 256 values passes through with a zero residual
    assert np.array_equal(_flat(_to(tout, lambda t: t.numpy()))["small"],
                          grads["small"])
    assert 0.25 < tstats["compress_ratio"] < 0.4
