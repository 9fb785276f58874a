"""The port's AdamW (`repro_torch.optim.adamw`) and PRNG key
(`repro_torch.train.state`) against the reference's: ``update``,
``clip_by_global_norm``, ``global_norm`` and ``cosine_schedule`` on the
same seeded trees to 1e-6 relative, and ``PRNGKey`` / ``fold_in`` bit for
bit with ``jax.random``."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.state import AdamWState, fold_in, prng_key  # noqa: E402

SHAPES = {"blocks": {"w": (3, 8, 16), "norm": (3, 8)}, "embed": (32, 8),
          "norm_f": (8,)}
REL = 1e-6


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (_tree(seed + 1 + i, scale, v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for i, (k, v) in enumerate(sorted(shapes.items()))}


def _torch(tree):
    return {k: (_torch(v) if isinstance(v, dict) else torch.tensor(v))
            for k, v in tree.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("step,lr", [(0, 1e-3), (1, 3e-4), (41, 1e-2)])
def test_update_matches_reference(step, lr):
    p, g = _tree(0), _tree(10, 0.1)
    m, v = _tree(20, 1e-3), _tree(30, 1e-3)
    v = jax.tree.map(np.abs, v)
    jstate = jadamw.AdamWState(step=jnp.int32(step), m=m, v=v)
    jp, js = jadamw.update(p, g, jstate, lr=jnp.float32(lr))
    tp = _torch(p)
    tstate = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                        m=_torch(m), v=_torch(v))
    tp2, ts = adamw.update(tp, _torch(g), tstate,
                           lr=torch.tensor(lr, dtype=torch.float32))
    assert tp2 is tp                       # in place
    assert int(ts.step) == int(js.step) == step + 1
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for a, b in zip(_leaves(want), _leaves(jax.tree.map(
                np.asarray, jax.tree.map(lambda t: t.numpy(), got)))):
            _close(b, a)


def test_init_is_zero_moments_and_step():
    p = _torch(_tree(1))
    st = adamw.init(p)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for t in jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), st.m)):
        assert t.dtype == np.float32 and not t.any()
    assert st.m["embed"] is not st.v["embed"]


@pytest.mark.parametrize("scale,max_norm", [(0.1, 1.0), (10.0, 1.0),
                                            (1.0, 0.5)])
def test_global_norm_and_clip_match_reference(scale, max_norm):
    g = _tree(3, scale)
    jg, jn = jadamw.clip_by_global_norm(g, max_norm)
    _close(float(adamw.global_norm(_torch(g))), float(jadamw.global_norm(g)))
    tg, tn = adamw.clip_by_global_norm(_torch(g), max_norm)
    _close(float(tn), float(jn))
    for a, b in zip(_leaves(jg), _leaves(jax.tree.map(
            lambda t: t.numpy(), tg))):
        _close(b, a)


@pytest.mark.parametrize("base,warmup,total", [(3e-4, 100, 10_000),
                                               (1e-3, 10, 1000),
                                               (1e-2, 0, 50)])
def test_cosine_schedule_matches_reference(base, warmup, total):
    jfn = jadamw.cosine_schedule(base, warmup, total)
    tfn = adamw.cosine_schedule(base, warmup, total)
    for step in (0, 1, 5, warmup, warmup + 1, total // 2, total, total + 7):
        _close(float(tfn(torch.tensor(step, dtype=torch.int32))),
               float(jfn(jnp.int32(step))))


@pytest.mark.parametrize("seed", [0, 1, 5, 1234, 2**31 - 1])
def test_prng_key_and_fold_in_bit_identical(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng_key(seed)
    assert tk.dtype == torch.uint32 and tk.shape == (2,)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for data in (0, 1, 2, 7, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            fold_in(tk, data).numpy(), np.asarray(jax.random.fold_in(jk, data)))


def test_fold_in_bit_identical_over_random_keys_and_chains():
    rng = np.random.default_rng(0)
    for _ in range(64):
        key = rng.integers(0, 2**32, 2, dtype=np.uint32)
        data = int(rng.integers(0, 2**32))
        want = np.asarray(jax.random.fold_in(jnp.asarray(key), data))
        got = fold_in(torch.from_numpy(key.astype(np.int64)).to(torch.uint32),
                      data)
        np.testing.assert_array_equal(got.numpy(), want)
    # the train step's chain: fold_in(rng, 1) once per step
    jk, tk = jax.random.PRNGKey(3), prng_key(3)
    for _ in range(20):
        jk, tk = jax.random.fold_in(jk, 1), fold_in(tk, 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
