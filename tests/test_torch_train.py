"""The port's training stack against the JAX reference on the CPU:
``chunked_attention`` (forward and gradients, causal, window, meta
tokens), ``chunked_ce_loss`` (ignored labels, a ragged last chunk),
``Model.loss``, one train step from JAX's init carried across by
`convert.load_reference_train_state`, two steps with ``grad_accum=2``,
and the state's integer leaves after several steps, bit for bit.

The bars of a train step: AdamW's first step moves each element by about
``lr * sign(g)``, so where a gradient is near zero the two frameworks may
round to opposite signs.  On elements with ``|g| >= G * max|g|`` of their
leaf the parameters after the step agree within ``1e-6 + 1e-3 * lr``
(tight); elsewhere within ``1e-6 + 2 * lr`` per step (loose: a flipped
sign moves an element by up to ``2 * lr``, and the subtraction from the
parameter rounds once more).  ``G`` is the
gradient bar of the compute dtype (`GRAD_TOL`): 1e-3 in fp32, where the
gradients agree to 1e-4 of their largest; 3e-2 in bf16, where the two
frameworks round the activations at different points and the gradients
agree only to 2.6e-2 of their largest (opposite signs were seen at up to
5.4e-3 of it), the bar that ``chunked_attention`` meets in bf16."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.pipeline import shard_batch as jshard  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.models.model import chunked_ce_loss as jce  # noqa: E402
from repro.train.state import init_train_state as jinit  # noqa: E402
from repro.train.steps import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.steps import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.convert import load_reference_train_state  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model, chunked_ce_loss  # noqa: E402
from repro_torch.train.state import init_train_state, train_state_shapes  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    TrainConfig,
    deterministic,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

ARCH = "internlm2-1.8b"
SEQ, BATCH, CHUNK = 32, 4, 16
LR = 1e-3
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# loss and grad-norm bars of one step, relative
STEP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 1e-2)}
# gradients' bar relative to the leaf's largest; the tight set of a step
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the smoke model's
    ops are small, and under a loaded parallel test run a pool of threads
    spends far more time waiting for each other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bar(got, want, tol):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, tol)


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

# B, Sq, H, KVH, D, causal, window, n_meta, q_chunk, kv_chunk
ATTN_CASES = [
    (2, 32, 4, 2, 16, True, 0, 0, 16, 16),
    (1, 40, 4, 4, 8, True, 0, 0, 16, 8),       # ragged: padded chunks
    (2, 48, 6, 2, 16, True, 12, 0, 16, 16),    # sliding window
    (1, 37, 4, 2, 16, True, 8, 5, 8, 16),      # window + meta tokens
    (2, 24, 4, 2, 8, False, 0, 0, 8, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_chunked_attention_forward_and_grads_match_jax(case, dtype):
    b, s, h, kvh, d, causal, window, n_meta, qc, kc = case
    q, k, v = (_rand((b, s, n, d), i) for i, n in enumerate((h, kvh, kvh)))
    ct = _rand((b, s, h, d), 9)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(causal=causal, window=window, n_meta=n_meta, q_chunk=qc,
              kv_chunk=kc)
    jd = jnp.dtype(dtype)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, jnp.asarray(pos),
                                      jnp.asarray(pos), **kw)
        return (out.astype(jnp.float32) * ct).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(x).to(td).requires_grad_() for x in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    tout = tattn.chunked_attention(tq, tk, tv, tpos, tpos, **kw)
    assert tout.dtype == td and tout.shape == (b, s, h, d)
    (tout.float() * torch.from_numpy(ct)).sum().backward()
    _bar(tout, jout, ATTN_TOL[dtype])
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert got.dtype == td
        _bar(got, want, ATTN_TOL[dtype])


def test_chunked_attention_rounds_p_to_v_dtype():
    """bf16: P is cast to V's dtype before P·V, as the reference does.  The
    same values of V held in fp32 keep P in fp32 (the port without the
    cast); that product must land measurably farther from JAX's than the
    port's own, so that a port which kept P in fp32 fails here."""
    b, s, h, kvh, d = 1, 64, 2, 1, 16
    q, k, v = (_rand((b, s, n, d), 20 + i) for i, n in enumerate((h, kvh,
                                                                  kvh)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = _np(jattn.chunked_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(pos), q_chunk=32, kv_chunk=32))
    tpos = torch.from_numpy(pos.copy())
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = tattn.chunked_attention(tq, tk, tv, tpos, tpos, q_chunk=32,
                                  kv_chunk=32)
    p_fp32 = tattn.chunked_attention(tq, tk, tv.float(), tpos, tpos,
                                     q_chunk=32, kv_chunk=32)
    assert got.dtype == p_fp32.dtype == torch.bfloat16
    err = np.abs(_np(got) - want).max()
    gap = np.abs(_np(p_fp32) - want).max()
    assert gap > 0 and err <= 0.25 * gap, (err, gap)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,chunk", [(40, 16), (32, 32), (7, 512)])
def test_chunked_ce_loss_matches_jax(t, chunk):
    b, d, vocab = 3, 16, 50
    h, w = _rand((b, t, d), 1), _rand((d, vocab), 2, 0.3)
    labels = np.random.default_rng(3).integers(0, vocab, (b, t)).astype(
        np.int32)
    labels[0, :5] = -1
    labels[2, -3:] = -1

    def jloss(h, w):
        s, c = jce(h, w, jnp.asarray(labels), chunk=chunk)
        return s / c, (s, c)

    (_, (js, jc)), (jgh, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ts, tc = chunked_ce_loss(th, tw, torch.from_numpy(labels), chunk=chunk)
    (ts / tc).backward()
    assert float(tc) == float(jc) == float((labels >= 0).sum())
    np.testing.assert_allclose(float(ts.detach()), float(js), rtol=1e-5)
    _bar(th.grad, jgh, 1e-5)
    _bar(tw.grad, jgw, 1e-5)


# ---------------------------------------------------------------------------
# the model's loss and the train step, from JAX's init
# ---------------------------------------------------------------------------


def _pair(compute_dtype, seed=0, tcfg=None):
    """JAX model, state and jitted step; the port's over the same init."""
    tcfg = tcfg or dict(lr=LR, warmup_steps=0, total_steps=100)
    jcfg = jsmoke(ARCH).replace(compute_dtype=compute_dtype)
    jm = build_model(jcfg, q_chunk=CHUNK, kv_chunk=CHUNK)
    js = jinit(jm.init(jax.random.PRNGKey(seed)), seed)
    tm = Model(get_smoke_config(ARCH).replace(compute_dtype=compute_dtype),
               device="cpu", q_chunk=CHUNK, kv_chunk=CHUNK)
    ts = load_reference_train_state(tm, js)
    jstep = jax.jit(jmake_step(jm, JTrainConfig(**tcfg)))
    tstep = make_train_step(tm, TrainConfig(**tcfg))
    data = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH, seed=seed))
    return jm, js, jstep, tm, ts, tstep, data


def _assert_step_bars(jparams, tparams, jgrads, lr, grad_tol, steps=1):
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        key = jax.tree_util.keystr(path)
        got, want = _np(_leaf(tparams, path)), _np(want)
        g = np.abs(_np(_leaf(jgrads, path)))
        tight = g >= grad_tol * g.max()
        err = np.abs(got - want)
        assert err[tight].max(initial=0) <= 1e-6 + 1e-3 * lr, key
        assert err.max() <= 1e-6 + 2 * lr * steps, key


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_one_train_step_match_jax(dtype):
    jm, js, jstep, tm, ts, tstep, data = _pair(dtype)
    batch = data.batch_at(0)
    (jl, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        js.params, jshard(batch))
    tl, tmet = tm.loss(shard_batch(batch, "cpu"))
    loss_tol, gnorm_tol = STEP_TOL[dtype]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=loss_tol)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == SEQ * BATCH
    paths, leaves = zip(*_named(tm.params()))
    grads = torch.autograd.grad(tl, leaves)
    for k, g in zip(paths, grads):
        _bar(g, _leaf(jgrads, [jax.tree_util.DictKey(x)
                               for x in k.split(".")]),
             1e-4 if dtype == "float32" else GRAD_TOL[dtype])
    js2, jmt = jstep(js, jshard(batch))
    ts2, tmt = tstep(ts, shard_batch(batch, "cpu"))
    assert ts2.params is ts.params           # updated in place
    assert tm.embed is ts2.params["embed"]   # the model's own tensors
    np.testing.assert_allclose(float(tmt["loss"]), float(jmt["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(tmt["grad_norm"]),
                               float(jmt["grad_norm"]), rtol=gnorm_tol)
    assert float(tmt["lr"]) == pytest.approx(float(jmt["lr"]), rel=1e-6)
    assert float(tmt["step"]) == float(jmt["step"]) == 1.0
    assert set(tmt) == set(jmt)
    _assert_step_bars(js2.params, ts2.params, jgrads, LR, GRAD_TOL[dtype])


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def test_two_steps_with_grad_accum_match_jax():
    tcfg = dict(lr=LR, warmup_steps=0, total_steps=100, grad_accum=2)
    jm, js, jstep, tm, ts, tstep, data = _pair("float32", seed=1, tcfg=tcfg)
    _, jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        js.params, jshard(data.batch_at(0)))
    for i in range(2):
        batch = data.batch_at(i)
        js, jmt = jstep(js, jshard(batch))
        ts, tmt = tstep(ts, shard_batch(batch, "cpu"))
        assert set(tmt) == set(jmt)
        for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tmt[k]), float(jmt[k]),
                                       rtol=1e-4, atol=1e-7)
    _assert_step_bars(js.params, ts.params, jgrads, LR, GRAD_TOL["float32"],
                      steps=2)


def test_state_integers_bit_for_bit_after_steps():
    jm, js, jstep, tm, ts, tstep, data = _pair("float32", seed=2)
    for i in range(3):
        batch = data.batch_at(int(ts.data_cursor))
        js, _ = jstep(js, jshard(data.batch_at(int(js.data_cursor))))
        ts, _ = tstep(ts, shard_batch(batch, "cpu"))
    np.testing.assert_array_equal(ts.rng.numpy(), np.asarray(js.rng))
    assert ts.rng.dtype == torch.uint32
    assert ts.opt.step.dtype == ts.data_cursor.dtype == torch.int32
    assert int(ts.opt.step) == int(js.opt.step) == 3
    assert int(ts.data_cursor) == int(js.data_cursor) == 3
    assert ts.data_cursor.device.type == "cpu"


def test_load_reference_train_state_checks_paths_shapes_dtypes():
    jm = build_model(jsmoke(ARCH))
    js = jinit(jm.init(jax.random.PRNGKey(0)), 0)
    tm = Model(get_smoke_config(ARCH), device="cpu")
    st = load_reference_train_state(tm, js)
    np.testing.assert_array_equal(st.opt.m["embed"].numpy(),
                                  np.asarray(js.opt.m["embed"]))
    assert st.params["embed"] is tm.embed
    m = dict(js.opt.m)
    with pytest.raises(KeyError, match="opt.m paths differ"):
        load_reference_train_state(tm, js._replace(opt=js.opt._replace(
            m={k: v for k, v in m.items() if k != "norm_f"})))
    with pytest.raises(ValueError, match="shape"):
        load_reference_train_state(tm, js._replace(opt=js.opt._replace(
            v=dict(m, norm_f=m["embed"]))))
    with pytest.raises(TypeError, match="dtype"):
        load_reference_train_state(tm, js._replace(
            rng=js.rng.astype(jnp.int32)))
    with pytest.raises(TypeError, match="dtype"):
        load_reference_train_state(tm, js._replace(opt=js.opt._replace(
            step=js.opt.step.astype(jnp.float32))))


def test_port_init_state_and_shapes():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    st = init_train_state(model.params(), seed=4)
    np.testing.assert_array_equal(st.rng.numpy(),
                                  np.asarray(jax.random.PRNGKey(4)))
    shapes = train_state_shapes(model)
    js = jax.eval_shape(lambda: jinit(build_model(jsmoke(ARCH)).init(
        jax.random.PRNGKey(0))))
    from repro_torch.checkpoint.serialize import leaf_paths
    ours = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in leaf_paths(shapes)}
    theirs = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
              for p, v in jax.tree_util.tree_leaves_with_path(js)}
    assert ours == theirs
    assert all(v.device.type == "meta" for _, v in leaf_paths(shapes))
    # the serving steps are the model's own
    tokens = torch.zeros(2, 5, dtype=torch.int32)
    cache, logits = make_prefill_step(model)({"tokens": tokens},
                                             model.init_cache(2, 8))
    _, want = model.prefill({"tokens": tokens}, model.init_cache(2, 8))
    assert torch.equal(logits, want)
    _, step_logits = make_decode_step(model)(cache, tokens[:, :1])
    assert step_logits.shape == (2, 1, cfg.vocab)
    # the hybrid and MLA families train too
    # (tests/test_torch_train_families.py, test_torch_mla_vlm_audio.py)
    for arch in ("hymba-1.5b", "minicpm3-4b"):
        other = Model(get_smoke_config(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        loss, _ = other.loss({
            "tokens": torch.zeros(1, 4, dtype=torch.int32),
            "labels": torch.zeros(1, 4, dtype=torch.int32)})
        assert torch.isfinite(loss)


def test_deterministic_step_on_cuda_needs_cublas_workspace_config(
        monkeypatch):
    """On CUDA the step's deterministic block raises, naming the fix,
    when ``CUBLAS_WORKSPACE_CONFIG`` is missing, and does not set it; on
    the CPU it needs nothing.  The check comes before any CUDA work."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with deterministic(torch.device("cuda")):
            pass
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    was = torch.are_deterministic_algorithms_enabled()
    with deterministic(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == was
