"""Train mode of the MoE, hybrid and xLSTM families against the JAX
reference on the CPU: each train route on its own (`moe_ffn_train`,
`ssm_forward_train`, `mlstm_forward_train`, `slstm_forward_train`, forward
and gradients, at a length that is not a multiple of the chunk), then
deepseek-moe-16b, dbrx-132b, hymba-1.5b and xlstm-350m at their smoke
sizes from JAX's init (`convert.load_reference_params` /
`load_reference_train_state`): ``Model.loss`` and its gradients, one train
step, and (but dbrx) two steps with ``grad_accum=2``; no kernel of the
port in a train step; every arch's loss, and `Model`'s refusal of a
family no config has; the executor's transparency
and event-log cases on an xLSTM job against the JAX executor; the
launcher on hymba.

Bars.  fp32: outputs and gradients within 1e-5 (modules) or 1e-4 (models)
of the compared tensor's largest magnitude, losses within 1e-5 relative,
a train step within ``tests/test_torch_train.py``'s bars.  bf16: the
reference's own bf16 run lands far from its fp32 run on these recurrent
and routed blocks (xlstm-350m's smoke gradients by up to 0.6 of their
largest, against the port's 0.16: XLA and torch round to bf16 at other
points and the mLSTM's normaliser amplifies it), so the port's bf16 result
is held to the reference's fp32 one: no farther than 1.25 times the
reference's bf16 result is, plus 1e-2 of the largest magnitude
(`_bf16_bar`); losses within 1e-3 relative of the reference's bf16 loss;
a bf16 step's parameters by `_assert_bf16_step_bars`.
"""
import copy

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import ManagerConfig as JConfig  # noqa: E402
from repro.cluster.executor import ClusterExecutor as JExecutor  # noqa: E402
from repro.cluster.executor import ManagedJob as JManagedJob  # noqa: E402
from repro.cluster.executor import small_train_job as jsmall  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.data.pipeline import shard_batch as jshard  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.train.state import init_train_state as jinit  # noqa: E402
from repro.train.steps import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.steps import make_train_step as jmake_step  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    CheckpointManager,
    ManagerConfig,
)
from repro_torch.cluster.executor import (  # noqa: E402
    ClusterExecutor,
    ManagedJob,
    small_train_job,
)
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.configs.base import FAMILIES as MODEL_FAMILIES  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    flat_paths,
    load_reference_train_state,
)
from repro_torch.core.types import JobState  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.model import Model, resolve_frontend  # noqa: E402
from repro_torch.train.steps import TrainConfig, make_train_step  # noqa: E402

FAMILIES = ["deepseek-moe-16b", "dbrx-132b", "hymba-1.5b", "xlstm-350m"]
SEQ, BATCH, CHUNK = 37, 4, 16
LR = 1e-3
# tests/test_torch_train.py's bars: loss and grad norm of a step, relative;
# the gradients' bar relative to the leaf's largest, the tight set of a step
STEP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 1e-2)}
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the smoke models'
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


def _bar(got, want, tol, floor=1.0):
    """Within ``tol`` of the larger of ``want``'s largest magnitude and
    ``floor``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), floor), (err, tol)


def _bf16_bar(got, want16, want32, what="", floor=1e-6):
    """The port's bf16 ``got`` is no farther from the reference's fp32
    ``want32`` than 1.25 times the reference's bf16 ``want16`` is, plus
    1e-2 of the larger of the largest magnitude and ``floor``."""
    got, want16, want32 = _np(got), _np(want16), _np(want32)
    ref_err = np.abs(want16 - want32).max()
    err = np.abs(got - want32).max()
    assert err <= 1.25 * ref_err + 1e-2 * max(np.abs(want32).max(), floor), (
        what, err, ref_err)


def _tensor(a, dtype):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dtype)


def _check_module(dtype, run_jax, run_port, inputs):
    """``run_jax(params, x)`` and ``run_port(params, x)`` return (out,
    side): the block's output and a second result (an fp32 scalar loss,
    which joins the differentiated sum, or the final state, which is
    compared).  ``sum(out * ct)`` (+ the scalar) is differentiated with
    respect to x and every parameter on both sides.  fp32 within 1e-5;
    bf16 by `_bf16_bar` against the fp32 reference.  A parameter whose
    gradient sums terms that cancel (the mLSTM's ``b_i``: largest 6e-4,
    from terms the size of ``w_i``'s gradient, up to 180) carries the
    terms' rounding, so each parameter's gradient is held against the
    larger of its own largest magnitude and a tenth of the largest of the
    block (measured against a float64 run: the reference's fp32 ``b_i``
    gradient is 6.5e-6 off, the port's 1.5e-5)."""
    params, x, ct = inputs

    def scalar(side):
        return side if side.ndim == 0 else 0.0

    def jrun(jdt):
        p = {k: (v if v.dtype == jnp.float32 else v.astype(jdt))
             for k, v in params.items()}

        def loss(p, x):
            out, side = run_jax(p, x)
            return (out.astype(jnp.float32) * ct).sum() + scalar(side), (
                out, side)
        (_, (out, side)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x, jdt))
        return out, side, grads

    jout32, jside32, (jgp32, jgx32) = jrun(jnp.float32)
    td = getattr(torch, dtype)
    tp = {k: (_tensor(v, torch.float32) if v.dtype == jnp.float32
              else _tensor(v, td)).requires_grad_()
          for k, v in params.items()}
    tx = _tensor(x, td).requires_grad_()
    tout, tside = run_port(tp, tx)
    ((tout.float() * torch.from_numpy(ct)).sum() + scalar(tside)).backward()
    assert tout.dtype == td and tout.shape == jout32.shape
    floor = 0.1 * max(np.abs(_np(g)).max() for g in jgp32.values())
    if dtype == "float32":
        for got, want in ((tout, jout32), (tside, jside32), (tx.grad, jgx32)):
            _bar(got, want, 1e-5)
        for k in params:
            _bar(tp[k].grad, jgp32[k], 1e-5, floor)
        return
    jout16, jside16, (jgp16, jgx16) = jrun(jnp.bfloat16)
    _bf16_bar(tout, jout16, jout32, "out")
    _bf16_bar(tside, jside16, jside32, "side")
    _bf16_bar(tx.grad, jgx16, jgx32, "x")
    for k in params:
        _bf16_bar(tp[k].grad, jgp16[k], jgp32[k], k, floor)


# ---------------------------------------------------------------------------
# each train route on its own
# ---------------------------------------------------------------------------


def _init(spec, seed):
    """Random params for a ``{name: (shape, init, dtype)}`` spec, flat
    (``"shared.w_up"``): N(0, 0.3) draws for the products' weights, the
    reference's own initialiser elsewhere."""
    out = {}
    for i, (k, leaf) in enumerate(sorted(spec.items())):
        if isinstance(leaf, dict):
            out.update({f"{k}.{n}": v for n, v in _init(leaf, seed + 50 * i
                                                        ).items()})
            continue
        shape, init, dt = leaf
        out[k] = init(jax.random.PRNGKey(seed + i), shape, jnp.float32)
        if k in ("router", "w_gate", "w_up", "w_down", "w_in", "w_out",
                 "w_xproj", "w_dt", "conv_w", "w_q", "w_k", "w_v",
                 "w_gates", "r_gates", "w_i", "w_f"):
            out[k] = jnp.asarray(_rand(shape, seed + i, 0.3))
        out[k] = out[k].astype(jnp.float32 if dt == jnp.float32
                               else jnp.bfloat16)
    return out


def nest(flat):
    """``{"a.b": v}`` -> ``{"a": {"b": v}}``."""
    out = {}
    for k, v in flat.items():
        head, _, rest = k.partition(".")
        if rest:
            out.setdefault(head, {})[rest] = v
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_train_matches_jax(dtype):
    moe = jsmoke("deepseek-moe-16b").moe
    d = 24
    params = _init(jmoe.moe_params_spec(d, moe, jnp.bfloat16), 3)
    x, ct = _rand((2, 13, d), 1), _rand((2, 13, d), 2)

    def run_jax(p, x):
        return jmoe.moe_ffn(moe, nest(p), x)

    reads = tmoe.HOST_READS

    def run_port(p, x):
        return tmoe.moe_ffn_train(moe, nest(p), x)

    _check_module(dtype, run_jax, run_port, (params, x, ct))
    assert tmoe.HOST_READS == reads      # 26 tokens: C = T, no host read


def test_moe_ffn_train_reads_the_capacity_above_the_row_tile():
    """Above the kernel's row tile the capacity is the largest count
    rounded up to the tile, one host read; the padding rows change no
    output: the result equals the reference's ``ragged_dot``."""
    moe = jsmoke("dbrx-132b").moe
    d = 16
    params = _init(jmoe.moe_params_spec(d, moe, jnp.float32), 5)
    t = gmm_ops.ROW_TILE + 11
    x = _rand((t, d), 4)
    want, waux = jmoe.moe_ffn(moe, nest(params), jnp.asarray(x))
    reads = tmoe.HOST_READS
    got, aux = tmoe.moe_ffn_train(
        moe, nest({k: _tensor(v, torch.float32) for k, v in params.items()}),
        torch.from_numpy(x))
    assert tmoe.HOST_READS == reads + 1
    _bar(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_train_matches_jax(dtype):
    cfg = jsmoke("hymba-1.5b")
    params = _init(jssm.ssm_params_spec(cfg.d_model, cfg.ssm, jnp.bfloat16),
                   11)
    x, ct = _rand((2, SEQ, cfg.d_model), 1), _rand((2, SEQ, cfg.d_model), 2)

    def run_jax(p, x):
        st = jssm.SSMState.init(2, cfg.d_model, cfg.ssm)
        y, st = jssm.ssm_forward(cfg.ssm, p, x, st, chunk=CHUNK)
        return y, st.h

    def run_port(p, x):
        y, st = tssm.ssm_forward_train(cfg.ssm, p, x, chunk=CHUNK)
        return y, st.h

    _check_module(dtype, run_jax, run_port, (params, x, ct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_train_matches_jax(dtype):
    cfg = jsmoke("xlstm-350m")
    h, xl, d = cfg.n_heads, cfg.xlstm, cfg.d_model
    params = _init(jxlstm.mlstm_params_spec(d, h, xl, jnp.bfloat16), 21)
    x, ct = _rand((2, SEQ, d), 1), _rand((2, SEQ, d), 2)

    def run_jax(p, x):
        st = jxlstm.MLSTMState.init(2, d, h, xl, x.dtype)
        y, st = jxlstm.mlstm_forward(xl, h, p, x, st, chunk=CHUNK)
        return y, st.c

    def run_port(p, x):
        st = txlstm.MLSTMState.init(2, d, h, xl, x.dtype)
        y, st = txlstm.mlstm_forward_train(xl, h, p, x, st, chunk=CHUNK)
        return y, st.c

    _check_module(dtype, run_jax, run_port, (params, x, ct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_train_matches_jax(dtype):
    cfg = jsmoke("xlstm-350m")
    h, xl, d = cfg.n_heads, cfg.xlstm, cfg.d_model
    params = _init(jxlstm.slstm_params_spec(d, h, xl, jnp.bfloat16), 31)
    x, ct = _rand((2, SEQ, d), 1), _rand((2, SEQ, d), 2)

    def run_jax(p, x):
        st = jxlstm.SLSTMState.init(2, d, xl, x.dtype)
        y, st = jxlstm.slstm_forward(xl, h, p, x, st, chunk=CHUNK)
        return y, st.c

    def run_port(p, x):
        st = txlstm.SLSTMState.init(2, d, xl, x.dtype)
        y, st = txlstm.slstm_forward_train(xl, h, p, x, st, chunk=CHUNK)
        return y, st.c

    _check_module(dtype, run_jax, run_port, (params, x, ct))


def test_train_forms_equal_the_serving_forms_in_value():
    """Without autograd, each train form computes what its serving form
    computes from the same state (fp32, the CPU's plain scans)."""
    hy, xc = get_smoke_config("hymba-1.5b"), get_smoke_config("xlstm-350m")
    gen = torch.Generator().manual_seed(0)
    model = Model(hy, device="cpu").init(gen)
    p = {k: v[0] for k, v in model.params()["blocks"]["ssm"].items()}
    x = torch.randn(2, SEQ, hy.d_model, generator=gen)
    with torch.no_grad():
        want, wst = tssm.ssm_forward(
            hy.ssm, p, x, tssm.SSMState.init(2, hy.d_model, hy.ssm))
        got, st = tssm.ssm_forward_train(hy.ssm, p, x, chunk=CHUNK)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st.h, wst.h, rtol=1e-5, atol=1e-5)
        xm = Model(xc, device="cpu").init(gen).params()
        pm = {k: v[0] for k, v in xm["m_blocks"].items()}
        ps = {k: v[0] for k, v in xm["s_blocks"].items()}
        x = torch.randn(2, SEQ, xc.d_model, generator=gen)
        st = txlstm.MLSTMState.init(2, xc.d_model, xc.n_heads, xc.xlstm)
        want, _ = txlstm.mlstm_forward(xc.xlstm, xc.n_heads, pm, x, st,
                                       chunk=CHUNK)
        got, _ = txlstm.mlstm_forward_train(xc.xlstm, xc.n_heads, pm, x, st,
                                            chunk=CHUNK)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        st = txlstm.SLSTMState.init(2, xc.d_model, xc.xlstm)
        want, _ = txlstm.slstm_forward(xc.xlstm, xc.n_heads, ps, x, st)
        got, _ = txlstm.slstm_forward_train(xc.xlstm, xc.n_heads, ps, x, st,
                                            chunk=CHUNK)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the families' loss and train step, from JAX's init
# ---------------------------------------------------------------------------


def _pair(arch, compute_dtype, seed=0, tcfg=None):
    """JAX model, state and jitted step; the port's over the same init."""
    tcfg = tcfg or dict(lr=LR, warmup_steps=0, total_steps=100)
    jcfg = jsmoke(arch).replace(compute_dtype=compute_dtype)
    jm = build_model(jcfg, q_chunk=CHUNK, kv_chunk=CHUNK)
    js = jinit(jm.init(jax.random.PRNGKey(seed)), seed)
    tm = Model(get_smoke_config(arch).replace(compute_dtype=compute_dtype),
               device="cpu", q_chunk=CHUNK, kv_chunk=CHUNK)
    ts = load_reference_train_state(tm, js)
    jstep = jax.jit(jmake_step(jm, JTrainConfig(**tcfg)))
    tstep = make_train_step(tm, TrainConfig(**tcfg))
    data = JSyntheticLM(JDataConfig(vocab=jcfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH, seed=seed))
    return jm, js, jstep, tm, ts, tstep, data


def _jgrads(jm, params, batch, fn=None):
    fn = fn or jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    (loss, met), grads = fn(params, jshard(batch))
    return float(loss), met, flat_paths(grads)


def _tight(jgrads, key, grad_tol):
    """Where every step's gradient (``jgrads``: one tree per step) is at
    least ``grad_tol`` of its leaf's largest."""
    tight = True
    for grads in jgrads:
        g = np.abs(_np(grads[key]))
        tight = tight & (g >= grad_tol * g.max())
    return tight


def _assert_step_bars(jparams, tparams, jgrads, lr, grad_tol, steps=1):
    """``tests/test_torch_train.py``'s bars: within ``1e-6 + 1e-3 lr`` on
    `_tight`'s elements, ``1e-6 + 2 lr`` a step elsewhere."""
    got_all, want_all = flat_paths(tparams), flat_paths(jparams)
    for key, want in want_all.items():
        err = np.abs(_np(got_all[key]) - _np(want))
        tight = _tight(jgrads, key, grad_tol)
        assert err[tight].max(initial=0) <= 1e-6 + 1e-3 * lr, key
        assert err.max() <= 1e-6 + 2 * lr * steps, key


def _assert_bf16_step_bars(want32, want16, tparams, jgrads32, lr):
    """One bf16 step against the reference's fp32 step: ``1e-6 + 2 lr``
    everywhere; on `_tight`'s elements (``GRAD_TOL["bfloat16"]``) an
    element off by more than ``1e-6 + 1e-3 lr`` took the other sign, and
    the port's bf16 step may take it no more often than 1.25 times the
    reference's bf16 step does, plus 1% of the tight set (at least one)."""
    got_all, w32, w16 = (flat_paths(p) for p in (tparams, want32, want16))
    for key, want in w32.items():
        want = _np(want)
        err = np.abs(_np(got_all[key]) - want)
        ref_err = np.abs(_np(w16[key]) - want)
        tight = np.broadcast_to(_tight([jgrads32], key, GRAD_TOL["bfloat16"]),
                                want.shape)
        bar = 1e-6 + 1e-3 * lr
        flips, ref_flips = ((e[tight] > bar).sum() for e in (err, ref_err))
        assert flips <= 1.25 * ref_flips + max(1.0, 0.01 * tight.sum()), (
            key, flips, ref_flips, tight.sum())
        assert err.max() <= 1e-6 + 2 * lr, key


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_and_one_step_match_jax_fp32(arch):
    jm, js, jstep, tm, ts, tstep, data = _pair(arch, "float32")
    batch = data.batch_at(0)
    jl, jmet, jgrads = _jgrads(jm, js.params, batch)
    tl, tmet = tm.loss(shard_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux_loss"].detach()),
                               float(jmet["aux_loss"]), rtol=1e-5, atol=1e-8)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == SEQ * BATCH
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()))
    for k, g in zip(named, grads):
        _bar(g, jgrads[k], 1e-4)
    js2, jmt = jstep(js, jshard(batch))
    ts2, tmt = tstep(ts, shard_batch(batch, "cpu"))
    loss_tol, gnorm_tol = STEP_TOL["float32"]
    np.testing.assert_allclose(float(tmt["loss"]), float(jmt["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(tmt["grad_norm"]),
                               float(jmt["grad_norm"]), rtol=gnorm_tol)
    assert set(tmt) == set(jmt)
    _assert_step_bars(js2.params, ts2.params, [jgrads], LR,
                      GRAD_TOL["float32"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_grads_and_one_step_match_jax_bf16(arch):
    """bf16 compute, fp32 master weights: the loss within 1e-3 of the
    reference's bf16 loss; every gradient held to the reference's fp32 run
    by `_bf16_bar`; the parameters after one step to the reference's fp32
    step by `_assert_bf16_step_bars`."""
    jm, js, jstep, tm, ts, tstep, data = _pair(arch, "bfloat16")
    jm32 = build_model(jsmoke(arch).replace(compute_dtype="float32"),
                       q_chunk=CHUNK, kv_chunk=CHUNK)
    batch = data.batch_at(0)
    jl, _, jgrads = _jgrads(jm, js.params, batch)
    jl32, _, jgrads32 = _jgrads(jm32, js.params, batch)
    tl, _ = tm.loss(shard_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tl.detach()), jl,
                               rtol=STEP_TOL["bfloat16"][0])
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()))
    for k, g in zip(named, grads):
        _bf16_bar(g, jgrads[k], jgrads32[k], k)
    step32 = jax.jit(jmake_step(jm32, JTrainConfig(
        lr=LR, warmup_steps=0, total_steps=100)))
    js2, jmt = jstep(js, jshard(batch))
    js2_32, _ = step32(js, jshard(batch))
    ts2, tmt = tstep(ts, shard_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tmt["loss"]), float(jmt["loss"]),
                               rtol=STEP_TOL["bfloat16"][0])
    _assert_bf16_step_bars(js2_32.params, js2.params, ts2.params, jgrads32,
                           LR)


# the second step's update is no longer a sign: it is as close as the two
# gradients are, relative to each element.  xlstm-350m's fp32 gradients
# agree to ~1e-5 of their leaf's largest, not ~1e-6 (its mLSTM normaliser
# and cancelling sums: a float64 run puts the reference's own fp32 error at
# 6.5e-6 on b_i), so its tight set starts at 1e-2 of the largest
ACCUM_GRAD_TOL = {"deepseek-moe-16b": 1e-3, "hymba-1.5b": 1e-3,
                  "xlstm-350m": 1e-2}


@pytest.mark.parametrize("arch", sorted(ACCUM_GRAD_TOL))
def test_two_steps_with_grad_accum_match_jax(arch):
    tcfg = dict(lr=LR, warmup_steps=0, total_steps=100, grad_accum=2)
    jm, js, jstep, tm, ts, tstep, data = _pair(arch, "float32", seed=1,
                                               tcfg=tcfg)
    vg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    jgrads = []
    for i in range(2):
        batch = data.batch_at(i)
        jgrads.append(_jgrads(jm, js.params, batch, vg)[2])
        js, jmt = jstep(js, jshard(batch))
        ts, tmt = tstep(ts, shard_batch(batch, "cpu"))
        assert set(tmt) == set(jmt)
        for k in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tmt[k]), float(jmt[k]),
                                       rtol=1e-4, atol=1e-7)
    _assert_step_bars(js.params, ts.params, jgrads, LR, ACCUM_GRAD_TOL[arch],
                      steps=2)
    assert int(ts.opt.step) == int(js.opt.step) == 2
    np.testing.assert_array_equal(ts.rng.numpy(), np.asarray(js.rng))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_launches_no_kernel(arch, monkeypatch):
    """The kernels' wrappers raise if anything calls them: a train step of
    every family runs the train forms only."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran in a train step")

    monkeypatch.setattr(gmm_ops, "expert_swiglu", refuse)
    monkeypatch.setattr(tssm, "selective_scan", refuse)
    monkeypatch.setattr(txlstm, "mlstm_scan", refuse)
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                     global_batch=2, seed=0)).batch_at(0)
    loss, _ = model.loss(shard_batch(batch, "cpu"))
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    # the serving path does reach them
    with pytest.raises(AssertionError, match="kernel wrapper"):
        model.prefill({"tokens": torch.zeros(2, 4, dtype=torch.int32)},
                      model.init_cache(2, 8))


def test_check_trainable_accepts_four_families_and_names_slice_10():
    """Every arch of ``configs/`` trains (the four families of this file,
    and MLA, VLM and audio): its smoke model's loss is finite and its
    backward pass runs, so the port keeps no list of trainable families.
    A family that no config has is refused by `Model` itself."""
    families = set()
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        families.add(cfg.family)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                 "labels": torch.zeros(1, 4, dtype=torch.int32)}
        frontend = resolve_frontend(cfg, None, 1, "cpu")
        if frontend is not None:
            batch["frontend"] = frontend
        loss, _ = model.loss(batch)
        loss.backward()
        assert torch.isfinite(loss), arch
        assert model.embed.grad is not None, arch
    assert families == set(MODEL_FAMILIES)
    with pytest.raises(ValueError, match="diffusion"):
        Model(_with_family(get_smoke_config("internlm2-1.8b"), "diffusion"),
              device="cpu")


def _with_family(cfg, family):
    """A copy of ``cfg`` claiming ``family`` (which the config itself
    would refuse to build)."""
    cfg = copy.copy(cfg)
    object.__setattr__(cfg, "family", family)
    return cfg


# ---------------------------------------------------------------------------
# the executor and the launcher on the recurrent families
# ---------------------------------------------------------------------------

EXEC_ARCH = "xlstm-350m"


def _scenario(types, mk_job, mk_mgr, executor, tmp):
    """test_e2e_train's preemption scenario, shortened: B (12 CPUs, 10
    units) runs alone until A (8 CPUs, 4 units) arrives at t=3 and OMFS
    evicts B."""
    users = [types.User("A", 50.0), types.User("B", 50.0)]
    ex = executor(users, types.SchedulerConfig(cpu_total=16, quantum=2),
                  steps_per_tick=2)
    jb = types.Job(user="B", cpus=12, work=10, submit_time=0, id=0,
                   job_class=types.JobClass.CHECKPOINTABLE)
    ja = types.Job(user="A", cpus=8, work=4, submit_time=3, id=1,
                   job_class=types.JobClass.CHECKPOINTABLE)
    for d, seed, root in ((jb, 1, "b"), (ja, 2, "a")):
        yield ex, d, mk_job(tmp, seed), mk_mgr(tmp / root)


def _mk(tmp, seed):
    return small_train_job(tmp, arch_cfg=get_smoke_config(EXEC_ARCH),
                           seq=16, batch=2, seed=seed, device="cpu")


def test_executor_on_xlstm_is_transparent_and_logs_as_jax(tmp_path):
    runs = {}
    for name, types, mk_job, mk_mgr, executor, managed in (
            ("port", ttypes, _mk,
             lambda r: CheckpointManager(ManagerConfig(root=r,
                                                       durable_every=100)),
             ClusterExecutor, ManagedJob),
            ("jax", jtypes,
             lambda t, seed: jsmall(t, arch_cfg=jsmoke(EXEC_ARCH), seq=16,
                                    batch=2, seed=seed),
             lambda r: JManager(JConfig(root=r, durable_every=100)),
             JExecutor, JManagedJob)):
        mjs, ex = [], None
        for ex, d, job, mgr in _scenario(types, mk_job, mk_mgr, executor,
                                         tmp_path / name):
            mjs.append(managed(d, job, mgr))
            ex.submit(mjs[-1])
        ex.run(40)
        runs[name] = (ex, mjs)
    ex, (mb, ma) = runs["port"]
    jex, _ = runs["jax"]
    assert mb.descriptor.state == ma.descriptor.state == JobState.DONE
    assert mb.checkpoints >= 1 and mb.restores >= 1, ex.events
    twin = _mk(tmp_path, 1)
    twin.cold_start()
    want = [twin.run_step() for _ in range(len(mb.train_job.losses))]
    assert len(want) == 20 and want == mb.train_job.losses
    assert ex.events == jex.events
    assert [tuple(e) for e in ex.bus.events] == [
        tuple(e) for e in jex.bus.events]
    for mj in runs["port"][1]:
        assert mj.train_job.state is None
        mj.ckpt.close()


def test_launcher_trains_hymba_and_resumes_bit_exactly(tmp_path):
    base = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu", "--seq",
            "24", "--batch", "2", "--ckpt-every", "2", "--lr", "1e-3"]
    straight = train_launcher.main(
        base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    first = train_launcher.main(
        base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    second = train_launcher.main(
        base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b"),
                "--resume"])
    assert second.resumed_from == "step_00000002"
    assert first.losses + second.losses == straight.losses
    assert all(np.isfinite(straight.losses))
    for a, b in zip(straight.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    # a cut config goes through run's arguments
    cfg = get_smoke_config("deepseek-moe-16b").replace(n_layers=1)
    rec = train_launcher.run(train_launcher.parser().parse_args(
        ["--arch", "deepseek-moe-16b", "--device", "cpu", "--steps", "1",
         "--seq", "8", "--batch", "2", "--ckpt-every", "0",
         "--ckpt-dir", str(tmp_path / "c")]), cfg=cfg)
    assert rec.cfg is cfg
    assert rec.model.params()["blocks"]["norm_attn"].shape[0] == 1
    rec.mgr.close()
