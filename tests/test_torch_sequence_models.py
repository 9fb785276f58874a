"""The port's recurrent sequence mixers and the two recurrent serving paths
against the JAX reference: the SSM, mLSTM and sLSTM blocks with the same
parameters, the port's twins of tests/test_sequence_models.py, the
deterministic initialisers, the parameter trees at full widths, and
prefill + 4 decode steps of hymba-1.5b-smoke and xlstm-350m-smoke with the
reference's weights carried across."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import SSMConfig, XLSTMConfig  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.layers import build_params  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import count_params as jax_count_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.configs.base import XLSTMConfig as TXLSTMConfig  # noqa: E402
from repro_torch.core.convert import load_reference_params  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.models.model import Model, count_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
SSM = dict(d_state=4, d_conv=3, expand=2)
XL = dict(conv_width=3)
D, H, B, T = 8, 2, 2, 13


def _t(tree):
    """A reference params dict (or array) as torch tensors, dtypes kept."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    arr = np.asarray(tree.astype(jnp.float32))
    out = torch.from_numpy(arr.copy())
    return out.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _x(seed, t=T, d=D):
    return np.array(jax.random.normal(jax.random.fold_in(KEY, seed),
                                      (B, t, d)) * 0.5)


# ---------------------------------------------------------------------------
# the blocks against JAX, same parameters
# ---------------------------------------------------------------------------


def test_ssm_forward_matches_jax():
    jcfg, tcfg = SSMConfig(**SSM), TSSMConfig(**SSM)
    params = build_params(jssm.ssm_params_spec(D, jcfg, jnp.float32), KEY)
    x = _x(1)
    want, wst = jssm.ssm_forward(jcfg, params, jnp.asarray(x),
                                 jssm.SSMState.init(B, D, jcfg), chunk=4)
    got, st = tssm.ssm_forward(tcfg, _t(params), torch.from_numpy(x),
                               tssm.SSMState.init(B, D, tcfg))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(st.h), _np(wst.h), atol=1e-5)
    np.testing.assert_allclose(_np(st.conv), _np(wst.conv), atol=1e-5)


def _mlstm_state(kind, cfg, seed=5):
    """The port's mLSTM state: ``MLSTMState.init``'s zero state, or a
    carried one drawn with numpy (C and n at a prefill's scale, m
    finite)."""
    st = txlstm.MLSTMState.init(B, D, H, cfg)
    if kind == "zero":
        return st
    rng = np.random.default_rng(seed)
    draw = lambda t, scale: torch.from_numpy(
        (rng.standard_normal(tuple(t.shape)) * scale).astype(np.float32))
    return st._replace(c=draw(st.c, 0.3), n=draw(st.n, 0.3),
                       m=torch.from_numpy(rng.uniform(
                           -1.0, 2.0, tuple(st.m.shape)).astype(np.float32)))


@pytest.mark.parametrize("state", ["zero", "carried"])
def test_mlstm_forward_matches_jax(state):
    """The port's one route (the kernel's plain version here) from the
    zero state and from a carried one."""
    jcfg, tcfg = XLSTMConfig(**XL), TXLSTMConfig(**XL)
    params = build_params(jxlstm.mlstm_params_spec(D, H, jcfg, jnp.float32),
                          KEY)
    x = _x(1)
    st0 = _mlstm_state(state, tcfg)
    jst0 = jxlstm.MLSTMState.init(B, D, H, jcfg)._replace(
        c=jnp.asarray(st0.c.numpy()), n=jnp.asarray(st0.n.numpy()),
        m=jnp.asarray(st0.m.numpy()))
    want, wst = jxlstm.mlstm_forward(jcfg, H, params, jnp.asarray(x), jst0,
                                     chunk=4)
    got, st = txlstm.mlstm_forward(tcfg, H, _t(params), torch.from_numpy(x),
                                   st0, chunk=4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    for name in ("c", "n", "m"):
        np.testing.assert_allclose(_np(getattr(st, name)),
                                   _np(getattr(wst, name)), atol=1e-5)
    np.testing.assert_allclose(_np(st.conv), _np(wst.conv), atol=1e-5)


def test_slstm_forward_matches_jax():
    jcfg, tcfg = XLSTMConfig(**XL), TXLSTMConfig(**XL)
    params = build_params(jxlstm.slstm_params_spec(D, H, jcfg, jnp.float32),
                          KEY)
    x = _x(3)
    want, wst = jxlstm.slstm_forward(jcfg, H, params, jnp.asarray(x),
                                     jxlstm.SLSTMState.init(B, D, jcfg),
                                     chunk=4)
    got, st = txlstm.slstm_forward(tcfg, H, _t(params), torch.from_numpy(x),
                                   txlstm.SLSTMState.init(B, D, tcfg))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    for name in ("h", "c", "n", "m"):
        np.testing.assert_allclose(_np(getattr(st, name)),
                                   _np(getattr(wst, name)), atol=1e-5)


# ---------------------------------------------------------------------------
# the port's twins of tests/test_sequence_models.py
# ---------------------------------------------------------------------------


def _torch_params(spec_fn, *args):
    """Parameters of a port spec filled by the port's initialisers."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, (shape, init, dtype) in sorted(spec_fn(*args).items()):
        out[name] = init(torch.empty(shape, dtype=dtype), gen)
    return out


def test_ssm_scan_equals_stepwise_decode():
    cfg = TSSMConfig(**SSM)
    params = _torch_params(tssm.ssm_params_spec, D, cfg, torch.float32)
    x = torch.from_numpy(_x(1, t=11))
    st0 = tssm.SSMState.init(B, D, cfg)
    y_full, st_full = tssm.ssm_forward(cfg, params, x, st0)
    st, ys = st0, []
    for i in range(x.shape[1]):
        y, st = tssm.ssm_decode_step(cfg, params, x[:, i:i + 1], st)
        ys.append(y)
    np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)), atol=1e-5)
    np.testing.assert_allclose(_np(st_full.h), _np(st.h), atol=1e-5)


@pytest.mark.parametrize("chunks", [(4, 1), (13, 4)])
def test_mlstm_chunk_sizes_agree(chunks):
    big, small = chunks
    cfg = TXLSTMConfig(**XL)
    params = _torch_params(txlstm.mlstm_params_spec, D, H, cfg, torch.float32)
    x = torch.from_numpy(_x(1))
    st0 = txlstm.MLSTMState.init(B, D, H, cfg)
    y_a, _ = txlstm.mlstm_forward(cfg, H, params, x, st0, chunk=big)
    y_b, _ = txlstm.mlstm_forward(cfg, H, params, x, st0, chunk=small)
    np.testing.assert_allclose(_np(y_a), _np(y_b), atol=1e-4)


@pytest.mark.parametrize("state", ["zero", "carried"])
def test_mlstm_streaming_equals_one_shot(state):
    cfg = TXLSTMConfig(**XL)
    params = _torch_params(txlstm.mlstm_params_spec, D, H, cfg, torch.float32)
    x = torch.from_numpy(_x(2))
    st0 = _mlstm_state(state, cfg)
    y_ref, _ = txlstm.mlstm_forward(cfg, H, params, x, st0, chunk=4)
    y_a, st = txlstm.mlstm_forward(cfg, H, params, x[:, :7], st0, chunk=4)
    y_b, _ = txlstm.mlstm_forward(cfg, H, params, x[:, 7:], st, chunk=4)
    np.testing.assert_allclose(_np(torch.cat([y_a, y_b], 1)), _np(y_ref),
                               atol=1e-4)


def test_slstm_streaming_equals_one_shot():
    cfg = TXLSTMConfig(**XL)
    params = _torch_params(txlstm.slstm_params_spec, D, H, cfg, torch.float32)
    x = torch.from_numpy(_x(3))
    st0 = txlstm.SLSTMState.init(B, D, cfg)
    y_ref, _ = txlstm.slstm_forward(cfg, H, params, x, st0)
    y_a, st = txlstm.slstm_forward(cfg, H, params, x[:, :7], st0)
    y_b, _ = txlstm.slstm_forward(cfg, H, params, x[:, 7:], st)
    np.testing.assert_allclose(_np(torch.cat([y_a, y_b], 1)), _np(y_ref),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# initialisers and parameter trees
# ---------------------------------------------------------------------------

def _log_states(shape):
    return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)), shape)


def _linspace(shape):
    return np.broadcast_to(np.linspace(3.0, 6.0, shape[-1]), shape)


def _slstm_bias(shape):
    d4 = shape[-1] // 4
    bias = np.zeros((4, d4))
    bias[1] = np.linspace(3.0, 6.0, d4)
    return np.broadcast_to(bias.reshape(-1), shape)


# (port init, reference init, float64 values, shape): a_log stacked at
# hymba-1.5b's widths and its smoke config's, the forget biases at
# xlstm-350m's and its smoke config's
DETERMINISTIC = [
    (tssm._a_log_init, jssm._a_log_init, _log_states, (32, 3200, 16)),
    (tssm._a_log_init, jssm._a_log_init, _log_states, (2, 64, 4)),
    (txlstm._fgate_bias_init, jxlstm._fgate_bias_init, _linspace, (12, 4)),
    (txlstm._slstm_bias_init, jxlstm._slstm_bias_init, _slstm_bias,
     (12, 4096)),
    (txlstm._slstm_bias_init, jxlstm._slstm_bias_init, _slstm_bias, (2, 128)),
]


@pytest.mark.parametrize("port,ref,exact,shape", DETERMINISTIC,
                         ids=[f"{p.__name__}-{s}"
                              for p, _, _, s in DETERMINISTIC])
def test_deterministic_initialisers_equal_jax(port, ref, exact, shape):
    """The port's values are the float64 ones rounded once to fp32; the
    reference's eager XLA values are within 1 ulp of them (XLA's CPU log is
    1 ulp above at log 7; its linspace multiplies by 1/(n-1) and fuses into
    FMAs differently in the vectorised body and the tail)."""
    got = port(torch.empty(shape), torch.Generator()).numpy()
    np.testing.assert_array_equal(got, exact(shape).astype(np.float32))
    want = np.asarray(ref(None, shape, jnp.float32))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_parameter_tree_at_full_widths_is_the_references(arch):
    model = Model(tconfigs.get_config(arch), device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in model.state_dict().items()}
    shapes = jax_build_model(jconfigs.get_config(arch)).param_shapes()
    want = {".".join(str(p.key) for p in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert got == want
    assert count_params(tconfigs.get_config(arch)) == jax_count_params(
        jconfigs.get_config(arch))


def test_ported_initialisers_fill_every_deterministic_leaf():
    """A port init of the smoke hybrid model: a_log is log(1..ds), d_skip
    ones, conv_b zeros, whatever the generator."""
    cfg = tconfigs.get_smoke_config("hymba-1.5b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    ssm = model.params()["blocks"]["ssm"]
    ds = cfg.ssm.d_state
    want = np.log(np.arange(1, ds + 1)).astype(np.float32)
    np.testing.assert_array_equal(ssm["a_log"].detach().numpy(),
                                  np.broadcast_to(want, ssm["a_log"].shape))
    assert bool((ssm["d_skip"] == 1).all())
    assert bool((ssm["conv_b"] == 0).all())
    dt = torch.nn.functional.softplus(ssm["dt_bias"].detach())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


# ---------------------------------------------------------------------------
# the whole slice: prefill + decode of the two smoke configs against JAX
# ---------------------------------------------------------------------------


def _cache_leaves(cache):
    """(name, tensor or array) of a hybrid or xLSTM cache's layer leaves."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        return [(k, layers[k]) for k in sorted(layers)]
    return [(f"{part}.{f}", getattr(getattr(layers, part), f))
            for part in ("m", "s") for f in getattr(layers, part)._fields]


# fp32: the reference's own bar for prefill vs decode (tests/test_models.py).
# bf16: 5e-2 of each compared tensor's largest magnitude.  The two
# frameworks round to bf16 at other places (torch after every elementwise
# op, XLA's CPU fusions keep fp32 inside a fusion), one bf16 ulp is 2^-8 of
# the value, and the differences compound through four layers and the
# recurrent states; hymba's prefill also carries the flash kernel's fp32 P
# against the reference's bf16 P (ROADMAP Queue 3).  The measured worst
# case is below 3e-2 of the largest logit.
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_prefill_and_decode_match_jax(arch, compute_dtype):
    b, s, steps = 2, 12, 4
    jcfg = jconfigs.get_smoke_config(arch).replace(compute_dtype=compute_dtype)
    tcfg = tconfigs.get_smoke_config(arch).replace(compute_dtype=compute_dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = load_reference_params(Model(tcfg, device="cpu"), params)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab, (b, steps)).astype(np.int32)

    def check(got, want):
        got, want = _np(got), _np(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max()
        if compute_dtype == "float32":
            assert err < 1e-4, err
        else:
            assert err <= 5e-2 * max(np.abs(want).max(), 1e-3), err

    def check_cache(tcache, jcache):
        assert int(tcache["length"]) == int(jcache["length"])
        if "pos" in jcache:
            np.testing.assert_array_equal(tcache["pos"].numpy(),
                                          np.asarray(jcache["pos"]))
        got, want = _cache_leaves(tcache), _cache_leaves(jcache)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, g), (_, w) in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            check(g, w)

    cache_dtype = compute_dtype
    jcache = jmodel.init_cache(b, s + steps, dtype=getattr(jnp, cache_dtype))
    jcache, jlogits = jax.jit(jmodel.prefill)(
        params, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tmodel.init_cache(b, s + steps, dtype=getattr(torch, cache_dtype))
    tcache, tlogits = tmodel.prefill({"tokens": torch.from_numpy(prompt)},
                                     tcache)
    assert tlogits.dtype == torch.float32
    check(tlogits, jlogits)
    check_cache(tcache, jcache)
    decode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jcache, jlogits = decode(params, jcache, jnp.asarray(tok))
        tcache, tlogits = tmodel.decode_step(tcache, torch.from_numpy(tok))
        check(tlogits, jlogits)
    check_cache(tcache, jcache)


def test_xlstm_prefill_onto_a_carried_state_continues_it():
    """A second prefill (from the first one's carried state) continues it
    as one prefill over both would."""
    cfg = tconfigs.get_smoke_config("xlstm-350m").replace(
        compute_dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    _, want = model.prefill({"tokens": tokens},
                            model.init_cache(2, 20, torch.float32))
    cache, _ = model.prefill({"tokens": tokens[:, :9]},
                             model.init_cache(2, 20, torch.float32))
    cache, got = model.prefill({"tokens": tokens[:, 9:]}, cache)
    assert int(cache["length"]) == 20
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_xlstm_prefill_and_decode_read_nothing_back_to_the_host(
        monkeypatch):
    """A prefill onto a non-empty cache and a decode step with every host
    read of a tensor refused: the mLSTM's one route needs no read of the
    cache's length (on the card, each read would be a sync)."""
    cfg = tconfigs.get_smoke_config("xlstm-350m").replace(
        compute_dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    cache, _ = model.prefill({"tokens": tokens[:, :9]},
                             model.init_cache(2, 21, torch.float32))

    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was read back to the host")

    with monkeypatch.context() as patch:
        for name in ("item", "__int__", "__bool__", "tolist"):
            patch.setattr(torch.Tensor, name, refuse)
        cache, logits = model.prefill({"tokens": tokens[:, 9:]}, cache)
        cache, step = model.decode_step(cache, tokens[:, :1])
    assert int(cache["length"]) == 21
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
