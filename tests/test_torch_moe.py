"""The port's MoE family against the JAX reference: routing, the
load-balance loss and the capacity-form ``moe_ffn`` (its expert ids and its
output) with the same parameters, the port's twins of
tests/test_sequence_models.py's MoE cases, a skewed router, the parameter
trees and counts at full widths, and prefill + 4 decode steps of
deepseek-moe-16b-smoke and dbrx-132b-smoke with the reference's weights
carried across."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import build_params  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import count_params as jax_count_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.core.convert import load_reference_params  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model, count_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
MOE_ARCHS = ["deepseek-moe-16b", "dbrx-132b"]
#: fp32 layer outputs: the bar for one MoE layer (the two sides sum
#: each token's k contributions in another order)
LAYER_TOL = 1e-5


def _t(tree):
    """A reference params dict (or array) as torch tensors, dtypes kept."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    arr = np.asarray(tree.astype(jnp.float32))
    out = torch.from_numpy(arr.copy())
    return out.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer(kw, d, seed=0):
    """The same MoE layer in both packages: (jax cfg, port cfg, jax params,
    port params)."""
    jcfg, tcfg = MoEConfig(**kw), TMoEConfig(**kw)
    params = build_params(jmoe.moe_params_spec(d, jcfg, jnp.float32),
                          jax.random.fold_in(KEY, seed))
    return jcfg, tcfg, params, _t(params)


def _both_ffn(jcfg, tcfg, jparams, tparams, x):
    """Both packages' moe_ffn on numpy x, and each side's expert ids from
    its own router logits (sorted within each token)."""
    y_j, aux_j = jax.jit(lambda p, x: jmoe.moe_ffn(jcfg, p, x))(
        jparams, jnp.asarray(x))
    y_t, aux_t = tmoe.moe_ffn(tcfg, tparams, torch.from_numpy(x))
    xf = x.reshape(-1, x.shape[-1])
    _, ids_j, _ = jmoe.route_topk(
        jnp.asarray(xf) @ jparams["router"], jcfg.top_k)
    _, ids_t, _ = tmoe.route_topk(
        torch.from_numpy(xf) @ tparams["router"], tcfg.top_k)
    np.testing.assert_array_equal(np.sort(ids_t.numpy(), -1),
                                  np.sort(np.asarray(ids_j), -1))
    return (y_t, aux_t), (y_j, aux_j)


# ---------------------------------------------------------------------------
# routing and the layer against JAX
# ---------------------------------------------------------------------------


def test_route_topk_matches_jax_with_ties_to_the_lower_index():
    logits = np.random.default_rng(0).standard_normal((13, 8)).astype(
        np.float32)
    logits[3] = 0.0                          # eight-way tie
    logits[5, [1, 4, 6]] = 2.0               # three-way tie at the top
    for k in (1, 3):
        w_t, ids_t, p_t = tmoe.route_topk(torch.from_numpy(logits), k)
        w_j, ids_j, p_j = jmoe.route_topk(jnp.asarray(logits), k)
        assert ids_t.dtype == torch.int32
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-7)
        np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, atol=1e-6)
    assert ids_t[3].tolist() == [0, 1, 2] and ids_t[5].tolist() == [1, 4, 6]


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(8), 40).astype(np.float32)
    experts = rng.integers(0, 8, (40, 2)).astype(np.int32)
    got = tmoe.load_balance_loss(torch.from_numpy(probs),
                                 torch.from_numpy(experts), 8)
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(experts), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# (MoE config, d_model, x shape): tests/test_sequence_models.py's routed +
# shared layer and its routed-only one, both with T at most the kernel's
# row tile (C = T), and the shared layer over 160 tokens (C from one host
# read of the largest count)
FFN_CASES = {
    "shared": (dict(n_routed=8, top_k=2, d_expert=16, n_shared=1,
                    d_shared=32), 24, (2, 5, 24)),
    "routed-only": (dict(n_routed=4, top_k=2, d_expert=16), 12, (1, 9, 12)),
    "shared-T160": (dict(n_routed=8, top_k=2, d_expert=16, n_shared=1,
                         d_shared=32), 24, (2, 80, 24)),
}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    kw, d, shape = FFN_CASES[case]
    jcfg, tcfg, jparams, tparams = _layer(kw, d, seed=4)
    x = np.array(jax.random.normal(jax.random.fold_in(KEY, 5), shape))
    before = tmoe.HOST_READS
    (y_t, aux_t), (y_j, aux_j) = _both_ffn(jcfg, tcfg, jparams, tparams, x)
    t = int(np.prod(shape[:-1]))
    assert tmoe.HOST_READS - before == (t > gmm_ops.ROW_TILE)
    assert y_t.shape == x.shape and y_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), _np(y_j), atol=LAYER_TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    assert float(aux_t) > 0


def test_moe_permutation_equivariance():
    """Permuting tokens permutes outputs (dispatch bookkeeping is sound):
    the port's twin of tests/test_sequence_models.py's case."""
    _, tcfg, _, tparams = _layer(dict(n_routed=4, top_k=2, d_expert=16), 12,
                                 seed=6)
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(KEY, 5), (1, 9, 12))))
    perm = torch.from_numpy(np.random.default_rng(6).permutation(9))
    y, _ = tmoe.moe_ffn(tcfg, tparams, x)
    y_p, _ = tmoe.moe_ffn(tcfg, tparams, x[:, perm])
    np.testing.assert_allclose(_np(y[:, perm]), _np(y_p), atol=1e-5)


@pytest.mark.parametrize("n_tokens", [9, 100])
def test_skewed_router_is_drop_free_and_equals_jax(n_tokens):
    """Every token picks the same k experts (logits = sum(x) * c_e with
    sum(x) > 0): their counts are all of T, C covers them, and the layer
    still equals the reference's."""
    kw = dict(n_routed=8, top_k=2, d_expert=16, n_shared=1, d_shared=32)
    jcfg, tcfg, jparams, tparams = _layer(kw, 24, seed=7)
    c = np.linspace(1.0, 0.3, 8, dtype=np.float32)
    jparams = dict(jparams, router=jnp.asarray(np.ones((24, 1), np.float32)
                                               * c[None]))
    tparams = dict(tparams, router=torch.from_numpy(np.array(
        jparams["router"])))
    x = np.abs(np.random.default_rng(8).standard_normal(
        (1, n_tokens, 24))).astype(np.float32)
    _, experts, _ = tmoe.route_topk(
        torch.from_numpy(x[0]) @ tparams["router"], 2)
    counts, pos = tmoe.dispatch(experts, 8)
    assert counts.tolist() == [n_tokens, n_tokens] + [0] * 6
    assert sorted(pos[:, 0].tolist()) == list(range(n_tokens))
    assert tmoe.capacity(n_tokens, counts) >= n_tokens
    (y_t, _), (y_j, _) = _both_ffn(jcfg, tcfg, jparams, tparams, x)
    np.testing.assert_allclose(_np(y_t), _np(y_j), atol=LAYER_TOL)


def test_capacity_rounds_the_largest_count_up_to_the_row_tile():
    tile = gmm_ops.ROW_TILE
    counts = torch.tensor([3, tile + 1, 0], dtype=torch.int32)
    before = tmoe.HOST_READS
    assert tmoe.capacity(tile, counts) == tile         # C = T, no read
    assert tmoe.HOST_READS == before
    assert tmoe.capacity(10 * tile, counts) == 2 * tile
    assert tmoe.capacity(10 * tile, counts - 1) == tile
    assert tmoe.HOST_READS == before + 2


# ---------------------------------------------------------------------------
# the parameter trees and counts at full widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_parameter_tree_at_full_widths_is_the_references(arch):
    model = Model(tconfigs.get_config(arch), device="meta")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in model.state_dict().items()}
    shapes = jax_build_model(jconfigs.get_config(arch)).param_shapes()
    want = {".".join(str(p.key) for p in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert got == want
    if arch == "deepseek-moe-16b":
        assert sum(p.numel() for p in model.parameters()) == 16_879_568_896


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_count_params_is_the_references(arch):
    got = count_params(tconfigs.get_config(arch))
    assert got == jax_count_params(jconfigs.get_config(arch))
    assert got["active"] < got["total"]


def test_load_reference_params_carries_the_moe_tree():
    """bf16 master weights: the router stays fp32, the stacked [L, E, d, f]
    experts cross as bf16, bit for bit."""
    cfg = jconfigs.get_smoke_config("deepseek-moe-16b").replace(
        param_dtype="bfloat16")
    params = jax_build_model(cfg).init(KEY)
    model = load_reference_params(Model(tconfigs.get_smoke_config(
        "deepseek-moe-16b").replace(param_dtype="bfloat16"), device="cpu"),
        params)
    ffn = model.params()["blocks"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert tuple(ffn["w_down"].shape) == (2, 8, 16, 32)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            _np(ffn[name]), _np(params["blocks"]["ffn"][name]))
    np.testing.assert_array_equal(
        _np(ffn["shared"]["w_up"]),
        _np(params["blocks"]["ffn"]["shared"]["w_up"]))


# ---------------------------------------------------------------------------
# the whole slice: prefill + decode of the two smoke configs against JAX
# ---------------------------------------------------------------------------


# fp32 compute: the reference's own bar for prefill vs decode
# (tests/test_models.py).  bf16 compute: 2e-2 of the largest |logit|, as
# for the dense family (tests/test_torch_models.py): the reference's
# prefill rounds P to bf16 before P.V and the flash kernel's function keeps
# it in fp32, and the two frameworks round to bf16 at other places.
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
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
            assert err <= 2e-2 * np.abs(want).max(), err

    def check_cache(tcache, jcache):
        assert int(tcache["length"]) == int(jcache["length"])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for name in ("k", "v"):
            check(tcache["layers"][name], jcache["layers"][name])

    dtype = compute_dtype
    jcache = jmodel.init_cache(b, s + steps, dtype=getattr(jnp, dtype))
    jcache, jlogits = jax.jit(jmodel.prefill)(
        params, {"tokens": jnp.asarray(prompt)}, jcache)
    tcache = tmodel.init_cache(b, s + steps, dtype=getattr(torch, dtype))
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


@pytest.mark.cuda
def test_serve_path_on_card_goes_through_the_gmm_kernel():
    """The test-suite twin of chip_smoke.py's [serve-moe] launch check: a
    depth-2 smoke-width prefill launches the kernel three times per layer,
    and so does a decode step."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    cfg = tconfigs.get_smoke_config("deepseek-moe-16b")
    assert cfg.n_layers == 2
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 40), device="cuda",
                           dtype=torch.int32)
    def launched():       # smoke widths are bf16 multiples of 8: wgmma
        return gmm_ops.LAUNCHES + gmm_ops.WGMMA_LAUNCHES

    before = launched()
    cache, logits = model.prefill({"tokens": tokens},
                                  model.init_cache(2, 44))
    torch.cuda.synchronize()
    assert launched() - before == 6
    model.decode_step(cache, logits[:, -1].argmax(-1)[:, None].int())
    torch.cuda.synchronize()
    assert launched() - before == 12
