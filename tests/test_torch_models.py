"""The port's dense GQA serving stack against the JAX reference: layers,
the ring KV cache, decode attention, the parameter tree at full widths,
and prefill + decode of three smoke configs with the reference's weights
carried across."""
import copy
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.convert import load_reference_params  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.state import (  # noqa: E402
    INTERNLM2_1_8B,
    dense_state_template,
)

DENSE = ["internlm2-1.8b", "glm4-9b", "mistral-nemo-12b"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


def test_config_registry_is_the_references():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            mine = getattr(tconfigs, get)(arch)
            ref = getattr(jconfigs, get)(arch)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    assert [s.name for s in tconfigs.SHAPES] == [s.name for s in
                                                 jconfigs.SHAPES]


def test_rms_norm_rope_swiglu_match_jax():
    x = _rand((2, 5, 4, 16), 0)
    scale = _rand((16,), 1) + 1.0
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-6)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 3
    for theta in (10000.0, 1000000.0):
        np.testing.assert_allclose(
            _np(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                   theta)),
            _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            atol=1e-6)
    p = {"w_gate": _rand((16, 24), 2, 0.25), "w_up": _rand((16, 24), 3, 0.25),
         "w_down": _rand((24, 16), 4, 0.2)}
    h = _rand((2, 5, 16), 5)
    np.testing.assert_allclose(
        _np(tlayers.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(h))),
        _np(jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(h))), atol=1e-6)


# ---------------------------------------------------------------------------
# the ring KV cache and decode attention
# ---------------------------------------------------------------------------

RING_CASES = [  # size, n_pinned, cursor, n_new
    (8, 0, 0, 5), (8, 0, 6, 5), (8, 0, 3, 20), (6, 2, 0, 1), (6, 2, 1, 3),
    (6, 2, 5, 9), (6, 2, 13, 4), (2, 1, 7, 3), (24, 6, 60, 40), (5, 0, 0, 5),
]


@pytest.mark.parametrize("size,n_pinned,cursor,n_new", RING_CASES)
def test_ring_slots_equal_jax(size, n_pinned, cursor, n_new):
    want = np.asarray(jattn.ring_slots(jnp.int32(cursor), n_new, size,
                                       n_pinned))
    got = tattn.ring_slots(torch.tensor(cursor, dtype=torch.int32), n_new,
                           size, n_pinned)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size,n_pinned,cursor,n_new", RING_CASES)
def test_cache_write_and_pos_write_equal_jax(size, n_pinned, cursor, n_new):
    b, kvh, d = 2, 1, 3
    ck, cv = _rand((b, size, kvh, d), 0), _rand((b, size, kvh, d), 1)
    kn, vn = _rand((b, n_new, kvh, d), 2), _rand((b, n_new, kvh, d), 3)
    pos = np.full((b, size), -1, np.int32)
    new_pos = (cursor + np.arange(n_new, dtype=np.int32))[None].repeat(b, 0)
    jk, jv = jattn.cache_write(jnp.asarray(ck), jnp.asarray(cv),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.int32(cursor), n_pinned=n_pinned)
    jp = jattn.cache_pos_write(jnp.asarray(pos), jnp.asarray(new_pos),
                               jnp.int32(cursor), n_pinned=n_pinned)
    cur = torch.tensor(cursor, dtype=torch.int32)
    tk, tv = tattn.cache_write(torch.from_numpy(ck.copy()),
                               torch.from_numpy(cv.copy()),
                               torch.from_numpy(kn), torch.from_numpy(vn),
                               cur, n_pinned=n_pinned)
    tp = tattn.cache_pos_write(torch.from_numpy(pos.copy()),
                               torch.from_numpy(new_pos), cur,
                               n_pinned=n_pinned)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    single = tattn.cache_write_single(torch.from_numpy(ck.copy()),
                                      torch.from_numpy(kn), cur,
                                      n_pinned=n_pinned)
    np.testing.assert_array_equal(single.numpy(), np.asarray(
        jattn.cache_write_single(jnp.asarray(ck), jnp.asarray(kn),
                                 jnp.int32(cursor), n_pinned=n_pinned)))


def test_kv_cache_init_is_the_references():
    want = jattn.KVCache.init(3, 2, 7, 2, 8, d_v=4)
    got = tattn.KVCache.init(3, 2, 7, 2, 8, d_v=4)
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(_np(g), w.astype(np.float32))


def test_cache_write_ring_semantics_with_pinned_meta():
    """tests/test_attention.py's case: meta slots survive a wrap, the ring
    holds the newest, one token at a time, written in place."""
    b, s, kvh, d, n_meta = 1, 6, 1, 2, 2
    k = torch.zeros((b, s, kvh, d))
    v = torch.zeros((b, s, kvh, d))
    jk = jnp.zeros((b, s, kvh, d))
    for i in range(10):
        val = torch.full((b, 1, kvh, d), float(i))
        out_k, _ = tattn.cache_write(k, v, val, val, torch.tensor(i),
                                     n_pinned=n_meta)
        assert out_k is k
        jk, _ = jattn.cache_write(jk, jk, jnp.asarray(val.numpy()),
                                  jnp.asarray(val.numpy()), jnp.int32(i),
                                  n_pinned=n_meta)
    got = k[0, :, 0, 0].tolist()
    assert got[:2] == [0, 1] and sorted(got[2:]) == [6, 7, 8, 9]
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


@pytest.mark.parametrize("window,n_meta", [(0, 0), (3, 0), (3, 2)])
def test_decode_attention_matches_jax_with_invalid_slots(window, n_meta):
    b, s, h, kvh, d = 2, 9, 4, 2, 8
    q = _rand((b, 2, h, d), 0)
    k, v = _rand((b, s, kvh, d), 1), _rand((b, s, kvh, d), 2)
    kv_pos = np.where(np.arange(s) < 6, np.arange(s), -1).astype(np.int32)
    kv_pos = np.stack([kv_pos, np.roll(kv_pos, 2)])
    q_pos = np.array([[4, 5], [5, 6]], np.int32)
    kw = dict(window=window, n_meta=n_meta)
    got = tattn.decode_attention(*map(torch.from_numpy,
                                      (q, k, v, q_pos, kv_pos)), **kw)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                                  **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jbf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = tattn.decode_attention(*bf, torch.from_numpy(q_pos),
                                 torch.from_numpy(kv_pos), **kw)
    want = jattn.decode_attention(*jbf, jnp.asarray(q_pos),
                                  jnp.asarray(kv_pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def test_prefill_attention_takes_arange_positions_only():
    q = torch.zeros(1, 4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32)[None]
    tattn.prefill_attention(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="arange"):
        tattn.prefill_attention(q, q, q, pos + 1, pos + 1)


def test_model_prefill_positions_pass_the_guard_without_a_read(monkeypatch):
    """The model's prefill builds its positions with `arange_positions`,
    whose mark passes the guard without comparing values (on the card a
    comparison is a host sync per layer); unmarked positions are still
    compared, and refused unless they are arange."""
    marked = tattn.arange_positions(2, 5, "cpu")
    assert torch.equal(marked, torch.arange(5, dtype=torch.int32).expand(2, 5))
    q = torch.zeros(2, 5, 2, 8)

    def no_read(*args, **kw):
        raise AssertionError("the guard compared position values")

    monkeypatch.setattr(torch, "equal", no_read)
    tattn.prefill_attention(q, q, q, marked, marked)
    cfg = tconfigs.get_smoke_config("internlm2-1.8b")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 6), dtype=torch.int32)
    _, logits = model.prefill({"tokens": tokens}, model.init_cache(2, 8))
    assert torch.isfinite(logits).all()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="arange"):
        tattn.prefill_attention(q, q, q, marked + 1, marked + 1)
    with pytest.raises(ValueError, match="arange"):
        tattn.prefill_attention(q, q, q, marked.flip(-1), marked.flip(-1))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), v.dtype)
    return out


def test_state_dict_at_full_widths_is_the_train_state_params_tree():
    model = Model(tconfigs.get_config("internlm2-1.8b"), device="meta")
    got = {k: (tuple(v.shape), v.dtype)
           for k, v in model.state_dict().items()}
    want = _flat_shapes(dense_state_template(**INTERNLM2_1_8B).params)
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 1_889_110_016


def test_every_family_builds_and_trains():
    """Every arch of ``configs/`` builds, and train mode runs for each
    family: the dense, MLA, MoE and hybrid stacks and the loss of every
    family (VLM and audio with a frontend); `Model` refuses a family that
    no config has."""
    pos = torch.arange(3)[None]
    batch = {"tokens": torch.zeros(1, 3, dtype=torch.int32),
             "labels": torch.zeros(1, 3, dtype=torch.int32)}
    for arch in ("internlm2-1.8b", "minicpm3-4b", "deepseek-moe-16b",
                 "hymba-1.5b", "xlstm-350m", "llama-3.2-vision-11b",
                 "whisper-base"):
        cfg = tconfigs.get_smoke_config(arch)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        b = dict(batch)
        if cfg.family == "vlm":
            b["frontend"] = torch.ones(1, cfg.vision.n_patches,
                                       cfg.vision.vision_dim)
        if cfg.family == "audio":
            b["frontend"] = torch.ones(1, cfg.audio.n_audio_ctx, cfg.d_model)
        loss, _ = model.loss(b)
        assert torch.isfinite(loss)
        if cfg.family in ("dense", "moe", "hybrid"):
            x = torch.zeros(1, 3, cfg.d_model)
            h, _, _ = ttfm.stack_apply(cfg, model.params()["blocks"], x, pos,
                                       mode="train")
            assert h.shape == x.shape
    unknown = copy.copy(tconfigs.get_smoke_config("internlm2-1.8b"))
    object.__setattr__(unknown, "family", "diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        Model(unknown, device="cpu")


def test_load_reference_params_checks_paths_shapes_dtypes():
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    model = Model(tconfigs.get_smoke_config("internlm2-1.8b"), device="cpu")
    load_reference_params(model, params)
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  np.asarray(params["embed"]))
    with pytest.raises(KeyError, match="missing"):
        load_reference_params(model, {k: v for k, v in params.items()
                                      if k != "norm_f"})
    with pytest.raises(KeyError, match="extra"):
        load_reference_params(model, dict(params, meta=params["norm_f"]))
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(model, dict(params, norm_f=params["embed"]))
    with pytest.raises(TypeError, match="dtype"):
        load_reference_params(model, dict(
            params, norm_f=params["norm_f"].astype(jnp.bfloat16)))


def _both_models(arch, compute_dtype, seed):
    jcfg = jconfigs.get_smoke_config(arch).replace(compute_dtype=compute_dtype)
    tcfg = tconfigs.get_smoke_config(arch).replace(compute_dtype=compute_dtype)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = load_reference_params(Model(tcfg, device="cpu"), params)
    return jmodel, params, tmodel


def _assert_cache_equal(tcache, jcache, check):
    assert int(tcache["length"]) == int(jcache["length"])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        check(tcache["layers"][name], jcache["layers"][name])


# fp32 compute: the reference's own bar for prefill vs decode
# (tests/test_models.py:83).  bf16 compute: 2e-2 of the largest |logit|,
# because the reference's prefill (chunked_attention) rounds P to bf16
# before P.V (src/repro/models/attention.py:123-126) and the flash
# kernel's function, which the port's prefill computes, keeps P in fp32.
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, compute_dtype):
    b, s, steps = 2, 12, 4
    jmodel, params, tmodel = _both_models(arch, compute_dtype, seed=1)
    cache_dtype = "float32" if compute_dtype == "float32" else "bfloat16"
    rng = np.random.default_rng(7)
    vocab = jmodel.cfg.vocab
    prompt = rng.integers(0, vocab, (b, s)).astype(np.int32)
    forced = rng.integers(0, vocab, (b, steps)).astype(np.int32)

    def check_logits(got, want):
        got, want = _np(got), _np(want)
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max()
        if compute_dtype == "float32":
            assert err < 1e-4, err
        else:
            assert err <= 2e-2 * np.abs(want).max(), err

    def check_cache(got, want):
        got, want = _np(got), _np(want)
        if compute_dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()

    jcache = jmodel.init_cache(b, s + steps, dtype=getattr(jnp, cache_dtype))
    jcache, jlogits = jax.jit(jmodel.prefill)(params,
                                              {"tokens": jnp.asarray(prompt)},
                                              jcache)
    tcache = tmodel.init_cache(b, s + steps, dtype=getattr(torch, cache_dtype))
    tcache, tlogits = tmodel.prefill({"tokens": torch.from_numpy(prompt)},
                                     tcache)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (b, 1, vocab)
    check_logits(tlogits, jlogits)
    _assert_cache_equal(tcache, jcache, check_cache)

    decode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jcache, jlogits = decode(params, jcache, jnp.asarray(tok))
        tcache, tlogits = tmodel.decode_step(tcache, torch.from_numpy(tok))
        check_logits(tlogits, jlogits)
    _assert_cache_equal(tcache, jcache, check_cache)


@pytest.mark.cuda
def test_prefill_on_card_goes_through_the_flash_kernel():
    """The test-suite twin of chip_smoke.py's [serve] launch check: a
    depth-2 smoke-width prefill launches the kernel once per layer."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) GPU")
    cfg = tconfigs.get_smoke_config("internlm2-1.8b")
    assert cfg.n_layers == 2
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 16), device="cuda",
                           dtype=torch.int32)
    def launched():       # smoke head dim 8: the SIMT kernel
        return flash_ops.LAUNCHES + flash_ops.WGMMA_LAUNCHES

    before = launched()
    cache, logits = model.prefill({"tokens": tokens},
                                  model.init_cache(2, 20))
    torch.cuda.synchronize()
    assert launched() - before == 2
    assert torch.isfinite(logits).all()
    model.decode_step(cache, logits[:, -1].argmax(-1)[:, None].int())
    torch.cuda.synchronize()
    assert launched() - before == 2
