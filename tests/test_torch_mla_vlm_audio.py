"""The MLA (minicpm3-4b), VLM (llama-3.2-vision-11b) and audio
(whisper-base) families of the port against the JAX reference on the CPU,
at their smoke sizes: the layers they add (``layer_norm``, ``gelu_mlp``,
``sinusoidal_positions``), MLA's decompressed and absorbed attention, the
gated cross-attention block and the VLM stack, Whisper's encoder and
decoder, the flash wrapper's plain version with Dv < Dk and non-causal
Sq != Skv against the reference's ``chunked_attention``; then each arch's
``Model.prefill`` and 4 decode steps (fp32 and bf16), the prefill/decode
consistency of ``tests/test_models.py`` for minicpm3 and whisper,
``Model.loss`` with its gradients and one train step, and a preempted
whisper job through the executor, bit-equal to an uninterrupted run.

The reference's parameters cross by `convert.load_reference_params`.  The
VLM's cross-attention gates start at zero (the block adds nothing at
init), so every VLM case draws them from a seed in the JAX tree before it
crosses, and feeds a random frontend.

Bars (those of ``tests/test_torch_models.py`` and
``tests/test_torch_train_families.py``).  Modules: fp32 within 1e-5 of the
larger of 1 and the compared tensor's largest magnitude; bf16 within 2e-2
of the largest magnitude.  Models: fp32 logits within 1e-4, caches within
1e-4; bf16 within 2e-2 of the largest |logit| or cache entry (the
reference's prefill rounds P to bf16 before P.V, the flash kernel's
function keeps it in fp32).  Train: fp32 loss within 1e-5 relative,
gradients within 1e-4 of the larger of 1 and their leaf's largest, a
step's parameters within ``1e-6 + 1e-3 lr`` where the gradient is at least
1e-3 of its leaf's largest and ``1e-6 + 2 lr`` elsewhere; bf16 loss within
1e-3 relative of the reference's bf16 loss, gradients no farther from the
reference's fp32 ones than twice the reference's bf16 ones are, plus 1e-2
of the largest magnitude.  (``test_torch_train_families.py`` allows 1.25
times; on these smoke trees of a few hundred elements a leaf's bf16 error
is noise of its own: over seeds 0-3 the port's largest error per leaf was
0.6-1.7 times the reference's, either way, on all three archs.)
"""
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import types as ttypes  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    flat_paths,
    load_reference_params,
    load_reference_train_state,
)
from repro_torch.core.types import JobState  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.steps import TrainConfig, make_train_step  # noqa: E402

MLA, VLM, AUDIO = "minicpm3-4b", "llama-3.2-vision-11b", "whisper-base"
ARCHS = [MLA, VLM, AUDIO]
SEQ, BATCH, CHUNK, LR = 13, 2, 8, 1e-3
DTYPES = ["float32", "bfloat16"]


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
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), floor), (err, tol)


def _check(got, want, dtype):
    """fp32: within 1e-5 of max(1, max|want|); bf16: 2e-2 of max|want|."""
    if dtype == "float32":
        _bar(got, want, 1e-5)
    else:
        _bar(got, want, 2e-2, floor=0.0)


def _random_tree(spec, seed):
    """Numpy fp32 params for a port spec ``{name: (shape, init, dtype) |
    subdict}``: fan-in scaled normals for the matrices, ``1 + 0.1 N`` for
    norm scales and ``0.3 N`` for biases and the cross-attention gates (so
    that every one of them shows)."""
    out = {}
    for i, name in enumerate(sorted(spec)):
        leaf = spec[name]
        if isinstance(leaf, dict):
            out[name] = _random_tree(leaf, seed * 31 + i + 1)
            continue
        shape, init, _ = leaf
        x = _rand(shape, seed * 31 + i)
        if init is tlayers.ones_init:
            out[name] = 1.0 + 0.1 * x
        elif init is tlayers.zeros_init:
            out[name] = 0.3 * x
        else:
            out[name] = x / np.sqrt(shape[-2] if len(shape) > 1 else 1)
    return out


def _trees(spec, seed):
    flat = _random_tree(spec, seed)
    to_j = jax.tree.map(jnp.asarray, flat)
    to_t = jax.tree.map(torch.from_numpy, flat)
    return to_j, to_t


def _x(shape, seed, dtype, scale=1.0):
    a = _rand(shape, seed, scale)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _arange(b, t):
    return np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_gelu_mlp_sinusoidal_positions_match_jax(dtype):
    jx, tx = _x((2, 7, 24), 0, dtype, 3.0)
    scale, bias = _rand((24,), 1) + 1.0, _rand((24,), 2)
    _check(tlayers.layer_norm(tx, torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-5),
           jlayers.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                              1e-5), dtype)
    assert tlayers.layer_norm(tx, torch.from_numpy(scale),
                              torch.from_numpy(bias)).dtype == tx.dtype
    jp, tp = _trees(tlayers.gelu_mlp_params(24, 40, torch.float32), 3)
    _check(tlayers.gelu_mlp(tp, tx), jlayers.gelu_mlp(jp, jx), dtype)
    # the angle pos * inv is an fp32 product up to 1,499: one ulp of exp's
    # result (XLA's against libm's) moves it by up to 2 ulp(1,499) =
    # 2.4e-4, and the sine with it
    for n, dim in ((12, 32), (1500, 512), (5, 2)):
        got = tlayers.sinusoidal_positions(n, dim)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jlayers.sinusoidal_positions(n, dim)),
            atol=2.5e-4 if n > 100 else 2e-6)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_full_and_decode_match_jax(dtype):
    cfg = get_smoke_config(MLA)
    mla, h, theta = cfg.mla, cfg.n_heads, cfg.rope_theta
    jp, tp = _trees(tmla.mla_params_spec(cfg.d_model, h, mla, torch.float32),
                    4)
    b, t = 2, 12
    jx, tx = _x((b, t, cfg.d_model), 5, dtype)
    pos = _arange(b, t)
    jout, (jckv, jkr) = jmla.mla_attention_full(
        mla, h, jp, jx, jnp.asarray(pos), theta, q_chunk=4, kv_chunk=4)
    for mode in ("train", "prefill"):
        tpos = (torch.from_numpy(pos) if mode == "train"
                else tattn.arange_positions(b, t, "cpu"))
        out, (ckv, kr) = tmla.mla_attention_full(
            mla, h, tp, tx, tpos, theta, mode=mode, q_chunk=4, kv_chunk=4)
        assert out.dtype == tx.dtype
        _check(out, jout, dtype)
        _check(ckv, jckv, dtype)
        _check(kr, jkr, dtype)
    # absorbed decode: two new tokens against a 16-slot cache holding the
    # prompt's latents, four slots empty
    s = 16
    ckv_c = np.zeros((b, s, mla.kv_lora_rank), np.float32)
    kr_c = np.zeros((b, s, mla.qk_rope_head_dim), np.float32)
    ckv_c[:, :t], kr_c[:, :t] = _np(jckv), _np(jkr)
    kv_pos = np.where(np.arange(s) < t, np.arange(s), -1).astype(np.int32)
    kv_pos = np.broadcast_to(kv_pos, (b, s)).copy()
    jn, tn = _x((b, 1, cfg.d_model), 6, dtype)
    qpos = np.full((b, 1), t - 1, np.int32)
    want = jmla.mla_attention_decode(
        mla, h, jp, jn, jnp.asarray(qpos),
        jnp.asarray(ckv_c, jn.dtype), jnp.asarray(kr_c, jn.dtype),
        jnp.asarray(kv_pos), theta)
    got = tmla.mla_attention_decode(
        mla, h, tp, tn, torch.from_numpy(qpos),
        torch.from_numpy(ckv_c).to(tn.dtype),
        torch.from_numpy(kr_c).to(tn.dtype), torch.from_numpy(kv_pos), theta)
    assert got.dtype == tn.dtype
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# flash's plain version: Dv < Dk, non-causal Sq != Skv
# ---------------------------------------------------------------------------

FLASH_SHAPES = [  # B, Sq, Skv, H, KVH, Dk, Dv, causal
    (2, 20, 20, 4, 4, 12, 8, True),     # MLA: Dv < Dk, causal
    (2, 9, 23, 4, 2, 16, 16, False),    # cross-attention, GQA
    (1, 30, 17, 2, 1, 8, 8, False),     # Sq > Skv
    (2, 11, 19, 4, 4, 24, 16, False),   # both
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_version_matches_jax_chunked_attention(shape, dtype):
    b, sq, skv, h, kvh, dk, dv, causal = shape
    jq, tq = _x((b, sq, h, dk), 7, dtype)
    jk, tk = _x((b, skv, kvh, dk), 8, dtype)
    jv, tv = _x((b, skv, kvh, dv), 9, dtype)
    if causal:
        qp, kp = _arange(b, sq), _arange(b, skv)
    else:
        qp, kp = np.zeros((b, sq), np.int32), np.zeros((b, skv), np.int32)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(qp),
                                   jnp.asarray(kp), causal=causal,
                                   q_chunk=8, kv_chunk=8)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, sq, h, dv) and got.dtype == tq.dtype
    _check(got, want, dtype)
    # the plain version at Dv is the padded launch's first Dv columns
    pad = torch.nn.functional.pad(tv, (0, dk - dv))
    torch.testing.assert_close(
        flash_attention_ref(tq, tk, pad, causal=causal)[..., :dv], got,
        rtol=0, atol=0)
    if not causal:
        torch.testing.assert_close(tattn.noncausal_attention(tq, tk, tv), got,
                                   rtol=0, atol=0)


def test_flash_wrapper_refuses_a_v_wider_than_k():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="Dv <= D"):
        flash_ops.flash_attention(q, q, torch.zeros(1, 4, 2, 16))
    with pytest.raises(ValueError, match="Dv <= D"):
        flash_ops.flash_attention(q, q, torch.zeros(1, 5, 2, 8))


# ---------------------------------------------------------------------------
# the VLM's cross-attention block and stack
# ---------------------------------------------------------------------------


def _with_gates(tree, seed):
    """The JAX tree with its cross blocks' gates drawn from ``seed``."""
    cross = dict(tree["cross"])
    for i, name in enumerate(("gate_attn", "gate_ffn")):
        cross[name] = jnp.asarray(_rand(cross[name].shape, seed + i, 0.8))
    return dict(tree, cross=cross)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_block_matches_jax_with_nonzero_gates(dtype):
    cfg = get_smoke_config(VLM)
    jcfg = jsmoke(VLM)
    jp, tp = _trees(ttfm.cross_block_params_spec(cfg, torch.float32), 10)
    assert abs(float(tp["gate_attn"][0])) > 0.05 and abs(
        float(tp["gate_ffn"][0])) > 0.05
    b, t, pm = 2, 7, cfg.vision.n_patches
    jx, tx = _x((b, t, cfg.d_model), 11, dtype)
    jm, tm = _x((b, pm, cfg.d_model), 12, dtype)
    want, (jk, jv) = jtfm.cross_block(jcfg, jp, jx, memory=jm, q_chunk=4)
    for mode in ("train", "prefill"):
        got, (k, v) = ttfm.cross_block(cfg, tp, tx, mode=mode, memory=tm,
                                       q_chunk=4)
        _check(got, want, dtype)
        _check(k, jk, dtype)
        _check(v, jv, dtype)
    # decode: one new token against the cached K and V
    jn, tn = _x((b, 1, cfg.d_model), 13, dtype)
    want, _ = jtfm.cross_block(jcfg, jp, jn, mem_kv=(jk, jv), q_chunk=4)
    got, _ = ttfm.cross_block(cfg, tp, tn, mode="decode",
                              mem_kv=(k.to(tn.dtype), v.to(tn.dtype)))
    _check(got, want, dtype)
    # the gates weigh the block: at zero it adds nothing
    zero = dict(tp, gate_attn=torch.zeros(1), gate_ffn=torch.zeros(1))
    got, _ = ttfm.cross_block(cfg, zero, tx, mode="prefill", memory=tm)
    assert torch.equal(got, tx)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_stack_apply_train_matches_jax(dtype):
    cfg = get_smoke_config(VLM).replace(compute_dtype=dtype)
    jcfg = jsmoke(VLM).replace(compute_dtype=dtype)
    spec = Model(cfg, device="meta").param_spec()
    jp, tp = _trees({"blocks": spec["blocks"], "cross": spec["cross"]}, 14)
    b, t = 2, 9
    jx, tx = _x((b, t, cfg.d_model), 15, dtype)
    jm, tm = _x((b, cfg.vision.n_patches, cfg.d_model), 16, dtype)
    pos = _arange(b, t)
    want, _, jaux = jtfm.vlm_stack_apply(
        jcfg, jp, jx, jnp.asarray(pos), mode="train", vision_states=jm,
        q_chunk=4, kv_chunk=4)
    got, cache, aux = ttfm.vlm_stack_apply(
        cfg, tp, tx, torch.from_numpy(pos), mode="train", vision_states=tm,
        q_chunk=4, kv_chunk=4)
    assert cache is None and float(aux) == float(jaux) == 0.0
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# Whisper's encoder and decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_and_decoder_forward_match_jax(dtype):
    cfg = get_smoke_config(AUDIO).replace(compute_dtype=dtype)
    jcfg = jsmoke(AUDIO).replace(compute_dtype=dtype)
    spec = Model(cfg, device="meta").param_spec()
    jp, tp = _trees({"enc": spec["enc"], "dec": spec["dec"]}, 17)
    b, te, t = 2, cfg.audio.n_audio_ctx, 10
    jf, tf = _x((b, te, cfg.d_model), 18, dtype)
    jenc = jwhisper.encoder_forward(jcfg, jp["enc"], jf)
    for mode in ("train", "prefill"):
        enc = twhisper.encoder_forward(cfg, tp["enc"], tf, mode=mode)
        assert enc.dtype == tf.dtype
        _check(enc, jenc, dtype)
    jx, tx = _x((b, t, cfg.d_model), 19, dtype)
    pos = _arange(b, t)
    want, _ = jwhisper.decoder_forward(jcfg, jp["dec"], jx, jnp.asarray(pos),
                                       jenc, mode="train")
    got, cache = twhisper.decoder_forward(
        cfg, tp["dec"], tx, torch.from_numpy(pos),
        torch.from_numpy(_np(jenc)).to(tx.dtype), mode="train")
    assert cache is None
    _check(got, want, dtype)


# ---------------------------------------------------------------------------
# the models: prefill and decode
# ---------------------------------------------------------------------------


def _frontend(cfg, b, seed):
    if cfg.family == "vlm":
        return _rand((b, cfg.vision.n_patches, cfg.vision.vision_dim), seed)
    if cfg.family == "audio":
        return _rand((b, cfg.audio.n_audio_ctx, cfg.d_model), seed)
    return None


def _both_models(arch, compute_dtype, seed, **chunks):
    jcfg = jsmoke(arch).replace(compute_dtype=compute_dtype)
    tcfg = get_smoke_config(arch).replace(compute_dtype=compute_dtype)
    jmodel = build_model(jcfg, **chunks)
    params = jmodel.init(jax.random.PRNGKey(seed))
    if jcfg.family == "vlm":
        params = _with_gates(params, seed + 100)
    tmodel = load_reference_params(Model(tcfg, device="cpu", **chunks),
                                   params)
    return jmodel, params, tmodel


def _batches(cfg, tokens, frontend):
    jb, tb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if frontend is not None:
        jb["frontend"] = jnp.asarray(frontend)
        tb["frontend"] = torch.from_numpy(frontend)
    return jb, tb


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, compute_dtype):
    b, s, steps = 2, 12, 4
    jmodel, params, tmodel = _both_models(arch, compute_dtype, seed=1)
    rng = np.random.default_rng(7)
    vocab = jmodel.cfg.vocab
    prompt = rng.integers(0, vocab, (b, s)).astype(np.int32)
    forced = rng.integers(0, vocab, (b, steps)).astype(np.int32)
    jb, tb = _batches(jmodel.cfg, prompt, _frontend(jmodel.cfg, b, 8))

    def check(got, want, what):
        got, want = _np(got), _np(want)
        assert got.shape == want.shape and np.isfinite(got).all(), what
        err = np.abs(got - want).max()
        if compute_dtype == "float32":
            assert err < 1e-4, (what, err)
        else:
            assert err <= 2e-2 * np.abs(want).max(), (what, err)

    def check_cache(tcache, jcache):
        assert int(tcache["length"]) == int(jcache["length"])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        assert sorted(tcache["layers"]) == sorted(jcache["layers"])
        for name, leaf in tcache["layers"].items():
            check(leaf, jcache["layers"][name], name)

    dt = getattr(jnp, compute_dtype)
    jcache = jmodel.init_cache(b, s + steps, dtype=dt)
    jcache, jlogits = jax.jit(jmodel.prefill)(params, jb, jcache)
    tcache = tmodel.init_cache(b, s + steps, dtype=getattr(torch,
                                                           compute_dtype))
    tcache, tlogits = tmodel.prefill(tb, tcache)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (b, 1, vocab)
    check(tlogits, jlogits, "prefill logits")
    check_cache(tcache, jcache)
    decode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        jcache, jlogits = decode(params, jcache, jnp.asarray(tok))
        tcache, tlogits = tmodel.decode_step(tcache, torch.from_numpy(tok))
        check(tlogits, jlogits, f"decode {i}")
    check_cache(tcache, jcache)


@pytest.mark.parametrize("arch", [MLA, AUDIO])
def test_prefill_decode_matches_teacher_forcing(arch):
    """tests/test_models.py's case on the port: decoding token t against a
    cache equals position t of a full prefill (fp32)."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    model = Model(cfg, device="cpu", q_chunk=8, kv_chunk=8).init(
        torch.Generator().manual_seed(1))
    b, s = 2, 10
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    batch = {"tokens": tokens}
    fe = _frontend(cfg, b, 4)
    if fe is not None:
        batch["frontend"] = torch.from_numpy(fe)
    _, full = model.prefill(batch, model.init_cache(b, s + 2, torch.float32))
    cache, _ = model.prefill(dict(batch, tokens=tokens[:, :s - 1]),
                             model.init_cache(b, s + 2, torch.float32))
    _, dec = model.decode_step(cache, tokens[:, s - 1:])
    assert float((full - dec).abs().max()) < 1e-4


def test_vlm_gates_move_the_logits():
    """With zero gates the VLM's logits ignore the frontend; with the seeded
    gates they do not, so the cases above see cross-attention."""
    _, params, tmodel = _both_models(VLM, "float32", seed=1)
    cfg = tmodel.cfg
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    outs = []
    for seed in (1, 2):
        fe = torch.from_numpy(_frontend(cfg, 1, seed))
        outs.append(tmodel.prefill({"tokens": tokens, "frontend": fe},
                                   tmodel.init_cache(1, 5))[1])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3
    with torch.no_grad():
        tmodel.cross.gate_attn.zero_()
        tmodel.cross.gate_ffn.zero_()
    outs = [tmodel.prefill({"tokens": tokens, "frontend": torch.from_numpy(
        _frontend(cfg, 1, seed))}, tmodel.init_cache(1, 5))[1]
        for seed in (1, 2)]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# training: Model.loss, its gradients and one step
# ---------------------------------------------------------------------------


def _train_pair(arch, dtype, seed=0):
    tcfg = dict(lr=LR, warmup_steps=0, total_steps=100)
    jmodel, params, tmodel = _both_models(arch, dtype, seed, q_chunk=CHUNK,
                                          kv_chunk=CHUNK)
    js = jinit(params, seed)
    ts = load_reference_train_state(tmodel, js)
    data = JSyntheticLM(JDataConfig(vocab=jmodel.cfg.vocab, seq_len=SEQ,
                                    global_batch=BATCH, seed=seed))
    batch = data.batch_at(0)
    jb, tb = jshard(batch), shard_batch(batch, "cpu")
    fe = _frontend(jmodel.cfg, BATCH, seed + 5)
    if fe is not None:
        jb["frontend"] = jnp.asarray(fe)
        tb["frontend"] = torch.from_numpy(fe)
    return (jmodel, js, jax.jit(jmake_step(jmodel, JTrainConfig(**tcfg))),
            tmodel, ts, make_train_step(tmodel, TrainConfig(**tcfg)), jb, tb)


def _jgrads(jmodel, params, jb):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jb)
    return float(loss), flat_paths(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_one_step_match_jax_fp32(arch):
    jm, js, jstep, tm, ts, tstep, jb, tb = _train_pair(arch, "float32")
    jl, jgrads = _jgrads(jm, js.params, jb)
    tl, tmet = tm.loss(tb)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    assert float(tmet["tokens"]) == SEQ * BATCH
    named = dict(tm.named_parameters())
    assert named.keys() == jgrads.keys()
    # whisper's norm_f is unread (its decoder ends in its own LayerNorm):
    # a zero gradient, as JAX's
    grads = torch.autograd.grad(tl, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    for k, g in zip(named, grads):
        _bar(g, jgrads[k], 1e-4)
    if arch == VLM:      # the seeded gates carry gradient
        assert float(grads[list(named).index("cross.gate_attn")].abs().max()
                     ) > 0
    js2, jmt = jstep(js, jb)
    ts2, tmt = tstep(ts, tb)
    np.testing.assert_allclose(float(tmt["loss"]), float(jmt["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmt["grad_norm"]),
                               float(jmt["grad_norm"]), rtol=1e-4)
    got_all, want_all = flat_paths(ts2.params), flat_paths(js2.params)
    for key, want in want_all.items():
        err = np.abs(_np(got_all[key]) - _np(want))
        g = np.abs(_np(jgrads[key]))
        tight = g >= 1e-3 * g.max()
        assert err[tight].max(initial=0) <= 1e-6 + 1e-3 * LR, key
        assert err.max() <= 1e-6 + 2 * LR, key


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_bf16(arch):
    jm, js, _, tm, _, _, jb, tb = _train_pair(arch, "bfloat16")
    jm32 = build_model(jsmoke(arch).replace(compute_dtype="float32"),
                       q_chunk=CHUNK, kv_chunk=CHUNK)
    jl, jgrads = _jgrads(jm, js.params, jb)
    _, jgrads32 = _jgrads(jm32, js.params, jb)
    tl, _ = tm.loss(tb)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-3)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    for k, g in zip(named, grads):
        got, w16, w32 = _np(g), _np(jgrads[k]), _np(jgrads32[k])
        ref_err = np.abs(w16 - w32).max()
        err = np.abs(got - w32).max()
        assert err <= 2 * ref_err + 1e-2 * max(np.abs(w32).max(), 1e-6), (
            k, err, ref_err)


def test_train_step_launches_no_kernel(monkeypatch):
    """The flash wrapper raises if anything calls it: a train step of each
    family runs `chunked_attention` only; its prefill does reach it."""
    def refuse(*a, **k):
        raise AssertionError("the flash wrapper ran in a train step")

    monkeypatch.setattr(tattn, "flash_attention", refuse)
    for arch in ARCHS:
        _, _, _, tm, ts, tstep, _, tb = _train_pair(arch, "float32")
        _, met = tstep(ts, tb)
        assert np.isfinite(float(met["loss"]))
        with pytest.raises(AssertionError, match="flash wrapper"):
            tm.prefill({k: v[:, :4] if k == "tokens" else v
                        for k, v in tb.items() if k != "labels"},
                       tm.init_cache(BATCH, 8))


# ---------------------------------------------------------------------------
# the executor: OMFS preempts a whisper job transparently
# ---------------------------------------------------------------------------


def _audio_job(tmp, seed, frontend=None):
    return small_train_job(tmp, arch_cfg=get_smoke_config(AUDIO), seq=12,
                           batch=2, seed=seed, device="cpu",
                           frontend=frontend)


def test_executor_preempts_a_whisper_job_bit_exactly(tmp_path):
    """test_e2e_train's scenario, shortened: B (12 CPUs, 10 units) runs
    alone until A (8 CPUs, 4 units) arrives at t=3 and OMFS evicts B; B's
    losses equal an uninterrupted run's bit for bit.  B trains on seeded
    random frames, A on the stub's zeros."""
    frames = torch.from_numpy(_frontend(get_smoke_config(AUDIO), 2, 20))
    users = [ttypes.User("A", 50.0), ttypes.User("B", 50.0)]
    ex = ClusterExecutor(users, ttypes.SchedulerConfig(cpu_total=16,
                                                       quantum=2),
                         steps_per_tick=2)
    jb = ttypes.Job(user="B", cpus=12, work=10, submit_time=0, id=0,
                    job_class=ttypes.JobClass.CHECKPOINTABLE)
    ja = ttypes.Job(user="A", cpus=8, work=4, submit_time=3, id=1,
                    job_class=ttypes.JobClass.CHECKPOINTABLE)
    mjs = []
    for d, job, root in ((jb, _audio_job(tmp_path, 1, frames), "b"),
                         (ja, _audio_job(tmp_path, 2), "a")):
        mjs.append(ManagedJob(d, job, CheckpointManager(ManagerConfig(
            root=tmp_path / root, durable_every=100))))
        ex.submit(mjs[-1])
    ex.run(40)
    mb, ma = mjs
    assert mb.descriptor.state == ma.descriptor.state == JobState.DONE
    assert mb.checkpoints >= 1 and mb.restores >= 1, ex.events
    twin = _audio_job(tmp_path, 1, frames)
    twin.cold_start()
    want = [twin.run_step() for _ in range(len(mb.train_job.losses))]
    assert len(want) == 20 and want == mb.train_job.losses
    assert all(np.isfinite(want))
    stub = _audio_job(tmp_path, 2)
    stub.cold_start()
    assert [stub.run_step() for _ in range(len(ma.train_job.losses))] == \
        ma.train_job.losses
    for mj in mjs:
        assert mj.train_job.state is None
        mj.ckpt.close()
