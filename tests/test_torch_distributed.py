"""The port's multi-device execution (`repro_torch.distributed`, the
sharded model, restore and train step) against the reference's 8-device
runs, on the CPU.

Two module-scoped runs feed every test: the reference in three concurrent
subprocesses with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(as ``tests/test_multidevice.py`` runs it) on a (2, 4) mesh (the xLSTM's
on (4, 2)), which write their outputs and the parameters and inputs
behind them to an npz; then the port on eight gloo ranks of the same
meshes (`torch_dist_ranks.py`: a ``FileStore`` in ``tmp_path``, no ports,
one torch thread a rank).  The configs and inputs are
``tests/test_multidevice.py``'s and the families' smokes."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]

REFERENCE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import ModelConfig, MoEConfig
from repro.distributed import sharding as shd
from repro.distributed.moe_ep import moe_ffn_ep
from repro.models.layers import build_params
from repro.models.model import build_model
from repro.models.moe import moe_ffn, moe_params_spec
from repro.train.state import init_train_state
from repro.train.steps import TrainConfig, make_train_step

out = {}
def save(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for p, leaf in flat:
        out[prefix + ".".join(shd._path_names(p))] = np.asarray(leaf)

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
# moe_ffn_ep at three capacity factors (test_multidevice.py:55-75)
moe = MoEConfig(n_routed=8, top_k=2, d_expert=16)
params = build_params(moe_params_spec(24, moe, jnp.float32),
                      jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 24)) * 0.5
save("ep.p.", params)
out["ep.x"] = np.asarray(x)
out["ep.plain"] = np.asarray(jax.jit(lambda p, x: moe_ffn(moe, p, x))(
    params, x)[0])
with mesh:
    for cf in (0.5, 1.0, 8.0):
        out[f"ep.{cf}"] = np.asarray(jax.jit(lambda p, x: moe_ffn_ep(
            moe, p, x, mesh, capacity_factor=cf))(params, x)[0])

# the sharded train step (test_multidevice.py:105-133), seeded tokens
cfg = ModelConfig(name="m", family="moe", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=48, vocab=128,
                  moe=MoEConfig(n_routed=8, top_k=2, d_expert=48))
model = build_model(cfg, q_chunk=16, kv_chunk=16)
step = make_train_step(model, TrainConfig(grad_accum=2, lr=1e-3,
                                          warmup_steps=0))
rng = np.random.default_rng(0)
batch = {"tokens": jnp.asarray(rng.integers(0, 128, (8, 32)), jnp.int32),
         "labels": jnp.asarray(rng.integers(0, 128, (8, 32)), jnp.int32)}
out["train.tokens"] = np.asarray(batch["tokens"])
out["train.labels"] = np.asarray(batch["labels"])
with jax.set_mesh(mesh):
    state = init_train_state(model.init(jax.random.PRNGKey(0)))
    save("train.p.", state.params)
    p_sh = shd.param_shardings(cfg, state.params, mesh)
    state = state._replace(params=jax.device_put(state.params, p_sh))
    state, metrics = jax.jit(step)(state, batch)
    out["train.loss"] = np.asarray(metrics["loss"])

# sequence-sharded KV decode (test_multidevice.py:136-166)
base = ModelConfig(name="m", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
                   compute_dtype="float32", decode_kv_shard=True)
key = jax.random.PRNGKey(0)
tok = jax.random.randint(key, (4, 16), 0, 128)
nxt = jax.random.randint(jax.random.fold_in(key, 1), (4, 1), 0, 128)
model = build_model(base, q_chunk=8, kv_chunk=8)
params = model.init(key)
save("dec.p.", params)
out["dec.tokens"] = np.asarray(tok)
out["dec.next"] = np.asarray(nxt)
with jax.set_mesh(mesh):
    cache = model.init_cache(4, 20, dtype=jnp.float32)
    cache, _ = jax.jit(model.prefill)(params, {"tokens": tok}, cache)
    cache, _ = jax.jit(model.decode_step)(params, cache, nxt)
    cache, logits = jax.jit(model.decode_step)(params, cache, nxt)
out["dec.sharded"] = np.asarray(logits)

# the same model without decode_kv_shard: its 2 KV heads do not divide the
# 4-way model axis, so the cache splits head_dim (sharding.py:162-169)
model = build_model(base.replace(decode_kv_shard=False), q_chunk=8,
                    kv_chunk=8)
with jax.set_mesh(mesh):
    cache = model.init_cache(4, 20, dtype=jnp.float32)
    cache, logits = jax.jit(model.prefill)(params, {"tokens": tok}, cache)
    out["hd.prefill"] = np.asarray(logits)
    for i in (1, 2):
        cache, logits = jax.jit(model.decode_step)(params, cache, nxt)
        out[f"hd.decode{i}"] = np.asarray(logits)

# the VLM smoke in fp32: 4 query heads, 2 KV heads (head_dim split on the
# 4-way model axis) and a variant with 4 KV heads (heads); seeded nonzero
# gates, so that each cross block adds to the stream
from repro.configs import get_smoke_config
rng = np.random.default_rng(3)
vlm_tok = jnp.asarray(rng.integers(0, 128, (4, 6)), jnp.int32)
vlm_nxt = jnp.asarray(rng.integers(0, 128, (4, 1)), jnp.int32)
vlm_fe = jnp.asarray(rng.standard_normal((4, 8, 16)), jnp.float32)
vlm_batch = {"tokens": jnp.asarray(rng.integers(0, 128, (4, 16)), jnp.int32),
             "labels": jnp.asarray(rng.integers(0, 128, (4, 16)), jnp.int32),
             "frontend": vlm_fe}
for name, vlm_kvh in (("vlm", 2), ("vlm4", 4)):
    vcfg = get_smoke_config("llama-3.2-vision-11b").replace(
        compute_dtype="float32", n_kv_heads=vlm_kvh)
    model = build_model(vcfg, q_chunk=8, kv_chunk=8)
    params = model.init(jax.random.PRNGKey(11))
    gates = jax.random.normal(jax.random.PRNGKey(12), (2, 2, 1)) * 0.8
    params["cross"]["gate_attn"], params["cross"]["gate_ffn"] = gates
    save(f"{name}.p.", params)
    with jax.set_mesh(mesh):
        cache = model.init_cache(4, 8, dtype=jnp.float32)
        cache, logits = jax.jit(model.prefill)(
            params, {"tokens": vlm_tok, "frontend": vlm_fe}, cache)
        out[f"{name}.prefill"] = np.asarray(logits)
        for i in (1, 2):
            cache, logits = jax.jit(model.decode_step)(params, cache, vlm_nxt)
            out[f"{name}.decode{i}"] = np.asarray(logits)
    if name == "vlm":
        step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=0))
        with jax.set_mesh(mesh):
            state = init_train_state(params)
            p_sh = shd.param_shardings(vcfg, state.params, mesh)
            state = state._replace(params=jax.device_put(state.params, p_sh))
            state, metrics = jax.jit(step)(state, vlm_batch)
            out["vlm.train.loss"] = np.asarray(metrics["loss"])
        # the one-device step: on jax 0.9.0 the mesh's grad norm differs
        _, metrics = jax.jit(step)(init_train_state(params), vlm_batch)
        out["vlm.train.gnorm_one_device"] = np.asarray(metrics["grad_norm"])
out["vlm.tokens"] = np.asarray(vlm_tok)
out["vlm.next"] = np.asarray(vlm_nxt)
out["vlm.frontend"] = np.asarray(vlm_fe)
for k in ("tokens", "labels"):
    out[f"vlm.train.{k}"] = np.asarray(vlm_batch[k])
np.savez(sys.argv[1], **out)
"""

#: the MLA and hybrid families' reference runs, in a second subprocess
#: beside the first
REFERENCE_NEW_FAMILIES = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.distributed import sharding as shd
from repro.models.model import build_model
from repro.train.state import init_train_state
from repro.train.steps import TrainConfig, make_train_step

out = {}
def save(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for p, leaf in flat:
        out[prefix + ".".join(shd._path_names(p))] = np.asarray(leaf)

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
# the MLA and hybrid smokes in fp32: minicpm3-4b (4 heads; its latent
# cache 8 and 4 wide) and hymba-1.5b (4 query and 2 KV heads, 4 meta
# tokens, a ring of 8 slots that a 16-token prompt wraps, d_inner 64); then
# each with 6 query heads, 1.5 a rank of the 4-way model axis (minicpm3's
# 6 KV heads, hymba's 2), built from the seed here
rng = np.random.default_rng(5)
for name, arch, prompt, change in (
        ("mla", "minicpm3-4b", 6, {}), ("hyb", "hymba-1.5b", 16, {}),
        ("mla6", "minicpm3-4b", 6, {"n_heads": 6, "n_kv_heads": 6}),
        ("hyb6", "hymba-1.5b", 16, {"n_heads": 6, "n_kv_heads": 2})):
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", **change)
    model = build_model(cfg, q_chunk=8, kv_chunk=8)
    params = model.init(jax.random.PRNGKey(13))
    save(f"{name}.p.", params)
    tok = jnp.asarray(rng.integers(0, 128, (4, prompt)), jnp.int32)
    nxt = jnp.asarray(rng.integers(0, 128, (4, 1)), jnp.int32)
    batch = {k: jnp.asarray(rng.integers(0, 128, (4, 16)), jnp.int32)
             for k in ("tokens", "labels")}
    out[f"{name}.tokens"], out[f"{name}.next"] = np.asarray(tok), np.asarray(nxt)
    for k in ("tokens", "labels"):
        out[f"{name}.train.{k}"] = np.asarray(batch[k])
    with jax.set_mesh(mesh):
        cache = model.init_cache(4, prompt + 4, dtype=jnp.float32)
        cache, logits = jax.jit(model.prefill)(params, {"tokens": tok}, cache)
        out[f"{name}.prefill"] = np.asarray(logits)
        for i in (1, 2):
            cache, logits = jax.jit(model.decode_step)(params, cache, nxt)
            out[f"{name}.decode{i}"] = np.asarray(logits)
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=0))
    with jax.set_mesh(mesh):
        state = init_train_state(params)
        p_sh = shd.param_shardings(cfg, state.params, mesh)
        state = state._replace(params=jax.device_put(state.params, p_sh))
        _, metrics = jax.jit(step)(state, batch)
        out[f"{name}.train.loss"] = np.asarray(metrics["loss"])
        out[f"{name}.train.gnorm_mesh"] = np.asarray(metrics["grad_norm"])
    # the one-device step, against which the port is held where the
    # mesh's step disagrees with it (the VLM's on jax 0.9.0)
    _, metrics = jax.jit(step)(init_train_state(params), batch)
    out[f"{name}.train.gnorm_one_device"] = np.asarray(metrics["grad_norm"])
np.savez(sys.argv[1], **out)
"""

#: the xLSTM and audio families' reference runs, in a third subprocess
#: beside the two others: the xLSTM smoke (2 heads, d_inner 64, d_ff 42) on
#: a (4, 2) mesh, whose model axis its heads divide, and the whisper smoke
#: (4 heads, d_ff 64) on (2, 4), in fp32
REFERENCE_XLSTM_AUDIO = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.distributed import sharding as shd
from repro.models.model import build_model
from repro.train.state import init_train_state
from repro.train.steps import TrainConfig, make_train_step

out = {}
def save(prefix, tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for p, leaf in flat:
        out[prefix + ".".join(shd._path_names(p))] = np.asarray(leaf)

rng = np.random.default_rng(9)
for name, arch, shape, prompt in (("xlstm", "xlstm-350m", (4, 2), 6),
                                  ("audio", "whisper-base", (2, 4), 5)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    model = build_model(cfg, q_chunk=8, kv_chunk=8)
    params = model.init(jax.random.PRNGKey(17))
    save(f"{name}.p.", params)
    tok = jnp.asarray(rng.integers(0, 128, (4, prompt)), jnp.int32)
    nxt = jnp.asarray(rng.integers(0, 128, (4, 1)), jnp.int32)
    batch = {k: jnp.asarray(rng.integers(0, 128, (4, 16)), jnp.int32)
             for k in ("tokens", "labels")}
    serve = {"tokens": tok}
    if cfg.family == "audio":
        fe = jnp.asarray(rng.standard_normal(
            (4, cfg.audio.n_audio_ctx, cfg.d_model)), jnp.float32)
        serve["frontend"] = batch["frontend"] = fe
        out[f"{name}.frontend"] = np.asarray(fe)
    out[f"{name}.tokens"], out[f"{name}.next"] = np.asarray(tok), np.asarray(nxt)
    for k in ("tokens", "labels"):
        out[f"{name}.train.{k}"] = np.asarray(batch[k])
    with jax.set_mesh(mesh):
        cache = model.init_cache(4, prompt + 4, dtype=jnp.float32)
        cache, logits = jax.jit(model.prefill)(params, serve, cache)
        out[f"{name}.prefill"] = np.asarray(logits)
        for i in (1, 2):
            cache, logits = jax.jit(model.decode_step)(params, cache, nxt)
            out[f"{name}.decode{i}"] = np.asarray(logits)
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=0))
    with jax.set_mesh(mesh):
        state = init_train_state(params)
        p_sh = shd.param_shardings(cfg, state.params, mesh)
        state = state._replace(params=jax.device_put(state.params, p_sh))
        _, metrics = jax.jit(step)(state, batch)
        out[f"{name}.train.loss"] = np.asarray(metrics["loss"])
        out[f"{name}.train.gnorm_mesh"] = np.asarray(metrics["grad_norm"])
    _, metrics = jax.jit(step)(init_train_state(params), batch)
    out[f"{name}.train.gnorm_one_device"] = np.asarray(metrics["grad_norm"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's) as loaded npz files."""
    tmp = tmp_path_factory.mktemp("dist")
    ref_path, out_path = tmp / "ref.npz", tmp / "port.npz"
    # one thread per process on both sides, so that the runs take eight
    # cores at most while other test files share the machine
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    scripts = (REFERENCE, REFERENCE_NEW_FAMILIES, REFERENCE_XLSTM_AUDIO)
    parts = [tmp / f"ref{i}.npz" for i in range(len(scripts))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script), str(path)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for script, path in zip(scripts, parts)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    merged = {}
    for path in parts:
        with np.load(path) as part:
            merged.update({k: part[k] for k in part.files})
    np.savez(ref_path, **merged)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dist_ranks.py"),
         str(ref_path), str(out_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(ref_path), np.load(out_path)


@pytest.mark.parametrize("cf", [0.5, 1.0, 8.0])
def test_moe_ep_equals_reference_ep(runs, cf):
    ref, port = runs
    err = np.abs(port[f"ep.{cf}"] - ref[f"ep.{cf}"]).max()
    assert err < 1e-5, (cf, err)


def test_moe_ep_capacity_drops_degrade_monotonically(runs):
    _, port = runs
    errs = [np.abs(port[f"ep.{cf}"] - port["ep.plain"]).mean()
            for cf in (0.5, 1.0, 8.0)]
    assert errs[0] >= errs[1] >= errs[2], errs
    assert np.abs(port["ep.8.0"] - port["ep.plain"]).max() < 1e-5


def test_moe_ep_train_gradients_equal_moe_ffn_train(runs):
    _, port = runs
    # GRAD_TOL["float32"] of tests/test_torch_train.py, relative to max
    assert float(port["ep.grad_err"][0]) <= 1e-3
    assert float(port["ep.y_train_err"]) < 1e-5


def test_elastic_reshard_across_meshes(runs):
    _, port = runs
    assert bool(port["reshard.ok"])
    assert int(port["reshard.local_numel"]) == 16 * 8 // 8


def test_pod_mesh_groups_and_gradient_boxes(runs):
    _, port = runs
    assert bool(port["pod.ok"])


def test_embed_lookup_equals_plain_gather(runs):
    _, port = runs
    assert bool(port["embed.equal"])


def test_constrain_heads_places_heads_else_head_dim(runs):
    _, port = runs
    assert bool(port["heads.ok"])


def test_sharded_kv_decode_equals_baseline_and_reference(runs):
    ref, port = runs
    assert str(port["dec.layout"]) == "seq"
    # a (2, 4) mesh: batch 2 a rank, 20 / 4 = 5 slots, both kv heads
    assert tuple(port["dec.k_local"]) == (2, 2, 5, 2, 8)
    # one MAX and two SUM all-reduces a layer per decode step
    assert int(port["dec.combine"]) == 3 * 2
    assert np.abs(port["dec.sharded"] - port["dec.baseline"]).max() < 1e-4
    assert np.abs(port["dec.sharded"] - ref["dec.sharded"]).max() < 1e-4


def test_head_dim_kv_decode_equals_baseline_and_reference(runs):
    ref, port = runs
    # 4 query heads divide the 4-way model axis, 2 KV heads do not: each
    # rank holds a quarter of head_dim of both KV heads, as the reference
    assert str(port["hd.layout"]) == "head_dim"
    assert tuple(port["hd.k_local"]) == (2, 2, 20, 2, 8 // 4)
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"hd.{step}"]
        assert np.abs(got - port[f"hd.baseline.{step}"]).max() < 1e-4, step
        assert np.abs(got - ref[f"hd.{step}"]).max() < 1e-4, step
    # one fp32 SUM of the partial scores a layer per decode step
    assert int(port["hd.score_sums"]) == 2


def test_columns_form_sequence_split_decode_equals_one_process(runs):
    """The same model cut to 2 query heads with ``decode_kv_shard``: the
    columns form (half a head a rank) on the sequence-split cache; prefill
    and both decode steps equal one process, no attention leaf gathered
    whole."""
    _, port = runs
    assert str(port["cols.layout"]) == "seq"
    assert tuple(port["cols.k_local"]) == (2, 2, 5, 2, 8)
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"cols.sharded.{step}"]
        assert np.abs(got - port[f"cols.one.{step}"]).max() < 1e-4, step
    assert int(port["cols.attn_gathers"]) == 0


def test_sharded_train_step_equals_reference_and_one_process(runs):
    ref, port = runs
    # the reference's cell: capacity 1.25, aux averaged over the data
    # axes, bf16 compute: tests/test_torch_train.py's bf16 loss bar
    np.testing.assert_allclose(float(port["train.loss_ref_cell"]),
                               float(ref["train.loss"]), rtol=1e-3)
    # drop-free and aux-free against the port's one-process step on the
    # same bf16 operations: loss and norm within the fp32 bars, the
    # parameters within the bf16 ones
    np.testing.assert_allclose(float(port["train.loss_sharded"]),
                               float(port["train.loss_one"]), rtol=1e-5)
    np.testing.assert_allclose(float(port["train.gnorm_sharded"]),
                               float(port["train.gnorm_one"]), rtol=1e-4)
    lr = 1e-3
    keys = [k[len("train.after_one."):] for k in port.files
            if k.startswith("train.after_one.")]
    assert len(keys) > 10
    for k in keys:
        got = port[f"train.after_sharded.{k}"]
        want = port[f"train.after_one.{k}"]
        g = np.abs(port[f"train.grad_one.{k}"])
        err = np.abs(got - want)
        tight = g >= 3e-2 * g.max()      # GRAD_TOL["bfloat16"]
        assert err[tight].max(initial=0) <= 1e-6 + 1e-3 * lr, k
        assert err.max() <= 1e-6 + 2 * lr, k
    # every sharded leaf held at most half of its values on a rank
    assert float(port["train.largest_local_share"]) <= 0.5
    # the per-layer FSDP gather: no rank held more than one layer's
    # gathered stacked weights at once, forward or backward
    one_layer = int(port["train.layer_gathered_bytes"])
    assert 0 < int(port["train.gathered_peak"]) <= one_layer


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-base",
                                  "whisper-base-1x8"])
def test_whole_layer_families_train_sharded_as_one_process(runs, arch):
    """Where the model axis does not divide their heads (the xLSTM smoke's
    2 and whisper's cut to 2 on the 4-way axis of (2, 4), whisper's 4 on
    the 8-way axis of (1, 8): ``torch_dist_ranks.WHOLE_ARCHS``), the
    xLSTM's blocks and whisper's attention run every head on every rank,
    each stacked layer gathered where its stack runs it (whisper's MLP
    split): their sharded fp32 step equals the one-process step within
    the fp32 bars, and no rank held more than one layer's gathered weights
    (whole, and its model shard on the way) at once.  On (1, 8) the
    data-axis gather of a layer is an alias of the stacked leaf, which the
    live count leaves out."""
    _, port = runs
    got = {k: float(port[f"whole.{arch}.{k}"]) for k in (
        "loss_sharded", "loss_one", "gnorm_sharded", "gnorm_one")}
    np.testing.assert_allclose(got["loss_sharded"], got["loss_one"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_sharded"], got["gnorm_one"],
                               rtol=1e-4)
    peak = int(port[f"whole.{arch}.gathered_peak"])
    assert 0 < peak <= float(port[f"whole.{arch}.layer_bytes"])


@pytest.mark.parametrize("name,layout,xk", [
    # 4 query heads divide the 4-way model axis, 2 KV heads do not: each
    # rank a quarter of head_dim of both KV heads of its 2 rows
    ("vlm", "head_dim", (2, 2, 8, 2, 8 // 4)),
    # 4 KV heads: each rank one whole KV head
    ("vlm4", "heads", (2, 2, 8, 1, 8))])
def test_vlm_tensor_parallel_serve_equals_reference_and_one_process(
        runs, name, layout, xk):
    """The VLM smoke's self layers and gated cross blocks run
    tensor-parallel on the (2, 4) mesh, the vision K/V cache placed as the
    reference's ``cache_shardings`` places it: prefill and both decode
    steps equal the reference's 8-device run and one process in fp32."""
    ref, port = runs
    assert str(port[f"{name}.layout"]) == layout
    assert tuple(port[f"{name}.xk_local"]) == xk
    assert tuple(port[f"{name}.k_local"]) == (2, 2, 8, *xk[3:])
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"{name}.sharded.{step}"]
        assert np.abs(got - port[f"{name}.one.{step}"]).max() < 1e-4, step
        assert np.abs(got - ref[f"{name}.{step}"]).max() < 1e-4, step
    # head_dim: one fp32 score SUM a decode step for each self layer and
    # each cross block (one of each a group, two groups); heads: none
    want = 2 + 2 if layout == "head_dim" else 0
    assert list(port[f"{name}.score_sums"]) == [want, want]


def test_vlm_tensor_parallel_train_step_equals_one_process(runs):
    """The VLM smoke's sharded fp32 train step on (2, 4), its stack
    tensor-parallel in the head_dim form: loss and grad norm within the
    fp32 bars of one process; the loss the reference's sharded step's, the
    grad norm its one-device step's (its mesh run's norm differs on jax
    0.9.0); no sharded leaf more than half on a rank; the unembedding
    never gathered."""
    ref, port = runs
    got = {k: float(port[f"vlm.train.{k}"]) for k in (
        "loss_sharded", "loss_one", "gnorm_sharded", "gnorm_one")}
    np.testing.assert_allclose(got["loss_sharded"], got["loss_one"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_sharded"], got["gnorm_one"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["loss_sharded"],
                               float(ref["vlm.train.loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_sharded"],
                               float(ref["vlm.train.gnorm_one_device"]),
                               rtol=1e-4)
    assert float(port["vlm.train.largest_local_share"]) <= 0.5
    assert int(port["vlm.train.unembed_gathers"]) == 0


def test_vocab_parallel_ce_equals_chunked_ce(runs):
    """`collectives.vocab_parallel_ce` on the 4-way model axis against
    `chunked_ce_loss` on one process in fp32, with labels on both sides of
    every shard boundary, -1 labels and a 5-position last chunk: loss, dh
    and dW (gathered) within 1e-5 of their size; each of the three chunks
    one MAX and two SUM all-reduces forward, again in its recompute, and
    one SUM of dh's partials."""
    _, port = runs
    assert float(port["ce.errs"].max()) <= 1e-5, port["ce.errs"]
    assert bool(port["ce.count_equal"])
    assert list(port["ce.chunk_collectives"]) == [2 * 3, 5 * 3]


def test_sharded_loss_gathers_no_unembedding(runs):
    """With a divisible vocab `Model.loss` under the mesh takes the
    vocab-split CE: the loss of one process, no unembedding gathered, in
    the dense loss and in the MoE and VLM sharded train steps."""
    _, port = runs
    sharded, one = port["ce.model_loss.128"]
    np.testing.assert_allclose(sharded, one, rtol=1e-5)
    assert int(port["ce.unembed_gathers.128"]) == 0
    assert int(port["train.unembed_gathers"]) == 0
    assert int(port["vlm.train.unembed_gathers"]) == 0


def test_indivisible_vocab_takes_the_gathered_path(runs):
    """A vocab of 130 on the 4-way model axis keeps the gathered
    unembedding and `chunked_ce_loss`: the loss of one process."""
    _, port = runs
    sharded, one = port["ce.model_loss.130"]
    np.testing.assert_allclose(sharded, one, rtol=1e-5)
    assert int(port["ce.unembed_gathers.130"]) == 1


@pytest.mark.parametrize("name,layout,boxes,sums", [
    # 4 heads divide the 4-way model axis: the heads form; the latent
    # cache a quarter of kv_lora_rank (8) and of qk_rope_head_dim (4) a
    # rank; one fp32 score SUM a layer per decode step
    ("mla", "latent", {"ckv": (2, 2, 10, 2), "kr": (2, 2, 10, 1)}, 2),
    # 4 query heads divide, 2 KV heads do not: head_dim; a ring of 8 + 4
    # meta slots that the 16-token prompt (20 with the meta tokens) wraps;
    # the SSM's state on a quarter of d_inner (64) a rank
    ("hyb", "head_dim", {"k": (2, 2, 12, 2, 2), "ssm_h": (2, 2, 16, 4),
                         "ssm_conv": (2, 2, 2, 16)}, 2),
    # 6 heads, 1.5 a rank: the columns form; the latent cache as "mla"'s
    ("mla6", "latent", {"ckv": (2, 2, 10, 2), "kr": (2, 2, 10, 1)}, 2),
    # 6 query and 2 KV heads: the columns form, the cache a quarter of
    # head_dim of both KV heads (the reference's Shard(4))
    ("hyb6", "head_dim", {"k": (2, 2, 12, 2, 2), "v": (2, 2, 12, 2, 2),
                          "ssm_h": (2, 2, 16, 4)}, 2)])
def test_mla_hybrid_tensor_parallel_serve_equals_reference_and_one_process(
        runs, name, layout, boxes, sums):
    """The MLA (minicpm3-4b) and hybrid (hymba-1.5b) smokes run
    tensor-parallel on the (2, 4) mesh in fp32, the caches placed as the
    reference's ``cache_shardings`` places them: prefill and both decode
    steps equal the reference's 8-device run and one process.  With 6
    heads on the 4-way model axis each rank computes on the column blocks
    the reference places on it (`transformer.columns_split`)."""
    ref, port = runs
    assert str(port[f"{name}.layout"]) == layout
    for leaf, box in boxes.items():
        assert tuple(port[f"{name}.local.{leaf}"]) == box, leaf
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"{name}.sharded.{step}"]
        assert np.abs(got - port[f"{name}.one.{step}"]).max() < 1e-4, step
        assert np.abs(got - ref[f"{name}.{step}"]).max() < 1e-4, step
    assert list(port[f"{name}.score_sums"]) == [sums, sums]


@pytest.mark.parametrize("name,layout,sums", [
    ("mla2", "latent", 2), ("hyb2", "head_dim", 2), ("hybw", "full", 0),
    ("mlaw", "latent", 2)])
def test_heads_that_do_not_divide_serve_as_one_process(runs, name, layout,
                                                       sums):
    """With 2 heads on the 4-way model axis (half a head a rank) attention
    runs in the columns form, each rank on the one head its rows of
    ``w_o`` touch; MLA's latent cache splits and hymba's cache takes a
    quarter of head_dim (each decode one score SUM a layer).  hymba at 2
    query heads and 1 KV head 6 wide (``w_k``'s 6 columns do not divide
    the axis) runs every head on every rank from gathered weights, its
    cache whole.  minicpm3 at 2 heads with v_head_dim 3 (``w_uv``'s 6
    columns do not divide) runs every head on every rank from gathered
    up-projections, its latent cache still split as the reference's
    cache rule splits it.  The SSM still runs on a rank's channels and
    the FFN still splits: prefill and both decode steps equal one
    process."""
    _, port = runs
    mla = name.startswith("mla")
    assert str(port[f"{name}.layout"]) == layout
    assert tuple(port[f"{name}.local.{'ckv' if mla else 'ssm_h'}"]
                 ) == ((2, 2, 10, 2) if mla else (2, 2, 16, 4))
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"{name}.sharded.{step}"]
        assert np.abs(got - port[f"{name}.one.{step}"]).max() < 1e-4, step
    assert list(port[f"{name}.score_sums"]) == [sums, sums]


@pytest.mark.parametrize("name", ["mla", "hyb", "mla6", "hyb6", "mla2",
                                  "hyb2", "hybw", "mlaw"])
def test_mla_hybrid_train_step_equals_one_process(runs, name):
    """The sharded fp32 train step of the MLA and hybrid smokes on (2, 4)
    (at 6 and 2 heads in the columns form), the per-layer FSDP gather of
    each stacked leaf: loss and grad norm
    within the fp32 bars of one process; for the reference's configs the
    loss of its sharded step and the grad norm of its one-device step
    (the VLM's mesh norm differs from it on jax 0.9.0); no sharded leaf
    more than half on a rank; the unembedding never gathered (vocab 128
    divides the model axis)."""
    ref, port = runs
    got = {k: float(port[f"{name}.train.{k}"]) for k in (
        "loss_sharded", "loss_one", "gnorm_sharded", "gnorm_one")}
    np.testing.assert_allclose(got["loss_sharded"], got["loss_one"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_sharded"], got["gnorm_one"],
                               rtol=1e-4)
    if name in ("mla", "hyb", "mla6", "hyb6"):
        np.testing.assert_allclose(got["loss_sharded"],
                                   float(ref[f"{name}.train.loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            got["gnorm_sharded"],
            float(ref[f"{name}.train.gnorm_one_device"]), rtol=1e-4)
    assert float(port[f"{name}.train.largest_local_share"]) <= 0.5
    assert int(port[f"{name}.train.unembed_gathers"]) == 0


@pytest.mark.parametrize("name", ["mla6", "hyb6", "mla2", "hyb2", "hybw",
                                  "mlaw"])
def test_columns_form_gathers_no_attention_leaf(runs, name):
    """Where the query heads do not divide the model axis, serving
    (prefill and two decode steps) and the sharded train step compute on
    the attention weights' column blocks: no attention leaf is gathered
    whole (``COLLECTIVES["attn_gather"]``).  ``hybw``, whose ``w_k``
    width does not divide the axis, gathers its split ``w_q`` and ``w_o``
    every layer, and ``mlaw``, whose ``w_uv`` and ``w_o`` widths do not,
    its split ``w_uq`` and ``w_uk``, as the counts show (2 layers; a
    serve runs 3 steps, the train step each layer forward and in its
    recompute)."""
    _, port = runs
    want = ((2 * 2 * 3, 2 * 2 * 2) if name in ("hybw", "mlaw") else (0, 0))
    assert (int(port[f"{name}.serve_attn_gathers"]),
            int(port[f"{name}.train.attn_gathers"])) == want


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-base",
                                  "whisper-base-1x8"])
def test_whole_layer_families_serve_as_one_process(runs, arch):
    """The same fallback serves as one process: the cache whole on the
    model axis (layout "full"), prefill and both decode steps within
    1e-4 in fp32."""
    _, port = runs
    assert str(port[f"whole.{arch}.layout"]) == "full"
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"whole.{arch}.sharded.{step}"]
        want = port[f"whole.{arch}.one.{step}"]
        assert np.abs(got - want).max() < 1e-4, step


@pytest.mark.parametrize("name,boxes", [
    # (4, 2): one row a rank; 2 pairs; the mLSTM's 1 head of 2 (dh 32,
    # d_inner 64), the sLSTM's 16 of 32 units, conv windows of 2
    ("xlstm", {"m.c": (2, 1, 1, 32, 32), "m.n": (2, 1, 1, 32),
               "m.m": (2, 1, 1), "m.conv": (2, 1, 2, 32),
               "s.h": (2, 1, 16), "s.m": (2, 1, 16),
               "s.conv": (2, 1, 2, 16)}),
    # (2, 4): two rows a rank; 1 KV head of 4, 5 + 4 slots, 12 frames
    ("audio", {"k": (2, 2, 9, 1, 8), "v": (2, 2, 9, 1, 8),
               "xk": (2, 2, 12, 1, 8), "xv": (2, 2, 12, 1, 8)})])
def test_xlstm_audio_tensor_parallel_serve_equals_reference_and_one_process(
        runs, name, boxes):
    """The xLSTM smoke on (4, 2) and the whisper smoke on (2, 4) run
    tensor-parallel in fp32, each rank on its heads (the mLSTM's scan on
    [B * H / TP, T, dh], the sLSTM's state on its heads' units, whisper's
    attention on its heads): the cache boxes are the rank's heads, and
    prefill and both decode steps equal the reference's 8-device run and
    one process within 1e-4; the logits take the rank's vocab columns
    (128 divides both model axes) and gather no unembedding."""
    ref, port = runs
    assert str(port[f"{name}.layout"]) == "heads"
    for leaf, box in boxes.items():
        assert tuple(port[f"{name}.local.{leaf}"]) == box, leaf
    for step in ("prefill", "decode1", "decode2"):
        got = port[f"{name}.sharded.{step}"]
        assert np.abs(got - port[f"{name}.one.{step}"]).max() < 1e-4, step
        assert np.abs(got - ref[f"{name}.{step}"]).max() < 1e-4, step
    assert int(port[f"{name}.serve_unembed_gathers"]) == 0


@pytest.mark.parametrize("name", ["xlstm", "audio"])
def test_xlstm_audio_train_step_equals_one_process(runs, name):
    """The sharded fp32 train step of the xLSTM smoke on (4, 2) and the
    whisper smoke on (2, 4), tensor-parallel with the per-layer FSDP
    gather: loss and grad norm within the fp32 bars of one process and of
    the reference (its sharded step's loss, its one-device step's norm,
    which its mesh step's equals here); no sharded leaf more than half on
    a rank; the loss on the rank's vocab columns, no unembedding
    gathered."""
    ref, port = runs
    got = {k: float(port[f"{name}.train.{k}"]) for k in (
        "loss_sharded", "loss_one", "gnorm_sharded", "gnorm_one")}
    np.testing.assert_allclose(got["loss_sharded"], got["loss_one"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_sharded"], got["gnorm_one"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["loss_sharded"],
                               float(ref[f"{name}.train.loss"]), rtol=1e-5)
    for norm in ("gnorm_one_device", "gnorm_mesh"):
        np.testing.assert_allclose(got["gnorm_sharded"],
                                   float(ref[f"{name}.train.{norm}"]),
                                   rtol=1e-4)
    assert float(port[f"{name}.train.largest_local_share"]) <= 0.5
    assert int(port[f"{name}.train.unembed_gathers"]) == 0


def test_xlstm_split_inputs_equal_the_whole_rows(runs):
    """On (4, 2) the rank's mLSTM inputs (q, k, v, lf, li on its head; z
    and the conv window on its d_inner / 2 channels, cut from the
    exchanged ``[xi | z]``) and the sLSTM's exchanged gate inputs (whole)
    and conv window (its units) equal the whole computation's, in
    fp32."""
    _, port = runs
    assert float(port["xlstm.split_errs"].max()) <= 1e-6, \
        port["xlstm.split_errs"]
    assert bool(port["xlstm.split_shapes_ok"])
