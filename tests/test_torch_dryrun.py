"""The port's dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`) at smoke widths on the CPU.

Both sides run in subprocesses: importing ``repro.launch.dryrun`` forces
512 JAX host devices for the rest of the process, and the port's dry run
initialises a fake process group; the test process gets neither.  The
cell is internlm2-1.8b at smoke widths (``tuning_override["cfg"]``) at
train_4k and decode_32k, costed on one device and on a (2, 4) mesh:

* the port's matmul FLOPs per device are within 5% of the reference's
  compiled-HLO ``dot`` FLOPs per device (``tests/torch_dryrun_ref.py``
  resolves each dot's operand shape where it is defined);
* its argument bytes equal ``memory_analysis().argument_size_in_bytes``,
  the scalar leaves included (step, rng, cursor: ``SCALAR_LEAVES``);
* on (2, 4) its per-device FLOPs are within 5% of its own one-device
  FLOPs over 8;
* ``SHAPE_TUNING``, ``_layer_unit``, ``cell_is_applicable`` and the
  record's keys are the reference's.

Two configs: ``SMOKE`` is the smoke config's widths, whose 2 KV heads do
not divide the 4-way model axis; ``HEADS`` gives it 4 KV heads.  A third
cell, llama-3.2-vision-11b at ``SMOKE`` widths and one group of 5 layers
(``VLM_CELLS``), holds the VLM's tensor-parallel stack to the same counts,
its two gaps pinned and explained (the test docstrings); the MLA and
hybrid smokes (``NEW_CELLS``) hold theirs, with a gap each, their
6-head configs (``COLUMN_CELLS``, the columns form on (2, 4)) the split
of XLA's one-device count plus the touched heads' attention, and the
xLSTM and audio smokes (``XA_CELLS``, on meshes whose model axis their
heads divide) theirs, with their gaps pinned.  At
``SMOKE`` on (2, 4) the port splits K and V on head_dim as the reference
pins them (q by heads, the KV cache a quarter of head_dim a rank), so the
5% bars and the argument bytes hold at both configs.  Collective bytes
are no bar: XLA chooses reduce-scatter and all-to-all where the port
all-reduces and all-gathers (`PERF.md` has the two side by side).
"""
import ast
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.configs import SHAPES_BY_NAME  # noqa: E402
from repro.configs import cell_is_applicable as ref_applicable  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro_torch.configs import cell_is_applicable, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
SMOKE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=128)
HEADS = dict(SMOKE, n_kv_heads=4)
CELLS = [dict(arch=ARCH, shape=shape, mesh=mesh, cfg=cfg, name=name)
         for name, cfg in (("smoke", SMOKE), ("heads", HEADS))
         for mesh in ("1", "2x4") for shape in ("train_4k", "decode_32k")]
#: the VLM at SMOKE widths, one group of its published cross_attn_every
#: (4 self layers and a gated cross block), its published vision (6,404
#: patches of 1,280)
VLM = "llama-3.2-vision-11b"
VLM_SMOKE = dict(SMOKE, n_layers=5)
VLM_CELLS = [dict(arch=VLM, shape=shape, mesh=mesh, cfg=VLM_SMOKE, name="vlm")
             for mesh in ("1", "2x4") for shape in ("train_4k", "decode_32k")]
#: the MLA (minicpm3-4b) and hybrid (hymba-1.5b) smokes, their stacks
#: tensor-parallel on (2, 4): MLA in the heads form with its latent cache
#: split, hymba's attention in the head_dim form and its SSM on a quarter
#: of its channels a rank (``mla`` and ``ssm`` as dicts of their fields)
MLA = "minicpm3-4b"
HYBRID = "hymba-1.5b"
NEW_SMOKES = {
    MLA: dict(SMOKE, n_kv_heads=4, mla=dict(
        q_lora_rank=16, kv_lora_rank=8, qk_nope_head_dim=8,
        qk_rope_head_dim=4, v_head_dim=8)),
    HYBRID: dict(SMOKE, head_dim=8, sliding_window=8, n_meta_tokens=4,
                 ssm=dict(d_state=4, d_conv=3, expand=2))}
NEW_CELLS = [dict(arch=arch, shape=shape, mesh=mesh, cfg=cfg, name=arch)
             for arch, cfg in NEW_SMOKES.items()
             for mesh in ("1", "2x4") for shape in ("train_4k", "decode_32k")]
#: the same smokes at 6 query heads (minicpm3's 6 KV heads, hymba's 2):
#: 1.5 heads a rank of the 4-way model axis, minicpm3-4b's and hymba's
#: case on 16, which the port computes in the columns form
COLUMN_SMOKES = {"mla6": (MLA, dict(NEW_SMOKES[MLA], n_heads=6,
                                    n_kv_heads=6)),
                 "hyb6": (HYBRID, dict(NEW_SMOKES[HYBRID], n_heads=6))}
COLUMN_CELLS = [dict(arch=arch, shape=shape, mesh=mesh, cfg=cfg, name=name)
                for name, (arch, cfg) in COLUMN_SMOKES.items()
                for mesh in ("1", "2x4")
                for shape in ("train_4k", "decode_32k")]
#: the xLSTM smoke's widths (2 heads, d_inner 64, d_ff 42) on (4, 2) and
#: the whisper smoke's (4 heads, d_ff 64; 2 encoder layers over the
#: published 1,500 frames) on (2, 4): each rank on its heads.  The xLSTM's
#: train cell is left out: its sLSTM loop over 4,096 tokens takes about two
#: minutes on meta tensors
XA_SMOKES = {
    "xlstm-350m": dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                       vocab=128),
    "whisper-base": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                         d_ff=64, vocab=128, audio=dict(n_encoder_layers=2,
                                                        n_audio_ctx=1500))}
XA_CELLS = [dict(arch=arch, shape=shape, mesh=mesh, cfg=XA_SMOKES[arch],
                 name=arch) for arch, mesh, shape in (
    ("xlstm-350m", "4x2", "decode_32k"),
    ("whisper-base", "2x4", "decode_32k"),
    ("whisper-base", "2x4", "train_4k"))]
#: the train state's scalar leaves, in both packages: step int32 [],
#: rng uint32 [2], data_cursor int32 []
SCALAR_LEAVES = {"step": 4, "rng": 8, "data_cursor": 4}


def _run(script: str, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "tests" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cells = json.dumps([{k: c[k] for k in ("arch", "shape", "mesh", "cfg")}
                        for c in CELLS + VLM_CELLS + NEW_CELLS + XA_CELLS
                        + COLUMN_CELLS])
    out = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run, "torch_dryrun_ref.py", cells)
        port = pool.submit(_run, "torch_dryrun_port.py", cells, str(out))
        return ref.result(), port.result()


def _pairs(both):
    ref, port = both
    return {(c["name"], c["mesh"], c["shape"]): (r, p) for c, r, p in
            zip(CELLS + VLM_CELLS + NEW_CELLS + XA_CELLS + COLUMN_CELLS,
                ref["cells"], port["cells"])}


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_matmul_flops_per_device_match_reference_dots(both, shape, mesh):
    for name in ("smoke", "heads"):
        ref, port = _pairs(both)[name, mesh, shape]
        assert port["kernel_flops"] == 0   # neither step reaches a kernel
        rel = port["matmul_flops"] / ref["dot_flops"] - 1
        assert abs(rel) <= 0.05, (name, port["matmul_flops"],
                                  ref["dot_flops"])


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_kv_heads_that_do_not_divide_split_as_the_reference(both, shape):
    """With 2 KV heads on a 4-way model axis each model rank computes its
    query head against the one KV head it uses, from k and v projected on
    its columns, as the reference's head_dim pins split the work: the
    port's matmul FLOPs per device are within 5% of the reference's HLO
    dots, and a decode rank holds a quarter of head_dim of its rows' KV
    cache, so its argument bytes are XLA's."""
    ref, port = _pairs(both)["smoke", "2x4", shape]
    rel = port["matmul_flops"] / ref["dot_flops"] - 1
    assert abs(rel) <= 0.05, (port["matmul_flops"], ref["dot_flops"])
    assert port["argument_bytes"] == ref["argument_bytes"]


@pytest.mark.parametrize("name,mesh,shape", [
    (c["name"], c["mesh"], c["shape"]) for c in CELLS])
def test_argument_bytes_equal_xla(both, name, mesh, shape):
    ref, port = _pairs(both)[name, mesh, shape]
    # the scalar leaves are arguments of the train step in both packages
    # (XLA keeps a replicated scalar whole on every device), so the
    # totals agree with them included
    assert port["argument_bytes"] == ref["argument_bytes"], (
        port["argument_bytes"] - ref["argument_bytes"], SCALAR_LEAVES)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_per_device_flops_split_over_the_mesh(both, shape):
    pairs = _pairs(both)
    one = pairs["heads", "1", shape][1]["matmul_flops"]
    eight = pairs["heads", "2x4", shape][1]["matmul_flops"]
    assert abs(eight / (one / 8) - 1) <= 0.05, (eight, one / 8)


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_vlm_matmul_flops_per_device_match_reference_dots(both, shape,
                                                          mesh):
    """The VLM's per-device matmul FLOPs against XLA's dots, its stack
    tensor-parallel on (2, 4) (the self layers and the cross block in the
    head_dim form, as the reference's pins split them).  Decode: within
    5%.  Train: the cross block attends over 6,404 patches in two
    4,096-key chunks, and XLA's text holds the second chunk in a while
    loop whose body it counts once, so the port's count is XLA's plus one
    chunk's attention FLOPs (QK and PV, forward, its two recomputes and
    two backward products: 5 x 4 x B x T x 4,096 x H x hd over the
    devices); on (2, 4) also plus the vision projection's work that every
    model rank repeats on its rows (the port gathers ``vision_proj``
    whole: forward and dW, 2 x 2 x rows x P x vision_dim x d, 3/4 of it
    beyond the rank's share).  The gap is pinned within 1% of XLA's
    count."""
    ref, port = _pairs(both)["vlm", mesh, shape]
    assert port["kernel_flops"] == 0
    if shape == "decode_32k":
        rel = port["matmul_flops"] / ref["dot_flops"] - 1
        assert abs(rel) <= 0.05, (port["matmul_flops"], ref["dot_flops"])
        return
    cfg = get_config(VLM).replace(**VLM_SMOKE)
    spec = SHAPES_BY_NAME[shape]
    rows = spec.global_batch // dryrun.SHAPE_TUNING[shape]["grad_accum"]
    n_dev, tp = (1, 1) if mesh == "1" else (8, 4)
    chunk = (5 * 4 * rows * spec.seq_len * 4096 * cfg.n_heads
             * cfg.resolved_head_dim) / n_dev
    vis = cfg.vision
    proj = (2 * 2 * rows * vis.n_patches * vis.vision_dim * cfg.d_model
            / (n_dev // tp) * (1 - 1 / tp))
    gap = port["matmul_flops"] - ref["dot_flops"]
    assert abs(gap - (chunk + proj)) <= 0.01 * ref["dot_flops"], (
        gap, chunk, proj)


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_vlm_argument_bytes_equal_xla(both, shape, mesh):
    """The VLM's argument bytes are XLA's, less at decode the leaves that
    decode never reads and ``jax.jit`` prunes from its compiled arguments
    (``keep_unused=False``): ``vision_proj`` and the cross blocks' ``w_k``
    and ``w_v`` (K and V come from the cache), sharded over the
    devices."""
    ref, port = _pairs(both)["vlm", mesh, shape]
    unread = 0
    if shape == "decode_32k":
        cfg = get_config(VLM).replace(**VLM_SMOKE)
        hd, groups = cfg.resolved_head_dim, cfg.n_layers // 5
        unread = 4 * (cfg.vision.vision_dim * cfg.d_model
                      + 2 * groups * cfg.d_model * cfg.n_kv_heads * hd)
        unread //= 1 if mesh == "1" else 8
    assert port["argument_bytes"] - ref["argument_bytes"] == unread


def _new_config(arch):
    from repro_torch.configs.base import MLAConfig, SSMConfig

    nested = {"mla": MLAConfig, "ssm": SSMConfig}
    return get_config(arch).replace(**{
        k: nested[k](**v) if k in nested else v
        for k, v in NEW_SMOKES[arch].items()})


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_mla_hybrid_matmul_flops_per_device_match_reference_dots(
        both, arch, shape, mesh):
    """The MLA and hybrid smokes' per-device matmul FLOPs against XLA's
    dots, their stacks tensor-parallel on (2, 4).  Within 5%, with two
    gaps pinned within 1% of XLA's count.  Hymba's train step: its 4
    meta tokens make the sequence 4,100, which 4,096-position chunks pad
    to two q chunks and two KV chunks; XLA's text holds the pairs in
    while loops whose bodies it counts once, so the port's count is
    XLA's plus three chunk pairs' attention FLOPs (QK and PV, forward,
    two recomputes and two backward products: 3 x 5 x 4 x B x 4,096^2 x
    H x hd a layer, over the devices).  MLA's decode on (2, 4): a rank's
    slice of the rotary key is one column wide, and torch's einsum forms
    a one-wide contraction as an elementwise product and a sum, which
    the counter does not count: the port's count is XLA's less those
    scores (2 x rows x H x S x dr / TP a layer, each rank's rows).  Only
    hymba's decode step reaches a kernel (the scan, whose cost the counter
    keeps apart from the matmuls)."""
    ref, port = _pairs(both)[arch, mesh, shape]
    scan = arch == HYBRID and shape == "decode_32k"
    assert (port["kernel_flops"] > 0) == scan
    cfg = _new_config(arch)
    spec = SHAPES_BY_NAME[shape]
    n_dev, tp = (1, 1) if mesh == "1" else (8, 4)
    want = 0.0
    if arch == HYBRID and shape == "train_4k":
        rows = spec.global_batch // dryrun.SHAPE_TUNING[shape]["grad_accum"]
        want = (3 * 5 * 4 * rows * spec.seq_len ** 2 * cfg.n_heads
                * cfg.resolved_head_dim * cfg.n_layers) / n_dev
    elif arch == MLA and shape == "decode_32k" and mesh == "2x4":
        rows = spec.global_batch // (n_dev // tp)
        want = -(2 * rows * cfg.n_heads * spec.seq_len
                 * cfg.mla.qk_rope_head_dim // tp * cfg.n_layers)
    gap = port["matmul_flops"] - ref["dot_flops"]
    if want:
        assert abs(gap - want) <= 0.01 * ref["dot_flops"], (gap, want)
    else:
        assert abs(gap) <= 0.05 * ref["dot_flops"], (
            port["matmul_flops"], ref["dot_flops"])


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_mla_hybrid_argument_bytes_equal_xla(both, arch, shape, mesh):
    """The MLA and hybrid smokes' argument bytes are XLA's: the latent
    cache a quarter of its widths a rank, the SSM state a quarter of its
    channels; less at hymba's decode its meta tokens, which decode never
    reads and ``jax.jit`` prunes (``meta`` [4, d], d over the model
    axis)."""
    ref, port = _pairs(both)[arch, mesh, shape]
    unread = 0
    if arch == HYBRID and shape == "decode_32k":
        cfg = _new_config(arch)
        unread = 4 * cfg.n_meta_tokens * cfg.d_model // (1 if mesh == "1"
                                                         else 4)
    assert port["argument_bytes"] - ref["argument_bytes"] == unread


def _column_config(name):
    from repro_torch.configs.base import MLAConfig, SSMConfig

    arch, fields = COLUMN_SMOKES[name]
    nested = {"mla": MLAConfig, "ssm": SSMConfig}
    return get_config(arch).replace(**{
        k: nested[k](**v) if k in nested else v for k, v in fields.items()})


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("name", ["mla6", "hyb6"])
def test_columns_form_matmul_flops_per_device_match_reference_dots(
        both, name, shape):
    """The 6-head smokes on (2, 4), 1.5 heads a rank: the port's
    per-device matmul FLOPs are XLA's one-device dots over the 8 devices
    (its pinned one-device gap, hymba's train chunks, over 8 too), plus
    the attention of the heads a rank touches beyond its share: the
    columns form attends on the 2 query heads its rows of ``w_o`` touch,
    against 6 / 4 = 1.5 (train: QK and PV, forward, two recomputes and two
    backward products, 5 x 2 (Dk + Dv) x pairs a head and row, the pairs
    those of the chunks that cover the sequence: hymba's 4,100 tokens in
    two 4,096-position chunks); less at MLA's decode the one-wide rotary
    scores (as `test_mla_hybrid_matmul_flops_per_device_match_reference_
    dots` pins them) and at hymba's decode the scan's output contraction
    (C . h over d_state, 2 x rows x d_inner x d_state a layer), a dot in
    XLA's text that the port's scan kernel holds in its kernel cost.
    Pinned within 1% of that split.  XLA's own (2, 4)
    count is no anchor here: it partitions the heads that do not divide
    by replicating ("involuntary full rematerialization"), so MLA's count
    there is above the port's (hymba's train loops it counts once, as on
    one device)."""
    ref1 = _pairs(both)[name, "1", shape][0]
    ref, port = _pairs(both)[name, "2x4", shape]
    cfg = _column_config(name)
    spec = SHAPES_BY_NAME[shape]
    n_dev, tp = 8, 4
    rows = spec.global_batch // dryrun.SHAPE_TUNING[shape]["grad_accum"]
    want = ref1["dot_flops"] / n_dev
    if shape == "train_4k":
        if cfg.mla is not None:
            dk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
            dv = cfg.mla.v_head_dim
        else:
            dk = dv = cfg.resolved_head_dim
        chunks = -(-(spec.seq_len + cfg.n_meta_tokens) // spec.seq_len)
        pairs = (chunks * spec.seq_len) ** 2
        if cfg.mla is None:     # XLA counts 1 of the 4 chunk pairs
            want += (3 * 5 * 4 * rows * spec.seq_len ** 2 * cfg.n_heads
                     * dk * cfg.n_layers) / n_dev
        touched = 2 - cfg.n_heads / tp
        want += (touched * rows / (n_dev // tp) * 5 * 2 * (dk + dv) * pairs
                 * cfg.n_layers)
    elif cfg.mla is not None:
        want -= (2 * rows // (n_dev // tp) * cfg.n_heads * spec.seq_len
                 * cfg.mla.qk_rope_head_dim // tp * cfg.n_layers)
    else:   # the scan's C . h, a dot in XLA's text, the kernel's cost here
        want -= (2 * rows * cfg.ssm.expand * cfg.d_model * cfg.ssm.d_state
                 * cfg.n_layers) / n_dev
    assert abs(port["matmul_flops"] - want) <= 0.01 * ref1["dot_flops"] / 8, (
        port["matmul_flops"], want)
    if cfg.mla is not None:
        assert port["matmul_flops"] < ref["dot_flops"]


@pytest.mark.parametrize("mesh", ["1", "2x4"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("name", ["mla6", "hyb6"])
def test_columns_form_argument_bytes_equal_xla(both, name, shape, mesh):
    """The 6-head smokes' argument bytes are XLA's: every attention leaf
    split as the reference's rules split it (the flat widths divide the
    model axis though the heads do not), hymba's cache a quarter of
    head_dim a rank; less at hymba's decode its meta tokens, as in
    `test_mla_hybrid_argument_bytes_equal_xla`."""
    ref, port = _pairs(both)[name, mesh, shape]
    cfg = _column_config(name)
    unread = 0
    if cfg.mla is None and shape == "decode_32k":
        unread = 4 * cfg.n_meta_tokens * cfg.d_model // (1 if mesh == "1"
                                                         else 4)
    assert port["argument_bytes"] - ref["argument_bytes"] == unread


def _xa_config(arch):
    from repro_torch.configs.base import AudioConfig

    fields = dict(XA_SMOKES[arch])
    if "audio" in fields:
        fields["audio"] = AudioConfig(**fields["audio"])
    return get_config(arch).replace(**fields)


@pytest.mark.parametrize("arch,mesh", [("xlstm-350m", "4x2"),
                                       ("whisper-base", "2x4")])
def test_xlstm_audio_matmul_flops_per_device_match_reference_dots(
        both, arch, mesh):
    """The xLSTM's and whisper's decode step, each rank on its heads:
    whisper's per-device matmul FLOPs equal XLA's dots; the xLSTM's differ
    by a gap pinned to the FLOP.  The port runs the sLSTM recurrence whole
    on every rank as one block-diagonal [d, 4d] product (2 x rows x d x 4d
    a token), where XLA computes the reference's per-head einsum on its
    model shard of ``r_gates``' columns (2 x rows x H x dh x 4dh / TP);
    and XLA's text holds the mLSTM's decode step as dots (C q, 2 x rows x
    H / TP x dh^2, and two normaliser products, 2 x rows x H / TP x dh
    each), which the port's kernel runs (its FLOPs counted apart).  The
    train cells' loops (whisper's 512-position attention chunks) XLA's
    text counts once a body, so its train dots are no bar."""
    ref, port = _pairs(both)[arch, mesh, "decode_32k"]
    cfg = _xa_config(arch)
    tp = int(mesh.split("x")[1])
    rows = SHAPES_BY_NAME["decode_32k"].global_batch // (8 // tp)
    want = 0
    if cfg.family == "ssm":
        d, h = cfg.d_model, cfg.n_heads
        dh, dh_m = d // h, int(cfg.xlstm.proj_factor_mlstm * d) // h
        pairs = cfg.n_layers // cfg.xlstm.slstm_every
        want = pairs * (2 * rows * d * 4 * d - 2 * rows * h * dh * 4 * dh // tp
                        - 2 * rows * h // tp * (dh_m ** 2 + 2 * dh_m))
        assert port["kernel_flops"] > 0      # the mLSTM kernel's decode
    assert port["matmul_flops"] - ref["dot_flops"] == want, (
        port["matmul_flops"], ref["dot_flops"], want)


@pytest.mark.parametrize("arch,mesh,shape", [
    (c["arch"], c["mesh"], c["shape"]) for c in XA_CELLS])
def test_xlstm_audio_argument_bytes_equal_xla(both, arch, mesh, shape):
    """The xLSTM's and whisper's argument bytes are XLA's, their caches
    the rank's heads (the xLSTM's mLSTM ``n`` by heads where the reference
    splits it by ``dh``: the same bytes); less at whisper's decode the
    leaves that decode never reads and ``jax.jit`` prunes: the encoder's,
    the cross blocks' ``w_k``, ``w_v`` and ``b_v`` (K and V come from the
    cache) and ``norm_f`` (the decoder ends in its own LayerNorm), each
    its per-device box."""
    import math

    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model

    ref, port = _pairs(both)[arch, mesh, shape]
    unread = 0
    if arch == "whisper-base" and shape == "decode_32k":
        sizes = dict(zip(("data", "model"), map(int, mesh.split("x"))))
        for k, p in Model(_xa_config(arch), device="meta").named_parameters():
            names = k.split(".")
            if not (names[0] == "enc" or k == "norm_f" or (
                    "cross" in names and names[-1] in ("w_k", "w_v", "b_v"))):
                continue
            spec = shd.leaf_spec(names, p.shape, sizes)
            split = math.prod(math.prod(sizes[a] for a in ax)
                              for ax in spec if ax)
            unread += p.numel() // split * p.element_size()
    assert port["argument_bytes"] - ref["argument_bytes"] == unread


def _reference_record_keys():
    """The keys of an applicable cell's costed record in the reference's
    ``run_cell``, read from its source (the test never imports it)."""
    tree = ast.parse((REPO / "src" / "repro" / "launch" / "dryrun.py")
                     .read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
            if "arch" in names or "costing_extrapolated" in names:
                keys |= names
    return keys


def test_schema_is_the_reference(both):
    ref, port = both
    assert dryrun.SHAPE_TUNING == ref["shape_tuning"]
    for arch in dryrun.ARCH_IDS:
        assert dryrun._layer_unit(get_config(arch)) == ref["layer_unit"][arch]
        for s in SHAPES_BY_NAME:
            want = ref_applicable(ref_config(arch), SHAPES_BY_NAME[s])
            assert list(cell_is_applicable(get_config(arch),
                                           dryrun.SHAPES_BY_NAME[s])) == \
                ref["applicable"][f"{arch}/{s}"] == list(want)
    record = port["record"]
    assert record["status"] == "ok", record
    assert set(record) == _reference_record_keys()
    assert set(record["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_estimate_bytes"}
    rf = record["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert rf[term] > 0
    assert record["n_devices"] == 256 and record["costing_extrapolated"]


def test_the_test_process_holds_no_dry_run_state(both):
    assert "repro.launch.dryrun" not in sys.modules
    assert not (torch.distributed.is_available()
                and torch.distributed.is_initialized())
