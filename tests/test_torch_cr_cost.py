"""`repro_torch.launch.cr_cost.measure` against the JAX reference: on two
consecutive smoke TrainStates carried across to the port, its byte rows
equal what the reference's calls in ``benchmarks/bench_cr_cost.py``
give on the same states (state bytes, disk raw and zstd bytes, the delta's
bytes and delta fraction, the int8 codec's bytes).  No timings are
compared."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint.reshard import save_global as jsave_global  # noqa: E402
from repro.checkpoint.tiers import DiskTier as JDiskTier  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core.crcost import state_mib_of  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM, shard_batch  # noqa: E402
from repro.kernels.ckpt_codec.ops import quantize_array  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.train.state import init_train_state  # noqa: E402
from repro.train.steps import TrainConfig, make_train_step  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core.crcost import CRCostModel, TieredCRCostModel  # noqa: E402
from repro_torch.kernels.ckpt_codec import ops as codec_ops  # noqa: E402
from repro_torch.launch import cr_cost  # noqa: E402


@pytest.fixture(scope="module")
def snapshots():
    """bench_cr_cost.py's smoke job (d_model 128, 2 layers, vocab 4096)
    after its two train steps: the (prev, cur) pair it measures."""
    cfg = get_smoke_config("internlm2-1.8b").replace(
        d_ff=256, n_layers=2, d_model=128, vocab=4096)
    model = build_model(cfg, q_chunk=64, kv_chunk=64)
    state = init_train_state(model.init(jax.random.PRNGKey(0)))
    step = jax.jit(make_train_step(model, TrainConfig()))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    states = []
    for i in range(2):
        state, _ = step(state, shard_batch(data.batch_at(i)))
        states.append(jax.tree.map(lambda a: a.copy(), state))
    return states


@pytest.fixture(scope="module")
def rows(snapshots, tmp_path_factory):
    prev, cur = (convert.tree_from_reference(s, device="cpu")
                 for s in snapshots)
    return cr_cost.measure(prev, cur, tick_seconds=0.1,
                           root=tmp_path_factory.mktemp("cr"), device="cpu")


def test_byte_rows_equal_reference(snapshots, rows, tmp_path):
    prev, cur = (jsave_global(s) for s in snapshots)
    total = sum(a.nbytes for a in cur.values())
    assert rows["state_bytes_raw"] == total
    for name, level in (("disk_raw", None), ("disk_zstd", 3)):
        tier = JDiskTier(tmp_path / name, compress=level)
        tier.save_leaves("s", cur)
        assert rows[f"{name}_bytes"] == tier.stats.bytes_written
    blobs, sizes = jdelta.encode_snapshot(cur, prev)
    assert rows["delta_zstd_bytes"] == sum(sizes.values())
    assert rows["delta_frac"] == np.mean([b.is_delta for b in blobs.values()])
    q_bytes = 0
    for a in cur.values():
        if a.dtype == np.float32 and a.size >= 128:
            q, s = quantize_array(jnp.asarray(a), interpret=True)
            q_bytes += q.size + s.size * 4
        else:
            q_bytes += a.nbytes
    assert rows["int8_quant_bytes"] == q_bytes
    assert rows["state_mib"] == state_mib_of(total)
    assert rows["compressor"] == ("zstd" if jdelta.zstd is not None
                                  else "zlib")


def test_restore_and_calibration_rows(rows):
    assert rows["restore_bit_equal"] is True
    assert 0 < rows["int8_roundtrip_error"] < 1e-2
    model, tiered = rows["cost_model"], rows["tiered_cost_model"]
    assert isinstance(model, CRCostModel)
    assert isinstance(tiered, TieredCRCostModel) and tiered.n_tiers == 2
    assert rows["model_save_mib_per_tick"] == model.save_mib_per_tick > 0
    assert rows["model_restore_mib_per_tick"] == \
        model.restore_mib_per_tick > 0
    assert rows["model_save_ticks"] == model.save_cost(rows["state_mib"])
    assert rows["model_restore_ticks"] == \
        model.restore_cost(rows["state_mib"])


def test_measure_runs_the_codec_plain_on_cpu_and_needs_cuda_by_default(
        snapshots, rows, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # `rows` came from CPU tensors: the plain codec, no kernel launch
    assert codec_ops.LAUNCHES == {"quantize": 0, "dequantize": 0}
    prev, cur = (convert.tree_from_reference(s, device="cpu")
                 for s in snapshots)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cr_cost.measure(prev, cur, tick_seconds=0.1, root=tmp_path)
