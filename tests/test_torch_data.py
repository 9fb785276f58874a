"""The port's data pipeline (`repro_torch.data.pipeline`): the twins of
``tests/test_data.py``'s five cases, batches bit-identical to the
reference's `SyntheticLM`, and `shard_batch`'s device contract."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    SyntheticLM,
    shard_batch,
)


def test_batch_at_is_pure_function_of_cursor():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=4, seed=3)
    a = SyntheticLM(cfg)
    b = SyntheticLM(cfg)
    for cur in (0, 5, 1000):
        ba, bb = a.batch_at(cur), b.batch_at(cur)
        assert (ba["tokens"] == bb["tokens"]).all()
        assert (ba["labels"] == bb["labels"]).all()


def test_labels_are_next_tokens():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=2, seed=0)
    b = SyntheticLM(cfg).batch_at(0)
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()


def test_resume_mid_stream_is_identical():
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=2, seed=1)
    ds = SyntheticLM(cfg)
    full = [b["tokens"] for (_, b), _ in zip(ds.iterator(0), range(6))]
    resumed = [b["tokens"] for (_, b), _ in zip(ds.iterator(3), range(3))]
    for x, y in zip(full[3:], resumed):
        assert (x == y).all()


def test_different_cursors_differ_and_tokens_in_range():
    cfg = DataConfig(vocab=100, seq_len=128, global_batch=2, seed=1)
    ds = SyntheticLM(cfg)
    b0, b1 = ds.batch_at(0), ds.batch_at(1)
    assert not (b0["tokens"] == b1["tokens"]).all()
    for b in (b0, b1):
        assert b["tokens"].dtype == np.int32
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 100


def test_stream_has_learnable_structure():
    cfg = DataConfig(vocab=64, seq_len=256, global_batch=8, seed=0,
                     n_patterns=16, pattern_len=8)
    b = SyntheticLM(cfg).batch_at(0)
    toks = b["tokens"].reshape(-1)
    pairs = toks[:-1] * 64 + toks[1:]
    counts = np.bincount(pairs, minlength=64 * 64).astype(np.float64)
    p = counts / counts.sum()
    entropy = -(p[p > 0] * np.log(p[p > 0])).sum()
    assert entropy < 0.8 * np.log(64 * 64)   # far from uniform bigrams


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_batches_bit_identical_to_reference(seed):
    kw = dict(vocab=92544 if seed == 7 else 128, seq_len=48, global_batch=3,
              seed=seed)
    ours, ref = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for cursor in (0, 1, 2, 37, 10**6):
        a, b = ours.batch_at(cursor), ref.batch_at(cursor)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_shard_batch_puts_int32_tensors_on_the_device_asked():
    b = SyntheticLM(DataConfig(vocab=64, seq_len=16, global_batch=2)
                    ).batch_at(3)
    out = shard_batch(b, "cpu")
    for k, v in b.items():
        assert out[k].dtype == torch.int32 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)
    # a copy: the tensors do not alias the host batch
    b["tokens"][0, 0] += 1
    assert out["tokens"][0, 0] != b["tokens"][0, 0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            shard_batch(b)
