"""TrainState: everything a transparent checkpoint must capture (the twin of
``src/repro/train/state.py``'s structure).

The port cannot train yet (the model and optimizer are a later slice), so
this module holds only the state's shape: ``(params, opt, rng,
data_cursor)`` with ``opt = (step, m, v)``, and the shape table of a dense
GQA transformer's state as the reference's ``train_state_shapes`` gives it
(fp32 master weights and AdamW moments, int32 step and cursor, a uint32
PRNG key), as a tree of ``device="meta"`` tensors.  Checkpoint code and
measurements fill it; `serialize.leaf_paths` names its leaves exactly as
``jax.tree_util.keystr`` names the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: Any         # [] int32
    m: Any            # tree like params, fp32
    v: Any            # tree like params, fp32


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    rng: Any          # [2] uint32 PRNG key
    data_cursor: Any  # [] int32 cursor into the data stream


#: the published widths of internlm2-1.8b (src/repro/configs/internlm2_1_8b.py)
INTERNLM2_1_8B = dict(n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
                      d_ff=8192, vocab=92544)


def dense_state_template(*, n_layers: int, d_model: int, n_heads: int,
                         n_kv_heads: int, d_ff: int, vocab: int) -> TrainState:
    """The TrainState of a dense GQA transformer with SwiGLU FFN, untied
    embeddings and stacked layers, as ``device="meta"`` tensors."""
    hd = d_model // n_heads

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def params():
        blocks = {
            "attn": {"w_k": t(n_layers, d_model, n_kv_heads * hd),
                     "w_o": t(n_layers, n_heads * hd, d_model),
                     "w_q": t(n_layers, d_model, n_heads * hd),
                     "w_v": t(n_layers, d_model, n_kv_heads * hd)},
            "ffn": {"w_down": t(n_layers, d_ff, d_model),
                    "w_gate": t(n_layers, d_model, d_ff),
                    "w_up": t(n_layers, d_model, d_ff)},
            "norm_attn": t(n_layers, d_model),
            "norm_ffn": t(n_layers, d_model),
        }
        return {"blocks": blocks, "embed": t(vocab, d_model),
                "norm_f": t(d_model), "unembed": t(d_model, vocab)}

    return TrainState(
        params=params(),
        opt=AdamWState(step=t(dtype=torch.int32), m=params(), v=params()),
        rng=t(2, dtype=torch.uint32),
        data_cursor=t(dtype=torch.int32))
