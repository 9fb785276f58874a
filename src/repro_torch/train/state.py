"""TrainState: everything a transparent checkpoint must capture (the twin of
``src/repro/train/state.py``).

The paper's "transparent C/R" maps to ``(params, opt, rng, data_cursor)``
with ``opt = (step, m, v)``: restoring this tuple and re-entering the train
loop is bitwise the same as never having been preempted.  ``params`` is a
`models.model.Model`'s own parameter tree (``Model.params()``), so a train
step that updates it in place updates the model; ``step`` is an int32
scalar and ``rng`` the reference's ``[2]`` uint32 PRNG key, both on the
parameters' device; ``data_cursor`` is an int32 scalar **on the host**: the
host data pipeline reads it every step, and a cursor on the card would
cost a host sync per step.  `serialize.leaf_paths` names the leaves
exactly as ``jax.tree_util.keystr`` names the reference's, so a
checkpoint written by either package restores in the other.

The key is ``jax.random.PRNGKey(seed)`` and each step folds it with
``fold_in(rng, 1)``; both are threefry-2x32 as JAX computes it, in int64
arithmetic masked to 32 bits (torch has no uint32 arithmetic), bit for
bit with ``jax.random``.  ``dense_state_template`` is the shape table of a
dense GQA transformer's state at given widths, as ``device="meta"``
tensors (the twin of ``eval_shape``).
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
    data_cursor: Any  # [] int32 cursor into the data stream (host)

    @property
    def step(self):
        return self.opt.step


# ---------------------------------------------------------------------------
# The PRNG key: threefry-2x32, as jax.random computes it
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry_2x32(k0, k1, x0, x1):
    """The threefry-2x32 block (20 rounds) over int64 tensors that hold
    uint32 values; returns the two output words, masked to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the [2] uint32 key ``[seed >> 32,
    seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    words = torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                         dtype=torch.int64)
    return words.to(torch.uint32).to(device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a [2] uint32 key, on the key's
    device: threefry-2x32 of the counter ``[0, data]`` under the key."""
    k = key.to(torch.int64)
    x0 = torch.zeros((), dtype=torch.int64, device=key.device)
    x1 = torch.full((), int(data) & _MASK, dtype=torch.int64,
                    device=key.device)
    y0, y1 = threefry_2x32(k[0], k[1], x0, x1)
    return torch.stack([y0, y1]).to(torch.uint32)


# ---------------------------------------------------------------------------
# Building a state
# ---------------------------------------------------------------------------


def init_train_state(params, seed: int = 0) -> TrainState:
    """A fresh state over ``params`` (a model's ``params()`` tree): zero
    moments, step 0, ``PRNGKey(seed)``, cursor 0."""
    from repro_torch.optim import adamw

    opt = adamw.init(params)
    return TrainState(params=params, opt=opt,
                      rng=prng_key(seed, opt.step.device),
                      data_cursor=torch.zeros((), dtype=torch.int32))


def bind_state(model, state: TrainState) -> TrainState:
    """A restored state (its leaves on the model's device) made the
    model's: the restored parameters become the model's own tensors
    (``Model.adopt``, no copy) and the cursor moves to the host (a meta
    cursor, a shape table's, stays meta)."""
    model.adopt(state.params)
    cursor = state.data_cursor
    return TrainState(params=model.params(), opt=state.opt, rng=state.rng,
                      data_cursor=cursor if cursor.is_meta else cursor.cpu())


def train_state_shapes(model, seed: int = 0) -> TrainState:
    """The state's shape table as ``device="meta"`` tensors (the twin of
    ``jax.eval_shape``): no allocation."""
    del seed  # the key's shape does not depend on it

    def meta(tree, dtype=None):
        return {k: (meta(v, dtype) if isinstance(v, dict) else torch.empty(
            v.shape, dtype=dtype or v.dtype, device="meta"))
            for k, v in tree.items()}

    params = model.params()
    return TrainState(
        params=meta(params),
        opt=AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                       m=meta(params, torch.float32),
                       v=meta(params, torch.float32)),
        rng=torch.empty(2, dtype=torch.uint32, device="meta"),
        data_cursor=torch.empty((), dtype=torch.int32, device="meta"))


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
