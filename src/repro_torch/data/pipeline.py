"""Deterministic, resumable synthetic LM data pipeline (the twin of
``src/repro/data/pipeline.py``).

Transparent C/R requires the data stream to be a pure function of
``(seed, cursor)``: restoring a checkpoint's cursor and re-entering the
loop reproduces the exact token stream a never-preempted run would have
seen.  `SyntheticLM` is numpy, copied from the reference as it stands, so
both packages draw bit-identical batches; only `shard_batch` differs: it
puts a host batch on an explicit torch device.

The synthetic corpus is a Zipf-ish Markov token stream with enough
structure for a small model to show a decreasing loss curve (pure noise
would pin the loss at log V).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.omfs_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic-structure knobs
    n_patterns: int = 512          # distinct repeated motifs
    pattern_len: int = 16
    zipf_a: float = 1.3


class SyntheticLM:
    """Batch factory: ``batch_at(cursor)`` is a pure function of cursor."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # motif table: patterns of tokens the stream stitches together
        self._patterns = base.integers(
            0, cfg.vocab, size=(cfg.n_patterns, cfg.pattern_len), dtype=np.int32)
        ranks = np.arange(1, cfg.n_patterns + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._pattern_p = p / p.sum()

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        """The ``cursor``-th global batch: {tokens, labels} [B, S] int32."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ int(cursor))
        n_motifs = cfg.seq_len // cfg.pattern_len + 2
        idx = rng.choice(
            cfg.n_patterns, size=(cfg.global_batch, n_motifs), p=self._pattern_p)
        stream = self._patterns[idx].reshape(cfg.global_batch, -1)
        # light noise so the mapping isn't trivially memorizable
        noise_mask = rng.random(stream.shape) < 0.05
        noise = rng.integers(0, cfg.vocab, size=stream.shape, dtype=np.int32)
        stream = np.where(noise_mask, noise, stream)
        tokens = stream[:, : cfg.seq_len]
        labels = stream[:, 1 : cfg.seq_len + 1]
        return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    def iterator(self, start_cursor: int = 0) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        cursor = start_cursor
        while True:
            yield cursor, self.batch_at(cursor)
            cursor += 1


def shard_batch(batch: Dict[str, np.ndarray],
                device="cuda") -> Dict[str, torch.Tensor]:
    """Host batch -> int32 tensors on ``device`` (``"cuda"`` unless the
    caller asks for the CPU).  On the card each array goes through pinned
    memory with a non-blocking copy, so that feeding a step costs the host
    no wait on the card."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        host = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
        if dev.type == "cuda":
            out[k] = host.pin_memory().to(dev, non_blocking=True)
        else:
            out[k] = host.to(dev, copy=True)
    return out
