"""Seeded host-read violations in a models/ module: every function is a
context (exact lines asserted by tests/test_torch_analysis.py)."""
import torch


def capacity(n_tokens: int, counts: torch.Tensor) -> int:
    if n_tokens <= 64:
        return n_tokens
    return int(counts.max())                   # line 9: int()


def decode_step(cfg, x, positions: torch.Tensor):
    h = x @ x.T
    if positions.max() > cfg.window:           # line 14: if on a tensor
        h = h * 2
    scale = 1.0 if h.sum() > 0 else 2.0        # line 16: conditional expr
    return h * scale


def shapes_only(x, mode: str):
    b, s = x.shape[:2]
    if mode == "decode" and s > 1:
        return x[:, -1:]
    return x.reshape(b * s, -1)
