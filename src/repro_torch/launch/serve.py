"""Serve launcher: prefill + greedy decode of a batch of seeded random
prompts on seeded random weights (the port of the model path of
``src/repro/launch/serve.py``; ``--sched-status`` is ROADMAP slice 6).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --smoke --batch 4 --prompt-len 16 --gen 24 [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without
CUDA.  Seven archs are ported: the dense GQA family (internlm2-1.8b,
glm4-9b, mistral-nemo-12b), the MoE family (deepseek-moe-16b, whose 67.5
GB of fp32 master weights fit one 80 GB card, and dbrx-132b, which at its
full size needs the expert-parallel sharding of ROADMAP slice 11 and
serves here at its smoke size), the hybrid hymba-1.5b and xlstm-350m; the
other archs (MLA, VLM, audio) raise ``NotImplementedError`` naming ROADMAP
slice 10.  No trained weights are in the repository, so the generated ids
are meaningless; the path and its sizes are the real ones.  Prints the
reference's lines: the run, prefill ms and tok/s, decode ms and tok/s, and
the first generated row.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.models.model import Model


@dataclass
class ServeResult:
    """One serve run: generated ids [B, gen], wall seconds of the prefill
    and of the gen - 1 decode steps, and the fp32 logits of the prefill and
    of the last step."""

    cfg: ModelConfig
    tokens: torch.Tensor
    prefill_s: float
    decode_s: float
    prefill_logits: torch.Tensor
    last_logits: torch.Tensor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: ModelConfig, seed: int, device) -> Model:
    """The model on ``device``, its weights drawn from a generator seeded
    with ``seed`` on that device."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    return model.init(torch.Generator(device=dev).manual_seed(seed))


def prompts(cfg: ModelConfig, batch: int, length: int, seed: int,
            device) -> torch.Tensor:
    """Seeded random prompt ids [batch, length], int32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, length), generator=gen,
                         device=dev, dtype=torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next ids [B, 1] from logits [B, T, V]."""
    return logits[:, -1].argmax(-1)[:, None].to(torch.int32)


def generate(model: Model, tokens: torch.Tensor, gen: int,
             cache_dtype=torch.bfloat16) -> ServeResult:
    """Prefill ``tokens`` [B, S], then ``gen - 1`` greedy decode steps."""
    b, t = tokens.shape
    dev = tokens.device
    cache = model.init_cache(b, t + gen, dtype=cache_dtype)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = model.prefill({"tokens": tokens}, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = greedy(logits)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        cache, logits = model.decode_step(cache, tok)
        tok = greedy(logits)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(model.cfg, torch.cat(out, dim=1), prefill_s, decode_s,
                       prefill_logits, logits)


def report(res: ServeResult, batch: int, prompt_len: int, gen: int) -> None:
    print(f"arch={res.cfg.name} batch={batch} prompt={prompt_len} gen={gen}")
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms "
          f"({batch * prompt_len / res.prefill_s:.0f} tok/s)")
    print(f"decode : {res.decode_s * 1e3:.1f} ms "
          f"({batch * (gen - 1) / max(res.decode_s, 1e-9):.0f} tok/s)")
    print("sample generation row 0:", res.tokens[0].tolist())


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build(cfg, args.seed, dev)
    tokens = prompts(cfg, args.batch, args.prompt_len, args.seed + 1, dev)
    res = generate(model, tokens, args.gen)
    report(res, args.batch, args.prompt_len, args.gen)
    return res


if __name__ == "__main__":
    main()
