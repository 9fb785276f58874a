"""Train launcher: one device, full C/R (the port of
``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 50 --ckpt-dir build/ck [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 20 --resume --ckpt-dir build/ck   # transparent restart

The reference's flags, plus ``--device cuda|cpu`` (the card unless the CPU
is asked for; raises without CUDA) and ``--fast-tier-gib`` (the host
memory the checkpoint manager's fast tier may hold, default 4 as
``ManagerConfig``'s; a full-width internlm2-1.8b state is 21.11 GiB).  The
attention chunks are the model's default, 1,024 (the reference's launcher
takes 64: the chunk changes only the order of the softmax sums, and a
chunk of 64 at 2,048 tokens is a thousand small launches per layer on the
card).  Every arch of ``configs/`` trains: the dense (internlm2-1.8b,
glm4-9b, mistral-nemo-12b), MLA (minicpm3-4b), MoE (deepseek-moe-16b,
dbrx-132b), hybrid (hymba-1.5b), xLSTM (xlstm-350m), VLM
(llama-3.2-vision-11b) and audio (whisper-base) families, and no kernel
of the port runs in a step.  The VLM's and the audio model's frontends
are stubs, as in the reference: every step feeds zero patch or frame
embeddings (`models.model.frontend_stub`), unless a caller of `run`
passes its own ``frontend``.  Gradient compression
(`optim.compression`) is not called, as in the reference, so there is no
flag for it.

`run` is the loop, with its periodic fast-tier checkpoints; it returns a
`TrainRun` record (per-step losses, grad norms and wall seconds, the
model, the final state, the checkpoint manager, the step function and the
data).  A caller may pass the model config to `run` (the arch cut to a
depth that fits, say); the command line has no flag for it, as the
reference's has none.  ``main`` runs it, then writes the durable
checkpoint of the final state and closes the manager.  `step_once` is the
loop's body, one step of a record: each step reads its metrics back to the
host once, as one stacked tensor, which is the step's one host sync and
closes its wall time (an MoE layer adds its capacity read,
``models.moe.HOST_READS``).  ``__main__`` sets ``CUBLAS_WORKSPACE_CONFIG``
before any CUDA work, as the deterministic train step needs on the card.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, ManagerConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
from repro_torch.models.model import Model, resolve_frontend
from repro_torch.train.state import (
    TrainState,
    bind_state,
    init_train_state,
    train_state_shapes,
)
from repro_torch.train.steps import (
    CUBLAS_WORKSPACE_CONFIG,
    TrainConfig,
    make_train_step,
)


@dataclass
class TrainRun:
    """One launcher run: the per-step records of this run's steps, and what
    a caller needs to go on from its end."""

    cfg: ModelConfig
    model: Model
    state: TrainState
    mgr: CheckpointManager
    step_fn: Callable
    data: SyntheticLM
    device: torch.device
    start_step: int
    resumed_from: Optional[str] = None
    #: the VLM's or the audio model's frontend, fed to every step
    frontend: Optional[torch.Tensor] = None
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=Path,
                    default=Path(tempfile.gettempdir()) / "repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fast-tier-gib", type=float, default=4.0)
    return ap


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
        frontend: Optional[torch.Tensor] = None) -> TrainRun:
    """The training loop of ``args``; ``cfg`` replaces the arch's config
    (its published or ``--smoke`` one) where given, and ``frontend`` (on
    the run's device, ``args.batch`` rows) the VLM's or the audio model's
    stub frontend."""
    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    dev = resolve_device(args.device)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=10, total_steps=10_000,
                       grad_accum=args.grad_accum)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    mgr = CheckpointManager(ManagerConfig(
        root=args.ckpt_dir / args.arch, durable_every=2,
        mem_capacity_bytes=int(args.fast_tier_gib * 2**30)))

    resumed_from = None
    if args.resume and mgr.latest_step() is not None:
        model = Model(cfg, device="meta")
        state, resumed_from = mgr.restore(
            train_state_shapes(model, args.seed), device=dev)
        state = bind_state(model, state)
        print(f"resumed from {resumed_from} (step {int(state.step)})")
    else:
        model = Model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        state = init_train_state(model.params(), args.seed)
        print("cold start")
    step_fn = make_train_step(model, tcfg)
    frontend = resolve_frontend(cfg, frontend, args.batch, dev)
    rec = TrainRun(cfg=cfg, model=model, state=state, mgr=mgr,
                   step_fn=step_fn, data=data, device=dev,
                   start_step=int(state.step), resumed_from=resumed_from,
                   frontend=frontend)

    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        step, loss, gnorm, lr = step_once(rec)
        rec.step_seconds.append(time.perf_counter() - ts)
        rec.losses.append(loss)
        rec.grad_norms.append(gnorm)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {int(step):5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr:.2e}")
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            print(f"checkpointed {mgr.save(int(step), rec.state)}")
    seconds = time.perf_counter() - t0
    tokens = (int(rec.state.step) - rec.start_step) * args.seq * args.batch
    print(f"done: {tokens} tokens in {seconds:.1f}s "
          f"({tokens / seconds:.0f} tok/s)")
    return rec


def step_once(rec: TrainRun) -> List[float]:
    """One step of the run: the batch at the state's cursor, the train
    step (``rec.state`` becomes the new state), and its ``[step, loss,
    grad_norm, lr]`` read back to the host in one sync."""
    batch = shard_batch(rec.data.batch_at(int(rec.state.data_cursor)),
                        rec.device)
    if rec.frontend is not None:
        batch["frontend"] = rec.frontend
    rec.state, metrics = rec.step_fn(rec.state, batch)
    return torch.stack([metrics["step"], metrics["loss"],
                        metrics["grad_norm"], metrics["lr"]]).tolist()


def main(argv=None) -> TrainRun:
    rec = run(parser().parse_args(argv))
    rec.mgr.save(int(rec.state.step), rec.state, durable=True)
    rec.mgr.close()
    return rec


if __name__ == "__main__":
    # cuBLAS reads it at its first call, which must not precede it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
    main()
