"""Serve launcher: prefill + greedy decode of a batch of seeded random
prompts on seeded random weights, or, with ``--sched-status``, a
fleet-status HTTP endpoint serving the scheduler's telemetry for a
simulated schedule (Prometheus ``/metrics``, Perfetto ``/trace.json``,
``/healthz``); the port of ``src/repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --smoke --batch 4 --prompt-len 16 --gen 24 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --sched-status \\
      --port 9090 --policy omfs --tenants 4 --chips 64 --horizon 300 \\
      [--backend torch|python] [--device cpu] [--max-requests 3]

``--sched-status`` takes the reference's flags and defaults, with
``--backend torch`` (the default; the reference's ``jax``) on ``--device``
or ``python``; the schedule is simulated once and every endpoint's body
is built before the first request, so a scrape reads memory.  ``--arch``
is required without it.

Runs on the card unless ``--device cpu`` is given, and raises without
CUDA.  Every arch of ``configs/`` serves: the dense GQA family
(internlm2-1.8b, glm4-9b, mistral-nemo-12b), minicpm3-4b (MLA), the MoE
family (deepseek-moe-16b, whose 67.5 GB of fp32 master weights fit one 80
GB card, and dbrx-132b, whose 528 GB of fp32 weights no one card holds:
this one-device launcher serves it at its smoke size, and its experts
shard over ranks only under a mesh, through `distributed.moe_ep`), the
hybrid hymba-1.5b, xlstm-350m, llama-3.2-vision-11b and whisper-base.  The
VLM's and the audio model's frontends are stubs, as in the reference: zero
patch or frame embeddings (`models.model.frontend_stub`), unless a caller
of `generate` passes its own.  No trained weights are in the repository,
so the generated ids are meaningless; the path and its sizes are the real
ones.  Prints the reference's lines: the run, prefill ms and tok/s, decode
ms and tok/s, and the first generated row.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.omfs_torch import resolve_device
from repro_torch.models.model import Model, resolve_frontend


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
             cache_dtype=torch.bfloat16, frontend=None) -> ServeResult:
    """Prefill ``tokens`` [B, S], then ``gen - 1`` greedy decode steps.
    The VLM and the audio model read ``frontend`` (patch or frame
    embeddings on the tokens' device), by default `frontend_stub`'s
    zeros; the other families take none."""
    b, t = tokens.shape
    dev = tokens.device
    batch = {"tokens": tokens}
    frontend = resolve_frontend(model.cfg, frontend, b, dev)
    if frontend is not None:
        batch["frontend"] = frontend
    cache = model.init_cache(b, t + gen, dtype=cache_dtype)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = model.prefill(batch, cache)
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


def sched_status_payloads(args) -> dict:
    """Simulate the configured fleet once, with lifecycle events, and build
    every endpoint's body: ``{path: (content_type, bytes)}``."""
    from repro_torch.core import engine
    from repro_torch.core.metrics import event_summary
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.core.workload import WorkloadSpec, make_jobs, make_users
    from repro_torch.obs import registry_from_result, trace_from_result

    spec = WorkloadSpec(n_users=args.tenants, horizon=args.horizon,
                        cpu_total=args.chips, seed=args.seed,
                        arrival_rate=args.arrival_rate)
    users = make_users(spec)
    jobs = make_jobs(spec, users)
    cfg = SchedulerConfig(cpu_total=args.chips, quantum=args.quantum,
                          cr_overhead=2)
    res = engine.simulate(users, jobs, cfg, args.horizon, policy=args.policy,
                          backend=args.backend, device=args.device,
                          record_events=True)
    reg = registry_from_result(res, users=users)
    trace = trace_from_result(res, users=users)
    health = {"status": "ok", "policy": args.policy, "backend": args.backend,
              "horizon": args.horizon, "events": len(res.events),
              "events_dropped": res.events_dropped_total(),
              "summary": event_summary(res.events)}
    return {
        "/metrics": ("text/plain; version=0.0.4",
                     reg.to_prometheus().encode()),
        "/trace.json": ("application/json", json.dumps(trace).encode()),
        "/healthz": ("application/json", json.dumps(health).encode()),
    }


def sched_status_server(args, payloads: dict) -> ThreadingHTTPServer:
    """An HTTP server on ``(args.host, args.port)`` (port 0: any free one)
    that answers GET from ``payloads`` and 404 elsewhere."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            hit = payloads.get(self.path.split("?", 1)[0])
            if hit is None:
                self.send_error(404, explain=f"known: {sorted(payloads)}")
                return
            ctype, body = hit
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):   # no line per scrape
            pass

    return ThreadingHTTPServer((args.host, args.port), Handler)


def serve_sched_status(args, server: ThreadingHTTPServer = None) -> int:
    """Serve the scheduler-status payloads: ``args.max_requests`` requests,
    or until interrupted when it is 0.  ``server`` is one that
    `sched_status_server` built (a caller that must know its port before
    the first request); by default one is built on ``args``."""
    if server is None:
        server = sched_status_server(args, sched_status_payloads(args))
    host, port = server.server_address[:2]
    print(f"sched-status on http://{host}:{port}")
    try:
        if args.max_requests > 0:
            for _ in range(args.max_requests):
                server.handle_request()
        else:
            server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # the scheduler's fleet status (repro_torch.obs telemetry over HTTP)
    ap.add_argument("--sched-status", action="store_true",
                    help="serve scheduler telemetry for a simulated fleet "
                         "instead of running a model")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9090)
    ap.add_argument("--policy", default="omfs")
    ap.add_argument("--backend", default="torch", choices=["torch", "python"])
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--chips", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=300)
    ap.add_argument("--quantum", type=int, default=10)
    ap.add_argument("--arrival-rate", type=float, default=0.08)
    ap.add_argument("--max-requests", type=int, default=0,
                    help="serve N requests then exit (0 = forever)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.sched_status:
        return serve_sched_status(args)
    if args.arch is None:
        ap.error("--arch is required unless --sched-status is given")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build(cfg, args.seed, dev)
    tokens = prompts(cfg, args.batch, args.prompt_len, args.seed + 1, dev)
    res = generate(model, tokens, args.gen)
    report(res, args.batch, args.prompt_len, args.gen)
    return res


if __name__ == "__main__":
    main()
