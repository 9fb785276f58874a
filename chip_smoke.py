"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source,
all started together), holds each against its plain PyTorch version on the
card, and drives the port's paths.  flash attention and the grouped expert
matmul each have two kernels: a tensor-core one (TMA, mbarriers, wgmma;
bf16) that the bf16 serving paths take, and a SIMT one that keeps fp32
(the depth-2 `-vs-cpu` comparisons) and every other shape; both are held
against the plain version and timed beside it in one run.

* the tick engine (`repro_torch.core.engine.simulate`) on a 100k-job,
  16,384-CPU fleet with a T=4 checkpoint hierarchy, 50 ticks, for all seven
  policies: OMFS, its cheap-victim variant and the five baselines (hard
  division, capping, FCFS, backfill and backfill with C/R preemption).
  The three that plan evictions (the OMFS pair and backfill_cr) must go
  through the `sched_select` kernel, once per plan, and every policy must
  match the eager "torch" backend column for column; one plan must be one
  or two device events and make no host sync; each policy's host syncs
  under torch.cuda's sync debug mode must be the ones its `PassStats`
  counts; `simulate_matrix` over the seven must equal the per-policy runs;
  the port's analyzer (``python -m repro_torch.analysis --device cuda``)
  must pass every rule, and its three dispatch rules on CUDA tables must
  see each plan launch `sched_select` once per eviction branch and every
  host sync counted;
  then lifecycle-event capture: all seven policies on the launcher's
  fleet (cut to 80 ticks) on the card against the Python backend's
  EventBus, an undersized ring's drops, and omfs with capture on the
  100k-job fleet (its table unchanged, the capture's device share); then
  the batch and stream engines: the batched `sched_select` launch bit for
  bit against its plain version on random and edge cells stacked over
  B = 1, 7 and 256, the fleet as one `simulate_batch` of the seven
  policies (each cell equal to its `simulate`, the same host syncs and
  plans) and one of omfs at four quanta (one group: 32 host syncs a tick
  for the four), that batch's four-cell plan timed beside four single
  launches, [events]'s fleet as one batch with capture (each log
  [events]'s), `benchmarks/bench_sweep.py`'s grid on one seed (128
  cells) as one batch against 128 sequential runs (16 host syncs a tick),
  and omfs on the
  fleet's arrivals through `simulate_stream` at a capacity sized from a
  first run's live peak, equal to the monolithic run with no deferral;
  then the launcher, also with ``--events --trace-out --metrics-out`` and
  with ``--backend torch`` (on the card) against ``--backend python`` (one
  schedule); and ``launch.serve --sched-status``, whose payloads built on
  the card (through `sched_select`) equal the host reference's and are
  served over a socket on 127.0.0.1;
* training and checkpoint-restart: the int8 `ckpt_codec` kernels bit for
  bit against their plain versions; one train step of internlm2-1.8b at
  its published widths, cut to depth 2, on the card against the CPU from
  one seeded init (fp32 and bf16 compute); `repro_torch.launch.train` on
  internlm2-1.8b at its published widths cut to 12 of its 24 layers
  (fp32 master weights, bf16 compute), batch 4 x 2,048 tokens, 10 steps,
  then 2 steps rerun from its fast-tier snapshot bit for bit, its host
  syncs and its device busy share; the codec over that trained state;
  the cluster executor, OMFS preempting real training jobs (the
  transparency scenario of tests/test_e2e_train.py on the card, then two
  full-width internlm2-1.8b jobs at that depth, the larger evicted,
  checkpointed and restored once, its losses bit-equal to the launcher's
  uninterrupted run, one job's state resident at a time); a
  `CheckpointService` fast-tier save/save/restore cycle at depth 1 (4.94
  GiB) around a real train step;
  and `repro_torch.launch.cr_cost.measure` on two trained snapshots of the
  job that `benchmarks/bench_cr_cost.py` measures, whose calibrated cost
  lattice then prices the launcher's default fleet on both backends;
  then the other families' training: one step card against CPU for
  deepseek-moe-16b, hymba-1.5b and xlstm-350m at published widths, depth
  2 (fp32); `repro_torch.launch.train` on deepseek-moe-16b cut to depth 2
  (batch 4 x 2,048), on hymba-1.5b cut to 16 of its 32 layers and on
  xlstm-350m cut to 4 of its 24 (the per-token loops), rows of 512
  tokens, each with a
  bit-equal rerun from its snapshot, 0 kernel launches, its host syncs,
  its profile and, for the recurrent two, the per-token loop's share of a
  step; and the executor preempting the deepseek job, bit-equal to the
  launcher's run;
* serving: the flash-attention kernel against its plain version on every
  shape of the reference's kernel tests and on one layer at the serving
  shape, and timed there beside the SDPA library call; the serve path at
  the full widths and depth 2 on the card against the CPU (fp32); then
  `repro_torch.launch.serve` on the full 24-layer internlm2-1.8b (seeded
  random fp32 weights, bf16 compute), batch 4, prompt 2,048, 32 generated
  tokens, which must launch the kernel once per layer of the prefill, one
  prefill under torch.cuda's sync debug mode (its host syncs), and one
  prefill and one decode step under torch.profiler;
* the recurrent families: the `ssm_scan` and `mlstm_scan` kernels against
  their plain versions on the reference's kernel-test shapes and at the
  serving shapes (the mLSTM also from a carried state, and at S = 1),
  timed there beside their bounds; hymba-1.5b and
  xlstm-350m at the full widths and depth 2 on the card against the CPU
  (fp32); then `repro_torch.launch.serve` on the full 32-layer hymba-1.5b
  (32 flash and 32 `ssm_scan` launches per prefill, 32 `ssm_scan` per
  decode step) and xlstm-350m cut to 12 of its 24 layers (6 `mlstm_scan`
  launches per prefill and 6 per decode step, from the carried state),
  batch 4,
  prompt 2,048, 32 tokens, with the share of xlstm's prefill spent in the
  sLSTM, the host syncs of an xlstm prefill onto a non-empty cache, and
  one prefill and one decode step of each under torch.profiler;
* the MoE family, with every earlier model freed: the `moe_gmm`
  grouped-matmul kernel against its plain version on the reference's
  kernel-test shapes, at deepseek-moe-16b's prefill and decode capacity
  shapes (with per-expert counts and fp32 weights under bf16 x, as the
  path calls it) and on a router that sends every token to the same
  experts, and timed beside `torch.bmm` and its bound; deepseek-moe-16b at
  the full widths and depth 2 on the card against the CPU (fp32, expert
  ids equal outside near ties); then `repro_torch.launch.serve` on the
  full 28-layer deepseek-moe-16b (16.9 B fp32 master weights), batch 4,
  prompt 2,048, 32 tokens (28 flash and 84 `moe_gmm` launches per
  prefill, 84 `moe_gmm` per decode step), and one prefill and one decode
  step under torch.profiler;
* slice 10's families, last, each model freed before the next:
  minicpm3-4b (MLA: Dk 96, Dv 64, the wrapper padding V to 96),
  llama-3.2-vision-11b (32 self layers and 8 gated cross-attention blocks
  over 6,404 patches of a seeded frontend) and whisper-base (a non-causal
  encoder over 1,500 frames, a decoder with cross-attention): at full
  widths and a cut depth on the card against the CPU (fp32, the SIMT
  kernel), then `repro_torch.launch.serve` at published widths and depth,
  batch 4, prompt 2,048 (whisper 416), 32 tokens, every prefill attention
  through the tensor-core flash kernel (62, 40 and 18 launches per
  prefill), its host syncs and its profile.  Earlier, after the other
  families' training, one fp32 train step of each at a cut depth on the
  card against the CPU, and `repro_torch.launch.train` on minicpm3-4b
  (depth 2), the VLM (one group, a 32 GiB fast tier for its 25.8 GB
  state) and the full whisper-base, 2 steps, the second rerun bit for bit
  from a fast-tier snapshot; `[attn-compare]` holds the four new flash
  shapes (and the VLM cross shape a rank of 16 takes in the head_dim
  form: 2 query heads, 1 KV head) and `[attn-time]` times MLA's and the
  VLM cross shape, with the cost of V's padding.
* the dry run (`repro_torch.launch.dryrun`): `[dryrun]` runs it for
  internlm2-1.8b train_4k and deepseek-moe-16b decode_32k on the (16, 16)
  mesh, two processes on the host started beside `[train]` (whose step
  the card bounds) and waited for after it; each record must be ok with
  finite, positive terms (estimates from the datasheet constants).
  `[dryrun-vs-card]`, after `[serve]`, costs `[serve]`'s prefill and
  `[train]`'s step on one rank on meta tensors and holds them against
  the card: `[serve]`'s model runs the same prefill under the same
  `roofline.counting.costing` (matmul and kernel FLOPs equal to the meta
  count), and the prefill's and `[train]`'s peaks must lie within 10% of
  the dry run's estimates. The kernels' bounds (`[attn-time]`,
  `[ssm-time]`, `[mlstm-time]`, `[moe-time]`) come from each kernel
  package's `cost`, the dry run's source too.
* multi-device execution on the one card, last: `[ep-compare]` on a
  one-rank NCCL group; then two gloo processes (`[ep-ranks]`,
  `[shard-serve]`: internlm2-1.8b tensor-parallel with its cache split on
  the sequence) and four more at the same time (`[shard-serve-hd]`:
  glm4-9b cut to 4 layers on a (1, 4) mesh, its 2 KV heads split on
  head_dim; `[shard-train-hd]`: two sharded train steps of internlm2-1.8b
  cut to 2 layers on (2, 2), its loss on each rank's vocab columns (no
  unembedding gathered), each rank's peak against the dry run's
  estimate; `[shard-serve-vlm]`: llama-3.2-vision-11b cut to one group
  of 5 layers on (1, 4), its self layers and gated cross block on each
  rank's 8 query and 2 KV heads, the vision cache on its KV heads) and
  four more again (`[shard-serve-mla]`: minicpm3-4b cut to 2 layers on
  (1, 4), 10 heads a rank through the flash kernel, its latent cache a
  quarter of each width a rank; `[shard-serve-hybrid]`: hymba-1.5b cut
  to 2 layers on (1, 4), its attention on the column blocks of its
  weights (7 touched query heads a rank through the flash kernel, its
  cache a quarter of head_dim), the scan on 800 channels a rank;
  `[shard-serve-mla10]`: minicpm3-4b at 10 heads, 2.5 a rank, on its
  column blocks; no attention weight gathered whole), each held
  against a one-process run; `[batch-devices]`.  `[attn-compare]`,
  `[attn-time]`, `[ssm-compare]` and `[ssm-time]` hold and time the
  flash launches of a rank's 10 MLA heads, of the columns form's 7 and
  3 touched heads, and the scan on 800 channels.

TF32 is off for every comparison (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False below), so fp32
products on the card are full fp32.

The training steps run under ``torch.use_deterministic_algorithms(True)``
(inside `repro_torch.train.steps`); ``CUBLAS_WORKSPACE_CONFIG`` is set to
``:4096:8`` before torch loads, for every phase, and `[env]` prints it.
Every phase prints one line per result (the launchers print their own lines too); any failure
raises.  The last three lines are the card's name and power limit, the
kernels' JSON record and the device record.

Exits non-zero without a result where no CUDA device is visible.
"""
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# cuBLAS reads this at its first call: the deterministic train steps need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is False")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import serialize  # noqa: E402
from repro_torch.checkpoint.manager import ManagerConfig  # noqa: E402
from repro_torch.checkpoint.service import CheckpointService  # noqa: E402
from repro_torch.cluster.executor import (  # noqa: E402
    ClusterExecutor,
    ManagedJob,
    TrainJob,
    small_train_job,
)
from repro_torch.core import engine, omfs_torch  # noqa: E402
from repro_torch.core.crcost import (  # noqa: E402
    UNBOUNDED,
    CRCostModel,
    TieredCRCostModel,
    measured_delta_num,
)
from repro_torch.core.types import (  # noqa: E402
    Job,
    JobClass,
    JobState,
    SchedulerConfig,
    User,
)
from repro_torch.core.workload import (  # noqa: E402
    WorkloadSpec,
    arrival_stream,
    make_jobs,
    make_users,
)
from repro_torch.configs import (  # noqa: E402
    ShapeSpec,
    get_config,
    get_smoke_config,
)
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    SyntheticLM,
    shard_batch,
)
from repro_torch.kernels.ckpt_codec import ops as codec_ops  # noqa: E402
from repro_torch.kernels.ckpt_codec.ref import (  # noqa: E402
    LANE,
    dequantize_array_ref,
    dequantize_ref,
    quantize_array_ref,
    quantize_ref,
)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.cost import (  # noqa: E402
    cost as attn_bound,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    visible as flash_visible,
)
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.cost import (  # noqa: E402
    cost as mlstm_bound,
)
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.cost import cost as gmm_bound  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import (  # noqa: E402
    expert_swiglu_ref,
    grouped_matmul_ref,
    swiglu_gate,
)
from repro_torch.kernels.sched_select import ops as sched_ops  # noqa: E402
from repro_torch.kernels.sched_select.ref import (  # noqa: E402
    plan_evictions_batch_ref,
    plan_evictions_ref,
)
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.cost import cost as ssm_bound  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.timing import queued_ms  # noqa: E402
from repro_torch.launch import cluster_sim, cr_cost, serve  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_consts  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.obs import validate_trace  # noqa: E402
from repro_torch.obs.profile import ProfileTimers  # noqa: E402
from repro_torch.obs.events import (  # noqa: E402
    EventType,
    lossless_ring_size,
)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.roofline import counting  # noqa: E402
from repro_torch.train.state import (  # noqa: E402
    bind_state,
    init_train_state,
    train_state_shapes,
)
from repro_torch.train.steps import (  # noqa: E402
    TrainConfig,
    make_prefill_step,
    make_train_step,
)

DEV = torch.device("cuda", 0)
SEED = 0
# every comparison on the card is in full fp32: no TF32 products
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
#: H100 SXM data-sheet peaks (dense, `launch/mesh.py`): HBM bytes/s, the
#: non-tensor-core scalar rate used for the comparison count of a sort,
#: and the bf16 tensor-core rate
HBM_BYTES_PER_S = mesh_consts.HBM_BW
SCALAR_OPS_PER_S = mesh_consts.PEAK_FLOPS_FP32
BF16_OPS_PER_S = mesh_consts.PEAK_FLOPS_BF16

# the fleet: bench_sched_scale.py's scale generator and T=4 lattice
FLEET_JOBS = 100_000
FLEET_CPUS = 16_384
FLEET_TENANTS = 16
FLEET_QUANTUM = 10
FLEET_DEPTH = 32
#: ticks of every fleet phase (100 until the MLA and hybrid rank phases
#: needed the time): by tick 50 each planner has evicted 11 to 27 times
#: and spilled, and each of [batch-fleet]'s quanta has evicted
FLEET_HORIZON = 50
#: the registered policies, and the three that plan evictions
POLICIES = ("omfs", "omfs_cheap_victim", "static_partition", "capping",
            "fcfs", "backfill", "backfill_cr")
PLANNERS = ("omfs", "omfs_cheap_victim", "backfill_cr")
#: [events]: the launcher's fleet (6 tenants, 1,024 CPUs, arrival rate
#: 0.08, seed 0; a 4 GiB fast tier) cut from 800 ticks to 80 (120 until
#: the multi-device phases needed the time), where no queue is longer
#: than the pass depth, so the bounded tensor pass and the Python
#: backend's full sweep must agree (the phase raises otherwise); 32
#: positions a tick, not the launcher's 64, since every position costs
#: the tensor passes their ops whether a job is there or not; at 80 ticks
#: omfs still evicts, saves, restores and spills, backfill_cr evicts and
#: saves, and a ring of 16 overflows (43 drops; at 100 ticks none)
EVENTS_HORIZON = 80
EVENTS_DEPTH = 32
EVENTS_SMALL_RING = 16
#: [batch-kernel]: the batched launch's batches, (B, cells' J, T), each
#: over the six static variants; cell 0 of each has no candidate
BATCH_SHAPES = ((1, (100_000,), 4),
                (7, (1, 127, 129, 512, 4097, 100_000, 262_144), 1),
                (7, (1, 127, 129, 512, 4097, 100_000, 262_144), 4),
                (256, (1, 127, 129, 512, 1024, 4097), 2))
#: [batch-fleet]: omfs on the fleet at these quanta, one batch
BATCH_QUANTA = (5, 10, 20, 40)
#: [batch-sweep]: benchmarks/bench_sweep.py's grid on its first seed,
#: 128 cells (both seeds, 256 cells, until the MLA and hybrid rank
#: phases needed the time)
SWEEP_QUANTA = (1, 2, 3, 4, 5, 6, 8, 12)
SWEEP_DEPTHS = (1, 2, 3, 4, 5, 6, 7, 8)
SWEEP_POLICIES = ("omfs", "omfs_cheap_victim")
SWEEP_SEEDS = (0,)
SWEEP_JOBS, SWEEP_CPUS, SWEEP_HORIZON = 32, 32, 100
#: ticks each sweep cell runs (the workload's arrivals span SWEEP_HORIZON;
#: half of it still evicts in both planners, and the sequential loop the
#: batch is held against is the phase's cost)
SWEEP_TICKS = 50
#: [stream-fleet]: the fleet's arrivals (8 a tick) through a stream of
#: 50-tick segments, 4 of them (100-tick segments until the MLA and
#: hybrid rank phases needed the time, 6 of them until slice 10's
#: phases did; 100-tick segments defer arrivals at 200 ticks); the
#: first run's capacity holds every arrival
STREAM_HORIZON, STREAM_SEGMENT, STREAM_AMPLE = 200, 50, 1 << 15

# checkpoint-restart: the codec's sizes, and the job bench_cr_cost.py
# measures (internlm2-1.8b's smoke heads at d_model 256, 4 layers)
CODEC_SIZES = (1, 127, 128, 129, 33_000, 2048 * 128, 10**8 + 3)
FAST_TIER_DEPTH = 1
#: [cr-path]'s calibrated fleet: the launcher's, its first CR_FLEET_TICKS
#: ticks on both backends (800 before the dry run's phases, 400 before
#: the MLA and hybrid rank phases)
CR_FLEET_TICKS = 200
CR_JOB = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
              vocab=8192)
TICK_SECONDS = 0.1

# training: the launcher at internlm2-1.8b's full widths, depth
# TRAIN_LAYERS, the serving shape (batch 4 x 2,048), the model's attention
# chunks (1,024); the launcher snapshots the state after TRAIN_SNAPSHOT
# (fast tier only, sized above the state: 21.11 GiB at the full depth)
# and 2 steps rerun from there; [train-vs-cpu] is one step
# at the full widths and depth 2, batch 1 x 256, on the card and the CPU;
# its bars are tests/test_torch_train.py's: loss and grad norm relative
# (STEP_TOL), the parameters after the step within 1e-6 + 1e-3 lr where the
# gradient is at least GRAD_TOL of its leaf's largest, 1e-6 + 2 lr
# elsewhere
TRAIN_ARCH = "internlm2-1.8b"
#: [train]'s and [executor]'s depth: 12 of internlm2-1.8b's 24 layers
#: (the full depth until the MLA and hybrid rank phases needed the time)
TRAIN_LAYERS = 12
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 10
TRAIN_SNAPSHOT = 8
TRAIN_FAST_TIER_GIB = 24
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_LR = 2, 1, 256, 1e-3
STEP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 1e-2)}
GRAD_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# [executor]: tests/test_e2e_train.py's scenario at the smoke config (its
# work, quantum and steps per tick), then two full-width jobs: B (12 CPUs,
# EXEC_WORK[0] units, the launcher's run: its twin is [train]'s losses)
# and A (8 CPUs, EXEC_WORK[1] units, submitted at EXEC_SUBMIT_A) on 16
# CPUs at quantum 3, one step a tick; a tick of EXEC_TICK_S charges each
# measured save and restore in whole ticks, so B runs EXEC_WORK[0] plus
# those ticks, at most TRAIN_STEPS steps
EXEC_SMOKE_TICK_S = 0.05
EXEC_WORK, EXEC_SUBMIT_A, EXEC_TICK_S = (4, 2), 2, 10.0
# the other families' training (`launch.train.run` with the config passed
# in): deepseek-moe-16b at its published widths cut to MOE_TRAIN_LAYERS
# (its TrainState, 19.1 GB, fits the 24 GiB fast tier; depth 3 would be
# 26.2 GB), batch TRAIN_BATCH x TRAIN_SEQ; hymba-1.5b at its published
# widths cut to HYBRID_TRAIN_LAYERS (8 of 32) and xlstm-350m at its
# published widths cut to XLSTM_TRAIN_LAYERS (1 mLSTM/sLSTM pair of 12):
# their per-token loops make their depth cost the script more than its
# limit allows (slice 10's phases cut xlstm to 8 layers, the dry run's
# phases hymba to 16 and xlstm to 4, the MLA and hybrid rank phases
# hymba to 8 and xlstm to 2), TRAIN_BATCH rows of HYBRID_TRAIN_SEQ and
# XLSTM_TRAIN_SEQ tokens (hymba adds its 128 meta tokens); their one step
# reruns from a snapshot of the initial state.
# [executor-moe] is [executor]'s scenario with B the deepseek launcher run
# (its losses are [train-moe]'s) and A a smoke internlm2 job.
# [train-families-vs-cpu] is [train-vs-cpu] for each family at its depth,
# TRAIN_CPU_LAYERS (xlstm one pair), in fp32
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 8
HYBRID_TRAIN_SEQ, XLSTM_TRAIN_SEQ, RECURRENT_TRAIN_STEPS = 512, 512, 1
HYBRID_TRAIN_LAYERS, XLSTM_TRAIN_LAYERS = 8, 2
# [launcher]'s backend check: the launcher's fleet cut to 256 CPUs and 300
# ticks, where pass depth 64 covers every queue, so the tensor pass sees
# what the host reference sees; [sched-status] the launcher's defaults
LAUNCHER_BACKENDS_ARGV = ["--fast-tier-cap-mib", "4096", "--chips", "256",
                          "--horizon", "300"]
#: [launcher]: the launcher's default fleet, its first LAUNCHER_TICKS
#: ticks (17 preemptions; 300 until the multi-device phases needed the
#: time)
LAUNCHER_TICKS = 150
SCHED_STATUS_REQUESTS = 4

# serving: tests/test_kernels.py's FLASH_CASES (B, S, H, KVH, D, causal,
# window, n_meta), two ragged Sq != Skv cases (B, Sq, Skv, H, KVH, D,
# causal), internlm2-1.8b's prefill attention at batch 4, prompt 2,048, and
# hymba-1.5b's (HYBRID_ATTN_SHAPE, below)
FLASH_CASES = [(2, 128, 4, 2, 64, True, 0, 0), (1, 200, 4, 4, 32, True, 0, 0),
               (2, 256, 8, 2, 64, False, 0, 0), (1, 256, 4, 1, 64, True, 64, 16),
               (1, 72, 2, 2, 16, True, 0, 0), (2, 96, 4, 2, 128, True, 48, 8),
               (1, 128, 4, 2, 64, True, 0, 0)]
RAGGED_CASES = [(1, 200, 72, 4, 2, 32, True), (2, 40, 72, 4, 2, 16, False)]
SERVE_ARCH = "internlm2-1.8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
ATTN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 16, 8, 128)   # B, S, Hq, Hkv, d
#: kernel vs plain: the reference's own bar (tests/test_kernels.py)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: kernel vs plain, scaled to the output: the RMS of the difference over
#: the RMS of the plain version's output.  Where Skv is large an output is
#: a mean over many keys and is small (RMS ~0.02 at 6,404 keys), so
#: ATTN_TOL alone would pass a kernel that dropped the keys past the last
#: full 64-key tile.  That fault reads 2.5e-2 and more at the non-causal
#: shapes (`[attn-compare]` reads it on the plain version with the tail
#: cut and fails unless it is above twice the bar); sound kernels read at
#: most 2.8e-4 in bf16 and 2.1e-6 in fp32 at these shapes.  The bars sit
#: between: bf16 one unit (2^-9) of the output's rounding, fp32 2e-5
ATTN_REL_RMS = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -9}
# [serve-vs-cpu]: the full widths at depth 2, fp32 compute and cache
CPU_LAYERS, CPU_BATCH, CPU_PROMPT, CPU_STEPS = 2, 2, 256, 8
#: both sides compute in fp32, but the card sums the 2,048- and 8,192-long
#: products of its GEMMs and the kernel's online softmax in another order
#: than the CPU's BLAS and the plain full-score softmax; the logits are
#: O(1), so an fp32 rounding difference stays orders of magnitude below this
SERVE_CPU_TOL = 1e-3

# the recurrent families: tests/test_kernels.py's scan cases, and the
# shapes of hymba-1.5b's and xlstm-350m's prefill at SERVE_BATCH x
# SERVE_PROMPT (hymba adds its 128 meta tokens; one mLSTM block's heads)
HYBRID_ARCH, XLSTM_ARCH = "hymba-1.5b", "xlstm-350m"
_HYMBA, _XLSTM = get_config(HYBRID_ARCH), get_config(XLSTM_ARCH)
#: [serve-xlstm]'s depth: 6 mLSTM/sLSTM pairs of 12 (the full 24 layers
#: until the MLA and hybrid rank phases needed the time: the sLSTM's
#: per-token loop makes its prefill and that prefill's profile
#: host-bound)
XLSTM_SERVE_LAYERS = 12
# B S di ds; the last two: di not a multiple of a block's channels, and
# di, ds odd (the kernel's 4-byte copies)
SSM_CASES = [(2, 100, 64, 8), (1, 64, 32, 16), (3, 33, 16, 4),
             (2, 257, 200, 16), (1, 70, 37, 5)]
SSM_PREFILL = (SERVE_BATCH, SERVE_PROMPT + _HYMBA.n_meta_tokens,
               _HYMBA.ssm.expand * _HYMBA.d_model, _HYMBA.ssm.d_state)
#: the scan a rank of [shard-serve-hybrid]'s (1, 4) mesh: 3,200 / 4 = 800
#: channels
SSM_TP4_PREFILL = SSM_PREFILL[:2] + (SSM_PREFILL[2] // 4, SSM_PREFILL[3])
#: one layer of hymba-1.5b's prefill attention: the 128 meta tokens and
#: the prompt under its 1,024 window, so that rows past 1,152 lose keys to
#: the window but keep the meta tokens (B, S, Hq, Hkv, d, window, n_meta)
HYBRID_ATTN_SHAPE = (SERVE_BATCH, SSM_PREFILL[1], _HYMBA.n_heads,
                     _HYMBA.n_kv_heads, _HYMBA.head_dim,
                     _HYMBA.sliding_window, _HYMBA.n_meta_tokens)
MLSTM_CASES = [(3, 80, 32, 32), (1, 64, 16, 32), (2, 100, 64, 64),
               (1, 37, 16, 16)]                                # BH S dh L
#: dh not a multiple of 4: the kernel's 4-byte loads
MLSTM_ODD = (2, 70, 33, 16)
MLSTM_PREFILL = (SERVE_BATCH * _XLSTM.n_heads, SERVE_PROMPT,
                 int(_XLSTM.xlstm.proj_factor_mlstm * _XLSTM.d_model)
                 // _XLSTM.n_heads, 256)
#: the scan a rank of [shard-serve-xlstm]'s (1, 4) mesh: its 1 head of 4
MLSTM_TP4 = (MLSTM_PREFILL[0] // 4,) + MLSTM_PREFILL[1:]
MLSTM_RAGGED_S = 2000
#: a carried state is the plain version's state after this many steps of a
#: prefill from the zero state on random inputs: C, n and m as a prefill
#: leaves them
MLSTM_STATE_STEPS = 256
#: kernel vs plain at the reference's test shapes: its own bars
#: (tests/test_kernels.py).  At the serving shapes, the same bars times
#: the largest magnitude of the compared output where it is above 1: the
#: two versions sum thousands of fp32 terms (2,176 steps of a growing SSM
#: state; 256-long products and eight chunks of a carried 512 x 512
#: state) in other orders and with FMAs, so their rounding grows with the
#: values, while a fault of the function (a wrong gate, a lost step, a
#: missed chunk) moves the output by a sizeable part of its magnitude.
SSM_TOL = 1e-5
MLSTM_H_TOL, MLSTM_STATE_TOL = 2e-4, 1e-5

# the MoE family: tests/test_kernels.py's moe_gmm shapes (E, C, d, f), and
# deepseek-moe-16b's experts at SERVE_BATCH x SERVE_PROMPT prefill tokens
# and at one decode step of SERVE_BATCH tokens
MOE_ARCH = "deepseek-moe-16b"
_MOE = get_config(MOE_ARCH)
GMM_CASES = [(4, 96, 160, 224), (2, 128, 64, 64), (8, 32, 48, 96),
             (1, 256, 512, 128)]
#: one layer of deepseek-moe-16b's prefill attention (16/16 heads)
MOE_ATTN_SHAPE = (SERVE_BATCH, SERVE_PROMPT, _MOE.n_heads, _MOE.n_kv_heads,
                  _MOE.resolved_head_dim)
#: the head_dim form's flash launch a rank on 16 model ranks at the
#: serving shape: glm4-9b's 2 query heads and dbrx-132b's 3 (groups 16
#: and 6 whole), each against its one KV head
HD_RANK_ATTN = {"glm4_hd16": (SERVE_BATCH, SERVE_PROMPT, 2, 1, 128),
                "dbrx_hd16": (SERVE_BATCH, SERVE_PROMPT, 3, 1, 128)}
GMM_EXPERTS = (_MOE.moe.n_routed, _MOE.moe.top_k, _MOE.d_model,
               _MOE.moe.d_expert)                               # E k d f
GMM_TOKENS = {"prefill": SERVE_BATCH * SERVE_PROMPT, "decode": SERVE_BATCH}
#: kernel vs plain: the reference's own bars (tests/test_kernels.py), at
#: the serving shapes times max(1, max|output|) as for the scans
GMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
#: [moe-vs-cpu]: a token's experts must agree on both sides unless the
#: CPU's k-th and (k+1)-th router probabilities lie within this fraction
#: of the k-th (routing is discrete; the two sides' fp32 router products
#: differ in the last bits)
ROUTE_TIE_REL = 1e-5

#: [train-families-vs-cpu]'s depths: deepseek's CPU step at depth 2 took
#: 40 s of the script on an H100 machine's host (PERF.md section 4), so
#: one layer since slice 10's phases
FAMILIES_CPU_LAYERS = {MOE_ARCH: 1, HYBRID_ARCH: TRAIN_CPU_LAYERS,
                       XLSTM_ARCH: TRAIN_CPU_LAYERS}

# slice 10's rest: minicpm3-4b (MLA), llama-3.2-vision-11b (VLM) and
# whisper-base (audio)
MLA_ARCH, VLM_ARCH, AUDIO_ARCH = ("minicpm3-4b", "llama-3.2-vision-11b",
                                  "whisper-base")
_MLA, _VLM, _AUDIO = (get_config(a) for a in (MLA_ARCH, VLM_ARCH, AUDIO_ARCH))
#: whisper serves a 416-token prompt and 32 generated tokens: 448 in all,
#: its text context (arXiv:2212.04356), against 1,500 audio frames
AUDIO_PROMPT = 448 - SERVE_GEN
#: one prefill attention of each new shape (B, Sq, Skv, Hq, Hkv, Dk, Dv,
#: causal): MLA's decompressed heads (Dk = 64 + 32, Dv = 64), the VLM's
#: cross-attention over its 6,404 patches (GQA 32/8), whisper's encoder
#: and its decoder's cross-attention over the 1,500 frames
MLA_ATTN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, _MLA.n_heads,
            _MLA.n_heads, _MLA.mla.qk_nope_head_dim
            + _MLA.mla.qk_rope_head_dim, _MLA.mla.v_head_dim, True)
VLM_CROSS_ATTN = (SERVE_BATCH, SERVE_PROMPT, _VLM.vision.n_patches,
                  _VLM.n_heads, _VLM.n_kv_heads, _VLM.resolved_head_dim,
                  _VLM.resolved_head_dim, False)
#: the VLM's cross-attention a rank of the (16, 16) mesh in the head_dim
#: form: 32 / 16 = 2 query heads against the one KV head they use
VLM_CROSS_HD16_ATTN = (SERVE_BATCH, SERVE_PROMPT, _VLM.vision.n_patches,
                       _VLM.n_heads // 16, 1, _VLM.resolved_head_dim,
                       _VLM.resolved_head_dim, False)
#: MLA's prefill attention a rank of [shard-serve-mla]'s (1, 4) mesh:
#: 40 / 4 = 10 heads
MLA_TP4_ATTN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, _MLA.n_heads // 4,
                _MLA.n_heads // 4) + MLA_ATTN[5:]
#: the columns form's launches a rank of (1, 4): hymba-1.5b's 7 touched
#: query heads of 25 (ceil(25 / 4) + 1 at every rank), K and V expanded to
#: one KV head each, under its window and meta tokens
#: (HYBRID_ATTN_SHAPE's order); minicpm3-4b cut to 10 heads, whose 2.5
#: heads a rank are a (16, 16) rank's of the 40-head model: 3 touched
MLA_COLUMNS_HEADS = 10


def touched(n_heads, n, r=0):
    """How many query heads model rank ``r`` of ``n`` attends on in the
    columns form (`transformer.touched_heads`)."""
    lo, hi = tfm.touched_heads(n_heads, n, r)
    return hi - lo


HYBRID_TP4_ATTN = (HYBRID_ATTN_SHAPE[:2] + (touched(_HYMBA.n_heads, 4),) * 2
                   + HYBRID_ATTN_SHAPE[4:])
MLA10_TP4_ATTN = (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT) \
    + (touched(MLA_COLUMNS_HEADS, 4),) * 2 + MLA_ATTN[5:]
AUDIO_ENC_ATTN = (SERVE_BATCH, _AUDIO.audio.n_audio_ctx,
                  _AUDIO.audio.n_audio_ctx, _AUDIO.n_heads,
                  _AUDIO.n_kv_heads, _AUDIO.resolved_head_dim,
                  _AUDIO.resolved_head_dim, False)
AUDIO_CROSS_ATTN = (SERVE_BATCH, AUDIO_PROMPT, _AUDIO.audio.n_audio_ctx,
                    _AUDIO.n_heads, _AUDIO.n_kv_heads,
                    _AUDIO.resolved_head_dim, _AUDIO.resolved_head_dim,
                    False)
#: whisper's encoder attention a rank of [shard-serve-audio]'s (1, 4)
#: mesh: 8 / 4 = 2 query and 2 KV heads
AUDIO_ENC_TP4_ATTN = (AUDIO_ENC_ATTN[:3] + (_AUDIO.n_heads // 4,
                                            _AUDIO.n_kv_heads // 4)
                      + AUDIO_ENC_ATTN[5:])
#: depths of the [*-vs-cpu] and [train-new-families-vs-cpu] cuts: the VLM
#: one group (4 self layers, 1 cross block), whisper 2 encoder and 2
#: decoder layers, minicpm3 CPU_LAYERS
NEW_CPU_LAYERS = {MLA_ARCH: CPU_LAYERS,
                  VLM_ARCH: _VLM.vision.cross_attn_every,
                  AUDIO_ARCH: CPU_LAYERS}
#: [train-mla], [train-vlm], [train-audio]: minicpm3 cut to depth 2, the
#: VLM to one group (its TrainState, 2.15e9 x 12 B = 25.8 GB, above the
#: 24 GiB tier: NEW_FAST_TIER_GIB), whisper at full depth; rows of
#: TRAIN_SEQ tokens, whisper's of its 448-token context; 2 steps, the
#: second rerun from a snapshot taken after the first
NEW_TRAIN_LAYERS = {MLA_ARCH: 2, VLM_ARCH: _VLM.vision.cross_attn_every,
                    AUDIO_ARCH: _AUDIO.n_layers}
NEW_TRAIN_SEQ = {MLA_ARCH: TRAIN_SEQ, VLM_ARCH: TRAIN_SEQ,
                 AUDIO_ARCH: AUDIO_PROMPT + SERVE_GEN}
NEW_TRAIN_STEPS, NEW_FAST_TIER_GIB = 2, 32


T0 = time.perf_counter()


def log(phase, **kv):
    """One result line, stamped with the seconds since the script began."""
    kv["at_s"] = f"{time.perf_counter() - T0:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# sched_select inputs, bytes and timing
# ---------------------------------------------------------------------------


def random_case(rng, j, n_tiers, bounded):
    """Random int32 columns on the card; lattice values from a narrow range
    so the placement argmin meets ties."""
    return on_card(*random_cols(rng, j, n_tiers, bounded))


def random_cols(rng, j, n_tiers, bounded):
    """`random_case`'s columns and scalars as numpy arrays and ints."""
    save_lat = rng.integers(0, 6, (j, n_tiers)).astype(np.int32)
    evictable = rng.random(j) < 0.5
    cpus = rng.integers(1, 8, j).astype(np.int32)
    cap = rng.integers(0, 256, n_tiers).astype(np.int32)
    cap[rng.random(n_tiers) < 0.3] = -1
    cap[-1] = -1
    if not bounded:
        cap[:] = -1
    total = int(cpus[evictable].sum())
    cols = dict(
        prio=rng.integers(0, 5, j).astype(np.int32),
        run_start=rng.integers(-1, 40, j).astype(np.int32),
        jid=rng.permutation(j).astype(np.int32),
        key_cost=np.ascontiguousarray(save_lat[:, 0]),
        evictable=evictable,
        cpus=cpus,
        state_mib=rng.integers(0, 64, j).astype(np.int32),
        is_ckpt=rng.random(j) < 0.7,
        save_lat=save_lat,
    )
    scal = dict(idle=int(rng.integers(0, 20)),
                cpus_needed=int(rng.integers(0, max(2, total // 4))),
                occ=rng.integers(0, 128, n_tiers).astype(np.int32),
                cap=[int(c) for c in cap])
    return cols, scal


def on_card(cols, scal):
    cols = {k: torch.from_numpy(v).to(DEV) for k, v in cols.items()}
    return cols, dict(scal, occ=torch.from_numpy(scal["occ"]).to(DEV))


#: the cases `[kernel-vs-plain]` adds at J = 262,144, each over the six
#: static variants: key tuples that repeat (the row decides), keys and
#: lattice values at INT32_MAX and -1, no candidate, every row a
#: candidate, capacities of 0, eight tiers
SCHED_EDGE_CASES = ("ties", "extremes", "no_candidate", "all_candidates",
                    "cap_zero", "eight_tiers")
SCHED_EDGE_J = 262_144
INT32_MAX = 2**31 - 1


def edge_case(rng, name, j):
    n_tiers = 8 if name == "eight_tiers" else 4
    cols, scal = random_cols(rng, j, n_tiers, True)
    keys = ("prio", "run_start", "jid", "key_cost")
    if name == "ties":
        for k in keys:
            cols[k] = rng.integers(0, 2, j).astype(np.int32)
    elif name == "extremes":
        for k in keys:
            cols[k] = rng.choice(np.array([-1, INT32_MAX], np.int32), j)
        cols["save_lat"] = rng.choice(np.array([0, 3, INT32_MAX], np.int32),
                                      (j, n_tiers))
        cols["key_cost"] = np.ascontiguousarray(cols["save_lat"][:, 0])
    elif name == "no_candidate":
        cols["evictable"][:] = False
    elif name == "all_candidates":
        cols["evictable"][:] = True
    elif name == "cap_zero":
        scal["cap"] = [0, 0, 0, -1]
        scal["occ"][:] = 0
        cols["state_mib"][::3] = 0
    total = int(cols["cpus"][cols["evictable"]].sum())
    scal["cpus_needed"] = total // 2
    return cols, scal


#: runtime calls that put work on the card: launches, memsets, copies
ENQUEUE_CALLS = ("cudaLaunch", "cuLaunch", "Memset", "Memcpy")


def plan_events(fn, calls=5):
    """Device events (kernels, sets, copies) per call of ``fn`` over
    ``calls`` calls under torch.profiler: counted from the runtime calls
    that enqueue them (a short trace can drop device records), beside the
    device records the trace kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    enqueued = sum(
        1 for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == DeviceType.CPU
        and any(k in ev.name() for k in ENQUEUE_CALLS))
    return enqueued / calls, device_us(prof)[2] / calls

def time_plan(cols, scal, flags, iters=100):
    """A plan's time on the card (calls queued behind a sleep kernel), as
    the host issues it, and its device events; launch counts restored."""
    saved = kernel_counts()

    def fn():
        sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                       **flags)

    events, traced = plan_events(fn)
    row = dict(ms=queued_ms(fn, iters=iters), host_ms=time_ms(fn, iters),
               events=events, traced=traced)
    set_kernel_counts(saved)
    return row


def sched_floor_ms():
    """An empty cooperative launch of the plan's grid, on the card: the
    floor of a one-launch plan."""
    return queued_ms(lambda: sched_ops.floor_launch(DEV), iters=200)


def plan_bytes(cols, n_tiers, cheap, tiered, bounded, planned):
    """Bytes this plan must move, counted from its own inputs.  Rows that
    are not candidates change no output, so it reads the J evictable
    flags, the keys and CPUs of the E candidates, the checkpoint flag of
    each planned victim, and the T lattice words (and, bounded, the size)
    of each victim that saves a checkpoint; it writes ``planned``,
    ``tier`` and ``enough`` once.  ``planned`` is the plain version's."""
    j = cols["prio"].shape[0]
    e = int(cols["evictable"].sum())
    read = j + 4 * ((4 if cheap else 3) + 1) * e + 4 * (2 + n_tiers)
    if tiered:
        saves = int((planned & cols["is_ckpt"].to(torch.bool)).sum())
        read += int(planned.sum()) + 4 * saves * (n_tiers + int(bounded))
    return read + j + 4 * j + 1                         # planned, tier, enough


def plan_bound_ms(cols, n_tiers, cheap, tiered, bounded, planned):
    """The larger of the bytes over the memory rate and the sort's
    E*log2(E) compares over the scalar rate, in ms, and which it was."""
    e = int(cols["evictable"].sum())
    byte_s = plan_bytes(cols, n_tiers, cheap, tiered, bounded,
                        planned) / HBM_BYTES_PER_S
    ops_s = e * int(np.ceil(np.log2(max(e, 2)))) / SCALAR_OPS_PER_S
    return 1e3 * max(byte_s, ops_s), ("bytes" if byte_s >= ops_s
                                      else "operations")


def time_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_plan(cols, scal, **flags):
    """Kernel against the plain version on the same card inputs; returns
    the largest absolute difference over the three outputs."""
    got = sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                         **flags)
    torch.cuda.synchronize()
    want = plan_evictions_ref(*cols.values(), *scal.values(), **flags)
    err = 0
    for name, g, w in zip(("planned", "enough", "tier"), got, want):
        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if d != 0:
            raise AssertionError(f"sched_select {name} differs from its plain "
                                 f"version by {d} ({flags}, "
                                 f"J={cols['prio'].shape[0]})")
        err = max(err, d)
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    smi = nvidia_smi_line()
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(),
        capability=torch.cuda.get_device_capability(0), nvidia_smi=repr(smi))
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = (sched_ops, codec_ops, flash_ops, ssm_ops, mlstm_ops, gmm_ops)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        futures = [pool.submit(ops.build) for ops in libs]
        builds = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    for built in builds:
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "Compiling entry" in ln
                 or "spill" in ln or "Performance Loss" in ln]
        log("build", library=built.path.name, seconds=f"{built.seconds:.2f}",
            wall_s=f"{wall:.2f}")
        for ln in ptxas:
            print(f"  ptxas: {ln}")


def phase_kernel_compare():
    rng = np.random.default_rng(SEED)
    cases = 0
    err = 0
    t0 = time.perf_counter()
    for j in (1, 127, 129, 4097, 100_000, 262_144):
        for n_tiers in (1, 2, 4):
            for cheap in (False, True):
                for tiered, bounded in ((False, False), (True, False),
                                        (True, True)):
                    cols, scal = random_case(rng, j, n_tiers, bounded)
                    err = max(err, compare_plan(cols, scal, cheap=cheap,
                                                tiered=tiered,
                                                bounded=bounded))
                    cases += 1
    # the edge cases draw from their own generator, so the timed cases
    # below are the same columns whatever cases come before them
    edge_rng = np.random.default_rng(SEED + 1)
    for name in SCHED_EDGE_CASES:
        case_cols, case_scal = edge_case(edge_rng, name, SCHED_EDGE_J)
        for cheap in (False, True):
            for tiered, bounded in ((False, False), (True, False),
                                    (True, True)):
                sc = dict(case_scal, cap=case_scal["cap"] if bounded
                          else [-1] * len(case_scal["cap"]))
                cols, scal = on_card(case_cols, sc)
                err = max(err, compare_plan(cols, scal, cheap=cheap,
                                            tiered=tiered, bounded=bounded))
                cases += 1
    log("kernel-vs-plain", cases=cases, edge_cases=",".join(SCHED_EDGE_CASES),
        max_abs_err=err, seconds=f"{time.perf_counter() - t0:.1f}")
    # each size with the bounded walk and without it; E (candidates) and
    # the victims are printed
    floor = sched_floor_ms()
    for j in (100_000, 262_144):
        cols, scal = random_case(rng, j, 4, True)
        planned = plan_evictions_ref(*cols.values(), *scal.values(),
                                     tiered=True)[0]
        victims = int(planned.sum())
        for bounded in (False, True):
            flags = dict(cheap=False, tiered=True, bounded=bounded)
            sc = scal if bounded else dict(scal, cap=[-1] * 4)
            t = time_plan(cols, sc, flags)
            bound, _ = plan_bound_ms(cols, 4, False, True, bounded, planned)
            log("kernel-time", J=j, T=4, bounded=bounded,
                candidates=int(cols["evictable"].sum()), victims=victims,
                ms=f"{t['ms']:.4f}", host_ms=f"{t['host_ms']:.4f}",
                floor_ms=f"{floor:.4f}", device_events=t["events"],
                traced_device_events=t["traced"],
                bytes=plan_bytes(cols, 4, False, True, bounded, planned),
                bound_ms=f"{bound:.5f}",
                share_of_bound=f"{bound / t['ms']:.5f}")
    return err


@functools.cache
def fleet_workload():
    """bench_sched_scale's scale generator: enough arrivals to reach
    FLEET_JOBS rows, 0.5 jobs per tick per tenant, mean work 60.  Built
    once (~7 s of the host) and shared by every fleet phase: the tensor
    backends read the jobs into tables and never write to them."""
    gen_horizon = max(200, int(1.5 * FLEET_JOBS / (FLEET_TENANTS * 0.5)))
    spec = WorkloadSpec(n_users=FLEET_TENANTS, horizon=gen_horizon,
                        cpu_total=FLEET_CPUS, seed=1, arrival_rate=0.5,
                        mean_work=60)
    users = make_users(spec)
    jobs = make_jobs(spec, users)[:FLEET_JOBS]
    assert len(jobs) == FLEET_JOBS, len(jobs)
    return users, jobs


def fleet_config(backend):
    """The T=4 HBM/DRAM/NVMe/object lattice with delta 182/256: 4/16/64
    GiB bounded tiers plus an unbounded spill tier."""
    d = measured_delta_num()
    return SchedulerConfig(
        cpu_total=FLEET_CPUS, quantum=FLEET_QUANTUM, kernel_backend=backend,
        cr_tiers=TieredCRCostModel(
            tiers=(CRCostModel(save_mib_per_tick=8192,
                               restore_mib_per_tick=16384,
                               delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=4096,
                               restore_mib_per_tick=8192, save_base=1,
                               delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=512,
                               restore_mib_per_tick=1024, save_base=1,
                               restore_base=1, delta_num=d, delta_den=256),
                   CRCostModel(save_mib_per_tick=64,
                               restore_mib_per_tick=128, save_base=2,
                               restore_base=2, delta_num=d, delta_den=256)),
            capacity_mib=(4 << 10, 16 << 10, 64 << 10, UNBOUNDED)))


def assert_same_run(a, b, what):
    for f in omfs_torch.JobTable._fields:
        x, y = getattr(a.table, f).cpu(), getattr(b.table, f).cpu()
        if f == "jid":
            # two workload builds draw ids from one counter: same order,
            # shifted by the number of jobs built in between
            x, y = x - x[:1], y - y[:1]
        if x.dtype != torch.int32 or not torch.equal(x, y):
            raise AssertionError(f"{what}: column {f} differs")
    if not np.array_equal(a.busy_series(), b.busy_series()):
        raise AssertionError(f"{what}: busy series differ")


def phase_fleet():
    t0 = time.perf_counter()
    users, jobs = fleet_workload()
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    # the main path: every kernel count starts at 0 here
    zero_kernel_counts()
    for policy in POLICIES:
        runs[policy, "cuda"] = engine.simulate(
            users, jobs, fleet_config("cuda"), FLEET_HORIZON, policy,
            pass_depth=FLEET_DEPTH, device=DEV)
    launches = sched_ops.LAUNCHES
    branches = {p: runs[p, "cuda"].stats.evict_branches for p in PLANNERS}
    if launches != sum(branches.values()) or min(branches.values()) == 0:
        raise AssertionError(f"sched_select launches {launches} != eviction "
                             f"branches {branches} (each must be > 0)")
    for policy in POLICIES:
        runs[policy, "torch"] = engine.simulate(
            users, jobs, fleet_config("torch"), FLEET_HORIZON, policy,
            pass_depth=FLEET_DEPTH, device=DEV)
    if sched_ops.LAUNCHES != launches:
        raise AssertionError("the torch backend launched sched_select")
    peak = torch.cuda.max_memory_allocated()
    for policy in POLICIES:
        cu, to = runs[policy, "cuda"], runs[policy, "torch"]
        assert_same_run(cu, to, f"fleet {policy}")
        s = cu.summary()
        if policy in PLANNERS and (s["preemptions"] <= 0
                                   or s["spills"] <= 0):
            raise AssertionError(f"fleet {policy} exercised no eviction or "
                                 f"no spill: {s}")
        log("fleet" if policy.startswith("omfs") else "policies",
            policy=policy, J=FLEET_JOBS, cpus=FLEET_CPUS, T=4,
            horizon=FLEET_HORIZON, pass_depth=FLEET_DEPTH,
            ticks_per_s_cuda=f"{FLEET_HORIZON / cu.seconds['ticks']:.3f}",
            ticks_per_s_torch=f"{FLEET_HORIZON / to.seconds['ticks']:.3f}",
            build_s=f"{cu.seconds['build']:.2f}",
            host_syncs_per_tick=f"{cu.stats.host_syncs / FLEET_HORIZON:.2f}",
            evict_branches=cu.stats.evict_branches,
            launches=cu.stats.evict_branches,
            preemptions=s["preemptions"], spills=s["spills"],
            utilization=f"{s['utilization']:.4f}",
            goodput=f"{s['goodput']:.4f}", done=s["done"],
            identical_to_torch_backend=True)
    log("fleet-memory", max_memory_allocated=peak,
        workload_gen_s=f"{gen_s:.2f}", sched_select_launches=launches,
        **{f"branches_{p}": n for p, n in branches.items()})
    return runs, launches


def sync_sites(fn):
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, under
    which each synchronising op warns; returns (fn's result, every
    warning's innermost line of the port's source on the Python stack, the
    warnings' texts)."""
    import traceback

    src = str(Path(__file__).resolve().parent / "src")
    where, texts = [], set()

    def keep(message, category, filename, lineno, file=None, line=None):
        # every warning but the notice that the debug mode is a prototype,
        # which setting the mode prints
        if "prototype" in str(message):
            return
        texts.add(str(message).splitlines()[0][:80])
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(src)]
        where.append(f"{Path(ours[-1].filename).relative_to(src)}:"
                     f"{ours[-1].lineno}" if ours
                     else f"{Path(filename).name}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, where, texts


def phase_policy_syncs(runs):
    """Each policy's fleet run again on a copy of one built table, under
    the sync debug mode: the host syncs the card sees must be the ones the
    passes count in `PassStats` (the OMFS pair: one per queue position;
    backfill_cr: one per tick; the other four: none), and the table the
    run's."""
    users, jobs = fleet_workload()
    cfg = fleet_config("cuda")
    built, ent = omfs_torch.table_from_jobs(jobs, users, FLEET_CPUS, cfg, DEV)
    saved = kernel_counts()
    for policy in POLICIES:
        stats = omfs_torch.PassStats()
        tbl = omfs_torch.JobTable(*(c.clone() for c in built))
        pass_fn = engine.POLICIES[policy].torch_factory(FLEET_DEPTH)
        (tbl, _), where, texts = sync_sites(lambda: engine.run_table(
            cfg, ent, tbl, FLEET_HORIZON, pass_fn, stats=stats))
        if len(where) != stats.host_syncs:
            raise AssertionError(f"{policy}: {len(where)} host syncs on the "
                                 f"card, PassStats counts {stats.host_syncs}:"
                                 f" {sorted(set(where))}")
        if not omfs_torch.tables_equal(tbl, runs[policy, "cuda"].table):
            raise AssertionError(f"{policy}: the table differs from [fleet]'s")
        log("policy-syncs", policy=policy, ticks=FLEET_HORIZON,
            syncs=len(where), counted=stats.host_syncs,
            at={w: where.count(w) for w in sorted(set(where))} or "none",
            messages=sorted(texts) or "none")
    set_kernel_counts(saved)


def phase_audit():
    """``python -m repro_torch.analysis --device cuda`` (every rule, the
    dispatch audit of the passes and of each family's smoke serving on the
    card) must exit 0; then the three dispatch rules again on CUDA tables
    under ``kernel_backend="cuda"``: every plan a `sched_select` launch,
    the plans equal to `PassStats.evict_branches`, and the host syncs that
    the sync debug mode sees equal to the reads that `PassStats` counts."""
    from repro_torch import analysis
    from repro_torch.analysis import dispatch_audit

    saved = kernel_counts()
    root = Path(__file__).resolve().parent
    start = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis.main(["--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"repro_torch.analysis exited {rc}:\n"
                             f"{out.getvalue()[-4000:]}")
    cli_s = time.perf_counter() - start
    fx = dispatch_audit.fixture(DEV)
    zero_kernel_counts()
    (runs, idle), where, texts = sync_sites(lambda: (
        [dispatch_audit.run_pass(p, "cuda", fx) for p in POLICIES],
        [dispatch_audit.run_pass(p, "cuda", fx, idle=True)
         for p in dispatch_audit.CONFINED_POLICIES]))
    report = dispatch_audit.AuditReport(str(DEV), runs, idle, [])
    bad = (dispatch_audit.float_cast_violations(report, root)
           + dispatch_audit.confinement_violations(report, root)
           + dispatch_audit.host_read_violations(report, root))
    if bad:
        raise AssertionError("\n".join(map(str, bad)))
    counted = sum(r.stats.host_syncs + r.stats.place_reads
                  for r in runs + idle)
    branches = sum(r.stats.evict_branches for r in runs)
    if len(where) != counted:
        raise AssertionError(f"{len(where)} host syncs on the card, "
                             f"PassStats counts {counted}: "
                             f"{sorted(set(where))}")
    if not (sched_ops.PLANS == branches == sum(r.plans for r in runs) > 0
            and sched_ops.LAUNCHES > 0):
        raise AssertionError(f"{sched_ops.PLANS} plans in "
                             f"{sched_ops.LAUNCHES} sched_select launches "
                             f"for {branches} eviction branches")
    log("audit", rules=len(analysis.RULES), violations=0,
        cli_s=f"{cli_s:.1f}", passes=len(runs), ticks=dispatch_audit.HORIZON,
        evict_branches=branches, plans=sched_ops.PLANS,
        launches=sched_ops.LAUNCHES,
        reads=sum(r.reads for r in runs + idle),
        host_syncs=counted, syncs=len(where),
        messages=sorted(texts) or "none",
        seconds=f"{time.perf_counter() - start:.1f}")
    set_kernel_counts(saved)


def phase_policy_matrix(runs):
    """`simulate_matrix` over the seven policies on the card, one table
    build: each result must equal the policy's own `simulate` in [fleet]."""
    users, jobs = fleet_workload()
    saved = kernel_counts()
    t0 = time.perf_counter()
    matrix = engine.simulate_matrix(users, jobs, fleet_config("cuda"),
                                    FLEET_HORIZON, list(POLICIES),
                                    pass_depth=FLEET_DEPTH, device=DEV)
    wall = time.perf_counter() - t0
    set_kernel_counts(saved)
    for res in matrix:
        solo = runs[res.policy, "cuda"]
        assert_same_run(res, solo, f"matrix {res.policy}")
        if res.stats != solo.stats:
            raise AssertionError(f"matrix {res.policy}: {res.stats} != "
                                 f"{solo.stats}")
    log("policy-matrix", policies=len(matrix), J=FLEET_JOBS,
        horizon=FLEET_HORIZON, build_s=f"{matrix[0].seconds['build']:.2f}",
        wall_s=f"{wall:.2f}",
        per_policy_build_s=f"{runs['omfs', 'cuda'].seconds['build']:.2f}",
        identical_to_simulate=True)


def events_fleet():
    """The launcher's fleet cut to EVENTS_HORIZON ticks, with a 4 GiB
    fast tier (``--fast-tier-cap-mib 4096``)."""
    spec = WorkloadSpec(n_users=6, horizon=EVENTS_HORIZON, cpu_total=1024,
                        seed=0, arrival_rate=0.08)
    users = make_users(spec)
    tiers = TieredCRCostModel(
        tiers=(CRCostModel(), CRCostModel(save_mib_per_tick=2048,
                                          restore_mib_per_tick=4096)),
        capacity_mib=(4096, UNBOUNDED))
    cfg = SchedulerConfig(cpu_total=1024, quantum=20, cr_overhead=2,
                          cr_tiers=tiers)
    return users, make_jobs(spec, users), cfg


def same_log(a, b, what):
    if a.events != b.events:
        raise AssertionError(f"{what}: event logs differ")
    if not np.array_equal(a.event_counts, b.event_counts):
        raise AssertionError(f"{what}: event counts differ")
    if not np.array_equal(a.events_dropped, b.events_dropped):
        raise AssertionError(f"{what}: drops differ")


def phase_events():
    """Lifecycle events of all seven policies on the card against the
    Python backend's EventBus (the independent reference), the
    instrumented table against the uninstrumented one, the host syncs with
    capture on and off, and an undersized ring's drops."""
    users, jobs, cfg = events_fleet()
    saved = kernel_counts()
    py_s = card_s = 0.0
    cards = {}
    for policy in POLICIES:
        t0 = time.perf_counter()
        py = engine.simulate(users, jobs, cfg, EVENTS_HORIZON, policy,
                             backend="python", record_events=True)
        t1 = time.perf_counter()
        card = engine.simulate(users, jobs, cfg, EVENTS_HORIZON, policy,
                               pass_depth=EVENTS_DEPTH, device=DEV,
                               record_events=True)
        card_s += time.perf_counter() - t1
        py_s += t1 - t0
        cards[policy] = card
        plain = engine.simulate(users, jobs, cfg, EVENTS_HORIZON, policy,
                                pass_depth=EVENTS_DEPTH, device=DEV)
        queue = int((py.event_counts[:, EventType.DEFER]
                     + py.event_counts[:, EventType.START]).max())
        if queue > EVENTS_DEPTH:
            raise AssertionError(f"{policy}: a queue of {queue} exceeds the "
                                 f"pass depth {EVENTS_DEPTH}")
        same_log(card, py, f"events {policy}: card vs python")
        if card.signature() != py.signature():
            raise AssertionError(f"events {policy}: schedules differ")
        assert_same_run(card, plain, f"events {policy}: capture on vs off")
        if card.stats != plain.stats:
            raise AssertionError(f"events {policy}: host syncs {card.stats} "
                                 f"with capture, {plain.stats} without")
        per_type = card.event_counts.sum(axis=0)
        log("events", policy=policy, jobs=len(jobs), cpus=1024,
            horizon=EVENTS_HORIZON, pass_depth=EVENTS_DEPTH,
            longest_queue=queue, events=len(card.events),
            dropped=card.events_dropped_total(),
            host_syncs=card.stats.host_syncs,
            **{f"n_{e.name.lower()}": int(per_type[e]) for e in EventType},
            identical_to_python_bus=True, table_unchanged=True)
    full = cards["omfs"]
    tiny = engine.simulate(users, jobs, cfg, EVENTS_HORIZON, "omfs",
                           pass_depth=EVENTS_DEPTH, device=DEV,
                           record_events=True, event_ring=EVENTS_SMALL_RING)
    set_kernel_counts(saved)
    want = np.maximum(full.event_counts.sum(axis=1) - EVENTS_SMALL_RING, 0)
    if not np.array_equal(tiny.events_dropped, want) or want.sum() == 0:
        raise AssertionError("an undersized ring miscounted its drops")
    if (not np.array_equal(tiny.event_counts, full.event_counts)
            or not set(tiny.events) <= set(full.events)
            or len(tiny.events) + int(want.sum()) != len(full.events)):
        raise AssertionError("an undersized ring lost or invented events")
    log("events-ring", policy="omfs", ring=EVENTS_SMALL_RING,
        dropped=int(want.sum()), kept=len(tiny.events),
        total=len(full.events), drops_exact=True,
        python_backend_s=f"{py_s:.2f}", card_s=f"{card_s:.2f}")
    return (users, jobs, cfg), cards


def phase_events_fleet(fleet_omfs, plain_device_us):
    """omfs with capture on the 100k-job fleet: the table must be
    [fleet]'s; the capture's device share is this run's device time over
    [fleet-profile]'s (the same run without capture), both profiled."""
    from torch.profiler import ProfilerActivity, profile

    users, jobs = fleet_workload()
    saved = kernel_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = engine.simulate(users, jobs, fleet_config("cuda"),
                              FLEET_HORIZON, "omfs", pass_depth=FLEET_DEPTH,
                              device=DEV, record_events=True)
    set_kernel_counts(saved)
    dev_us, _, _ = device_us(prof)
    assert_same_run(res, fleet_omfs, "events-fleet vs fleet")
    if res.stats != fleet_omfs.stats:
        raise AssertionError(f"events-fleet: host syncs {res.stats} with "
                             f"capture, {fleet_omfs.stats} without")
    ring = lossless_ring_size(FLEET_JOBS)
    ring_bytes = FLEET_HORIZON * (ring * 3 + len(EventType) + 1) * 4
    per_tick = res.event_counts.sum(axis=1)
    log("events-fleet", policy="omfs", J=FLEET_JOBS, horizon=FLEET_HORIZON,
        ring=ring, ring_device_bytes=ring_bytes, events=len(res.events),
        events_per_tick_mean=f"{per_tick.mean():.1f}",
        events_per_tick_max=int(per_tick.max()),
        dropped=res.events_dropped_total(),
        device_busy_ms=f"{dev_us / 1e3:.3f}",
        device_busy_ms_without_capture=f"{plain_device_us / 1e3:.3f}",
        capture_device_share=(f"{(dev_us - plain_device_us) / dev_us:.4f}"
                              if dev_us else "not measured"),
        ticks_s=f"{res.seconds['ticks']:.3f}",
        decode_host_s=f"{res.seconds['decode']:.3f}",
        host_syncs=res.stats.host_syncs, table_unchanged=True)


def device_us(prof, names=()):
    """Device time in µs that a torch.profiler run saw, summed over the
    device-side events only (kernels, copies, sets): a CPU op's own device
    time repeats that of the kernels it launched, so summing every event
    counts most kernels twice.  Reads the profiler's raw events (building
    its per-op tables takes minutes for xlstm's ~540,000-kernel prefill).
    Returns (total, the part in kernels whose name holds one of ``names``,
    the number of device events)."""
    from torch.autograd import DeviceType

    total = ours = 0.0
    count = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU or ev.is_user_annotation():
            continue
        us = ev.duration_ns() / 1e3
        total += us
        count += 1
        if any(k in ev.name() for k in names):
            ours += us
    return total, ours, count


def phase_fleet_profile():
    """Device busy share of the tick loop: the fleet's runs of omfs, fcfs
    (for the four baselines that plan nothing, one loop shape) and
    backfill_cr under torch.profiler, device time summed over all kernels
    (and over the sched_select kernels) against the host wall time of the
    ticks, and the device events per tick.  Returns omfs's device time."""
    from torch.profiler import ProfilerActivity, profile

    users, jobs = fleet_workload()
    saved = kernel_counts()
    out = {}
    for policy in ("omfs", "fcfs", "backfill_cr"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = engine.simulate(users, jobs, fleet_config("cuda"),
                                  FLEET_HORIZON, policy,
                                  pass_depth=FLEET_DEPTH, device=DEV)
        dev_us, sched_us, n_events = device_us(prof, ("sched_select_plan",))
        ticks_s = res.seconds["ticks"]
        out[policy] = dev_us
        log("fleet-profile", policy=policy, ticks=FLEET_HORIZON,
            ticks_wall_s=f"{ticks_s:.4f}",
            device_busy_ms=f"{dev_us / 1e3:.3f}",
            sched_select_ms=f"{sched_us / 1e3:.3f}",
            device_busy_share=(f"{dev_us / 1e6 / ticks_s:.4f}" if dev_us
                               else "not measured"),
            device_events_per_tick=f"{n_events / FLEET_HORIZON:.1f}",
            evict_branches=res.stats.evict_branches,
            host_syncs=res.stats.host_syncs)
    set_kernel_counts(saved)
    return out["omfs"]


def fleet_plan_columns(tbl):
    """The columns and scalars of the plan a main-path eviction would make
    from the fleet's table ``tbl`` at its last tick (J=100k, T=4): one
    tenant's share of the CPUs needed, nothing idle."""
    cfg = fleet_config("cuda")
    t = FLEET_HORIZON - 1
    evictable = ((tbl.state == omfs_torch.RUNNING)
                 & (tbl.jclass != omfs_torch.NONP)
                 & ((t - tbl.run_start) >= cfg.quantum))
    eff = omfs_torch.effective_save_lat(tbl)
    cols = dict(prio=tbl.priority, run_start=tbl.run_start, jid=tbl.jid,
                key_cost=eff[:, 0].contiguous(), evictable=evictable,
                cpus=tbl.cpus, state_mib=tbl.state_mib,
                is_ckpt=tbl.jclass == omfs_torch.CKPT, save_lat=eff)
    scal = dict(idle=0, cpus_needed=FLEET_CPUS // FLEET_TENANTS,
                occ=omfs_torch.tier_occupancy(tbl, 4),
                cap=list(cfg.cr_tiers.capacity_mib))
    return cols, scal


def phase_kernel_on_fleet(final):
    """Time the kernel and its plain version on the plan a main-path
    eviction would make from the fleet's final table (J=100k, T=4)."""
    cols, scal = fleet_plan_columns(final.table)
    flags = dict(cheap=False, tiered=True, bounded=True)
    err = compare_plan(cols, scal, **flags)
    planned = plan_evictions_ref(*cols.values(), *scal.values(), **flags)[0]
    victims = int(planned.sum())
    saved = kernel_counts()
    t = time_plan(cols, scal, flags)
    floor = sched_floor_ms()
    # the plan as the engine issues it must make no host sync
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                       **flags)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    plain_ms = time_ms(lambda: plan_evictions_ref(
        *cols.values(), *scal.values(), **flags), iters=20, warmup=2)
    set_kernel_counts(saved)
    if not 0 < t["events"] <= 2:
        raise AssertionError(f"a fleet plan made {t['events']} device "
                             f"events (one launch, at most two)")
    bound, bound_by = plan_bound_ms(cols, 4, False, True, True, planned)
    log("kernel-on-fleet", J=FLEET_JOBS, T=4,
        candidates=int(cols["evictable"].sum()), victims=victims,
        ms=f"{t['ms']:.4f}", host_ms=f"{t['host_ms']:.4f}",
        floor_ms=f"{floor:.4f}", device_events=t["events"],
        traced_device_events=t["traced"], host_syncs=0,
        plain_ms=f"{plain_ms:.4f}",
        bytes=plan_bytes(cols, 4, False, True, True, planned),
        bound_ms=f"{bound:.5f}",
        share_of_bound=f"{bound / t['ms']:.4f}", max_abs_err=err)
    return dict(ms=t["ms"], host_ms=t["host_ms"], floor_ms=floor,
                plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


# ---------------------------------------------------------------------------
# the batch and stream engines, and the batched sched_select launch
# ---------------------------------------------------------------------------


def stacked_case(rng, sizes, n_tiers, bounded):
    """Cells of `random_cols` at the J of ``sizes``, padded with rows that
    are not candidates to the largest and stacked ``[B, J]`` (numpy); cell
    0 of a batch of several has no candidate.  The caps are one cell's (a
    batch has one cap vector), idle and cpus_needed each cell's."""
    j = max(sizes)
    cells = [random_cols(rng, n, n_tiers, bounded) for n in sizes]
    if len(sizes) > 1:
        cells[0][0]["evictable"][:] = False
    cols = {}
    for k in cells[0][0]:
        parts = []
        for c, _ in cells:
            v = c[k]
            pad = np.zeros((j - v.shape[0],) + v.shape[1:], v.dtype)
            parts.append(np.concatenate([v, pad]))
        cols[k] = np.ascontiguousarray(np.stack(parts))
    scal = dict(idle=np.array([s["idle"] for _, s in cells], np.int32),
                cpus_needed=np.array([s["cpus_needed"] for _, s in cells],
                                     np.int32),
                occ=np.stack([s["occ"] for _, s in cells]),
                cap=cells[0][1]["cap"])
    return cols, scal


def batch_on_card(cols, scal):
    cols = {k: torch.from_numpy(v).to(DEV) for k, v in cols.items()}
    return cols, dict(scal, **{k: torch.from_numpy(scal[k]).to(DEV)
                               for k in ("idle", "cpus_needed", "occ")})


def compare_batch(cols, scal, cells, **flags):
    """The batched launch against its plain version on the same card
    inputs; raises on any difference, returns the largest (0)."""
    got = sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                         cells=cells, **flags)
    torch.cuda.synchronize()
    want = plan_evictions_batch_ref(*cols.values(), *scal.values(),
                                    cells=cells, **flags)
    err = 0
    for name, g, w in zip(("planned", "enough", "tier"), got, want):
        d = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        if d != 0:
            raise AssertionError(
                f"batched sched_select {name} differs from its plain version "
                f"by {d} ({flags}, B={cols['prio'].shape[0]}, "
                f"{len(cells)} cells)")
        err = max(err, d)
    return err


def phase_batch_kernel_compare():
    """The batched launch bit for bit against its plain version: random
    cells of ragged J and E stacked over B in {1, 7, 256} (cell 0 with no
    candidate, cells of E > 512 beside it), every cell or every other one
    planned, and the [kernel-compare] edge cases stacked over B = 7."""
    rng = np.random.default_rng(SEED + 2)
    saved = kernel_counts()
    err = cases = 0
    t0 = time.perf_counter()
    for b, sizes, n_tiers in BATCH_SHAPES:
        sizes = [sizes[k % len(sizes)] for k in range(b)]
        for k, (cheap, tiered, bounded) in enumerate(
                (c, t, bd) for c in (False, True)
                for t, bd in ((False, False), (True, False), (True, True))):
            cols, scal = batch_on_card(*stacked_case(rng, sizes, n_tiers,
                                                     bounded))
            cells = list(range(b)) if k % 2 == 0 else list(range(0, b, 2))
            err = max(err, compare_batch(cols, scal, cells, cheap=cheap,
                                         tiered=tiered, bounded=bounded))
            cases += 1
        e = [int(x) for x in cols["evictable"].sum(1).tolist()]
        log("batch-kernel", case="random", B=b, J=max(sizes), T=n_tiers,
            candidates_min=min(e), candidates_max=max(e), max_abs_err=err)
    # the edge cases as one batch at T = 4, under cap_zero's caps
    edge_rng = np.random.default_rng(SEED + 3)
    names = [n for n in SCHED_EDGE_CASES if n != "eight_tiers"]
    edges = [edge_case(edge_rng, n, SCHED_EDGE_J) for n in names]
    edges += [random_cols(edge_rng, SCHED_EDGE_J, 4, True) for _ in range(2)]
    cols = {k: np.ascontiguousarray(np.stack([c[k] for c, _ in edges]))
            for k in edges[0][0]}
    scal = dict(idle=np.array([s["idle"] for _, s in edges], np.int32),
                cpus_needed=np.array([s["cpus_needed"] for _, s in edges],
                                     np.int32),
                occ=np.stack([s["occ"] for _, s in edges]),
                cap=edges[names.index("cap_zero")][1]["cap"])
    cols, scal = batch_on_card(cols, scal)
    for cheap in (False, True):
        for tiered, bounded in ((False, False), (True, False), (True, True)):
            sc = dict(scal, cap=scal["cap"] if bounded else [-1] * 4)
            err = max(err, compare_batch(cols, sc, list(range(len(edges))),
                                         cheap=cheap, tiered=tiered,
                                         bounded=bounded))
            cases += 1
    set_kernel_counts(saved)
    log("batch-kernel", case="edges", B=len(edges), J=SCHED_EDGE_J, T=4,
        edge_cases=",".join(names), cases=cases, max_abs_err=err,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return err


def phase_batch_kernel_time(captured):
    """The B = 4 plan of [batch-fleet]'s quantum batch (J = 100k, T = 4,
    a position where all four cells evict) as one batched launch beside
    four single launches on the same cells, in turns, on the card's time
    and as the host issues them; its bound is the four single plans'
    (`plan_bytes`, summed)."""
    args, flags = captured["args"], captured["flags"]
    names = ("prio", "run_start", "jid", "key_cost", "evictable", "cpus",
             "state_mib", "is_ckpt", "save_lat")
    cols = dict(zip(names, args[:9]))
    idle, need, occ, cap = args[9:13]
    b = cols["prio"].shape[0]
    scal = dict(idle=idle, cpus_needed=need, occ=occ, cap=cap)
    cells = list(range(b))
    err = compare_batch(cols, scal, cells, **flags)
    singles = [({k: v[c] for k, v in cols.items()},
                dict(idle=idle[c], cpus_needed=need[c], occ=occ[c], cap=cap))
               for c in cells]
    for c_cols, c_scal in singles:
        err = max(err, compare_plan(c_cols, c_scal, **flags))
    saved = kernel_counts()

    def batched():
        sched_ops.plan_evictions_fused(*cols.values(), *scal.values(),
                                       cells=cells, **flags)

    def four_singles():
        for c_cols, c_scal in singles:
            sched_ops.plan_evictions_fused(*c_cols.values(),
                                           *c_scal.values(), **flags)

    card = {"batched": [], "singles": []}
    for name in ("batched", "singles", "singles", "batched"):
        card[name].append(queued_ms(batched if name == "batched"
                                    else four_singles, iters=40))
    host, _ = in_turns({"batched": batched, "singles": four_singles},
                       iters={"batched": 100, "singles": 100}, warmup=5)
    events, _ = plan_events(batched)
    plain_ms = time_ms(lambda: plan_evictions_batch_ref(
        *cols.values(), *scal.values(), cells=cells, **flags), iters=10,
        warmup=1)
    set_kernel_counts(saved)
    planned = plan_evictions_batch_ref(*cols.values(), *scal.values(),
                                       cells=cells, **flags)[0]
    n_tiers = cols["save_lat"].shape[-1]
    nbytes = sum(plan_bytes({k: v[c] for k, v in cols.items()}, n_tiers,
                            flags["cheap"], flags["tiered"], flags["bounded"],
                            planned[c]) for c in cells)
    e = [int(x) for x in cols["evictable"].sum(1).tolist()]
    ops_s = sum(x * int(np.ceil(np.log2(max(x, 2)))) for x in e) \
        / SCALAR_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    bound = 1e3 * max(byte_s, ops_s)
    ms = sum(card["batched"]) / 2
    singles_ms = sum(card["singles"]) / 2
    log("batch-kernel", case="fleet-quanta", B=b,
        J=cols["prio"].shape[1], T=n_tiers, source=captured["source"],
        candidates=e, victims=[int(x) for x in planned.sum(1).tolist()],
        ms=f"{ms:.4f}", four_singles_ms=f"{singles_ms:.4f}",
        host_ms=f"{host['batched']:.4f}",
        four_singles_host_ms=f"{host['singles']:.4f}",
        device_events=events, plain_ms=f"{plain_ms:.4f}", bytes=nbytes,
        bound_ms=f"{bound:.5f}", share_of_bound=f"{bound / ms:.4f}",
        max_abs_err=err)
    return dict(ms=ms, singles_ms=singles_ms, host_ms=host["batched"],
                plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if byte_s >= ops_s else "operations",
                max_abs_err=err)


def sweep_workload(seed):
    """benchmarks/bench_sweep.py's workload: 4 tenants, 32 jobs, 32 CPUs."""
    spec = WorkloadSpec(n_users=4, horizon=SWEEP_HORIZON, cpu_total=SWEEP_CPUS,
                        seed=seed, arrival_rate=0.15, mean_work=20,
                        class_mix=(0.15, 0.35, 0.5))
    users = make_users(spec)
    return users, make_jobs(spec, users)[:SWEEP_JOBS]


def group_syncs(results):
    """Host syncs of a batch: each policy group's, once."""
    return sum({r.policy: r.stats.host_syncs for r in results}.values())


def phase_batch_sweep():
    """bench_sweep.py's grid (quantum x pass depth x victim key x
    seed, SWEEP_SEEDS: 128 cells) as one `simulate_batch` on the card:
    every cell must equal its sequential `simulate` on the card and the
    "torch" backend's batch; cells/s both ways, host syncs per tick,
    launches and plans."""
    workloads = {s: sweep_workload(s) for s in SWEEP_SEEDS}
    grid = [(q, d, p, s) for q in SWEEP_QUANTA for d in SWEEP_DEPTHS
            for p in SWEEP_POLICIES for s in SWEEP_SEEDS]
    cells = [engine.BatchCell(users=workloads[s][0], jobs=workloads[s][1],
                              policy=p, quantum=q, pass_depth=d)
             for q, d, p, s in grid]
    base = SchedulerConfig(cpu_total=SWEEP_CPUS, quantum=1)
    saved = kernel_counts()
    zero_kernel_counts()
    t0 = time.perf_counter()
    batch = engine.simulate_batch(cells, base, SWEEP_TICKS, device=DEV)
    cold_s = time.perf_counter() - t0
    launches, plans = sched_ops.LAUNCHES, sched_ops.PLANS
    t0 = time.perf_counter()
    engine.simulate_batch(cells, base, SWEEP_TICKS, device=DEV)
    warm_s = time.perf_counter() - t0
    eager = engine.simulate_batch(
        cells, dataclasses.replace(base, kernel_backend="torch"),
        SWEEP_TICKS, device=DEV)
    t0 = time.perf_counter()
    seq = [engine.simulate(workloads[s][0], workloads[s][1],
                           SchedulerConfig(cpu_total=SWEEP_CPUS, quantum=q),
                           SWEEP_TICKS, p, pass_depth=d, device=DEV)
           for q, d, p, s in grid]
    seq_s = time.perf_counter() - t0
    set_kernel_counts(saved)
    for (q, d, p, s), b, e, r in zip(grid, batch, eager, seq):
        what = f"sweep q={q} d={d} {p} seed={s}"
        assert_same_run(b, r, what + ": batch vs simulate")
        assert_same_run(b, e, what + ": cuda vs torch batch")
        if b.stats.evict_branches != r.stats.evict_branches:
            raise AssertionError(f"{what}: {b.stats} vs {r.stats}")
    branches = sum(r.stats.evict_branches for r in seq)
    syncs = group_syncs(batch) / SWEEP_TICKS
    if plans != branches or syncs != len(SWEEP_POLICIES) * max(SWEEP_DEPTHS):
        raise AssertionError(f"sweep: {plans} plans for {branches} branches, "
                             f"{syncs} host syncs a tick")
    n = len(cells)
    seq_syncs = sum(r.stats.host_syncs for r in seq) / SWEEP_TICKS
    log("batch-sweep", cells=n, jobs=SWEEP_JOBS, cpus=SWEEP_CPUS,
        ticks=SWEEP_TICKS, grid="quantum*depth*policy*seed",
        batch_cells_per_s=f"{n / warm_s:.2f}",
        batch_cold_cells_per_s=f"{n / cold_s:.2f}",
        seq_cells_per_s=f"{n / seq_s:.2f}",
        speedup_warm=f"{seq_s / warm_s:.2f}",
        host_syncs_per_tick=f"{syncs:.2f}",
        seq_host_syncs_per_tick=f"{seq_syncs:.2f}",
        evict_branches=branches, launches=launches, plans=plans,
        identical_to_simulate=True, identical_to_torch_backend=True)


def phase_batch_fleet(runs):
    """The 100k-job fleet as two batches on the card: the seven policies
    (B = 7, one cell a group: each must equal its [fleet] run, with the
    same host syncs and plans) and omfs at four quanta (B = 4, one group:
    32 host syncs a tick for the four, each cell equal to its own
    `simulate`).  Returns the launches of both, and the columns of one
    four-cell plan for [batch-kernel]."""
    users, jobs = fleet_workload()
    cfg = fleet_config("cuda")
    saved = kernel_counts()
    zero_kernel_counts()
    t0 = time.perf_counter()
    seven = engine.simulate_batch(
        [engine.BatchCell(users=users, jobs=jobs, policy=p,
                          pass_depth=FLEET_DEPTH) for p in POLICIES],
        cfg, FLEET_HORIZON, device=DEV)
    seven_s = time.perf_counter() - t0
    launches7, plans7 = sched_ops.LAUNCHES, sched_ops.PLANS
    for res in seven:
        solo = runs[res.policy, "cuda"]
        assert_same_run(res, solo, f"batch-fleet {res.policy}")
        if res.stats != solo.stats:
            raise AssertionError(f"batch-fleet {res.policy}: {res.stats} != "
                                 f"{solo.stats}")
    branches7 = sum(runs[p, "cuda"].stats.evict_branches for p in POLICIES)
    syncs7 = group_syncs(seven) / FLEET_HORIZON
    want7 = sum(runs[p, "cuda"].stats.host_syncs
                for p in POLICIES) / FLEET_HORIZON
    if launches7 != branches7 or plans7 != branches7 or syncs7 != want7:
        raise AssertionError(f"batch-fleet seven: {launches7} launches, "
                             f"{plans7} plans, {branches7} branches, "
                             f"{syncs7} syncs a tick against {want7}")
    seq7_s = sum(runs[p, "cuda"].seconds["build"]
                 + runs[p, "cuda"].seconds["ticks"] for p in POLICIES)
    log("batch-fleet", batch="seven-policies", B=len(seven), J=FLEET_JOBS,
        horizon=FLEET_HORIZON, wall_s=f"{seven_s:.2f}",
        seq_wall_s=f"{seq7_s:.2f}",
        ticks_s=f"{sum(r.seconds['ticks'] for r in seven):.2f}",
        host_syncs_per_tick=f"{syncs7:.2f}", launches=launches7,
        plans=plans7, identical_to_fleet=True)

    # omfs at four quanta: one group
    seq = {}
    for q in BATCH_QUANTA:
        seq[q] = (runs["omfs", "cuda"] if q == FLEET_QUANTUM else
                  engine.simulate(users, jobs,
                                  dataclasses.replace(cfg, quantum=q),
                                  FLEET_HORIZON, "omfs",
                                  pass_depth=FLEET_DEPTH, device=DEV))
    captured = {}
    real = sched_ops.plan_evictions_fused

    def spy(*args, cells=None, **flags):
        if cells is not None and len(cells) == len(BATCH_QUANTA) \
                and "args" not in captured:
            captured.update(args=[a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args], flags=flags,
                            source="a position where all four evict")
        return real(*args, cells=cells, **flags)

    sched_ops.plan_evictions_fused = spy
    launches_before = sched_ops.LAUNCHES
    plans_before = sched_ops.PLANS
    t0 = time.perf_counter()
    try:
        quanta = engine.simulate_batch(
            [engine.BatchCell(users=users, jobs=jobs, policy="omfs",
                              quantum=q, pass_depth=FLEET_DEPTH)
             for q in BATCH_QUANTA], cfg, FLEET_HORIZON, device=DEV)
    finally:
        sched_ops.plan_evictions_fused = real
    quanta_s = time.perf_counter() - t0
    launches4 = sched_ops.LAUNCHES - launches_before
    plans4 = sched_ops.PLANS - plans_before
    set_kernel_counts(saved)
    branches = [seq[q].stats.evict_branches for q in BATCH_QUANTA]
    for q, res in zip(BATCH_QUANTA, quanta):
        assert_same_run(res, seq[q], f"batch-fleet quantum {q}")
        if res.stats.evict_branches != seq[q].stats.evict_branches:
            raise AssertionError(f"batch-fleet quantum {q}: {res.stats}")
    syncs4 = group_syncs(quanta) / FLEET_HORIZON
    if (syncs4 != FLEET_DEPTH or plans4 != sum(branches)
            or not max(branches) <= launches4 <= sum(branches)):
        raise AssertionError(f"batch-fleet quanta: {syncs4} syncs a tick, "
                             f"{plans4} plans, {launches4} launches, "
                             f"branches {branches}")
    if "args" not in captured:
        # no position had all four evict: plan the four final tables at the
        # last tick, as [kernel-on-fleet] plans the fleet's
        per = [fleet_plan_columns(r.table) for r in quanta]
        args = [torch.stack([c[k] for c, _ in per]).contiguous()
                for k in per[0][0]]
        args += [torch.full((4,), per[0][1]["idle"], dtype=torch.int32,
                            device=DEV),
                 torch.full((4,), per[0][1]["cpus_needed"],
                            dtype=torch.int32, device=DEV),
                 torch.stack([s["occ"] for _, s in per]), per[0][1]["cap"]]
        captured.update(args=args, source="the final tables",
                        flags=dict(cheap=False, tiered=True, bounded=True))
    seq4_s = sum(seq[q].seconds["build"] + seq[q].seconds["ticks"]
                 for q in BATCH_QUANTA)
    seq4_ticks = sum(seq[q].seconds["ticks"] for q in BATCH_QUANTA)
    seq4_syncs = sum(seq[q].stats.host_syncs
                     for q in BATCH_QUANTA) / FLEET_HORIZON
    log("batch-fleet", batch="omfs-quanta", quanta=BATCH_QUANTA, B=len(quanta),
        J=FLEET_JOBS, horizon=FLEET_HORIZON, wall_s=f"{quanta_s:.2f}",
        ticks_s=f"{quanta[0].seconds['ticks']:.2f}",
        seq_wall_s=f"{seq4_s:.2f}",
        seq_ticks_s=f"{seq4_ticks:.2f}",
        host_syncs_per_tick=f"{syncs4:.2f}",
        seq_host_syncs_per_tick=f"{seq4_syncs:.2f}",
        evict_branches=branches, launches=launches4, plans=plans4,
        identical_to_simulate=True)
    return launches7 + launches4, captured


def phase_batch_events(workload, card_runs):
    """[events]'s fleet (the same jobs, so the same ids), the seven
    policies as one batch with capture on: each cell's log, counts and
    drops must be [events]'s for its policy."""
    users, jobs, cfg = workload
    saved = kernel_counts()
    t0 = time.perf_counter()
    batch = engine.simulate_batch(
        [engine.BatchCell(users=users, jobs=jobs, policy=p,
                          pass_depth=EVENTS_DEPTH) for p in POLICIES],
        cfg, EVENTS_HORIZON, record_events=True, device=DEV)
    wall = time.perf_counter() - t0
    set_kernel_counts(saved)
    for res in batch:
        solo = card_runs[res.policy]
        same_log(res, solo, f"batch-events {res.policy}")
        assert_same_run(res, solo, f"batch-events {res.policy}")
    log("batch-events", B=len(batch), jobs=len(jobs), horizon=EVENTS_HORIZON,
        pass_depth=EVENTS_DEPTH, events=sum(len(r.events) for r in batch),
        wall_s=f"{wall:.2f}", identical_to_events=True)


def phase_stream_fleet():
    """omfs on the fleet's arrivals through `simulate_stream`: a first run
    whose capacity holds every arrival measures the live peak, the second
    runs at the smallest power of two above it (profiled) and must equal
    the monolithic `simulate` over the jobs submitted before the horizon,
    with no deferral."""
    users, jobs = fleet_workload()
    cfg = fleet_config("cuda")
    due = [j for j in jobs if j.submit_time < STREAM_HORIZON]
    saved = kernel_counts()
    zero_kernel_counts()
    kw = dict(segment_len=STREAM_SEGMENT, pass_depth=FLEET_DEPTH, device=DEV)
    first = engine.simulate_stream(users, arrival_stream(jobs), cfg,
                                   STREAM_HORIZON, "omfs",
                                   capacity=STREAM_AMPLE, **kw)
    peak = first.stream_stats["peak_live"]
    capacity = 1 << max(0, peak - 1).bit_length()
    timers = ProfileTimers()
    t0 = time.perf_counter()
    res = engine.simulate_stream(users, arrival_stream(jobs), cfg,
                                 STREAM_HORIZON, "omfs", capacity=capacity,
                                 profile=timers, **kw)
    stream_s = time.perf_counter() - t0
    launches = sched_ops.LAUNCHES
    mono = engine.simulate(users, due, cfg, STREAM_HORIZON, "omfs",
                           pass_depth=FLEET_DEPTH, device=DEV)
    set_kernel_counts(saved)
    stats = res.stream_stats
    if stats["deferrals"] or first.stream_stats["deferrals"] \
            or stats["inserted"] != len(due):
        raise AssertionError(f"stream-fleet deferred or lost arrivals: "
                             f"{stats}, first run {first.stream_stats}")
    assert_same_run(res, mono, "stream-fleet vs monolithic")
    assert_same_run(first, mono, "stream-fleet (ample) vs monolithic")
    prof = timers.snapshot()
    reads = res.stats.table_reads / stats["segments"]
    log("stream-fleet", policy="omfs", horizon=STREAM_HORIZON,
        segment_len=STREAM_SEGMENT, arrivals=len(due),
        peak_live=peak, capacity=capacity, segments=stats["segments"],
        deferrals=stats["deferrals"], dropped=stats["dropped"],
        ticks_per_s_stream=f"{STREAM_HORIZON / stream_s:.3f}",
        ticks_per_s_monolithic=f"{STREAM_HORIZON / mono.seconds['ticks']:.3f}",
        # compile: 0 where an earlier phase had loaded the kernel library
        **{f"{k}_s": f"{prof.get(k, {'total_s': 0.0})['total_s']:.3f}"
           for k in ("compile", "dispatch", "compaction")},
        host_reads_per_boundary=f"{reads:.2f}",
        host_syncs_per_tick=f"{res.stats.host_syncs / STREAM_HORIZON:.2f}",
        launches=launches, spills=int(res.table.n_spill.sum()),
        identical_to_monolithic=True)


def phase_launcher():
    # the launcher's default fleet, its first LAUNCHER_TICKS ticks
    argv = ["--fast-tier-cap-mib", "4096", "--horizon", str(LAUNCHER_TICKS)]
    t0 = time.perf_counter()
    res = cluster_sim.main(argv + ["--device", "cuda"])
    cuda_s = time.perf_counter() - t0
    ref = cluster_sim.main(argv + ["--device", "cpu"])
    assert_same_run(res, ref, "launcher cuda vs cpu")
    log("launcher", ticks=len(res.busy_series()),
        seconds_cuda=f"{cuda_s:.2f}", identical_to_cpu_plain=True)
    with scratch_dir() as root:
        trace_path, metrics_path = (Path(root) / "trace.json",
                                    Path(root) / "metrics.json")
        t0 = time.perf_counter()
        ev = cluster_sim.main(argv + [
            "--device", "cuda", "--events", "--trace-out", str(trace_path),
            "--metrics-out", str(metrics_path)])
        events_s = time.perf_counter() - t0
        trace = json.loads(trace_path.read_text())
        metrics = json.loads(metrics_path.read_text())
    problems = validate_trace(trace, events=ev.events)
    if problems:
        raise AssertionError(f"launcher trace invalid: {problems[:5]}")
    if not metrics.get("sched_events_total"):
        raise AssertionError("launcher metrics hold no event counters")
    assert_same_run(ev, res, "launcher with events vs without")
    log("launcher", events=len(ev.events), dropped=ev.events_dropped_total(),
        trace_events=len(trace["traceEvents"]), metrics=len(metrics),
        seconds_cuda=f"{events_s:.2f}", trace_valid=True,
        table_unchanged=True)
    # --backend torch (on the card) against --backend python
    zero_kernel_counts()
    t0 = time.perf_counter()
    card = cluster_sim.main(LAUNCHER_BACKENDS_ARGV + [
        "--backend", "torch", "--device", DEV.type])
    card_s = time.perf_counter() - t0
    launches = kernel_counts()
    t0 = time.perf_counter()
    host = cluster_sim.main(LAUNCHER_BACKENDS_ARGV + ["--backend", "python"])
    host_s = time.perf_counter() - t0
    if card.signature() != host.signature():
        raise AssertionError("launcher: --backend torch and python schedule "
                             "differently")
    if launches["sched_select"] != card.stats.evict_branches or not launches[
            "sched_select"]:
        raise AssertionError(f"launcher: sched_select launches {launches} "
                             f"for {card.stats.evict_branches} branches")
    log("launcher", backends="torch-vs-python", argv=LAUNCHER_BACKENDS_ARGV,
        ticks=len(card.busy_series()),
        preemptions=card.summary()["preemptions"], same_signature=True,
        seconds_torch=f"{card_s:.2f}", seconds_python=f"{host_s:.2f}",
        launches_sched_select=launches["sched_select"])


def trace_without_ids(body):
    """A trace's JSON with its job ids counted from its first span's and
    its backend's name blanked: each build of a workload draws its job ids
    from the process's counter, and the trace names its backend."""
    trace = json.loads(body)
    first = min(e["args"]["jid"] for e in trace["traceEvents"]
                if e.get("ph") == "X")
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            e["args"]["jid"] -= first
            e["name"] = f"job {e['args']['jid']}"
        elif e.get("ph") in ("s", "f"):
            e["id"] -= first
    trace["otherData"]["backend"] = "any"
    return trace


def phase_sched_status():
    """`launch.serve --sched-status`'s payloads built on the card
    (``--backend torch``, through the `sched_select` kernel) and by the
    host reference (``--backend python``): ``/metrics`` byte-equal,
    ``/trace.json`` equal but for the job ids' origin and the backend's
    name, ``/healthz`` equal but for the backend; then the card's served on
    127.0.0.1 for SCHED_STATUS_REQUESTS requests and read back over a
    socket."""
    import threading
    import urllib.error
    import urllib.request

    argv = ["--sched-status", "--port", "0", "--max-requests",
            str(SCHED_STATUS_REQUESTS), "--device", DEV.type]
    payloads, secs = {}, {}
    for backend in ("torch", "python"):
        args = serve.parser().parse_args(argv + ["--backend", backend])
        zero_kernel_counts()
        t0 = time.perf_counter()
        payloads[backend] = serve.sched_status_payloads(args)
        secs[backend] = time.perf_counter() - t0
        if backend == "torch":
            launches = kernel_counts()
    card, host = payloads["torch"], payloads["python"]
    if card["/metrics"] != host["/metrics"]:
        raise AssertionError("sched-status: /metrics differ by backend")
    if trace_without_ids(card["/trace.json"][1]) != trace_without_ids(
            host["/trace.json"][1]):
        raise AssertionError("sched-status: /trace.json differs by backend")
    health = {k: json.loads(p["/healthz"][1]) for k, p in payloads.items()}
    if ({k: v for k, v in health["torch"].items() if k != "backend"}
            != {k: v for k, v in health["python"].items() if k != "backend"}):
        raise AssertionError(f"sched-status: /healthz differ: {health}")
    if launches["sched_select"] < 1:
        raise AssertionError(f"sched-status: no sched_select launch: "
                             f"{launches}")
    server = serve.sched_status_server(args, card)
    addr, port = server.server_address[:2]
    thread = threading.Thread(target=serve.serve_sched_status,
                              args=(args, server))
    thread.start()
    got, missing = {}, None
    try:
        for path in ("/metrics", "/trace.json", "/healthz"):
            with urllib.request.urlopen(f"http://{addr}:{port}{path}",
                                        timeout=60) as resp:
                got[path] = (resp.headers["Content-Type"], resp.read())
        try:
            urllib.request.urlopen(f"http://{addr}:{port}/nope", timeout=60)
        except urllib.error.HTTPError as err:
            missing = err.code
    finally:
        thread.join(timeout=60)
    if thread.is_alive() or got != card or missing != 404:
        raise AssertionError(f"sched-status: served {sorted(got)}, equal "
                             f"{got == card}, 404 {missing}, server ended "
                             f"{not thread.is_alive()}")
    summary = health["torch"]["summary"]
    log("sched-status", policy=args.policy, tenants=args.tenants,
        chips=args.chips, horizon=args.horizon, events=health["torch"][
            "events"], preemptions=summary["preemptions"],
        checkpoints=summary["checkpoints"], metrics_bytes=len(
            card["/metrics"][1]), trace_bytes=len(card["/trace.json"][1]),
        torch_equals_python=True, seconds_torch=f"{secs['torch']:.2f}",
        seconds_python=f"{secs['python']:.2f}",
        served=SCHED_STATUS_REQUESTS, host=addr,
        launches_sched_select=launches["sched_select"],
        plans=launches["sched_select_plans"])


# ---------------------------------------------------------------------------
# checkpoint-restart: the int8 codec, the TrainState-shaped state
# ---------------------------------------------------------------------------


def same_bits(a, b):
    """Equal dtype, shape and raw bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def codec_bound_ms(numels, ops_per_element):
    """Least time for quantizing (or dequantizing to fp32) tensors of
    ``numels`` elements: 4n + 128R + 4R bytes each, against the fp32
    operations the function needs."""
    rows = sum(-(-n // LANE) for n in numels)
    byte_s = (4 * sum(numels) + (LANE + 4) * rows) / HBM_BYTES_PER_S
    ops_s = ops_per_element * sum(numels) / SCALAR_OPS_PER_S
    return 1e3 * max(byte_s, ops_s), ("bytes" if byte_s >= ops_s
                                      else "operations")


def special_rows():
    """An all-zero row (it takes the 1e-12 floor) and rows of exact
    half-way codes: an absmax of 127 * 2^m makes the scale exactly 2^m
    (127 * fl32(1/127) rounds to 1), so (k + 0.5) * 2^m divides to k + 0.5
    and must round to even."""
    rows = [np.zeros(LANE, np.float32)]
    for m in (-20, -3, 0, 5):
        scale = np.float32(127 * 2.0**m) * np.float32(1.0 / 127.0)
        assert scale == np.float32(2.0**m), scale
        for ks in (np.arange(-126, 1), np.arange(0, 127)):
            rows.append(np.concatenate([[127.0], ks + 0.5]) * 2.0**m)
    return torch.from_numpy(np.stack(rows).astype(np.float32)).to(DEV)


def compare_codec(x):
    """Kernels against their plain versions on the same card tensor (codes,
    scales, fp32 and bf16 round trips, bit for bit), and the round trip's
    bound |y - x| <= absmax/127 + 1e-6; returns the largest absolute
    difference between kernel and plain outputs."""
    n = x.numel()
    q, s = codec_ops.quantize_array(x)
    qr, sr = quantize_array_ref(x)
    torch.cuda.synchronize()
    if not (same_bits(q, qr) and same_bits(s, sr)):
        raise AssertionError(
            f"ckpt_quantize differs from its plain version at n={n}: "
            f"{int((q != qr).sum())} codes, {int((s != sr).sum())} scales")
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        y = codec_ops.dequantize_array(q, s, shape=x.shape, dtype=dtype)
        yr = dequantize_array_ref(q, s, x.shape, dtype)
        torch.cuda.synchronize()
        if not same_bits(y, yr):
            raise AssertionError(
                f"ckpt_dequantize ({dtype}) differs from its plain version "
                f"at n={n} in {int((y != yr).sum())} elements")
        err = max(err, float((y.float() - yr.float()).abs().max()))
        if dtype == torch.float32:
            bound = float(x.abs().max()) / 127.0 + 1e-6
            worst = float((y - x).abs().max())
            if worst > bound:
                raise AssertionError(f"codec round trip error {worst} > "
                                     f"{bound} at n={n}")
    return err


def trained_snapshots(cfg, steps, *, seq, batch, chunk, seed=SEED):
    """The states after each of ``steps`` train steps of ``cfg`` on the
    card, copies taken as benchmarks/bench_cr_cost.py takes them:
    `TrainConfig()` defaults, `SyntheticLM` batches from cursor 0."""
    model = Model(cfg, device=DEV, q_chunk=chunk, kv_chunk=chunk)
    model.init(torch.Generator(device=DEV).manual_seed(seed))
    state = init_train_state(model.params(), seed)
    step = make_train_step(model, TrainConfig())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed))
    states = []
    for i in range(steps):
        state, _ = step(state, shard_batch(data.batch_at(i), DEV))
        states.append(serialize.map_with_path(
            lambda _k, t: t.detach().clone(), state))
    torch.cuda.synchronize()
    return states


def scratch_dir():
    """A temporary directory inside the checkout's git-ignored build/."""
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    return tempfile.TemporaryDirectory(dir=root)


def phase_codec_compare():
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    special = special_rows().reshape(-1)
    saved = dict(codec_ops.LAUNCHES)
    err = 0.0
    t0 = time.perf_counter()
    for n in CODEC_SIZES:
        x = torch.randn(n, generator=gen, device=DEV) * 3.0
        if n >= special.numel():
            x[:special.numel()] = special
        err = max(err, compare_codec(x))
        if n % LANE == 0:               # the [R, 128] block entry points
            blocks = x.view(-1, LANE)
            q, s = codec_ops.quantize_blocks(blocks)
            qr, sr = quantize_ref(blocks)
            y = codec_ops.dequantize_blocks(q, s, out_dtype=torch.bfloat16)
            yr = dequantize_ref(qr, sr, torch.bfloat16)
            torch.cuda.synchronize()
            if not (same_bits(q, qr) and same_bits(s, sr)
                    and same_bits(y, yr)):
                raise AssertionError(f"ckpt_codec block API differs at n={n}")
    err = max(err, compare_codec(special.view(-1, 8, 16)))
    codec_ops.LAUNCHES.update(saved)
    log("codec-compare", sizes=list(CODEC_SIZES),
        special_rows=special.numel() // LANE, bit_identical=True,
        max_abs_err=err, seconds=f"{time.perf_counter() - t0:.1f}")
    return err


def time_leaves(fn, leaves, iters, warmup=1):
    """CUDA-event ms of one pass of ``fn`` over every leaf."""
    def one_pass():
        for leaf in leaves:
            fn(leaf)
    return time_ms(one_pass, iters=iters, warmup=warmup)


def phase_codec_state(state, cfg):
    """The codec over every fp32 leaf of ``state``: `[train]`'s trained
    TrainState at the published widths of internlm2-1.8b, depth
    TRAIN_LAYERS."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = serialize.map_with_path(lambda _k, t: t.detach(), state)
    leaves = serialize.leaf_paths(state)
    state_bytes = serialize.tree_bytes(state)
    coded = [t for _, t in leaves
             if t.dtype == torch.float32 and t.numel() >= LANE]
    saved = dict(codec_ops.LAUNCHES)
    err = 0.0
    for t in coded:
        err = max(err, compare_codec(t))
    numels = [t.numel() for t in coded]
    big_path, big = max(leaves, key=lambda kv: kv[1].numel())
    big_index = next(i for i, t in enumerate(coded) if t is big)
    codes = [codec_ops.quantize_array(t) for t in coded]

    def dequantize(i):
        q, s = codes[i]
        return codec_ops.dequantize_array(q, s, shape=coded[i].shape)

    def dequantize_plain(i):
        return dequantize_array_ref(*codes[i], coded[i].shape)

    index = range(len(coded))
    timing = {
        "quantize": dict(
            ms=time_leaves(codec_ops.quantize_array, coded, iters=5),
            plain_ms=time_leaves(quantize_array_ref, coded, iters=2),
            big_ms=time_ms(lambda: codec_ops.quantize_array(big), iters=20),
            bound=codec_bound_ms(numels, 7)),
        "dequantize": dict(
            ms=time_leaves(dequantize, index, iters=5),
            plain_ms=time_leaves(dequantize_plain, index, iters=2),
            big_ms=time_ms(lambda: codec_ops.dequantize_array(
                *codes[big_index], shape=big.shape), iters=20),
            bound=codec_bound_ms(numels, 2)),
    }
    codec_ops.LAUNCHES.update(saved)
    peak = torch.cuda.max_memory_allocated()
    big_bound = {"quantize": codec_bound_ms([big.numel()], 7)[0],
                 "dequantize": codec_bound_ms([big.numel()], 2)[0]}
    for name, tm in timing.items():
        bound, bound_by = tm["bound"]
        log("codec-state", kernel=name, config=cfg.name, state="trained",
            step=int(state.step), layers=cfg.n_layers, leaves=len(leaves),
            coded_leaves=len(coded), state_bytes=state_bytes,
            state_gib=f"{state_bytes / 2**30:.2f}", ms=f"{tm['ms']:.4f}",
            plain_ms=f"{tm['plain_ms']:.4f}", bound_ms=f"{bound:.4f}",
            bound_by=bound_by, share_of_bound=f"{bound / tm['ms']:.4f}",
            launches_per_pass=len(coded), largest_leaf=repr(big_path),
            largest_ms=f"{tm['big_ms']:.4f}",
            largest_bound_ms=f"{big_bound[name]:.4f}",
            largest_share=f"{big_bound[name] / tm['big_ms']:.4f}",
            max_abs_err=err, max_memory_allocated=peak)
    del leaves, coded, codes, big
    torch.cuda.empty_cache()
    log("codec-state-done", seconds=f"{time.perf_counter() - t0:.1f}")
    return {name: dict(ms=tm["ms"], plain_ms=tm["plain_ms"],
                       bound_ms=tm["bound"][0], bound_by=tm["bound"][1],
                       max_abs_err=err)
            for name, tm in timing.items()}


def phase_cr_fast_tier():
    """A CheckpointService save, save, restore cycle on the card at the
    widths of internlm2-1.8b and depth FAST_TIER_DEPTH: the fast tier
    only (8 GiB, no delta, no durable save), around one real train step
    (batch 1 x 256 tokens)."""
    cfg = get_config(TRAIN_ARCH).replace(n_layers=FAST_TIER_DEPTH)
    model = Model(cfg, device=DEV)
    model.init(torch.Generator(device=DEV).manual_seed(SEED + 2))
    state = init_train_state(model.params(), SEED + 2)
    step = make_train_step(model, TrainConfig(lr=1e-3, warmup_steps=0))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                  global_batch=1, seed=SEED))
    template = train_state_shapes(model)
    state_bytes = serialize.tree_bytes(state)
    with scratch_dir() as root:
        svc = CheckpointService(ManagerConfig(
            root=Path(root), mem_capacity_bytes=8 << 30, use_delta=False,
            durable_every=1 << 30), device=DEV)
        try:
            svc.save(0, state)
            state, _ = step(state, shard_batch(data.batch_at(0), DEV))
            torch.cuda.synchronize()
            svc.save(1, state)
            restored, name = svc.restore(template)
            stats = svc.stats()
            evictions = svc.manager.mem.stats.evictions
            durable = svc.manager.disk.names()
        finally:
            svc.close()
    want = dict(serialize.leaf_paths(state))
    got = dict(serialize.leaf_paths(restored))
    if name != "step_00000001" or got.keys() != want.keys() or not all(
            same_bits(got[k], want[k].to(got[k].device)) for k in want):
        raise AssertionError(f"fast-tier restore of {name} is not the saved "
                             "state bit for bit")
    if got[".params['embed']"].device != DEV or durable:
        raise AssertionError("fast-tier restore left the card or wrote a "
                             "durable checkpoint")
    log("cr-fast-tier", config=cfg.name, layers=FAST_TIER_DEPTH,
        state="trained", state_bytes=state_bytes,
        state_gib=f"{state_bytes / 2**30:.2f}",
        saves=stats.saves, restores=stats.restores,
        save_s=f"{stats.save_seconds:.3f}",
        restore_s=f"{stats.restore_seconds:.3f}",
        device_to_host_GBps=f"{stats.save_bytes_per_s / 1e9:.3f}",
        host_to_device_GBps=f"{stats.restore_bytes_per_s / 1e9:.3f}",
        mem_evictions=evictions, bit_equal=True)
    del state, restored, got, want, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training: one step against the CPU, the launcher, the cluster executor
# ---------------------------------------------------------------------------


def step_bars(card, cpu, dtype, lr):
    """The parameters after one step on the card against the CPU's: the
    largest difference where |g| >= GRAD_TOL of the leaf's largest (the
    first moment after one step is 0.1 g, clipped), and everywhere; each
    CPU leaf copied to the card and compared there (the same exact fp32
    differences, without the host's passes over every leaf)."""
    m = dict(serialize.leaf_paths(cpu.opt.m))
    got = dict(serialize.leaf_paths(card.params))
    tight = loose = 0.0
    for path, want in serialize.leaf_paths(cpu.params):
        g = m[path].to(DEV).abs()
        err = (got[path].detach().float()
               - want.detach().to(DEV).float()).abs()
        sel = g >= GRAD_TOL[dtype] * g.max()
        tight = max(tight, float(err[sel].max()) if sel.any() else 0.0)
        loose = max(loose, float(err.max()))
    if tight > 1e-6 + 1e-3 * lr or loose > 1e-6 + 2 * lr:
        raise AssertionError(f"train step ({dtype}): parameters differ by "
                             f"{tight} where |g| is large, {loose} anywhere")
    return tight, loose


def phase_train_vs_cpu(phase="train-vs-cpu", arch=TRAIN_ARCH,
                       layers=TRAIN_CPU_LAYERS,
                       dtypes=("float32", "bfloat16"), frontend=None):
    """One train step of ``arch`` at its published widths, depth
    ``layers`` (`cut_config`), batch TRAIN_CPU_BATCH x TRAIN_CPU_SEQ, on
    the card and on the CPU from one seeded init (a VLM's gates by
    `seed_gates`), in each compute dtype of
    ``dtypes``, fp32 master weights, the VLM and the audio model on the
    first TRAIN_CPU_BATCH rows of ``frontend``: loss, grad norm and the
    parameters after the step to the CPU tests' bars, 0 kernel launches
    on the card."""
    for dtype in dtypes:
        t0 = time.perf_counter()
        cfg = cut_config(arch, layers, compute_dtype=dtype)
        # drawn on the card (a CPU generator takes ~20 s for deepseek's
        # 1.6 B weights), copied to the CPU; a VLM's gates seeded
        card = seed_gates(Model(cfg, device=DEV).init(
            torch.Generator(device=DEV).manual_seed(SEED)))
        cpu = Model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        tcfg = TrainConfig(lr=TRAIN_CPU_LR, warmup_steps=0, total_steps=100)
        batch = SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ,
            global_batch=TRAIN_CPU_BATCH, seed=SEED)).batch_at(0)
        states, metrics, secs = {}, {}, {}
        zero_kernel_counts()
        for name, model in (("cpu", cpu), ("card", card)):
            ts = time.perf_counter()
            state = init_train_state(model.params(), SEED)
            sharded = shard_batch(batch, model.device)
            if frontend is not None:
                sharded["frontend"] = frontend[:TRAIN_CPU_BATCH].to(
                    model.device)
            state, met = make_train_step(model, tcfg)(state, sharded)
            metrics[name] = {k: float(v) for k, v in met.items()}
            secs[name] = time.perf_counter() - ts
            states[name] = state
        loss_tol, gnorm_tol = STEP_TOL[dtype]
        rel = {k: abs(metrics["card"][k] - metrics["cpu"][k])
               / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
        if rel["loss"] > loss_tol or rel["grad_norm"] > gnorm_tol:
            raise AssertionError(f"train step ({dtype}): card {metrics['card']}"
                                 f" vs cpu {metrics['cpu']}")
        tight, loose = step_bars(states["card"], states["cpu"], dtype,
                                 TRAIN_CPU_LR)
        if not torch.equal(states["card"].rng.cpu(), states["cpu"].rng):
            raise AssertionError("the card's key differs from the CPU's")
        launches = kernel_counts()
        if any(launches.values()):
            raise AssertionError(f"{phase}: a train step launched a kernel: "
                                 f"{launches}")
        log(phase, config=arch, layers=layers,
            compute=dtype, batch=TRAIN_CPU_BATCH, seq=TRAIN_CPU_SEQ,
            params=sum(p.numel() for p in cpu.parameters()),
            loss_card=metrics["card"]["loss"], loss_cpu=metrics["cpu"]["loss"],
            loss_rel=f"{rel['loss']:.3g}", loss_bar=loss_tol,
            grad_norm_card=metrics["card"]["grad_norm"],
            grad_norm_cpu=metrics["cpu"]["grad_norm"],
            grad_norm_rel=f"{rel['grad_norm']:.3g}", grad_norm_bar=gnorm_tol,
            param_err_large_g=f"{tight:.3g}",
            param_bar_large_g=f"{1e-6 + 1e-3 * TRAIN_CPU_LR:.3g}",
            param_err_any=f"{loose:.3g}",
            param_bar_any=f"{1e-6 + 2 * TRAIN_CPU_LR:.3g}",
            step_s_card=f"{secs['card']:.2f}", step_s_cpu=f"{secs['cpu']:.2f}",
            seconds=f"{time.perf_counter() - t0:.1f}")
        del cpu, card, states
        collect_garbage()
        torch.cuda.empty_cache()


def state_fingerprint(state):
    """One int64 per leaf: the sum of its raw 32-bit words (every leaf of a
    TrainState is 4 bytes wide), computed where the leaf lies."""
    out = []
    for _, t in serialize.leaf_paths(state):
        words = t.detach().reshape(-1)
        words = (words.view(torch.int32) if t.dtype == torch.float32
                 else words.to(torch.int64))
        out.append(words.sum(dtype=torch.int64))
    return [int(x) for x in out]


def train_phase(phase, arch, cfg, *, seq, steps, snapshot,
                activities=None, frontend=None,
                fast_tier_gib=TRAIN_FAST_TIER_GIB):
    """`repro_torch.launch.train.run` on ``cfg`` (``arch``'s config, as the
    caller cut it; fp32 master weights from a seeded generator, bf16
    compute; the VLM and the audio model on ``frontend``), batch
    TRAIN_BATCH x ``seq``, a fast tier of ``fast_tier_gib``: ``snapshot``
    steps, then one
    fast-tier snapshot through the run's manager, then the launcher's step
    (`step_once`) up to ``steps``; then the steps after the snapshot rerun
    from it (losses and every leaf's fingerprint bit-equal), the last of
    them under the sync debug mode, then one step more under
    torch.profiler (``activities``; CPU and CUDA by default).  The path runs no kernel of the port (the
    reference's training runs no Pallas kernel): every count must stay 0.
    Logs ``[phase]``, ``[phase-rerun]``, ``[phase-syncs]`` and
    ``[phase-profile]``; returns the launcher's record, the run's peak
    device memory and the median step in ms."""
    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reads0 = moe_mod.HOST_READS
    with scratch_dir() as root:
        argv = ["--arch", arch, "--steps", str(snapshot), "--seq", str(seq),
                "--batch", str(TRAIN_BATCH), "--ckpt-every", "0",
                "--fast-tier-gib", str(fast_tier_gib),
                "--ckpt-dir", root, "--seed", str(SEED), "--device", DEV.type]
        # this training path: every kernel count starts at 0 here
        zero_kernel_counts()
        # the launcher's loop up to the snapshot (0 steps: the initial
        # state), its manager's fast-tier save, then the loop's body
        # (`step_once`) for the rest, each step timed as the loop times it
        rec = train_launcher.run(train_launcher.parser().parse_args(argv),
                                 cfg=cfg, frontend=frontend)
        rec.mgr.save(snapshot, rec.state)
        for _ in range(steps - snapshot):
            ts = time.perf_counter()
            _, loss, gnorm, _ = train_launcher.step_once(rec)
            rec.step_seconds.append(time.perf_counter() - ts)
            rec.losses.append(loss)
            rec.grad_norms.append(gnorm)
        peak = torch.cuda.max_memory_allocated()
        run_s = time.perf_counter() - t0
        reads = moe_mod.HOST_READS - reads0
        losses = rec.losses
        if len(losses) != steps or not all(
                np.isfinite(x) for x in losses + rec.grad_norms):
            raise AssertionError(f"{phase}: losses {losses}")
        state_bytes = serialize.tree_bytes(rec.state)
        want = state_fingerprint(rec.state)
        # the last steps again, from the fast-tier snapshot; the last one
        # under the sync debug mode and the profiler
        rec.state = None
        t1 = time.perf_counter()
        restored, name = rec.mgr.restore(train_state_shapes(rec.model),
                                         name=f"step_{snapshot:08d}",
                                         device=DEV)
        # the restore's copies to the card end here, not in the step after
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        rec.state = bind_state(rec.model, restored)
        del restored
        rerun = [train_launcher.step_once(rec)[1]
                 for _ in range(steps - snapshot - 1)]
        last, where, texts = sync_sites(
            lambda: train_launcher.step_once(rec))
        rerun.append(last[1])
        got = state_fingerprint(rec.state)
        if rerun != losses[snapshot:] or got != want:
            raise AssertionError(f"{phase}: rerun from {name}: losses "
                                 f"{rerun} vs {losses[snapshot:]}, leaves "
                                 f"equal {got == want}")
        # one step more, under the profiler alone: profiled within the
        # sync count too, a full-width internlm2-1.8b step's wall on an
        # H100 grew from 2.18 s to 3.1-3.4 s and its busy share fell to
        # 0.53-0.67
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities or [
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ts = time.perf_counter()
            train_launcher.step_once(rec)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - ts) * 1e6
        launches = kernel_counts()
        if any(launches.values()):
            raise AssertionError(f"{phase}: training launched a kernel: "
                                 f"{launches}")
        save_s = rec.mgr.timings["fast_save_s"]
        rec.mgr.close()
        rec.mgr = None
    busy_us, _, events = device_us(prof)
    top = top_kernels(prof, busy_us)
    timed = rec.step_seconds[2:] if steps > 3 else rec.step_seconds[-1:]
    median_ms = statistics.median(timed) * 1e3
    tokens = TRAIN_BATCH * seq
    log(phase, config=arch, layers=cfg.n_layers,
        params=sum(p.numel() for p in rec.model.parameters()),
        weights=f"{cfg.param_dtype}-seeded-random", compute=cfg.compute_dtype,
        batch=TRAIN_BATCH, seq=seq, meta_tokens=cfg.n_meta_tokens,
        frontend=tuple(frontend.shape) if frontend is not None else "none",
        fast_tier_gib=fast_tier_gib,
        attn_chunk=rec.model.q_chunk, steps=steps,
        median_step_ms=f"{median_ms:.1f}",
        median_of_steps=f"{steps - len(timed) + 1}-{steps}",
        step_ms=[f"{x * 1e3:.1f}" for x in rec.step_seconds],
        tokens_per_s=f"{tokens / median_ms * 1e3:.1f}",
        losses=[f"{x:.4f}" for x in losses],
        grad_norm_step1=rec.grad_norms[0], max_memory_allocated=peak,
        max_memory_gb=f"{peak / 1e9:.2f}", state_bytes=state_bytes,
        moe_host_reads_per_step=reads / steps, run_s=f"{run_s:.1f}",
        launches=launches)
    log(f"{phase}-rerun", snapshot=name, steps=steps - snapshot,
        losses_bit_equal=True, leaves_bit_equal=True,
        fast_tier_save_s=f"{save_s:.3f}", restore_s=f"{restore_s:.3f}",
        deterministic_algorithms=True,
        cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    log(f"{phase}-syncs", host_syncs_per_step=len(where),
        sites=sorted(set(where)), kinds=sorted(texts))
    log(f"{phase}-profile", device_busy_us=f"{busy_us:.1f}",
        wall_us=f"{wall_us:.1f}", busy_share=f"{busy_us / wall_us:.4f}",
        device_events=events, top_kernels_share=top)
    return rec, peak, median_ms


def phase_train():
    """[train]: internlm2-1.8b at its full widths, depth TRAIN_LAYERS,
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ, the last two rerun from the
    TRAIN_SNAPSHOT snapshot (`train_phase`).  Returns the launcher's record,
    the run's peak device memory and the median step in ms."""
    return train_phase("train", TRAIN_ARCH,
                       cut_config(TRAIN_ARCH, TRAIN_LAYERS),
                       seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                       snapshot=TRAIN_SNAPSHOT)


def loop_ms(loop, inputs, runs=3):
    """ms of a train step's part in ``loop(*inputs)``, measured alone: the
    loop under ``torch.utils.checkpoint`` (the layer's remat), its output
    summed and differentiated; the median of ``runs`` after a warm-up (the
    host's time varies by a third between runs)."""
    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = checkpoint(loop, *inputs, use_reentrant=False,
                         preserve_rng_state=False)
        out.sum().backward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    once()
    return statistics.median(once() for _ in range(runs))


def phase_loop_share(phase, rec, seq):
    """The per-token loop's share of a train step: the hybrid's SSM scan
    (`ssm.chunked_scan`, chunks of 128) or the sLSTM recurrence
    (`xlstm.slstm_chunked`, chunks of 64) alone at the step's shapes, with
    its remat and backward, times the layers that run it, over one step
    of ``rec`` (the launcher's record) timed right after it: the host's
    speed drifts by more than the loop's share between the phase's own
    steps and this measurement."""
    cfg = rec.cfg
    gen = torch.Generator(device=DEV).manual_seed(SEED)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale
                ).requires_grad_()

    b = TRAIN_BATCH
    if cfg.family == "hybrid":
        di, ds = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
        t = seq + cfg.n_meta_tokens
        # S4D's A = -[1 .. d_state]; delta in softplus's start range
        a = -torch.arange(1, ds + 1, device=DEV).float().expand(di, ds)
        delta = (torch.rand((b, t, di), generator=gen, device=DEV) * 0.1
                 + 1e-3).requires_grad_()
        inputs = (torch.zeros((b, di, ds), device=DEV),
                  a.clone().requires_grad_(), delta, rand(b, t, ds),
                  rand(b, t, ds), rand(b, t, di))

        def loop(h, a, delta, bm, cm, xf):
            return ssm_mod.chunked_scan(h, a, delta, bm, cm, xf, 128)[1]

        layers, name = cfg.n_layers, "ssm_scan_loop"
    else:
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        zeros = torch.zeros((b, d), device=DEV)
        inputs = (rand(nh, dh, 4 * dh, scale=dh ** -0.5), rand(4 * d),
                  rand(b, seq, 4 * d), zeros, zeros, zeros,
                  torch.full((b, d), -1e30, device=DEV))

        def loop(r, bias, gx, h, c, n, m):
            return xlstm_mod.slstm_chunked(nh, r, bias, gx, h, c, n, m,
                                           64)[0]

        layers = cfg.n_layers // cfg.xlstm.slstm_every
        name = "slstm_loop"
    ms = loop_ms(loop, inputs)
    del inputs
    torch.cuda.synchronize()
    ts = time.perf_counter()
    train_launcher.step_once(rec)
    step_ms = (time.perf_counter() - ts) * 1e3
    log(f"{phase}-loop", loop=name, ms_per_layer=f"{ms:.1f}", layers=layers,
        step_ms=f"{step_ms:.1f}", share=f"{layers * ms / step_ms:.4f}",
        tokens_per_row=t if cfg.family == "hybrid" else seq)


def phase_train_families():
    """[train-moe], [train-hybrid], [train-xlstm]: `train_phase` on
    deepseek-moe-16b cut to MOE_TRAIN_LAYERS (batch TRAIN_BATCH x
    TRAIN_SEQ), on hymba-1.5b cut to HYBRID_TRAIN_LAYERS and on xlstm-350m
    cut to XLSTM_TRAIN_LAYERS (rows of HYBRID_TRAIN_SEQ and XLSTM_TRAIN_SEQ
    tokens), each with 0 kernel
    launches and a bit-equal rerun; the recurrent two also with their
    loops' share.
    Returns deepseek's cut config, its losses and its run's peak."""
    moe_cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    rec, moe_peak, _ = train_phase(
        "train-moe", MOE_ARCH, moe_cfg, seq=TRAIN_SEQ,
        steps=MOE_TRAIN_STEPS, snapshot=MOE_TRAIN_STEPS - 2)
    moe_losses = rec.losses
    del rec
    cuda_only = [torch.profiler.ProfilerActivity.CUDA]
    for phase, arch, cfg, seq in (
            ("train-hybrid", HYBRID_ARCH,
             cut_config(HYBRID_ARCH, HYBRID_TRAIN_LAYERS), HYBRID_TRAIN_SEQ),
            ("train-xlstm", XLSTM_ARCH,
             cut_config(XLSTM_ARCH, XLSTM_TRAIN_LAYERS), XLSTM_TRAIN_SEQ)):
        rec, _, _ = train_phase(
            phase, arch, cfg, seq=seq,
            steps=RECURRENT_TRAIN_STEPS, snapshot=0,
            activities=cuda_only)
        phase_loop_share(phase, rec, seq)
        del rec
        collect_garbage()
        torch.cuda.empty_cache()
    collect_garbage()
    torch.cuda.empty_cache()
    return moe_cfg, moe_losses, moe_peak


def phase_train_new_families(frontends):
    """[train-mla], [train-vlm], [train-audio]: `train_phase` on
    minicpm3-4b and llama-3.2-vision-11b cut to NEW_TRAIN_LAYERS and
    whisper-base at full depth, rows of NEW_TRAIN_SEQ tokens, the VLM and
    whisper on their seeded frontends, NEW_TRAIN_STEPS steps, the last
    rerun bit for bit from the fast-tier snapshot before it (the VLM's
    tier NEW_FAST_TIER_GIB), 0 kernel launches."""
    for phase, arch in (("train-mla", MLA_ARCH), ("train-vlm", VLM_ARCH),
                        ("train-audio", AUDIO_ARCH)):
        rec, _, _ = train_phase(
            phase, arch, cut_config(arch, NEW_TRAIN_LAYERS[arch]),
            seq=NEW_TRAIN_SEQ[arch], steps=NEW_TRAIN_STEPS,
            snapshot=NEW_TRAIN_STEPS - 1, frontend=frontends.get(arch),
            fast_tier_gib=(NEW_FAST_TIER_GIB if arch == VLM_ARCH
                           else TRAIN_FAST_TIER_GIB))
        del rec
        collect_garbage()
        torch.cuda.empty_cache()


def top_kernels(prof, busy_us, n=8):
    """The ``n`` kernel names with the most device time in a profile, each
    with its share of ``busy_us`` (names cut to 60 characters)."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU or ev.is_user_annotation():
            continue
        key = ev.name()[:60]
        by_name[key] = by_name.get(key, 0.0) + ev.duration_ns() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [(k, f"{us / busy_us:.4f}") for k, us in top]


def exec_scenario(mk_job, root, *, work, submit_a, quantum, steps_per_tick,
                  tick_seconds, fast_tier_bytes=8 << 30):
    """tests/test_e2e_train.py's scenario: B (12 CPUs) runs alone until A
    (8 CPUs) arrives and OMFS evicts B, on 16 CPUs; each job's checkpoints
    go through its own `CheckpointService` on the card (fast tier only).
    Ticks until both are DONE; returns (executor, B, A, seconds)."""
    users = [User("A", 50.0), User("B", 50.0)]
    ex = ClusterExecutor(users, SchedulerConfig(cpu_total=16, quantum=quantum),
                         steps_per_tick=steps_per_tick,
                         tick_seconds=tick_seconds)
    descs = [Job(user="B", cpus=12, work=work[0], submit_time=0,
                 job_class=JobClass.CHECKPOINTABLE),
             Job(user="A", cpus=8, work=work[1], submit_time=submit_a,
                 job_class=JobClass.CHECKPOINTABLE)]
    mjs = [ManagedJob(d, mk_job(seed), CheckpointService(ManagerConfig(
        root=Path(root) / d.user, mem_capacity_bytes=fast_tier_bytes,
        use_delta=False, durable_every=1 << 30), device=DEV))
        for seed, d in enumerate(descs)]
    for mj in mjs:
        ex.submit(mj)
    t0 = time.perf_counter()
    while not all(d.state == JobState.DONE for d in descs):
        if ex.state.time > 1000:
            raise AssertionError(f"jobs not done: {ex.events}")
        ex.tick()
    for mj in mjs:
        mj.ckpt.close()
    return ex, mjs[0], mjs[1], time.perf_counter() - t0


def check_scenario(ex, mb, ma, twin_losses, what):
    """The phase's assertions on one scenario; returns the calibrated
    flat cost model."""
    if mb.checkpoints < 1 or mb.restores < 1:
        raise AssertionError(f"{what}: no checkpoint/restore: {ex.events}")
    if mb.measured_cr_ticks < 1:
        raise AssertionError(f"{what}: no measured C/R tick was charged")
    n = len(mb.train_job.losses)
    if n > len(twin_losses) or mb.train_job.losses != twin_losses[:n]:
        raise AssertionError(f"{what}: the preempted run's {n} losses are "
                             "not the uninterrupted run's")
    model = ex.calibrate()
    if not isinstance(model, CRCostModel):
        raise AssertionError(f"{what}: calibrate() returned {model!r}")
    return model


def phase_executor(train_losses, train_peak):
    """The cluster executor, OMFS preempting real training jobs on the
    card: test_e2e_train's transparency scenario at the smoke config,
    then two internlm2-1.8b jobs at full width (B the launcher's run of
    `[train]`, whose losses are its uninterrupted twin).  Both jobs DONE,
    B checkpointed and restored, its losses bit-equal to the twin's,
    measured C/R ticks charged, ``calibrate()`` a model; at full width the
    peak shows one job's state resident at a time (below ``train_peak``,
    one job's, plus half a state), and once both are done the jobs hold
    no device memory."""
    smoke = get_smoke_config(TRAIN_ARCH)
    with scratch_dir() as root:
        zero_kernel_counts()
        ex, mb, ma, secs = exec_scenario(
            lambda seed: small_train_job(root, arch_cfg=smoke, seq=32,
                                         batch=4, seed=seed, device=DEV),
            root, work=(30, 6), submit_a=5, quantum=3, steps_per_tick=2,
            tick_seconds=EXEC_SMOKE_TICK_S)
        twin = small_train_job(root, arch_cfg=smoke, seq=32, batch=4,
                               seed=0, device=DEV)
        twin.cold_start()
        twin_losses = [twin.run_step()
                       for _ in range(len(mb.train_job.losses))]
        model = check_scenario(ex, mb, ma, twin_losses, "smoke")
    stats = ex.cr_stats()
    log("executor", scenario="test_e2e_train", config=smoke.name,
        events=ex.events, steps_b=len(mb.train_job.losses),
        steps_a=len(ma.train_job.losses), checkpoints=mb.checkpoints,
        restores=mb.restores, measured_cr_ticks=mb.measured_cr_ticks,
        tick_s=EXEC_SMOKE_TICK_S, state_bytes=mb.descriptor.state_bytes,
        save_s=f"{stats.save_seconds:.4f}",
        restore_s=f"{stats.restore_seconds:.4f}",
        cost_model=(model.save_mib_per_tick, model.restore_mib_per_tick),
        losses_bit_equal=True, seconds=f"{secs:.1f}",
        launches=kernel_counts())

    cfg = cut_config(TRAIN_ARCH, TRAIN_LAYERS)
    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    with scratch_dir() as root:
        def full_job(seed):
            return TrainJob(
                Model(cfg, device="meta"),
                TrainConfig(lr=3e-4, warmup_steps=10, total_steps=10_000),
                DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=seed),
                seed=seed, device=DEV)

        zero_kernel_counts()
        ex, mb, ma, secs = exec_scenario(
            full_job, root, work=EXEC_WORK, submit_a=EXEC_SUBMIT_A,
            quantum=3, steps_per_tick=1, tick_seconds=EXEC_TICK_S,
            fast_tier_bytes=TRAIN_FAST_TIER_GIB << 30)
        launches = kernel_counts()
        model = check_scenario(ex, mb, ma, train_losses, "full width")
    held = torch.cuda.memory_allocated() - baseline
    peak = torch.cuda.max_memory_allocated()
    stats = ex.cr_stats()
    state_bytes = mb.descriptor.state_bytes
    if peak - baseline >= train_peak + state_bytes // 2:
        raise AssertionError(f"peak {peak - baseline} B: more than one "
                             f"job's state ({state_bytes} B) was resident")
    if held > 1 << 30:
        raise AssertionError(f"the finished, released jobs still hold "
                             f"{held} B on the card")
    if any(launches.values()):
        raise AssertionError(f"the executor launched a kernel: {launches}")
    log("executor", scenario="full-width", config=TRAIN_ARCH,
        layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        events=ex.events, steps_b=len(mb.train_job.losses),
        steps_a=len(ma.train_job.losses), checkpoints=mb.checkpoints,
        restores=mb.restores, measured_cr_ticks=mb.measured_cr_ticks,
        tick_s=EXEC_TICK_S, state_bytes=state_bytes,
        save_s=f"{stats.save_seconds:.3f}",
        restore_s=f"{stats.restore_seconds:.3f}",
        save_GBps=f"{stats.save_bytes_per_s / 1e9:.3f}",
        restore_GBps=f"{stats.restore_bytes_per_s / 1e9:.3f}",
        cost_model=(model.save_mib_per_tick, model.restore_mib_per_tick),
        peak_over_allocated=peak - baseline,
        max_memory_gb=f"{peak / 1e9:.2f}",
        train_peak_gb=f"{train_peak / 1e9:.2f}",
        held_after_done=held,
        losses_bit_equal_to_train=True, seconds=f"{secs:.1f}",
        launches=launches)
    del ex, mb, ma
    collect_garbage()
    torch.cuda.empty_cache()


def phase_executor_moe(cfg, train_losses, train_peak):
    """[executor]'s scenario on the MoE family: B the deepseek-moe-16b job
    of `[train-moe]` (its config, seed and data: the launcher's run is its
    uninterrupted twin), A a smoke internlm2 job.  B checkpointed,
    restored and DONE, its losses bit-equal to `[train-moe]`'s, 0 kernel
    launches, one MoE state resident at a time, nothing held once done."""
    collect_garbage()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    smoke = get_smoke_config(TRAIN_ARCH)
    with scratch_dir() as root:
        def job(seed):
            if seed:
                return small_train_job(root, arch_cfg=smoke, seq=32, batch=4,
                                       seed=seed, device=DEV)
            return TrainJob(
                Model(cfg, device="meta"),
                TrainConfig(lr=3e-4, warmup_steps=10, total_steps=10_000),
                DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=SEED),
                seed=SEED, device=DEV)

        zero_kernel_counts()
        ex, mb, ma, secs = exec_scenario(
            job, root, work=EXEC_WORK, submit_a=EXEC_SUBMIT_A, quantum=3,
            steps_per_tick=1, tick_seconds=EXEC_TICK_S,
            fast_tier_bytes=TRAIN_FAST_TIER_GIB << 30)
        launches = kernel_counts()
        model = check_scenario(ex, mb, ma, train_losses, "executor-moe")
    held = torch.cuda.memory_allocated() - baseline
    peak = torch.cuda.max_memory_allocated()
    stats = ex.cr_stats()
    state_bytes = mb.descriptor.state_bytes
    if peak - baseline >= train_peak + state_bytes // 2:
        raise AssertionError(f"executor-moe: peak {peak - baseline} B: more "
                             f"than one job's state ({state_bytes} B)")
    if held > 1 << 30:
        raise AssertionError(f"executor-moe: the released jobs still hold "
                             f"{held} B on the card")
    if any(launches.values()):
        raise AssertionError(f"executor-moe launched a kernel: {launches}")
    log("executor-moe", config=MOE_ARCH, layers=cfg.n_layers,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, job_a=smoke.name, events=ex.events,
        steps_b=len(mb.train_job.losses), steps_a=len(ma.train_job.losses),
        checkpoints=mb.checkpoints, restores=mb.restores,
        measured_cr_ticks=mb.measured_cr_ticks, tick_s=EXEC_TICK_S,
        state_bytes=state_bytes, save_s=f"{stats.save_seconds:.3f}",
        restore_s=f"{stats.restore_seconds:.3f}",
        save_GBps=f"{stats.save_bytes_per_s / 1e9:.3f}",
        restore_GBps=f"{stats.restore_bytes_per_s / 1e9:.3f}",
        cost_model=(model.save_mib_per_tick, model.restore_mib_per_tick),
        peak_over_allocated=peak - baseline,
        max_memory_gb=f"{peak / 1e9:.2f}",
        train_peak_gb=f"{train_peak / 1e9:.2f}", held_after_done=held,
        losses_bit_equal_to_train_moe=True, seconds=f"{secs:.1f}",
        launches=launches)
    del ex, mb, ma
    collect_garbage()
    torch.cuda.empty_cache()


def launcher_fleet(tiers, backend):
    """`repro_torch.launch.cluster_sim`'s default fleet, priced by
    ``tiers``."""
    spec = WorkloadSpec(n_users=6, horizon=800, cpu_total=1024, seed=0,
                        arrival_rate=0.08)
    users = make_users(spec)
    cfg = SchedulerConfig(cpu_total=1024, quantum=20, cr_overhead=2,
                          cr_tiers=tiers, kernel_backend=backend)
    return users, make_jobs(spec, users), cfg


def phase_cr_path():
    """`launch.cr_cost.measure` on two trained snapshots (steps 2 and 3)
    of the job that bench_cr_cost.py measures, then the calibrated lattice
    on the launcher's fleet, both backends: the C/R path, counted on its
    own."""
    cfg = get_smoke_config(TRAIN_ARCH).replace(**CR_JOB)
    prev, cur = trained_snapshots(cfg, 3, seq=64, batch=8, chunk=64)[-2:]
    runs = {}
    # the C/R path: every kernel count starts at 0 here
    zero_kernel_counts()
    t0 = time.perf_counter()
    with scratch_dir() as root:
        rows = cr_cost.measure(prev, cur, tick_seconds=TICK_SECONDS,
                               root=root, device=DEV)
    measure_s = time.perf_counter() - t0
    tiers = rows["tiered_cost_model"]
    for backend in ("cuda", "torch"):
        users, jobs, cfg = launcher_fleet(tiers, backend)
        runs[backend] = engine.simulate(users, jobs, cfg, CR_FLEET_TICKS,
                                        "omfs", pass_depth=64, device=DEV)
    launches = dict(codec_ops.LAUNCHES, sched_select=sched_ops.LAUNCHES)
    if not rows["restore_bit_equal"]:
        raise AssertionError("the service's restore differs from the second "
                             "snapshot")
    if rows["int8_roundtrip_error"] >= 1e-2:
        raise AssertionError(f"codec round trip error "
                             f"{rows['int8_roundtrip_error']}")
    if min(launches["quantize"], launches["dequantize"]) == 0:
        raise AssertionError(f"the C/R path missed a codec kernel: {launches}")
    branches = runs["cuda"].stats.evict_branches
    if launches["sched_select"] != branches:
        raise AssertionError(f"sched_select launches {launches} != eviction "
                             f"branches {branches}")
    assert_same_run(runs["cuda"], runs["torch"], "calibrated fleet")
    printable = {k: (f"{v:.4f}" if isinstance(v, float) else v)
                 for k, v in rows.items()
                 if k not in ("cost_model", "tiered_cost_model")}
    log("cr-path", config="internlm2-1.8b-smoke-heads", **CR_JOB,
        state="trained", steps=(int(prev.step), int(cur.step)),
        measure_s=f"{measure_s:.2f}", **printable)
    summary = runs["cuda"].summary()
    log("cr-path-fleet", tiers=[(m.save_mib_per_tick, m.restore_mib_per_tick)
                                for m in tiers.tiers],
        capacity_mib=list(tiers.capacity_mib), jobs=len(jobs),
        ticks=CR_FLEET_TICKS,
        preemptions=summary["preemptions"], spills=summary["spills"],
        checkpoints=summary["checkpoints"],
        utilization=f"{summary['utilization']:.4f}",
        identical_to_torch_backend=True, **{
            f"launches_{k}": v for k, v in launches.items()})
    return launches

# ---------------------------------------------------------------------------
# serving: the flash-attention kernel and the dense GQA serve path
# ---------------------------------------------------------------------------


def attn_inputs(gen, b, sq, skv, h, kvh, d, dtype, dv=None):
    q = torch.randn((b, sq, h, d), generator=gen, device=DEV).to(dtype)
    k = torch.randn((b, skv, kvh, d), generator=gen, device=DEV).to(dtype)
    v = torch.randn((b, skv, kvh, dv or d), generator=gen,
                    device=DEV).to(dtype)
    return q, k, v


def rel_rms(got, want):
    """RMS of ``got - want`` over the RMS of ``want`` (fp32)."""
    want = want.float()
    return float((got.float() - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt())


def tail_keys(skv):
    """Keys past the last full 64-key tile, both kernels' key tile."""
    return skv % 64


def compare_attn(q, k, v, route, **kw):
    """One kernel (``route``, as `flash_ops.kernel_route` names them)
    against the plain version on the same card tensors; raises above the
    dtype's absolute tolerance (ATTN_TOL) or its bar scaled to the output
    (ATTN_REL_RMS), returns the largest absolute difference and the
    scaled error."""
    got = flash_ops.launch(q, k, v, route, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    rel = rel_rms(got, want)
    if not (err <= ATTN_TOL[q.dtype] and rel <= ATTN_REL_RMS[q.dtype]):
        raise AssertionError(f"flash_attention's {route} kernel differs from "
                             f"its plain version by {err} (bar "
                             f"{ATTN_TOL[q.dtype]}), {rel} of the output's "
                             f"RMS (bar {ATTN_REL_RMS[q.dtype]}) (q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, "
                             f"{q.dtype}, {kw})")
    return err, rel


def tail_only(q, k, v):
    """(q, k, v) with V zero on every key but those past the last full
    64-key tile: a kernel that drops or masks that tail returns zeros, a
    scaled error of 1."""
    v = v.clone()
    v[:, :v.shape[1] - tail_keys(v.shape[1])] = 0
    return q, k, v


def dropped_tail_reading(q, k, v, **kw):
    """The scaled error that a kernel dropping the keys past the last full
    64-key tile would read: the plain version on the keys before the tail
    against the plain version on all of them."""
    cut = k.shape[1] - tail_keys(k.shape[1])
    return rel_rms(flash_attention_ref(q, k[:, :cut], v[:, :cut], **kw),
                   flash_attention_ref(q, k, v, **kw))


def attn_routes(q):
    """The kernels that take q: the SIMT one always, the tensor-core one
    where `flash_ops.kernel_route` sends q to it."""
    return ("simt", "wgmma") if flash_ops.kernel_route(q) == "wgmma" \
        else ("simt",)


def phase_attn_compare():
    """Both kernels against the plain version: the reference's test shapes
    and the ragged ones in fp32 (SIMT) and bf16 (both), internlm2-1.8b's
    and deepseek-moe-16b's serving shapes in bf16, and in both dtypes
    the head_dim form's launches a rank (HD_RANK_ATTN),
    hymba-1.5b's (window and meta tokens; whole, and the columns form's
    7 touched heads a rank of [shard-serve-hybrid]), minicpm3-4b's (Dk
    96, Dv 64; whole, a rank's 10 heads of [shard-serve-mla] and the
    columns form's 3 touched heads of [shard-serve-mla10]), the VLM's
    cross-attention (whole, and a 16-rank head_dim rank's) and
    whisper's encoder (whole, and a rank's 2 heads of
    [shard-serve-audio]) and cross-attention (non-causal; each again
    with V zero but on the keys past the last 64-key tile), every case
    under ATTN_TOL and ATTN_REL_RMS.  Returns the largest absolute error
    of each kernel."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    saved = kernel_counts()
    errs = {(dt, r): 0.0 for dt in (torch.float32, torch.bfloat16)
            for r in ("simt", "wgmma")}
    rels = dict(errs)
    cases = 0
    t0 = time.perf_counter()

    def run(qkv, rel_into=None, **kw):
        nonlocal cases
        got = {}
        for route in attn_routes(qkv[0]):
            got[route], rel = compare_attn(*qkv, route, **kw)
            key = (qkv[0].dtype, route)
            errs[key] = max(errs[key], got[route])
            rels[key] = max(rels[key], rel)
            if rel_into is not None:
                rel_into[route] = rel
            cases += 1
        return got

    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, kvh, d, causal, window, meta in FLASH_CASES:
            run(attn_inputs(gen, b, s, s, h, kvh, d, dtype), causal=causal,
                window=window, n_meta=meta)
        for b, sq, skv, h, kvh, d, causal in RAGGED_CASES:
            run(attn_inputs(gen, b, sq, skv, h, kvh, d, dtype), causal=causal)
    serving = {}
    for name, (b, s, h, kvh, d) in (("internlm2", ATTN_SHAPE),
                                    ("deepseek", MOE_ATTN_SHAPE)):
        serving[name] = run(attn_inputs(gen, b, s, s, h, kvh, d,
                                        torch.bfloat16), causal=True)
    # the head_dim form's launches a rank: few query heads, one KV head
    for name, (b, s, h, kvh, d) in HD_RANK_ATTN.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}_" + ("fp32" if dtype == torch.float32 else "bf16")
            serving[tag] = run(attn_inputs(gen, b, s, s, h, kvh, d, dtype),
                               causal=True)
    for name, (b, s, h, kvh, d, window, meta) in (
            ("hymba", HYBRID_ATTN_SHAPE), ("hymba_tp4", HYBRID_TP4_ATTN)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}_" + ("fp32" if dtype == torch.float32 else "bf16")
            serving[tag] = run(attn_inputs(gen, b, s, s, h, kvh, d, dtype),
                               causal=True, window=window, n_meta=meta)
    # slice 10's shapes, in both dtypes: MLA's Dk 96 / Dv 64 (V padded to
    # 96 in the wrapper), the non-causal Sq != Skv of the VLM's and
    # whisper's cross-attention, whisper's non-causal encoder.  Their Skv
    # leaves a tail past the last 64-key tile: each non-causal shape also
    # runs with V zero but on that tail, and the plain version with the
    # tail cut must read above the scaled bar
    scaled, faults = {}, {}
    for name, (b, sq, skv, h, kvh, d, dv, causal) in (
            ("mla", MLA_ATTN), ("mla_tp4", MLA_TP4_ATTN),
            ("mla10_tp4", MLA10_TP4_ATTN),
            ("vlm_cross", VLM_CROSS_ATTN),
            ("vlm_cross_hd16", VLM_CROSS_HD16_ATTN),
            ("whisper_enc", AUDIO_ENC_ATTN),
            ("whisper_enc_tp4", AUDIO_ENC_TP4_ATTN),
            ("whisper_cross", AUDIO_CROSS_ATTN)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{name}_" + ("fp32" if dtype == torch.float32 else "bf16")
            qkv = attn_inputs(gen, b, sq, skv, h, kvh, d, dtype, dv)
            scaled[tag] = {}
            serving[tag] = run(qkv, scaled[tag], causal=causal)
            if not causal and tail_keys(skv):
                fault = dropped_tail_reading(*qkv, causal=causal)
                if not fault > 2 * ATTN_REL_RMS[dtype]:
                    raise AssertionError(
                        f"a dropped {tail_keys(skv)}-key tail reads {fault} "
                        f"at {tag}, within twice the scaled bar "
                        f"{ATTN_REL_RMS[dtype]}")
                faults[tag] = fault
                scaled[tag + "_tail"] = {}
                serving[tag + "_tail"] = run(tail_only(*qkv),
                                             scaled[tag + "_tail"],
                                             causal=causal)
            del qkv
            collect_garbage()
    set_kernel_counts(saved)
    log("attn-compare", cases=cases,
        simt_err_fp32=f"{errs[torch.float32, 'simt']:.3e}",
        simt_err_bf16=f"{errs[torch.bfloat16, 'simt']:.3e}",
        wgmma_err_bf16=f"{errs[torch.bfloat16, 'wgmma']:.3e}",
        simt_rel_rms_fp32=f"{rels[torch.float32, 'simt']:.3e}",
        simt_rel_rms_bf16=f"{rels[torch.bfloat16, 'simt']:.3e}",
        wgmma_rel_rms_bf16=f"{rels[torch.bfloat16, 'wgmma']:.3e}",
        **{f"{name}_{route}_err": f"{err:.3e}"
           for name, got in serving.items() for route, err in got.items()},
        **{f"{name}_{route}_rel_rms": f"{rel:.3e}"
           for name, got in scaled.items() for route, rel in got.items()},
        **{f"{name}_dropped_tail_rel_rms": f"{rel:.3e}"
           for name, rel in faults.items()},
        hybrid_shape="x".join(map(str, HYBRID_ATTN_SHAPE)),
        hybrid_tp4_shape="x".join(map(str, HYBRID_TP4_ATTN)),
        **{f"{n}_shape": "x".join(map(str, shape[:-1])) for n, shape in (
            ("mla", MLA_ATTN), ("mla_tp4", MLA_TP4_ATTN),
            ("mla10_tp4", MLA10_TP4_ATTN),
            ("vlm_cross", VLM_CROSS_ATTN),
            ("vlm_cross_hd16", VLM_CROSS_HD16_ATTN),
            ("whisper_enc", AUDIO_ENC_ATTN),
            ("whisper_enc_tp4", AUDIO_ENC_TP4_ATTN),
            ("whisper_cross", AUDIO_CROSS_ATTN))},
        tol_fp32=ATTN_TOL[torch.float32], tol_bf16=ATTN_TOL[torch.bfloat16],
        rel_rms_bar_fp32=ATTN_REL_RMS[torch.float32],
        rel_rms_bar_bf16=ATTN_REL_RMS[torch.bfloat16],
        seconds=f"{time.perf_counter() - t0:.1f}")
    return {"simt": max(errs[dt, "simt"] for dt in (torch.float32,
                                                     torch.bfloat16)),
            "wgmma": errs[torch.bfloat16, "wgmma"]}


def in_turns(fns, iters, warmup):
    """Time each named function in the order given, then in the reverse
    order; returns each one's mean ms over the two passes (and both
    passes), so that a drift of the card's clocks weighs on all alike."""
    runs = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            runs[name].append(time_ms(fns[name], iters=iters[name],
                                      warmup=warmup))
    return {name: sum(v) / len(v) for name, v in runs.items()}, runs


def phase_attn_time():
    """Both kernels in bf16, as the serve paths call them, at ten
    shapes: one layer of internlm2-1.8b's prefill (ATTN_SHAPE), MLA's
    prefill attention (causal, Dk 96, Dv 64), whole, a rank's 10 heads
    of [shard-serve-mla] and the columns form's 3 touched heads of
    [shard-serve-mla10], hymba-1.5b's 7 touched heads a rank of
    [shard-serve-hybrid] (window 1,024 and 128 meta tokens: SDPA takes
    the mask as a boolean matrix, the bound counts the visible pairs
    only), the VLM's cross-attention (non-causal, 2,048 x
    6,404, GQA 32/8), whole and a 16-rank head_dim rank's (2 query heads
    on 1 KV head), and whisper's non-causal encoder (1,500 x 1,500), whole
    and a rank's 2 heads of [shard-serve-audio], and its cross-attention
    (416 x 1,500); beside them the plain version
    and the library's fused attention (SDPA on the same tensors viewed [B,
    H, S, D]; never called by the port), in turns, and the bound; for MLA
    also the cost of V's padding, the tensor-core launch on a V of Dv = Dk
    = 96 beside the same launch on the real Dv = 64 (padded to 96 in the
    wrapper, the output cut back).  Returns the timings of each kernel at
    the internlm2 shape and the four ranks' shapes, for the kernels'
    record."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    saved = kernel_counts()
    b, s, h, kvh, d = ATTN_SHAPE
    hb, hs, hh, hkvh, hd, window, meta = HYBRID_TP4_ATTN
    shapes = (("internlm2", (b, s, s, h, kvh, d, d, True)),
              ("mla", MLA_ATTN), ("mla_tp4", MLA_TP4_ATTN),
              ("mla10_tp4", MLA10_TP4_ATTN),
              ("hymba_tp4", (hb, hs, hs, hh, hkvh, hd, hd, True)),
              ("vlm_cross", VLM_CROSS_ATTN),
              ("vlm_cross_hd16", VLM_CROSS_HD16_ATTN),
              ("whisper_enc", AUDIO_ENC_ATTN),
              ("whisper_enc_tp4", AUDIO_ENC_TP4_ATTN),
              ("whisper_cross", AUDIO_CROSS_ATTN))
    # hymba's window and meta tokens; SDPA takes its mask as a boolean
    # [Sq, Skv] matrix (row i sees key j: `visible`)
    masked = {"hymba_tp4": dict(window=window, n_meta=meta)}
    out = {}
    for name, (b, sq, skv, h, kvh, d, dv, causal) in shapes:
        kw = masked.get(name, {})
        q, k, v = attn_inputs(gen, b, sq, skv, h, kvh, d, torch.bfloat16, dv)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = (dict(attn_mask=flash_visible(sq, skv, causal=causal,
                                             device=DEV, **kw))
                if kw else dict(is_causal=causal))
        fns = {
            "wgmma": lambda: flash_ops.launch(q, k, v, "wgmma",
                                              causal=causal, **kw),
            "simt": lambda: flash_ops.launch(q, k, v, "simt", causal=causal,
                                             **kw),
            "plain": lambda: flash_attention_ref(q, k, v, causal=causal,
                                                 **kw),
            "library": lambda: torch.nn.functional.
            scaled_dot_product_attention(qt, kt, vt, enable_gqa=kvh != h,
                                         **sdpa)}
        iters = dict(wgmma=20, simt=5, plain=3, library=20)
        extra = {}
        if dv < d:
            v_dk = torch.randn((b, skv, kvh, d), generator=gen,
                               device=DEV).to(torch.bfloat16)
            fns["wgmma_dv_eq_dk"] = lambda: flash_ops.launch(
                q, k, v_dk, "wgmma", causal=causal)
            iters["wgmma_dv_eq_dk"] = 20
        ms, runs = in_turns(fns, iters, warmup=2)
        if dv < d:
            extra = dict(wgmma_dv_eq_dk_ms=f"{ms['wgmma_dv_eq_dk']:.4f}",
                         padding_cost_ms=(
                             f"{ms['wgmma'] - ms['wgmma_dv_eq_dk']:.4f}"),
                         padded_over_unpadded=(
                             f"{ms['wgmma'] / ms['wgmma_dv_eq_dk']:.4f}"))
        bound = attn_bound(b, sq, h, kvh, d, 2, skv=skv, dv=dv,
                           causal=causal, **kw)
        for route in ("wgmma", "simt"):
            log("attn-time", shape=name, kernel=route, B=b, Sq=sq, Skv=skv,
                Hq=h, Hkv=kvh, Dk=d, Dv=dv, dtype="bfloat16", causal=causal,
                window=kw.get("window", 0), n_meta=kw.get("n_meta", 0),
                ms=f"{ms[route]:.4f}",
                passes=[f"{t:.4f}" for t in runs[route]],
                plain_ms=f"{ms['plain']:.4f}",
                library_ms=f"{ms['library']:.4f}", flop=bound["flop"],
                bytes=bound["bytes"], pairs_per_head=bound["pairs_per_head"],
                bound_ms=f"{bound['bound_ms']:.5f}",
                bound_by=bound["bound_by"],
                share_of_bound=f"{bound['bound_ms'] / ms[route]:.5f}",
                tflops=f"{bound['flop'] / ms[route] / 1e9:.2f}",
                x_library=f"{ms[route] / ms['library']:.2f}",
                **(extra if route == "wgmma" else {}))
            if name in ("internlm2", "mla_tp4", "mla10_tp4", "hymba_tp4",
                        "whisper_enc_tp4"):
                out.setdefault(name, {})[route] = dict(ms=ms[route], plain_ms=ms["plain"],
                                  library_ms=ms["library"],
                                  bound_ms=bound["bound_ms"],
                                  bound_by=bound["bound_by"])
        del q, k, v, qt, kt, vt, fns, sdpa
        collect_garbage()
    set_kernel_counts(saved)
    return out


def collect_garbage():
    """Collect Python's cyclic garbage: tensors of earlier phases held in
    reference cycles count as allocated until then (gigabytes of them
    before the serving phases), so a peak taken next would not be the
    step's own.
    The allocator keeps its cached blocks, as a running server's would."""
    gc.collect()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# serving, the recurrent families' kernels: ssm_scan and mlstm_scan
# ---------------------------------------------------------------------------


def kernel_counts():
    """Every kernel's launch count, by name (and the cells that
    `sched_select`'s launches planned)."""
    return dict(sched_select=sched_ops.LAUNCHES,
                sched_select_plans=sched_ops.PLANS, **{
        f"ckpt_{k}": v for k, v in codec_ops.LAUNCHES.items()},
        flash_attention=flash_ops.LAUNCHES,
        flash_attention_wgmma=flash_ops.WGMMA_LAUNCHES,
        ssm_scan=ssm_ops.LAUNCHES, mlstm_scan=mlstm_ops.LAUNCHES,
        moe_gmm=gmm_ops.LAUNCHES, moe_gmm_wgmma=gmm_ops.WGMMA_LAUNCHES)


def set_kernel_counts(counts):
    """Set every kernel's launch count (``kernel_counts()``'s keys)."""
    sched_ops.LAUNCHES = counts["sched_select"]
    sched_ops.PLANS = counts["sched_select_plans"]
    codec_ops.LAUNCHES.update(quantize=counts["ckpt_quantize"],
                              dequantize=counts["ckpt_dequantize"])
    flash_ops.LAUNCHES = counts["flash_attention"]
    flash_ops.WGMMA_LAUNCHES = counts["flash_attention_wgmma"]
    ssm_ops.LAUNCHES = counts["ssm_scan"]
    mlstm_ops.LAUNCHES = counts["mlstm_scan"]
    gmm_ops.LAUNCHES = counts["moe_gmm"]
    gmm_ops.WGMMA_LAUNCHES = counts["moe_gmm_wgmma"]


def zero_kernel_counts():
    set_kernel_counts(dict.fromkeys(kernel_counts(), 0))


def ssm_inputs(gen, b, s, di, ds, h0_scale=0.1):
    """delta, B, C, x, a, h0 drawn as tests/test_kernels.py draws them."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    delta = torch.nn.functional.softplus(rn(b, s, di)) * 0.1
    a = -torch.exp(rn(di, ds) * 0.3)
    return delta, rn(b, s, ds), rn(b, s, ds), rn(b, s, di), a, \
        rn(b, di, ds) * h0_scale


def rel_bar(bar, want):
    """``bar`` times the largest |want|, or ``bar`` itself below 1."""
    return bar * max(1.0, float(want.abs().max()))


def compare_ssm(args, serving):
    """Kernel against the plain version on the same card tensors; raises
    above the bar, returns the largest absolute difference."""
    y, h = ssm_ops.selective_scan(*args)
    torch.cuda.synchronize()
    yr, hr = ssm_scan_ref(*args)
    err = 0.0
    for name, g, w in (("y", y, yr), ("h", h, hr)):
        e = float((g - w).abs().max())
        bar = rel_bar(SSM_TOL, w) if serving else SSM_TOL
        if not e <= bar:
            raise AssertionError(f"ssm_scan {name} differs from its plain "
                                 f"version by {e} > {bar} at "
                                 f"{tuple(args[0].shape)}")
        err = max(err, e)
    return err


def phase_ssm_compare():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    saved = kernel_counts()
    t0 = time.perf_counter()
    test_err = max(compare_ssm(ssm_inputs(gen, *case), serving=False)
                   for case in SSM_CASES)
    b, s, di, ds = SSM_PREFILL
    serving = {
        "prefill_h0_zero": compare_ssm(ssm_inputs(gen, b, s, di, ds, 0.0),
                                       serving=True),
        "prefill_h0": compare_ssm(ssm_inputs(gen, b, s, di, ds),
                                  serving=True),
        "decode": compare_ssm(ssm_inputs(gen, b, 1, di, ds), serving=True)}
    # a rank's 800 channels of [shard-serve-hybrid]
    b, s, di, ds = SSM_TP4_PREFILL
    serving["tp4_prefill"] = compare_ssm(ssm_inputs(gen, b, s, di, ds),
                                         serving=True)
    serving["tp4_decode"] = compare_ssm(ssm_inputs(gen, b, 1, di, ds),
                                        serving=True)
    set_kernel_counts(saved)
    log("ssm-compare", cases=len(SSM_CASES) + len(serving),
        test_shapes_err=f"{test_err:.3e}", tol=SSM_TOL,
        **{f"{k}_err": f"{v:.3e}" for k, v in serving.items()},
        serving_bar=f"{SSM_TOL} x max(1, max|y|) (and |h|)",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return max(test_err, *serving.values())


def phase_ssm_time():
    """The kernel and its plain version at Hymba's prefill shape and at one
    decode step (S = 1), whole and on a rank's 800 channels of
    [shard-serve-hybrid], beside the bound.  ``ms`` is the card's time of
    back-to-back calls queued ahead (``queued_ms``); ``host_ms`` the same
    calls timed as the host issues them, which at S = 1 is the wrapper's
    host time.  No single PyTorch call computes the scan."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    saved = kernel_counts()
    rows = {}
    for name, (b, steps, di, ds) in (
            ("prefill", SSM_PREFILL), ("decode", SSM_PREFILL[:1] + (1,)
                                       + SSM_PREFILL[2:]),
            ("tp4_prefill", SSM_TP4_PREFILL),
            ("tp4_decode", SSM_TP4_PREFILL[:1] + (1,) + SSM_TP4_PREFILL[2:])):
        args = ssm_inputs(gen, b, steps, di, ds)
        ms = queued_ms(lambda a=args: ssm_ops.selective_scan(*a),
                       iters=20 if steps > 1 else 200)
        host_ms = time_ms(lambda a=args: ssm_ops.selective_scan(*a),
                          iters=20, warmup=3)
        plain_ms = time_ms(lambda a=args: ssm_scan_ref(*a),
                           iters=2 if steps > 1 else 20, warmup=1)
        bound = ssm_bound(b, steps, di, ds)
        rows[name] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, **bound)
        log("ssm-time", step=name, B=b, S=steps, di=di, ds=ds,
            ms=f"{ms:.5f}", host_ms=f"{host_ms:.5f}",
            plain_ms=f"{plain_ms:.4f}",
            bytes=bound["bytes"], flop=bound["flop"], exps=bound["exps"],
            bound_ms=f"{bound['bound_ms']:.5f}", bound_by=bound["bound_by"],
            share_of_bound=f"{bound['bound_ms'] / ms:.5f}",
            library_ms="none")
    set_kernel_counts(saved)
    return rows


def mlstm_inputs(gen, bh, s, dh):
    """q, k (pre-scaled), v, lf, li drawn as tests/test_kernels.py draws
    them."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)
    return (rn(bh, s, dh), rn(bh, s, dh) / dh ** 0.5, rn(bh, s, dh),
            torch.nn.functional.logsigmoid(rn(bh, s) + 3.0), rn(bh, s))


def mlstm_state(gen, bh, dh):
    """A carried (C0, n0, m0 [BH]): the plain version's state after
    MLSTM_STATE_STEPS steps from the zero state on fresh random inputs."""
    _, (c, n, m) = mlstm_scan_ref(*mlstm_inputs(gen, bh, MLSTM_STATE_STEPS,
                                                dh), chunk=256)
    return c, n, m[:, 0].contiguous()


def compare_mlstm(args, chunk, serving, state=None):
    h, st = mlstm_ops.mlstm_scan(*args, state, chunk=chunk)
    torch.cuda.synchronize()
    hr, state_r = mlstm_scan_ref(*args, state, chunk=chunk)
    errs = {}
    for name, g, w, bar in (("h", h, hr, MLSTM_H_TOL),
                            *((n, g, w, MLSTM_STATE_TOL) for n, g, w in
                              zip("Cnm", st, state_r))):
        e = float((g - w).abs().max())
        limit = rel_bar(bar, w) if serving else bar
        if not e <= limit:
            raise AssertionError(f"mlstm_scan {name} differs from its plain "
                                 f"version by {e} > {limit} at "
                                 f"{tuple(args[0].shape)}, chunk {chunk}, "
                                 f"{'carried' if state else 'zero'} state")
        errs[name] = e
    errs["max_h"] = float(hr.abs().max())
    return errs


def phase_mlstm_compare():
    """The reference's test shapes from the zero state and from a carried
    one; xlstm-350m's prefill shape (S = 2,048, and a ragged 2,000) from
    both, and one decode step (S = 1) from a carried state; a rank's
    prefill of [shard-serve-xlstm] (BH 4) from a carried state."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    saved = kernel_counts()
    t0 = time.perf_counter()
    test = {"h": 0.0, "state": 0.0}
    for bh, s, dh, chunk in (*MLSTM_CASES, MLSTM_ODD):
        for state in (None, mlstm_state(gen, bh, dh)):
            e = compare_mlstm(mlstm_inputs(gen, bh, s, dh), chunk,
                              serving=False, state=state)
            test["h"] = max(test["h"], e["h"])
            test["state"] = max(test["state"], e["C"], e["n"], e["m"])
    bh, s, dh, chunk = MLSTM_PREFILL
    serving = {"rank_S2048_carried": compare_mlstm(
        mlstm_inputs(gen, MLSTM_TP4[0], s, dh), chunk, serving=True,
        state=mlstm_state(gen, MLSTM_TP4[0], dh))}
    for n in (s, MLSTM_RAGGED_S, 1):
        if n > 1:
            serving[f"S{n}"] = compare_mlstm(mlstm_inputs(gen, bh, n, dh),
                                             chunk, serving=True)
        serving[f"S{n}_carried"] = compare_mlstm(
            mlstm_inputs(gen, bh, n, dh), chunk, serving=True,
            state=mlstm_state(gen, bh, dh))
    set_kernel_counts(saved)
    log("mlstm-compare", cases=2 * len(MLSTM_CASES) + 2 + len(serving),
        test_h_err=f"{test['h']:.3e}", test_state_err=f"{test['state']:.3e}",
        tol_h=MLSTM_H_TOL, tol_state=MLSTM_STATE_TOL,
        **{f"{k}_{n}_err" if n != "max_h" else f"{k}_max_h": f"{v:.3e}"
           for k, e in serving.items() for n, v in e.items()},
        serving_bar="tol x max(1, max|output|)",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return max(test["h"], test["state"],
               *(v for e in serving.values()
                 for n, v in e.items() if n != "max_h"))


def phase_mlstm_time():
    """The kernel and its plain version at xlstm-350m's prefill shape (one
    mLSTM block, batch 4) from the zero state and from a carried one, and
    at one decode step (S = 1, carried), beside the bound and the design's
    3xTF32 floor; and a rank's prefill of [shard-serve-xlstm] (BH 4, its
    1 head of 4, carried).  ``ms`` is the card's time of back-to-back
    calls queued ahead (``queued_ms``); ``host_ms`` the same calls as the
    host issues them.  No single PyTorch call computes the scan."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    saved = kernel_counts()
    bh, s, dh, chunk = MLSTM_PREFILL
    rows = {}
    state = mlstm_state(gen, bh, dh)
    rank_state = mlstm_state(gen, MLSTM_TP4[0], dh)
    for name, bh, steps, st in (("prefill_zero", bh, s, None),
                                ("prefill_carried", bh, s, state),
                                ("decode_carried", bh, 1, state),
                                ("rank_carried", MLSTM_TP4[0], s,
                                 rank_state)):
        args = mlstm_inputs(gen, bh, steps, dh)
        fn = lambda a=args, st=st: mlstm_ops.mlstm_scan(*a, st, chunk=chunk)
        ms = queued_ms(fn, iters=10 if steps > 1 else 100)
        host_ms = time_ms(fn, iters=10, warmup=2)
        plain_ms = time_ms(lambda a=args, st=st: mlstm_scan_ref(
            *a, st, chunk=chunk), iters=5, warmup=1)
        bound = mlstm_bound(bh, steps, dh, chunk, carried=st is not None)
        rows[name] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, **bound)
        log("mlstm-time", row=name, BH=bh, S=steps, dh=dh,
            chunk=min(chunk, steps), ms=f"{ms:.4f}", host_ms=f"{host_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", flop=bound["flop"],
            bytes=bound["bytes"], bound_ms=f"{bound['bound_ms']:.5f}",
            bound_by=bound["bound_by"],
            floor_3xtf32_ms=f"{bound['floor_ms']:.5f}",
            share_of_bound=f"{bound['bound_ms'] / ms:.5f}",
            share_of_floor=f"{bound['floor_ms'] / ms:.5f}",
            gflops=f"{bound['flop'] / ms / 1e6:.1f}", library_ms="none")
    set_kernel_counts(saved)
    return rows


# ---------------------------------------------------------------------------
# the serve paths: internlm2-1.8b, hymba-1.5b, xlstm-350m
# ---------------------------------------------------------------------------


def cache_leaves(cache):
    """(name, tensor) of a cache's layer leaves, for either family."""
    layers = cache["layers"]
    if isinstance(layers, dict):
        return [(k, layers[k]) for k in sorted(layers)]
    return [(f"{part}.{f}", getattr(getattr(layers, part), f))
            for part in ("m", "s") for f in getattr(layers, part)._fields]


def cache_bytes(cache):
    """Bytes of every tensor of a cache: length, pos and the layers."""
    tensors = [cache["length"], *(t for _, t in cache_leaves(cache))]
    if "pos" in cache:
        tensors.append(cache["pos"])
    return sum(t.numel() * t.element_size() for t in tensors)


def cut_config(arch, layers, **kw):
    """``arch``'s published config at depth ``layers`` (whisper: that many
    encoder and decoder layers; the VLM: a multiple of its group)."""
    cfg = get_config(arch)
    if cfg.family == "audio":
        kw["audio"] = dataclasses.replace(cfg.audio, n_encoder_layers=layers)
    return cfg.replace(n_layers=layers, **kw)


def seeded_frontend(cfg, batch, seed):
    """Seeded N(0, 1) fp32 frames on the card for the VLM ([B, n_patches,
    vision_dim]) and the audio model ([B, n_audio_ctx, d_model]); None for
    the other families."""
    stub = model_mod.frontend_stub(cfg, batch, DEV)
    if stub is None:
        return None
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(stub.shape, generator=gen, device=DEV)


@torch.no_grad()
def seed_gates(model):
    """Draw a VLM's cross-attention gates from a seeded N(0, 0.8^2) on
    their device: they start at zero, and a zero gate hides the block's
    output from every check downstream (a no-op for the other
    families)."""
    if model.cfg.family != "vlm":
        return model
    gen = torch.Generator(device=model.device).manual_seed(SEED + 8)
    for gate in (model.cross.gate_attn, model.cross.gate_ffn):
        value = 0.8 * torch.randn(gate.shape, generator=gen,
                                  device=model.device)
        if hasattr(gate, "to_local"):        # a replicated DTensor
            gate = gate.to_local()
            assert gate.shape == value.shape, "gates sharded"
        gate.copy_(value)
    return model


def phase_vs_cpu(arch, phase, prefill_counts, decode_counts, *,
                 layers=CPU_LAYERS, frontend=None):
    """The same seeded weights (drawn on the card, copied to the CPU) at the
    full widths and depth ``layers`` (`cut_config`; one mLSTM/sLSTM pair
    for xLSTM), fp32 compute and cache: prefill and CPU_STEPS decode steps
    on the card (the kernels) against the CPU (the plain versions),
    teacher-forced on the CPU's greedy ids, the VLM (its gates seeded,
    `seed_gates`) and the audio model on the first CPU_BATCH rows of
    ``frontend``; every logit, cache leaf, position and length must
    agree, and the card's launches per prefill and per step must be the
    given ones."""
    t0 = time.perf_counter()
    cfg = cut_config(arch, layers, compute_dtype="float32")
    card = seed_gates(Model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED)))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (CPU_BATCH, CPU_PROMPT)).astype(np.int32))
    max_seq = CPU_PROMPT + CPU_STEPS
    g_batch = {"tokens": tokens.to(DEV)}
    c_batch = {"tokens": tokens}
    if frontend is not None:
        g_batch["frontend"] = frontend[:CPU_BATCH]
        c_batch["frontend"] = frontend[:CPU_BATCH].cpu()
    # an MoE layer's routes, each side's, per layer and step
    calls, keep = route_log()
    with recording(moe_mod, "route_topk", keep):
        c_cache, c_logits = cpu.prefill(
            c_batch, cpu.init_cache(CPU_BATCH, max_seq, torch.float32))
        saved = kernel_counts()
        zero_kernel_counts()
        g_cache, g_logits = card.prefill(
            g_batch, card.init_cache(CPU_BATCH, max_seq, torch.float32))
        torch.cuda.synchronize()
        launches = {"prefill": kernel_counts()}
        errs = [float((g_logits.cpu() - c_logits).abs().max())]
        scale = float(c_logits.abs().max())
        zero_kernel_counts()
        for _ in range(CPU_STEPS):
            tok = serve.greedy(c_logits)
            c_cache, c_logits = cpu.decode_step(c_cache, tok)
            g_cache, g_logits = card.decode_step(g_cache, tok.to(DEV))
            errs.append(float((g_logits.cpu() - c_logits).abs().max()))
        launches["decode"] = kernel_counts()
    set_kernel_counts(saved)
    routes = {}
    if cfg.moe is not None:      # first: a route that moved moves logits
        ties, routed = compare_routes(calls, cfg.moe.top_k)
        routes = dict(routed_tokens=routed, near_tie_tokens=ties,
                      tie_margin_rel=ROUTE_TIE_REL, routes_equal=True)
    for step, want in (("prefill", prefill_counts),
                       ("decode", {k: CPU_STEPS * v
                                   for k, v in decode_counts.items()})):
        got = {k: v for k, v in launches[step].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{arch} depth {layers}: the card's "
                                 f"{step} launched {got}, not {want}")
    state_err = max(float((g.cpu() - c).abs().max()) for (_, g), (_, c) in
                    zip(cache_leaves(g_cache), cache_leaves(c_cache)))
    if not (max(errs) <= SERVE_CPU_TOL and state_err <= SERVE_CPU_TOL):
        raise AssertionError(f"{arch}: the card's serve path differs from "
                             f"the CPU's: logits {errs}, cache {state_err} "
                             f"(tolerance {SERVE_CPU_TOL})")
    if int(g_cache["length"]) != int(c_cache["length"]) or (
            "pos" in c_cache
            and not torch.equal(g_cache["pos"].cpu(), c_cache["pos"])):
        raise AssertionError(f"{arch}: the card's cache length or positions "
                             "differ from the CPU's")
    log(phase, config=arch, layers=layers, compute="float32",
        batch=CPU_BATCH, prompt=CPU_PROMPT, decode_steps=CPU_STEPS,
        frontend=(tuple(frontend[:CPU_BATCH].shape) if frontend is not None
                  else "none"),
        prefill_err=f"{errs[0]:.3e}", decode_max_err=f"{max(errs[1:]):.3e}",
        cache_err=f"{state_err:.3e}", max_abs_logit=f"{scale:.4f}",
        tol=SERVE_CPU_TOL, **routes,
        launches_prefill={k: v for k, v in launches["prefill"].items() if v},
        launches_decode={k: v for k, v in launches["decode"].items() if v},
        seconds=f"{time.perf_counter() - t0:.1f}")
    del cpu, card, c_cache, g_cache
    torch.cuda.empty_cache()
    return {k: launches["prefill"][k] + launches["decode"][k]
            for k in launches["prefill"]}


def slstm_share(model, tokens):
    """The warm-up request's prefill with every sLSTM block timed on the
    host (each call synchronised before and after): the sLSTM's seconds
    and the prefill's."""
    orig = xlstm_mod.slstm_forward
    spent = [0.0]

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    xlstm_mod.slstm_forward = timed
    try:
        res = serve.generate(model, tokens, 2)
    finally:
        xlstm_mod.slstm_forward = orig
    return spent[0], res.prefill_s


def phase_serve(arch, phase, per_prefill, per_decode, *,
                prompt=SERVE_PROMPT, frontend=None, layers=None):
    """An arch's main serving path: `repro_torch.launch.serve`'s own
    functions at its full published widths and depth, or cut to depth
    ``layers`` (`cut_config`) where that is given (master weights in
    the config's param dtype, fp32, from a seeded generator, a VLM's gates
    by `seed_gates`; bf16 compute and cache), batch SERVE_BATCH,
    ``prompt`` tokens (SERVE_PROMPT by
    default), SERVE_GEN tokens, the VLM and the audio model on
    ``frontend``: one warm-up request, then the measured one, whose
    launches must be per_prefill plus SERVE_GEN - 1 times per_decode, and
    no other kernel's.  Peaks are taken after `collect_garbage`, from the
    memory allocated before the request.  For an MoE arch the line adds
    the host reads of the dispatch, the capacities C it chose, and the
    card's memory left above the peak."""
    cfg = get_config(arch) if layers is None else cut_config(arch, layers)
    t0 = time.perf_counter()
    model = seed_gates(serve.build(cfg, SEED, DEV))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = serve.prompts(cfg, SERVE_BATCH, prompt, SEED + 1, DEV)
    extra = {}
    if frontend is not None:
        extra["frontend"] = tuple(frontend.shape)
    if cfg.family == "ssm":      # the warm-up, its sLSTM blocks timed
        spent, wall = slstm_share(model, tokens)
        extra = dict(warmup_slstm_s=f"{spent:.3f}",
                     warmup_prefill_s=f"{wall:.3f}",
                     slstm_share_of_prefill=f"{spent / wall:.4f}")
    else:
        serve.generate(model, tokens, 2, frontend=frontend)   # warm-up
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    reads = moe_mod.HOST_READS
    capacities = []
    # this serving path: every kernel count starts at 0 here
    zero_kernel_counts()
    with recording(moe_mod, "capacity", lambda a, c: capacities.append(c)):
        res = serve.generate(model, tokens, SERVE_GEN, frontend=frontend)
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    if cfg.moe is not None:      # C per MoE layer: prefill's, then decode's
        n = cfg.n_layers
        total = torch.cuda.get_device_properties(0).total_memory
        extra.update(moe_host_reads=moe_mod.HOST_READS - reads,
                     prefill_capacity_min=min(capacities[:n]),
                     prefill_capacity_max=max(capacities[:n]),
                     decode_capacity=sorted(set(capacities[n:])),
                     card_total_bytes=total, headroom_bytes=total - peak)
    serve.report(res, SERVE_BATCH, prompt, SERVE_GEN)
    steps = SERVE_GEN - 1
    want = {k: per_prefill.get(k, 0) + steps * per_decode.get(k, 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"{arch}: the request launched {launches}, not "
                             f"{want}")
    if not (torch.isfinite(res.prefill_logits).all()
            and torch.isfinite(res.last_logits).all()):
        raise AssertionError(f"{arch}: the served logits are not finite")
    if res.tokens.shape != (SERVE_BATCH, SERVE_GEN):
        raise AssertionError(f"generated ids {tuple(res.tokens.shape)}")
    cache_size = cache_bytes(model.init_cache(SERVE_BATCH,
                                              prompt + SERVE_GEN))
    log(phase, config=arch, layers=cfg.n_layers,
        params=sum(p.numel() for p in model.parameters()),
        weights=f"{cfg.param_dtype}-seeded-random",
        compute=cfg.compute_dtype,
        batch=SERVE_BATCH, prompt=prompt, gen=SERVE_GEN,
        prefill_ms=f"{res.prefill_s * 1e3:.3f}",
        prefill_tok_per_s=f"{SERVE_BATCH * prompt / res.prefill_s:.1f}",
        decode_ms_per_token=f"{res.decode_s * 1e3 / steps:.3f}",
        decode_tok_per_s=f"{SERVE_BATCH * steps / res.decode_s:.1f}",
        launches_prefill=per_prefill, launches_per_decode_step=per_decode,
        launches_request={k: v for k, v in launches.items() if v},
        weight_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
        cache_bytes=cache_size, allocated_before=baseline,
        max_memory_allocated=peak,
        peak_over_allocated=peak - baseline, logits_finite=True,
        init_s=f"{init_s:.2f}",
        deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
        cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        **extra)
    return model, tokens, launches


def phase_profile(phase, arch, model, tokens, names, per_prefill,
                  per_decode, frontend=None):
    """One prefill and one decode step under torch.profiler: device busy
    time against host wall time, the share of the device time in this
    arch's kernels (by name), the launches, device events and peak memory
    of each step.  The profiler records device activity only:
    xlstm's prefill launches ~540,000 kernels, and recording the host ops
    beside them slows the traced prefill by a sixth."""
    from torch.profiler import ProfilerActivity, profile

    prompt = tokens.shape[1]
    cache = model.init_cache(SERVE_BATCH, prompt + SERVE_GEN)
    batch = {"tokens": tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    saved = kernel_counts()
    rows = {}
    for step in ("prefill", "decode"):
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if step == "prefill":
                cache, logits = model.prefill(batch, cache)
            else:
                cache, logits = model.decode_step(cache, serve.greedy(logits))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernel_counts().items() if v}
        want = per_prefill if step == "prefill" else per_decode
        if counts != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{arch} {step}: launched {counts}, not "
                                 f"{want}")
        rows[step] = (wall, *device_us(prof, names),
                      torch.cuda.max_memory_allocated(), counts)
    set_kernel_counts(saved)
    for step, (wall, dev, ours, events, peak, counts) in rows.items():
        log(f"{phase}-profile", config=arch, step=step,
            batch=SERVE_BATCH, prompt=prompt,
            host_wall_ms=f"{wall * 1e3:.3f}",
            device_busy_ms=f"{dev / 1e3:.3f}",
            device_busy_share=(f"{dev / 1e6 / wall:.4f}" if dev
                               else "not measured"),
            kernels_ms=f"{ours / 1e3:.3f}",
            kernel_share_of_device=(f"{ours / dev:.4f}" if dev
                                    else "not measured"),
            launches=counts, device_events=events, max_memory_allocated=peak)

# ---------------------------------------------------------------------------
# the MoE family: the moe_gmm kernel, deepseek-moe-16b
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recording(module, name, keep):
    """Wrap ``module.name`` while the block runs: each call's arguments and
    result go to ``keep(args, result)``, and the result goes back."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        keep(args, out)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def phase_moe_memory():
    """The card's free and total memory before the MoE phases (every
    earlier model freed)."""
    collect_garbage()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log("moe-memory", free_bytes=free, total_bytes=total,
        allocated=torch.cuda.memory_allocated(),
        reserved=torch.cuda.memory_reserved())


def gmm_weights(gen, e, d, f, scale):
    return torch.randn((e, d, f), generator=gen, device=DEV) * scale


def gmm_routes(gen, tokens, skewed=False):
    """Experts [T, k] int32 of deepseek-moe-16b's router shape: a uniform
    router (k distinct experts per token, drawn at random), or one that
    sends every token to experts 0..k-1."""
    e, k = GMM_EXPERTS[:2]
    if skewed:
        return torch.arange(k, device=DEV, dtype=torch.int32).expand(
            tokens, k).contiguous()
    return torch.rand((tokens, e), generator=gen, device=DEV).argsort(
        -1)[:, :k].to(torch.int32)


def gmm_capacity_inputs(gen, experts, dtype):
    """The capacity buffer x [E, C, d] that `models.moe` builds for these
    routes (each token's hidden row, N(0, 1) as after the norm, copied to
    each of its experts; zero past each count) and the int32 counts."""
    e, k, d, _ = GMM_EXPERTS
    counts, pos = moe_mod.dispatch(experts, e)
    t = experts.shape[0]
    x = torch.zeros((e, moe_mod.capacity(t, counts), d), dtype=dtype,
                    device=DEV)
    rows = torch.randn((t, d), generator=gen, device=DEV).to(dtype)
    x[experts.long(), pos] = rows[:, None, :].expand(t, k, d)
    return x, counts


def gmm_route(route):
    """`grouped_matmul` and `expert_swiglu` through one named kernel
    (``route``, as `gmm_ops.kernel_route` names them)."""
    def grouped_matmul(x, w, counts=None):
        return gmm_ops.launch(x, w, counts, route)

    def expert_swiglu(x, w_gate, w_up, w_down, counts=None):
        h = swiglu_gate(grouped_matmul(x, w_gate, counts),
                        grouped_matmul(x, w_up, counts))
        return grouped_matmul(h, w_down, counts)
    return {"gate": grouped_matmul, "swiglu": expert_swiglu}


def gmm_routes_for(x, w):
    """The kernels that take (x, w): the SIMT one always, the tensor-core
    one where `gmm_ops.kernel_route` sends them to it."""
    return ("simt", "wgmma") if gmm_ops.kernel_route(x, w) == "wgmma" \
        else ("simt",)


def compare_gmm(route, part, ref, args, tol, serving):
    """One kernel against the plain version on the same card tensors;
    raises above the bar, returns the largest absolute difference and the
    largest |output| (a zero output would make any comparison pass)."""
    got = gmm_route(route)[part](*args)
    torch.cuda.synchronize()
    want = ref(*args).float()
    err = float((got.float() - want).abs().max())
    bar = rel_bar(tol, want) if serving else tol
    if not err <= bar:
        raise AssertionError(f"moe_gmm's {route} kernel ({part}) differs "
                             f"from its plain version by {err} > {bar} at x "
                             f"{tuple(args[0].shape)} {args[0].dtype}, w "
                             f"{args[1].dtype}")
    return err, float(want.abs().max())


def phase_moe_compare():
    """Both kernels through `expert_swiglu` on the reference's kernel-test
    shapes (with and without counts, at its bars; fp32 x on the SIMT
    kernel only), and `grouped_matmul`/`expert_swiglu` at
    deepseek-moe-16b's prefill and decode capacity shapes and on a skewed
    router (C = T), at the bars times max(1, max|out|).  Returns the
    largest error of each kernel."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    saved = kernel_counts()
    t0 = time.perf_counter()
    errs = {(dt, r): 0.0 for dt in (torch.float32, torch.bfloat16)
            for r in ("simt", "wgmma")}
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for e, c, d, f in GMM_CASES:
            x = (torch.randn((e, c, d), generator=gen, device=DEV) * 0.3
                 ).to(dtype)
            ws = [gmm_weights(gen, e, *dims, 0.05).to(dtype)
                  for dims in ((d, f), (d, f), (f, d))]
            counts = torch.tensor([c * (i + 1) // (e + 1) for i in range(e)],
                                  dtype=torch.int32, device=DEV)
            for route in gmm_routes_for(x, ws[0]):
                for cnt in (None, counts):
                    err, _ = compare_gmm(route, "swiglu", expert_swiglu_ref,
                                         (x, *ws, cnt), GMM_TOL[dtype],
                                         serving=False)
                    errs[dtype, route] = max(errs[dtype, route], err)
                    cases += 1
    e, _, d, f = GMM_EXPERTS
    w_gate, w_up = (gmm_weights(gen, e, d, f, d ** -0.5) for _ in range(2))
    w_down = gmm_weights(gen, e, f, d, f ** -0.5)
    serving, sizes = {}, {}
    for name, tokens, skewed in (("prefill", GMM_TOKENS["prefill"], False),
                                 ("decode", GMM_TOKENS["decode"], False),
                                 ("skewed", GMM_TOKENS["prefill"], True)):
        experts = gmm_routes(gen, tokens, skewed)
        for dtype in ((torch.bfloat16,) if name == "skewed"
                      else (torch.bfloat16, torch.float32)):
            x, counts = gmm_capacity_inputs(gen, experts, dtype)
            tol = GMM_TOL[dtype]
            tag = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            sizes[f"{tag}_C"] = x.shape[1]
            runs = {"gate": (grouped_matmul_ref, (x, w_gate, counts)),
                    "swiglu": (expert_swiglu_ref,
                               (x, w_gate, w_up, w_down, counts))}
            if dtype == torch.bfloat16:          # weights stored in bf16
                runs["gate_bf16w"] = (grouped_matmul_ref,
                                      (x, w_gate.to(dtype), counts))
            for part, (ref, args) in runs.items():
                for route in gmm_routes_for(x, w_gate):
                    err, sizes[f"{tag}_{part}_max_out"] = compare_gmm(
                        route, part.split("_")[0], ref, args, tol,
                        serving=True)
                    serving[f"{tag}_{part}_{route}"] = err
                    errs[dtype, route] = max(errs[dtype, route], err)
                    cases += 1
            del x, runs
    set_kernel_counts(saved)
    log("moe-compare", cases=cases,
        **{f"{r}_err_{'fp32' if dt == torch.float32 else 'bf16'}":
           f"{v:.3e}" for (dt, r), v in errs.items()
           if not (dt == torch.float32 and r == "wgmma")},
        tol_fp32=GMM_TOL[torch.float32], tol_bf16=GMM_TOL[torch.bfloat16],
        **{k: f"{v:.3e}" for k, v in serving.items()},
        **{k: (v if k.endswith("_C") else f"{v:.4f}")
           for k, v in sizes.items()},
        serving_bar="tol x max(1, max|out|)",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return {"simt": max(errs[dt, "simt"] for dt in (torch.float32,
                                                     torch.bfloat16)),
            "wgmma": errs[torch.bfloat16, "wgmma"]}


def phase_moe_time():
    """One gate product of deepseek-moe-16b's experts, bf16 x, at the
    prefill and decode capacity shapes of a uniform router, in turns: the
    tensor-core kernel on the fp32 master weights (as the serve path calls
    it) and on bf16 weights, the SIMT kernel on the fp32 weights, the
    plain version, `torch.bmm` on the bf16 weights (the library's batched
    product; never called by the port), and the bound."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    saved = kernel_counts()
    e, _, d, f = GMM_EXPERTS
    w = gmm_weights(gen, e, d, f, d ** -0.5)
    w16 = w.to(torch.bfloat16)
    rows = {}
    for name, tokens in GMM_TOKENS.items():
        x, counts = gmm_capacity_inputs(gen, gmm_routes(gen, tokens),
                                        torch.bfloat16)
        fns = {"wgmma": lambda: gmm_ops.launch(x, w, counts, "wgmma"),
               "wgmma_bf16w": lambda: gmm_ops.launch(x, w16, counts,
                                                     "wgmma"),
               "simt": lambda: gmm_ops.launch(x, w, counts, "simt"),
               "plain": lambda: grouped_matmul_ref(x, w, counts),
               "library": lambda: torch.bmm(x, w16)}
        n = 10 if name == "prefill" else 50
        ms, runs = in_turns(fns, dict(wgmma=n, wgmma_bf16w=n, simt=n // 2,
                                      plain=n // 2, library=n), warmup=2)
        bound = gmm_bound(x, w, counts)
        rows[name] = {}
        for route in ("wgmma", "simt"):
            log("moe-time", kernel=route, step=name, E=e, C=x.shape[1], d=d,
                f=f, dtype="bfloat16", weights="float32",
                ms=f"{ms[route]:.4f}",
                passes=[f"{t:.4f}" for t in runs[route]],
                ms_bf16_weights=(f"{ms['wgmma_bf16w']:.4f}"
                                 if route == "wgmma" else "not measured"),
                plain_ms=f"{ms['plain']:.4f}",
                library_ms=f"{ms['library']:.4f}", rows=bound["rows"],
                active_experts=bound["active_experts"], flop=bound["flop"],
                bytes=bound["bytes"], bound_ms=f"{bound['bound_ms']:.5f}",
                bound_by=bound["bound_by"],
                share_of_bound=f"{bound['bound_ms'] / ms[route]:.5f}",
                tflops=f"{bound['flop'] / ms[route] / 1e9:.2f}",
                x_library=f"{ms[route] / ms['library']:.2f}")
            rows[name][route] = dict(ms=ms[route], plain_ms=ms["plain"],
                                     library_ms=ms["library"], **bound)
        del x
    set_kernel_counts(saved)
    return rows


def route_log():
    """A list that `recording(moe_mod, "route_topk", ...)` fills with each
    call's (device type, experts, probs), on the host."""
    calls = []

    def keep(args, out):
        calls.append((args[0].device.type, out[1].cpu(), out[2].cpu()))
    return calls, keep


def compare_routes(calls, k):
    """Each card call's experts against the CPU call of the same layer and
    step: equal (as sets) for every token whose CPU gap between the k-th
    and (k+1)-th probability exceeds ROUTE_TIE_REL of the k-th.  Returns
    (near-tie tokens, tokens)."""
    cpu = [c for c in calls if c[0] == "cpu"]
    card = [c for c in calls if c[0] == "cuda"]
    if len(cpu) != len(card) or not cpu:
        raise AssertionError(f"{len(cpu)} CPU routings, {len(card)} on the "
                             "card")
    ties = tokens = 0
    for (_, ec, pc), (_, eg, _) in zip(cpu, card):
        top = pc.topk(k + 1, dim=-1).values
        clear = (top[:, k - 1] - top[:, k]) > ROUTE_TIE_REL * top[:, k - 1]
        same = (ec.sort(-1).values == eg.sort(-1).values).all(-1)
        if not bool(same[clear].all()):
            raise AssertionError(f"{int((~same & clear).sum())} tokens clear "
                                 "of a near tie took other experts on the "
                                 "card")
        ties += int((~clear).sum())
        tokens += pc.shape[0]
    return ties, tokens



def phase_prefill_syncs(model, tokens, arch=SERVE_ARCH, cache=None,
                        frontend=None):
    """One prefill of ``arch`` (into a fresh cache, or onto ``cache``; the
    VLM and the audio model on ``frontend``) under
    ``torch.cuda.set_sync_debug_mode("warn")``, under which each
    synchronising op warns: every such warning, by the innermost line of
    the port's source on the Python stack when it was raised, and its
    text."""
    if cache is None:
        cache = model.init_cache(SERVE_BATCH, tokens.shape[1] + SERVE_GEN)
    batch = {"tokens": tokens}
    if frontend is not None:
        batch["frontend"] = frontend
    saved = kernel_counts()
    _, where, texts = sync_sites(lambda: model.prefill(batch, cache))
    set_kernel_counts(saved)
    log("serve-syncs", config=arch, step="prefill",
        cache="carried" if int(cache["length"]) else "fresh",
        tokens=tuple(tokens.shape), syncs=len(where),
        at={w: where.count(w) for w in sorted(set(where))} or "none",
        messages=sorted(texts) or "none")
    return where


#: [serve-syncs] for xlstm-350m: the first prefill's and the measured
#: prefill's prompt (the sLSTM walks it token by token on the host)
XLSTM_SYNC_PROMPT = 256


def phase_xlstm_syncs(model, tokens):
    """The host syncs of one xlstm-350m prefill onto a non-empty cache
    (XLSTM_SYNC_PROMPT tokens after as many): none may come from
    ``models/model.py``, from ``mlstm_forward`` in ``models/xlstm.py`` or
    from the mLSTM kernel's wrapper."""
    import inspect

    n = XLSTM_SYNC_PROMPT
    saved = kernel_counts()
    cache = model.init_cache(SERVE_BATCH, 2 * n)
    cache, _ = model.prefill({"tokens": tokens[:, :n]}, cache)
    set_kernel_counts(saved)
    where = phase_prefill_syncs(model, tokens[:, n:2 * n], XLSTM_ARCH, cache)
    lines, first = inspect.getsourcelines(xlstm_mod.mlstm_forward)
    mlstm_lines = range(first, first + len(lines))
    bad = [w for w in where
           if w.startswith(("repro_torch/models/model.py",
                            "repro_torch/kernels/mlstm_scan/"))
           or (w.startswith("repro_torch/models/xlstm.py:")
               and int(w.rsplit(":", 1)[1]) in mlstm_lines)]
    if bad:
        raise AssertionError(f"xlstm-350m's prefill onto a carried cache "
                             f"syncs on the mLSTM path: {sorted(set(bad))}")


def flash_per_prefill(cfg):
    """Flash launches of one prefill: one per attention layer; whisper's
    encoder layers once, its decoder layers twice (self and cross)."""
    if cfg.family == "audio":
        return cfg.audio.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def phase_new_families_serve(frontends):
    """Slice 10's serving: for minicpm3-4b, llama-3.2-vision-11b and
    whisper-base, `phase_vs_cpu` at NEW_CPU_LAYERS (the SIMT kernel, fp32),
    then `phase_serve` at the published widths and depth (whisper's prompt
    AUDIO_PROMPT), the host syncs of one prefill and `phase_profile`, the
    VLM and whisper on their seeded frontends; each model freed before the
    next.  Every prefill attention goes through the flash kernel (VLM and
    whisper decode their cross-attention in plain torch, as every decode
    step does).  Returns the SIMT launches of the `-vs-cpu` runs and the
    tensor-core launches of the measured requests."""
    launches = {"flash_attention": 0, "flash_attention_wgmma": 0}
    for arch, tag in ((MLA_ARCH, "mla"), (VLM_ARCH, "vlm"),
                      (AUDIO_ARCH, "audio")):
        fe = frontends.get(arch)
        layers = NEW_CPU_LAYERS[arch]
        got = phase_vs_cpu(
            arch, f"{tag}-vs-cpu",
            {"flash_attention": flash_per_prefill(cut_config(arch, layers))},
            {}, layers=layers, frontend=fe)
        launches["flash_attention"] += got["flash_attention"]
        per_prefill = {"flash_attention_wgmma":
                       flash_per_prefill(get_config(arch))}
        prompt = AUDIO_PROMPT if arch == AUDIO_ARCH else SERVE_PROMPT
        model, tokens, got = phase_serve(arch, f"serve-{tag}", per_prefill,
                                         {}, prompt=prompt, frontend=fe)
        launches["flash_attention_wgmma"] += got["flash_attention_wgmma"]
        where = phase_prefill_syncs(model, tokens, arch, frontend=fe)
        if where:
            log(f"serve-{tag}-syncs", expected=0, found=len(where),
                note="a prefill of this arch reads the card")
        phase_profile(f"serve-{tag}", arch, model, tokens, ("flash_fwd",),
                      per_prefill, {}, frontend=fe)
        del model, tokens
        collect_garbage()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multi-device execution (ROADMAP slice 11, part 1): one card, one NCCL
# rank for the expert-parallel layer, then two gloo ranks sharing the card
# ---------------------------------------------------------------------------

EP_FACTOR = 1.25              # moe_ffn_ep's default capacity factor
#: a factor at which deepseek's layer drops pairs (C_e 768, the mean load:
#: about half the experts overflow), so that the drop rule is held
EP_DROP_FACTOR = 1.0
SHARD_RANKS = 2
SHARD_ARCH = "internlm2-1.8b"
SHARD_DECODE_STEPS = 8
#: the sharded serve's logits against the one-process bf16 run: the RMS of
#: the difference over the logits' RMS.  The two runs round the same bf16
#: products in other orders (the row-parallel sums add two halves in
#: fp32); a rank that attends over the wrong heads or slots, or drops a
#: half, is off by the logits' own size
SHARD_LOGITS_REL_RMS = 2.0 ** -5
#: the rank processes' budget, their start and the kernels' load included
SHARD_TIMEOUT_S = 600
#: internlm2-1.8b's decode: batch 4, a 2,080-slot cache, 16/8 heads, d 128
KV_DECODE_SHAPE = (4, 2080, 16, 8, 128)


def ep_layer(gen):
    """deepseek-moe-16b's MoE layer at its published widths (d 2,048, 64
    routed experts top-6 of d_expert 1,408, 2 shared of 2,816 together),
    fp32 weights drawn in the spec's sorted order from ``gen`` on the
    card, and seeded bf16 x [4, 2,048, 2,048] as after the norm."""
    spec = moe_mod.moe_params_spec(_MOE.d_model, _MOE.moe, torch.float32)

    def build(node):
        out = {}
        for k in sorted(node):
            if isinstance(node[k], dict):
                out[k] = build(node[k])
            else:
                shape, init, dt = node[k]
                out[k] = init(torch.empty(shape, dtype=dt, device=DEV), gen)
        return out

    params = build(spec)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, _MOE.d_model), generator=gen,
                    device=DEV).to(torch.bfloat16)
    return params, x


def plain_kept(experts, n_experts, cap):
    """The (token, slot) pairs that an expert keeps, on the host: each
    expert's first ``cap`` pairs in flat order."""
    flat = experts.reshape(-1).cpu().numpy()
    seen = np.zeros(n_experts, np.int64)
    keep = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        keep[i] = seen[e] < cap
        seen[e] += 1
    return keep.reshape(experts.shape)


def phase_ep_compare(work):
    """`moe_ffn_ep` on a (1, 1) mesh of a one-rank NCCL group, called
    directly on deepseek-moe-16b's layer: drop-free (C_e = T_local) it
    equals `moe_ffn` on the card; at the default factor 1.25 and at 1.0,
    where pairs are dropped (it fails if none is), its kept pairs are the
    plain path's, exactly, and its output is within the bar of the same
    dispatch through the plain expert FFN; one call launches three
    tensor-core `moe_gmm` kernels and makes no host sync; timed in turns
    against `moe_ffn`.  The kernel at the dispatch's shapes (C_e 768, 960
    and 8,192; at 768 the overflowing experts' counts are capped at C_e)
    against its plain version, timed beside `torch.bmm` on the same
    buffers with its bound.  Saves the layer's outputs for [ep-ranks]."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import moe_ep

    dist.init_process_group("nccl", store=dist.FileStore(
        str(work / "ep_store"), 1), rank=0, world_size=1)
    nccl = collective_probe(0, 1)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    moe = _MOE.moe
    e, k, d = moe.n_routed, moe.top_k, _MOE.d_model
    params, x = ep_layer(torch.Generator(device=DEV).manual_seed(SEED + 30))
    t = SERVE_BATCH * SERVE_PROMPT
    free = e / k                       # C_e = T_local: no pair dropped
    cap = moe_ep.ep_capacity(t, k, e, EP_FACTOR)
    bar = GMM_TOL[torch.bfloat16]
    bufs = {}
    keep_bufs = lambda a, out: bufs.setdefault(a[0].shape[1], a)  # noqa: E731
    y_plain, _ = moe_mod.moe_ffn(moe, params, x)
    with recording(gmm_ops, "expert_swiglu", keep_bufs):
        y_free, _ = moe_ep.moe_ffn_ep(moe, params, x, mesh,
                                      capacity_factor=free)
        torch.cuda.synchronize()
        err_free = float((y_free.float() - y_plain.float()).abs().max())
        if not err_free <= rel_bar(bar, y_plain.float()):
            raise AssertionError(f"drop-free EP differs from moe_ffn by "
                                 f"{err_free}")
        # the main path: every count at 0 just before, read just after
        zero_kernel_counts()
        (y, _), sites, texts = sync_sites(lambda: moe_ep.moe_ffn_ep(
            moe, params, x, mesh, capacity_factor=EP_FACTOR))
        launches = kernel_counts()
    if {n: c for n, c in launches.items() if c} != {"moe_gmm_wgmma": 3}:
        raise AssertionError(f"one EP call launched {launches}")
    if sites:
        raise AssertionError(f"the EP dispatch synchronised at {sites}")
    logits = x.reshape(-1, d).float() @ params["router"].float()
    _, experts, _ = moe_mod.route_topk(logits, k)
    outs, kept, errs = {EP_FACTOR: y}, {}, {}
    for factor in (EP_FACTOR, EP_DROP_FACTOR):
        c_e = moe_ep.ep_capacity(t, k, e, factor)
        _, keep, _ = moe_ep.local_slots(experts, 0, e, e, c_e)
        want_keep = plain_kept(experts, e, c_e)
        if not np.array_equal(keep.cpu().numpy(), want_keep):
            raise AssertionError(f"the EP dispatch at {factor} kept other "
                                 f"pairs than the plain path")
        kept[factor] = int(want_keep.sum())
        if factor not in outs:
            with recording(gmm_ops, "expert_swiglu", keep_bufs):
                outs[factor], _ = moe_ep.moe_ffn_ep(
                    moe, params, x, mesh, capacity_factor=factor)
        with recording(gmm_ops, "expert_swiglu", lambda a, o: None):
            # the plain version takes no ``pairs``: the cost record's
            gmm_ops.expert_swiglu = (
                lambda *a, pairs=None: expert_swiglu_ref(*a))
            y_ref, _ = moe_ep.moe_ffn_ep(moe, params, x, mesh,
                                         capacity_factor=factor)
        errs[factor] = float((outs[factor].float()
                              - y_ref.float()).abs().max())
        if not errs[factor] <= rel_bar(bar, y_ref.float()):
            raise AssertionError(f"EP at {factor} differs from its plain "
                                 f"version by {errs[factor]}")
    if not kept[EP_DROP_FACTOR] < t * k:
        raise AssertionError(f"EP at {EP_DROP_FACTOR} dropped no pair: the "
                             f"drop rule went unchecked")
    err = max(errs.values())
    ms, _ = in_turns({
        "ep": lambda: moe_ep.moe_ffn_ep(moe, params, x, mesh,
                                        capacity_factor=EP_FACTOR),
        "moe_ffn": lambda: moe_mod.moe_ffn(moe, params, x)},
        dict(ep=5, moe_ffn=5), warmup=1)
    # the kernel at the dispatch's own buffers
    saved = kernel_counts()
    rows, kerr = {}, 0.0
    for c_e in sorted(bufs):
        buf, wg, wu, wd, cnt = bufs[c_e]
        kerr = max(kerr, compare_gmm("wgmma", "swiglu", expert_swiglu_ref,
                                     (buf, wg, wu, wd, cnt), bar,
                                     serving=True)[0])
        mst, _ = in_turns({
            "wgmma": lambda: gmm_ops.launch(buf, wg, cnt, "wgmma"),
            "plain": lambda: grouped_matmul_ref(buf, wg, cnt),
            "library": lambda: torch.bmm(buf, wg)},
            dict(wgmma=10, plain=5, library=10), warmup=2)
        bound = gmm_bound(buf, wg, cnt)
        rows[c_e] = dict(ms=mst["wgmma"], plain_ms=mst["plain"],
                         library_ms=mst["library"], **bound)
        log("ep-kernel", E_local=buf.shape[0], C_e=c_e, d=d,
            f=wg.shape[2], x=str(buf.dtype), weights=str(wg.dtype),
            ms=f"{mst['wgmma']:.4f}", plain_ms=f"{mst['plain']:.4f}",
            library_ms=f"{mst['library']:.4f}", rows=bound["rows"],
            active_experts=bound["active_experts"], flop=bound["flop"],
            bytes=bound["bytes"], bound_ms=f"{bound['bound_ms']:.5f}",
            bound_by=bound["bound_by"],
            share_of_bound=f"{bound['bound_ms'] / mst['wgmma']:.5f}",
            x_library=f"{mst['wgmma'] / mst['library']:.2f}")
    set_kernel_counts(saved)
    torch.save({"y": {f: v.cpu() for f, v in outs.items()},
                "y_free": y_free.cpu()}, work / "ep.pt")
    log("ep-compare", config=MOE_ARCH, E=e, top_k=k, d=d,
        d_expert=moe.d_expert, shared=f"{moe.n_shared}x{moe.d_shared}",
        tokens=t, factor=EP_FACTOR, C_e=cap, C_e_free=t, pairs=t * k,
        kept_pairs=kept[EP_FACTOR],
        drop_factor=EP_DROP_FACTOR,
        C_e_drop=moe_ep.ep_capacity(t, k, e, EP_DROP_FACTOR),
        kept_pairs_drop=kept[EP_DROP_FACTOR],
        dropped_pairs_drop=t * k - kept[EP_DROP_FACTOR],
        kept_equal_plain=True, err_free_vs_moe_ffn=f"{err_free:.3e}",
        err_vs_plain=f"{errs[EP_FACTOR]:.3e}",
        err_vs_plain_drop=f"{errs[EP_DROP_FACTOR]:.3e}",
        bar=f"{bar} x max(1, max|y|)",
        launches=launches["moe_gmm_wgmma"], host_syncs=len(sites),
        ms_ep=f"{ms['ep']:.3f}", ms_moe_ffn=f"{ms['moe_ffn']:.3f}",
        kernel_err=f"{kerr:.3e}", nccl_on_cuda=nccl)
    if any(v != "ok" for k, v in nccl.items()
           if k.startswith(("all_reduce", "all_gather"))):
        raise AssertionError(f"NCCL refused a collective the port uses: "
                             f"{nccl}")
    del params, x, bufs
    dist.destroy_process_group()
    collect_garbage()
    torch.cuda.empty_cache()
    return dict(launches=launches["moe_gmm_wgmma"], err=max(kerr, err),
                timing=rows[cap])


def shard_reference(work, cfg, name, prompt=SERVE_PROMPT):
    """The one-process bf16 run that a sharded serve is held to: ``cfg``
    from `serve.build`'s seeded weights (a VLM's gates `seed_gates`'s), a
    4 x ``prompt`` prompt (a VLM's and the audio model's on
    `serve_batch`'s patches or frames), then
    SHARD_DECODE_STEPS greedy steps; saves the prompt, the fed ids and
    every step's logits to ``work/name``, through a temporary file, so
    that a rank that waits for it reads it whole."""
    model = seed_gates(serve.build(cfg, SEED, DEV))
    tokens = serve.prompts(cfg, SERVE_BATCH, prompt, SEED + 1, DEV)
    cache = model.init_cache(SERVE_BATCH, prompt + SHARD_DECODE_STEPS)
    cache, logits = model.prefill(serve_batch(cfg, tokens), cache)
    out, fed = [logits.cpu()], []
    for _ in range(SHARD_DECODE_STEPS):
        nxt = serve.greedy(logits)
        fed.append(nxt.cpu())
        cache, logits = model.decode_step(cache, nxt)
        out.append(logits.cpu())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.save({"tokens": tokens.cpu(), "fed": fed, "logits": out,
                "weight_bytes": weights}, work / f"{name}.part")
    os.replace(work / f"{name}.part", work / name)
    del model, cache
    collect_garbage()
    torch.cuda.empty_cache()
    return weights


def serve_batch(cfg, tokens):
    """A prefill batch of ``tokens``, with `seeded_frontend`'s patches
    where ``cfg`` takes a frontend: what a sharded serve and its
    one-process run both take."""
    fe = seeded_frontend(cfg, SERVE_BATCH, SEED + 9)
    return {"tokens": tokens} if fe is None else {"tokens": tokens,
                                                  "frontend": fe}


def collective_probe(rank, world):
    """Which collectives the default group (gloo or NCCL) takes on CUDA
    tensors."""
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device=DEV)
    tries = {
        "all_reduce_sum": lambda: dist.all_reduce(t.clone()),
        "all_reduce_max": lambda: dist.all_reduce(
            t.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=DEV), t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=DEV), t),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 -- recorded, not hidden
            out[name] = f"{type(exc).__name__}: {str(exc)[:60]}"
    return out


def _ranks_ep(mesh, work, res):
    """[ep-compare]'s layer over the two ranks, 32 experts each, against
    [ep-compare]'s output at the same factor: the default one and the one
    that drops pairs."""
    from repro_torch.distributed import moe_ep

    moe = _MOE.moe
    params, x = ep_layer(torch.Generator(device=DEV).manual_seed(SEED + 30))
    saved = torch.load(work / "ep.pt")["y"]
    res["ep_experts_local"] = moe.n_routed // SHARD_RANKS
    res["ep_err"], res["ep_bar"] = {}, {}
    for factor in (EP_FACTOR, EP_DROP_FACTOR):
        want = saved[factor].to(DEV)
        zero_kernel_counts()
        y, _ = moe_ep.moe_ffn_ep(moe, params, x, mesh,
                                 capacity_factor=factor)
        torch.cuda.synchronize()
        res["ep_launches"] = kernel_counts()["moe_gmm_wgmma"]
        res["ep_err"][str(factor)] = float((y.float()
                                            - want.float()).abs().max())
        res["ep_bar"][str(factor)] = rel_bar(GMM_TOL[torch.bfloat16],
                                             want.float())


def _ranks_kv_decode(mesh, res):
    """`sharded_kv_decode_attention` at KV_DECODE_SHAPE, each rank half
    the slots, against `decode_attention` over the whole cache, fp32 and
    bf16."""
    from repro_torch.distributed import collectives as col
    from repro_torch.models.attention import decode_attention

    b, s, h, kvh, d = KV_DECODE_SHAPE
    r, s_loc = col.tp_rank(mesh), s // SHARD_RANKS
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
        kc, vc = (torch.randn((b, s, kvh, d), generator=gen, device=DEV
                              ).to(dtype) for _ in range(2))
        q = torch.randn((b, 1, h, d), generator=gen, device=DEV).to(dtype)
        kn, vn = (torch.randn((b, 1, kvh, d), generator=gen, device=DEV
                              ).to(dtype) for _ in range(2))
        filled = SERVE_PROMPT
        pos = torch.arange(s, device=DEV, dtype=torch.int32)
        kv_pos = torch.where(pos < filled, pos, -1)[None].expand(b, s)
        q_pos = torch.full((b, 1), filled, dtype=torch.int32, device=DEV)
        cursor = torch.tensor(filled, dtype=torch.int32, device=DEV)
        # the plain path: write slot `filled`, attend over every slot
        kw, vw, pw = kc.clone(), vc.clone(), kv_pos.clone()
        kw[:, filled], vw[:, filled], pw[:, filled] = kn[:, 0], vn[:, 0], filled
        want = decode_attention(q, kw, vw, q_pos, pw).float()
        mine = slice(r * s_loc, (r + 1) * s_loc)
        col.reset_counts()
        out, k_loc, _, p_loc = col.sharded_kv_decode_attention(
            q, kc[:, mine].clone(), vc[:, mine].clone(), kn, vn, q_pos,
            kv_pos[:, mine].clone(), cursor, mesh)
        torch.cuda.synchronize()
        tag = "fp32" if dtype == torch.float32 else "bf16"
        res[f"kv_decode_err_{tag}"] = float((out.float() - want).abs().max())
        res[f"kv_decode_bar_{tag}"] = ATTN_TOL[dtype]
        res[f"kv_decode_writes_ok_{tag}"] = bool(
            torch.equal(k_loc, kw[:, mine]) and torch.equal(p_loc,
                                                            pw[:, mine]))
        res["kv_decode_collectives"] = dict(col.COLLECTIVES)


def _ranks_reshard(m12, res):
    """A state saved on the (1, 2) mesh, restored on (2, 1) and on no
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.reshard import restore_resharded, save_global
    from repro_torch.distributed import sharding as shd

    m21 = init_device_mesh("cuda", (2, 1), mesh_dim_names=("data", "model"))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 32)
    w = torch.randn((4096, 1024), generator=gen, device=DEV)
    b = torch.randn((1024,), generator=gen, device=DEV).to(torch.bfloat16)
    specs = {"w": (("data",), ("model",)), "b": (("model",),)}

    def sh(mesh):
        return {k: shd.Sharding(mesh, v, shd.to_placements(v, mesh))
                for k, v in specs.items()}

    state = {"w": shd.place(w, sh(m12)["w"], device=DEV),
             "b": shd.place(b, sh(m12)["b"], device=DEV)}
    leaves = save_global(state)
    template = {"w": torch.empty(w.shape, device="meta"),
                "b": torch.empty(b.shape, dtype=b.dtype, device="meta")}
    on21 = restore_resharded(leaves, template, sh(m21), device=DEV)
    whole = restore_resharded(leaves, template, None, device=DEV)
    box = shd.local_box(w.shape, specs["w"], shd.axis_sizes(m21),
                        shd.mesh_coord(m21))
    res["reshard_bit_equal"] = bool(
        torch.equal(on21["w"].to_local(), w[box])
        and torch.equal(whole["w"], w) and torch.equal(whole["b"], b)
        and np.array_equal(save_global(on21)["['w']"], w.cpu().numpy()))
    res["reshard_local_share"] = on21["w"].to_local().numel() / w.numel()


def _ranks_train(mesh, res):
    """One sharded train step of the smoke MoE (EP drop-free) against the
    one-process step, at the train bars."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed import sharding as shd
    from repro_torch.checkpoint.reshard import save_global
    from repro_torch.train import steps

    # fp32 compute: the two steps then differ only by the order of fp32
    # sums, and the train bars are the fp32 ones
    cfg = get_smoke_config(MOE_ARCH).replace(compute_dtype="float32")
    tcfg = TrainConfig(lr=1e-3, warmup_steps=0)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 33)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=gen,
                              device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    one = Model(cfg, device=DEV).init(
        torch.Generator(device=DEV).manual_seed(SEED + 34))
    src = {k: v.detach().clone() for k, v in one.named_parameters()}
    params = dict(one.named_parameters())
    loss, _ = one.loss(batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    s1, m1 = make_train_step(one, tcfg)(init_train_state(one.params()),
                                        batch)
    two = Model(cfg, device="meta")
    shd.shard_model(two, mesh, source=src, device=DEV)
    state = steps.TrainState(params=two.params(),
                             opt=steps.shard_opt(two.params()),
                             rng=s1.rng, data_cursor=s1.data_cursor)
    # drop-free: C_e = T_local
    was = moe_ep.EP_CAPACITY_FACTOR
    moe_ep.EP_CAPACITY_FACTOR = cfg.moe.n_routed / cfg.moe.top_k
    try:
        with col.use_mesh(mesh):
            s2, m2 = make_train_step(two, tcfg)(state, batch)
    finally:
        moe_ep.EP_CAPACITY_FACTOR = was
    after = save_global(s2.params)
    lt, gt = STEP_TOL[cfg.compute_dtype]
    tight_bad = loose = 0.0
    for k, p in dict(one.named_parameters()).items():
        key = "".join(f"[{n!r}]" for n in k.split("."))
        err = (torch.from_numpy(after[key]).to(DEV) - p.detach()).abs()
        g = grads[k].abs()
        tight = g >= GRAD_TOL[cfg.compute_dtype] * g.max()
        if bool(tight.any()):
            tight_bad = max(tight_bad, float(err[tight].max()))
        loose = max(loose, float(err.max()))
    res.update(
        train_loss=float(m2["loss"]), train_loss_one=float(m1["loss"]),
        train_gnorm=float(m2["grad_norm"]),
        train_gnorm_one=float(m1["grad_norm"]),
        train_ok=bool(abs(float(m2["loss"]) - float(m1["loss"]))
                      <= lt * abs(float(m1["loss"]))
                      and abs(float(m2["grad_norm"]) - float(m1["grad_norm"]))
                      <= gt * abs(float(m1["grad_norm"]))
                      and tight_bad <= 1e-6 + 1e-3 * tcfg.lr
                      and loose <= 1e-6 + 2 * tcfg.lr),
        train_param_err_tight=tight_bad, train_param_err=loose)


def _ranks_serve(mesh, work, res, cfg, ref_name, key="serve",
                 wait_s=0.0):
    """``cfg`` at full width, placed by `param_shardings` (a VLM's gates
    `seed_gates`'s, its prefill on `serve_batch`'s patches or frames):
    the one-process run's prompt, then SHARD_DECODE_STEPS steps on its
    ids (``work / ref_name``, waited for up to ``wait_s`` seconds),
    against its logits; the prefill and the first decode step under
    `sync_sites`; every flash and scan launch's shape recorded.  The
    results go to ``res`` under ``key``."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention as attention_mod

    out_res = {}
    deadline = time.perf_counter() + wait_s
    while not (work / ref_name).exists():
        if time.perf_counter() > deadline:
            raise AssertionError(f"no {ref_name} after {wait_s} s")
        time.sleep(1)
    ref = torch.load(work / ref_name)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="meta")
    shd.shard_model(model, mesh, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED))
    seed_gates(model)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    out_res["weight_bytes_local"] = sum(
        p.to_local().numel() * p.element_size() for p in model.parameters())
    # the leaves the rules leave whole on the model axis (a vocab it does
    # not divide: hymba's unembedding)
    model_dim = model.embed.device_mesh.mesh_dim_names.index("model")
    out_res["weight_bytes_model_replicated"] = sum(
        p.to_local().numel() * p.element_size() for p in model.parameters()
        if not p.placements[model_dim].is_shard())
    tokens = ref["tokens"].to(DEV)
    batch = serve_batch(cfg, tokens)
    heads, dims, scans, mlstms = [], set(), [], []

    def flash_call(a, _o):
        heads.append((a[0].shape[2], a[1].shape[2], a[0].shape[1],
                      a[1].shape[1]))
        dims.add((a[0].shape[3], a[2].shape[3]))

    with col.use_mesh(mesh), recording(
            attention_mod, "flash_attention", flash_call), recording(
            ssm_mod, "selective_scan",
            lambda a, _o: scans.append(list(a[3].shape))), recording(
            xlstm_mod, "mlstm_scan",
            lambda a, _o: mlstms.append(list(a[0].shape))):
        cache = model.init_cache(SERVE_BATCH,
                                 tokens.shape[1] + SHARD_DECODE_STEPS)
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        col.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (cache, logits), where, texts = sync_sites(
            lambda: model.prefill(batch, cache))
        prefill_s = time.perf_counter() - t0
        prefill_launches = kernel_counts()
        prefill_coll = dict(col.COLLECTIVES)
        prefill_scans, scans[:] = list(scans), []
        prefill_mlstms, mlstms[:] = list(mlstms), []
        out = [logits]
        fed = [n.to(DEV) for n in ref["fed"]]
        torch.cuda.synchronize()
        col.reset_counts()
        zero_kernel_counts()
        t0 = time.perf_counter()
        for i, nxt in enumerate(fed[:-1]):
            step = lambda n=nxt: model.decode_step(cache, n)  # noqa: E731
            if i == 0:
                (cache, logits), dec_where, dec_texts = sync_sites(step)
            else:
                cache, logits = step()
            out.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_coll = dict(col.COLLECTIVES)
        decode_launches = kernel_counts()
        decode_scans, decode_mlstms = list(scans), list(mlstms)
        # a broken run for the bar: the last step with every all-reduce
        # left to the rank's own half (each attends over its slots only,
        # each row-parallel sum keeps its half), from a copy of the cache
        last = fed[-1]
        broken = fault_step(model, cache, last)
        t0 = time.perf_counter()
        cache, logits = model.decode_step(cache, last)
        out.append(logits)
        torch.cuda.synchronize()
        decode_s += time.perf_counter() - t0
    rms = [rel_rms(got.cpu(), want) for got, want in zip(out, ref["logits"])]
    boxes = {k: list(v.shape) for k, v in cache_leaves(cache)}
    steps = SHARD_DECODE_STEPS - 1
    out_res.update(
        heads_aligned=tfm.heads_aligned(cfg, mesh),
        head_dim_split=tfm.head_dim_split(cfg, mesh),
        layout=cache["layout"],
        cache_local=boxes,
        cache_k_local=boxes.get("k"),
        cache_xk_local=boxes.get("xk"),
        init_peak=init_peak,
        peak=torch.cuda.max_memory_allocated(),
        weight_bytes_one=ref["weight_bytes"],
        prefill_ms=prefill_s * 1e3,
        decode_ms_per_step=decode_s * 1e3 / SHARD_DECODE_STEPS,
        prefill_syncs=len(where),
        prefill_sync_sites={w: where.count(w) for w in sorted(set(where))},
        prefill_sync_messages=sorted(texts),
        decode_syncs=len(dec_where),
        decode_sync_sites={w: dec_where.count(w)
                           for w in sorted(set(dec_where))},
        decode_sync_messages=sorted(dec_texts),
        flash_launches_prefill=prefill_launches["flash_attention_wgmma"],
        other_launches={k: v for k, v in prefill_launches.items()
                        if v and k != "flash_attention_wgmma"},
        launches_per_decode_step={k: v / steps
                                  for k, v in decode_launches.items() if v},
        flash_heads=sorted({h[0] for h in heads}),
        flash_kv_heads=sorted({h[1] for h in heads}),
        flash_head_dims=sorted(dims),
        flash_shapes={f"{sq}x{skv}": sum(1 for h in heads
                                         if h[2:] == (sq, skv))
                      for sq, skv in sorted({h[2:] for h in heads})},
        scan_shapes_prefill=sorted({tuple(x) for x in prefill_scans}),
        scan_shapes_decode=sorted({tuple(x) for x in decode_scans}),
        mlstm_shapes_prefill=sorted({tuple(x) for x in prefill_mlstms}),
        mlstm_shapes_decode=sorted({tuple(x) for x in decode_mlstms}),
        collectives_prefill=prefill_coll,
        collectives_per_decode_step={
            k: v / steps for k, v in decode_coll.items()},
        logits_rel_rms=max(rms),
        broken_rel_rms=rel_rms(broken.cpu(), ref["logits"][-1]),
        logits_max_abs=max(float((g.float().cpu() - w.float()).abs().max())
                           for g, w in zip(out, ref["logits"])),
        logits_finite=all(bool(torch.isfinite(g).all()) for g in out))
    res.update({f"{key}_{k}": v for k, v in out_res.items()})


def fault_step(model, cache, tokens):
    """One decode step from a copy of ``cache`` with every all-reduce of
    the collectives module left to the rank's own part: a broken sharded
    run, to set [shard-serve]'s bar against."""
    from repro_torch.distributed import collectives as col

    copy = serialize.map_with_path(
        lambda _k, t: t.clone() if isinstance(t, torch.Tensor) else t, cache)
    honest = col.all_reduce
    col.all_reduce = lambda x, grp, op="sum": x.detach().clone()
    try:
        _, logits = model.decode_step(copy, tokens)
    finally:
        col.all_reduce = honest
    return logits


def shard_rank(rank, store, work):
    """One of the SHARD_RANKS processes that share the card: a gloo group
    through a FileStore, a (1, 2) mesh; writes its results to
    ``work/rank{rank}.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARD_RANKS),
                            rank=rank, world_size=SHARD_RANKS)
    res = {"rank": rank, "gloo_on_cuda": collective_probe(rank,
                                                          SHARD_RANKS)}
    mesh = init_device_mesh("cuda", (1, SHARD_RANKS),
                            mesh_dim_names=("data", "model"))
    phases = {}
    for name, fn in (("ep", lambda: _ranks_ep(mesh, work, res)),
                     ("kv_decode", lambda: _ranks_kv_decode(mesh, res)),
                     ("reshard", lambda: _ranks_reshard(mesh, res)),
                     ("train", lambda: _ranks_train(mesh, res)),
                     ("serve", lambda: _ranks_serve(
                         mesh, work, res,
                         get_config(SHARD_ARCH).replace(decode_kv_shard=True),
                         "shard_ref.pt", wait_s=SHARD_TIMEOUT_S))):
        t0 = time.perf_counter()
        fn()
        collect_garbage()
        torch.cuda.empty_cache()
        phases[name] = round(time.perf_counter() - t0, 2)
    res["seconds"] = phases
    (work / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn, n, work, store):
    """``n`` spawned processes running ``fn(rank, store path, work)``."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(str(work / store), work), nprocs=n,
                              join=False, start_method="spawn")


def phase_shard_ranks(work):
    """[ep-ranks], [shard-serve], [shard-serve-hd], [shard-serve-vlm],
    [shard-serve-mla], [shard-serve-hybrid], [shard-serve-mla10],
    [shard-serve-xlstm] and [shard-serve-audio]: SHARD_RANKS processes
    (`shard_rank`, a (1, 2) mesh), SHARD_HD_RANKS more (`shard_hd_rank`)
    and SHARD_NEW_RANKS more (`shard_new_rank`) share the card over gloo
    at once, every set bound by gloo's copies through host memory on the
    host's cores; the host meanwhile runs the one-process runs that the
    later serves wait for and costs the train cells with `launch.dryrun`.
    Each check must hold on every rank."""
    t0 = time.perf_counter()
    # every rank set starts at once; the host then makes the one-process
    # runs in the order the ranks' serves wait for them
    ctxs = []
    try:
        for fn, n, store in ((shard_rank, SHARD_RANKS, "gloo_store"),
                             (shard_hd_rank, SHARD_HD_RANKS, "gloo_store_hd"),
                             (shard_new_rank, SHARD_NEW_RANKS,
                              "gloo_store_new")):
            ctxs.append(spawn_ranks(fn, n, work, store))
        hd_cfg = shard_hd_config(SHARD_HD_LAYERS)
        hd_weights = shard_reference(work, hd_cfg, "shard_hd_ref.pt")
        new_weights = {"mla": shard_reference(
            work, dict(SHARD_NEW_SERVES)["mla"], "shard_mla_ref.pt")}
        one_weights = shard_reference(work, get_config(SHARD_ARCH),
                                      "shard_ref.pt")
        cfgs = dict(SHARD_NEW_SERVES)
        for key in ("hyb", "mla10"):
            new_weights[key] = shard_reference(work, cfgs[key],
                                               f"shard_{key}_ref.pt")
        vlm_cfg = cut_config(VLM_ARCH, SHARD_VLM_LAYERS)
        vlm_weights = shard_reference(work, vlm_cfg, "shard_vlm_ref.pt")
        # after the VLM's: [shard-serve-vlm]'s ranks finish last
        new_weights["xlstm"] = shard_reference(work, cfgs["xlstm"],
                                               "shard_xlstm_ref.pt")
        new_weights["audio"] = shard_reference(
            work, cfgs["audio"], "shard_audio_ref.pt", prompt=AUDIO_PROMPT)
        ts = time.perf_counter()
        est = shard_hd_estimate()
        est_s = time.perf_counter() - ts
        est_glm4 = shard_hd_estimate(SHARD_HD_ARCH, SHARD_HD_LAYERS)
        for ctx in ctxs:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SHARD_TIMEOUT_S:
                    raise AssertionError(f"the rank processes ran past "
                                         f"{SHARD_TIMEOUT_S} s")
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    check_shard_ranks(work, one_weights)
    check_shard_hd(work, hd_cfg, hd_weights, est, est_s, est_glm4)
    check_shard_vlm(work, vlm_cfg, vlm_weights)
    launches = check_shard_new(work, new_weights)
    log("shard-ranks",
        processes=SHARD_RANKS + SHARD_HD_RANKS + SHARD_NEW_RANKS,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


def check_shard_ranks(work, one_weights):
    """[ep-ranks] and [shard-serve]'s checks, on every rank's results."""
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    n_layers = get_config(SHARD_ARCH).n_layers
    for r in ranks:
        checks = {
            "ep": (sorted(r["ep_err"]) == sorted(
                       str(f) for f in (EP_FACTOR, EP_DROP_FACTOR))
                   and all(r["ep_err"][f] <= r["ep_bar"][f]
                           for f in r["ep_err"])
                   and r["ep_launches"] == 3),
            "kv_decode": all(r[f"kv_decode_err_{t}"] <= r[f"kv_decode_bar_{t}"]
                             and r[f"kv_decode_writes_ok_{t}"]
                             for t in ("fp32", "bf16")),
            "reshard": r["reshard_bit_equal"]
            and r["reshard_local_share"] == 0.5,
            "train": r["train_ok"],
            "serve": (r["serve_layout"] == "seq"
                      and r["serve_flash_launches_prefill"] == n_layers
                      and not r["serve_other_launches"]
                      # both head counts divide: each rank its heads
                      and r["serve_heads_aligned"]
                      and r["serve_flash_heads"] == [
                          get_config(SHARD_ARCH).n_heads // SHARD_RANKS]
                      and r["serve_flash_kv_heads"] == [
                          get_config(SHARD_ARCH).n_kv_heads // SHARD_RANKS]
                      and r["serve_collectives_per_decode_step"].get(
                          "decode_combine") == 3 * n_layers
                      and r["serve_logits_finite"]
                      and r["serve_logits_rel_rms"] <= SHARD_LOGITS_REL_RMS
                      and r["serve_broken_rel_rms"]
                      > 2 * SHARD_LOGITS_REL_RMS),
        }
        log("ep-ranks", rank=r["rank"], mesh=f"(1, {SHARD_RANKS})",
            experts_local=r["ep_experts_local"],
            **{f"err_vs_ep_compare_at_{f}": f"{v:.3e}"
               for f, v in r["ep_err"].items()},
            **{f"bar_at_{f}": f"{v:.3e}" for f, v in r["ep_bar"].items()},
            launches=r["ep_launches"],
            kv_decode_shape=KV_DECODE_SHAPE,
            kv_decode_err_fp32=f"{r['kv_decode_err_fp32']:.3e}",
            kv_decode_err_bf16=f"{r['kv_decode_err_bf16']:.3e}",
            kv_decode_collectives=r["kv_decode_collectives"],
            reshard_bit_equal=r["reshard_bit_equal"],
            reshard_local_share=r["reshard_local_share"],
            train_loss=r["train_loss"], train_loss_one=r["train_loss_one"],
            train_gnorm=r["train_gnorm"],
            train_gnorm_one=r["train_gnorm_one"],
            train_param_err_tight=f"{r['train_param_err_tight']:.3e}",
            train_param_err=f"{r['train_param_err']:.3e}",
            gloo_on_cuda=r["gloo_on_cuda"], seconds=r["seconds"])
        log("shard-serve", rank=r["rank"], config=SHARD_ARCH,
            layers=n_layers, decode_kv_shard=True, layout=r["serve_layout"],
            cache_k_local=r["serve_cache_k_local"], batch=SERVE_BATCH,
            prompt=SERVE_PROMPT, decode_steps=SHARD_DECODE_STEPS,
            weight_bytes_local=r["serve_weight_bytes_local"],
            weight_bytes_one=one_weights,
            init_peak=r["serve_init_peak"], serve_peak=r["serve_peak"],
            prefill_ms=f"{r['serve_prefill_ms']:.1f}",
            decode_ms_per_step=f"{r['serve_decode_ms_per_step']:.1f}",
            flash_launches_prefill=r["serve_flash_launches_prefill"],
            flash_heads=r["serve_flash_heads"],
            flash_kv_heads=r["serve_flash_kv_heads"],
            collectives_prefill=r["serve_collectives_prefill"],
            collectives_per_decode_step=r[
                "serve_collectives_per_decode_step"],
            logits_rel_rms=f"{r['serve_logits_rel_rms']:.3e}",
            logits_bar=SHARD_LOGITS_REL_RMS,
            broken_rel_rms=f"{r['serve_broken_rel_rms']:.3e}",
            logits_max_abs=f"{r['serve_logits_max_abs']:.3e}",
            backend="gloo")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"rank {r['rank']} failed {bad}")


# ---------------------------------------------------------------------------
# [shard-serve-hd]: KV heads that do not divide the model axis, then the
# sharded train step's per-layer FSDP gather, on four gloo ranks
# ---------------------------------------------------------------------------

#: glm4-9b at its published widths (32 query heads, 2 KV heads, head_dim
#: 128, d_ff 13,696, vocab 151,552), its 40 layers cut to SHARD_HD_LAYERS
#: so that the one-process run and four ranks fit the phase's budget; on
#: a (1, 4) mesh its query heads divide the model axis and its KV heads do
#: not, so attention splits K and V on head_dim: 8 query heads a rank
#: against one KV head, the cache a quarter of head_dim
SHARD_HD_ARCH = "glm4-9b"
SHARD_HD_RANKS = 4
SHARD_HD_LAYERS = 4
#: then SHARD_HD_TRAIN_STEPS sharded train steps of SHARD_HD_TRAIN_ARCH at
#: its published widths cut to SHARD_HD_TRAIN_LAYERS on a (2, 2) mesh,
#: SERVE_BATCH x SERVE_PROMPT tokens in SHARD_HD_ACCUM microbatches, the
#: model's 1,024-token chunks; each rank's peak within PEAK_TOL of
#: `launch.dryrun`'s estimate of the cell.  Not glm4-9b: the dry run puts
#: its train cell at 24.23 GB a rank (the loss gathers its 151,552 x 4,096
#: unembedding whole), and four such ranks do not fit one 80 GB card
SHARD_HD_TRAIN_ARCH = "internlm2-1.8b"
#: one step: its checks (finite loss and norm, the peak, the gathered
#: bytes) need no second, and these ranks, the slowest set of
#: [shard-ranks], share the host's cores with [shard-serve-xlstm]'s
SHARD_HD_TRAIN_LAYERS, SHARD_HD_TRAIN_STEPS, SHARD_HD_ACCUM = 2, 1, 2
#: [shard-train-hd]'s all-gather bytes a step before the loss took the
#: rank's vocab columns (run HD2, PR 27: the unembedding gathered whole
#: once a microbatch)
SHARD_HD_TRAIN_GATHER_BYTES_BEFORE = 2_935_570_432
#: [shard-serve-vlm], on the same four ranks after [shard-train-hd]:
#: llama-3.2-vision-11b at its published widths (32 query heads, 8 KV
#: heads, head_dim 128, d_ff 14,336, vocab 128,256, 6,404 patches of
#: 1,280) cut 40 -> 5 layers, one group of 4 self layers and a gated
#: cross block; on a (1, 4) mesh both head counts divide the model axis,
#: so each rank runs 8 query heads against 2 KV heads in every layer and
#: holds 2 KV heads of each cache
SHARD_VLM_LAYERS = _VLM.vision.cross_attn_every
#: [shard-serve-mla] and [shard-serve-hybrid], on SHARD_NEW_RANKS more gloo
#: ranks beside [shard-serve-hd]'s: minicpm3-4b at its published widths
#: (40 heads, Dk 96 / Dv 64, the latent cache 256 + 32 wide, d_ff 6,400,
#: vocab 73,448) and hymba-1.5b at its (25 query and 5 KV heads, d_inner
#: 3,200, d_ff 5,504, vocab 32,001, 128 meta tokens, window 1,024), each
#: cut to SHARD_NEW_LAYERS, on a (1, 4) mesh: MLA in the heads form (10
#: heads a rank), its cache a quarter of each latent width a rank; hymba's
#: attention in the columns form (25 and 5 heads divide no 4-way axis:
#: each rank multiplies by its 400 columns of w_q, 80 of w_k and w_v,
#: attends on the 7 query heads its 400 rows of w_o touch, and holds a
#: quarter of head_dim of the 5 KV heads), its SSM on 800 channels a rank;
#: then [shard-serve-mla10], minicpm3-4b at 10 heads in the columns form
#: (MLA_COLUMNS_HEADS).  Two layers each: the four processes share the
#: host's cores and gloo's copies with the six others
SHARD_NEW_RANKS = 4
SHARD_NEW_LAYERS = 2
#: [shard-serve-xlstm] and [shard-serve-audio], on the same four ranks
#: after hymba's: xlstm-350m at its published widths (4 heads, d_inner
#: 2,048, d_ff 1,364, vocab 50,304) cut 24 -> SHARD_XLSTM_LAYERS (one
#: pair): each rank's mLSTM on its 1 head (the scan on [4, 2,048, 512]),
#: its sLSTM's state on its head's 256 units; whisper-base (8 heads, d_ff
#: 2,048, vocab 51,865) cut 6 + 6 -> SHARD_NEW_LAYERS + SHARD_NEW_LAYERS
#: layers, on a 416-token prompt and 1,500 frames: 2 query and 2 KV heads
#: a rank in every attention, its MLP on 512 of 2,048 rows.  At full
#: depth the script took 925.4 s of command on an H100 machine (run XA2
#: in PERF.md): its four ranks' serves slow the [shard-serve-hd] ranks,
#: which share the host's cores
SHARD_XLSTM_LAYERS = _XLSTM.xlstm.slstm_every


def shard_hd_config(layers, arch=SHARD_HD_ARCH):
    return get_config(arch).replace(n_layers=layers)


def shard_hd_train_cell():
    """The train cell of [shard-serve-hd] as `launch.dryrun.build_cell`
    takes it: (shape, tuning)."""
    shape = ShapeSpec("shard_hd_train", seq_len=SERVE_PROMPT,
                      global_batch=SERVE_BATCH, kind="train")
    return shape, {"cfg": {"n_layers": SHARD_HD_TRAIN_LAYERS},
                   "q_chunk": 1024, "kv_chunk": 1024,
                   "grad_accum": SHARD_HD_ACCUM}


def shard_hd_estimate(arch=SHARD_HD_TRAIN_ARCH,
                      layers=SHARD_HD_TRAIN_LAYERS):
    """`launch.dryrun`'s memory record of one rank of the train cell (of
    ``arch`` at ``layers``): the production pass on meta tensors over a
    fake world of the (2, 2) mesh (the host only; its process group
    destroyed after)."""
    import torch.distributed as dist

    mesh = dryrun.fake_mesh((2, SHARD_HD_RANKS // 2), ("data", "model"))
    try:
        shape, tune = shard_hd_train_cell()
        tune = dict(tune, cfg={"n_layers": layers})
        return roofline.memory_stats(dryrun.count_cell(
            dryrun.build_cell(arch, shape, mesh, tune),
            memory_only=True))
    finally:
        dist.destroy_process_group()


def _ranks_hd_train(mesh, res):
    """SHARD_HD_TRAIN_STEPS sharded train steps of the train cell on
    ``mesh``: losses, grad norms and ms a step; the rank's peak, as
    `launch.dryrun` counts it (its arguments, counted alike, plus what the
    steps allocated above what was allocated before them); the per-layer
    gather's peak of live gathered bytes against one layer's."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps
    from repro_torch.train.state import prng_key

    shape, tune = shard_hd_train_cell()
    cfg = shard_hd_config(SHARD_HD_TRAIN_LAYERS, SHARD_HD_TRAIN_ARCH)
    model = Model(cfg, device="meta",
                  q_chunk=tune["q_chunk"], kv_chunk=tune["kv_chunk"])
    shd.shard_model(model, mesh, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(
                        SEED + 40))
    params = model.params()
    state = steps.TrainState(params=params, opt=steps.shard_opt(params),
                             rng=prng_key(SEED, DEV),
                             data_cursor=torch.zeros((), dtype=torch.int32))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 41)
    batch = {k: torch.randint(0, model.cfg.vocab, (shape.global_batch,
                                                   shape.seq_len),
                              generator=gen, device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig(grad_accum=tune["grad_accum"],
                                              warmup_steps=0))
    # the arguments as `launch.dryrun.count_cell` counts them: the state's
    # local shards and the rank's box of the batch
    args = (sum(dryrun._nbytes(t) for t in counting.tensors(state))
            + dryrun._batch_bytes(batch, mesh))
    layer = sum(p.to_local()[0].numel() * col.dp_size(mesh) * p.element_size()
                for k, p in model.named_parameters()
                if k.startswith("blocks.") and col.layer_dp_dim(p) > 0)
    collect_garbage()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    col.reset_counts()
    losses, norms, ms = [], [], []
    with col.use_mesh(mesh):
        for _ in range(SHARD_HD_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    res.update(
        train_mesh=list(mesh.mesh.shape), train_losses=losses,
        train_grad_norms=norms, train_ms=ms,
        train_peak_bytes=args + torch.cuda.max_memory_allocated() - before,
        train_argument_bytes=args,
        train_layer_gathered_bytes=layer,
        train_gathered_peak_bytes=int(col.LAYER_GATHER["peak"]),
        train_unembed_gathers=col.COLLECTIVES["unembed_gather"],
        train_collectives_per_step={
            k: v / SHARD_HD_TRAIN_STEPS for k, v in col.COLLECTIVES.items()},
        train_collective_bytes_per_step={
            k: v / SHARD_HD_TRAIN_STEPS
            for k, v in col.COLLECTIVE_BYTES.items()})


def shard_hd_rank(rank, store, work):
    """One of the SHARD_HD_RANKS processes of [shard-serve-hd]: a gloo group
    through a FileStore; serves on a (1, 4) mesh, trains on (2, 2), then
    serves the VLM on (1, 4) ([shard-serve-vlm]); writes its results to
    ``work/hd_rank{rank}.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo",
                            store=dist.FileStore(store, SHARD_HD_RANKS),
                            rank=rank, world_size=SHARD_HD_RANKS)
    res, phases = {"rank": rank}, {}
    for name, shape, fn in (
            ("serve", (1, SHARD_HD_RANKS), lambda mesh: _ranks_serve(
                mesh, work, res, shard_hd_config(SHARD_HD_LAYERS),
                "shard_hd_ref.pt", wait_s=SHARD_TIMEOUT_S)),
            ("train", (2, SHARD_HD_RANKS // 2),
             lambda mesh: _ranks_hd_train(mesh, res)),
            ("serve_vlm", (1, SHARD_HD_RANKS), lambda mesh: _ranks_serve(
                mesh, work, res, cut_config(VLM_ARCH, SHARD_VLM_LAYERS),
                "shard_vlm_ref.pt", key="vlm", wait_s=SHARD_TIMEOUT_S))):
        t0 = time.perf_counter()
        fn(init_device_mesh("cuda", shape, mesh_dim_names=("data", "model")))
        collect_garbage()
        torch.cuda.empty_cache()
        phases[name] = round(time.perf_counter() - t0, 2)
    res["seconds"] = phases
    (work / f"hd_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


#: the serves of `shard_new_rank`, in order: (key, config)
SHARD_NEW_SERVES = (("mla", cut_config(MLA_ARCH, SHARD_NEW_LAYERS)),
                    ("hyb", cut_config(HYBRID_ARCH, SHARD_NEW_LAYERS)),
                    ("mla10", cut_config(MLA_ARCH, SHARD_NEW_LAYERS,
                                         n_heads=MLA_COLUMNS_HEADS,
                                         n_kv_heads=MLA_COLUMNS_HEADS)),
                    ("xlstm", cut_config(XLSTM_ARCH, SHARD_XLSTM_LAYERS)),
                    ("audio", cut_config(AUDIO_ARCH, SHARD_NEW_LAYERS)))


def shard_new_rank(rank, store, work):
    """One of the SHARD_NEW_RANKS processes of [shard-serve-mla],
    [shard-serve-hybrid], [shard-serve-mla10], [shard-serve-xlstm] and
    [shard-serve-audio]: a
    gloo group through a FileStore, a (1, 4) mesh; each serve waits for
    its one-process run's file; writes its results to
    ``work/new_rank{rank}.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo",
                            store=dist.FileStore(store, SHARD_NEW_RANKS),
                            rank=rank, world_size=SHARD_NEW_RANKS)
    mesh = init_device_mesh("cuda", (1, SHARD_NEW_RANKS),
                            mesh_dim_names=("data", "model"))
    res, phases = {"rank": rank}, {}
    for key, cfg in SHARD_NEW_SERVES:
        t0 = time.perf_counter()
        _ranks_serve(mesh, work, res, cfg, f"shard_{key}_ref.pt", key=key,
                     wait_s=SHARD_TIMEOUT_S)
        collect_garbage()
        torch.cuda.empty_cache()
        phases[key] = round(time.perf_counter() - t0, 2)
    res["seconds"] = phases
    (work / f"new_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def check_shard_new(work, weights):
    """[shard-serve-mla]'s, [shard-serve-hybrid]'s, [shard-serve-mla10]'s,
    [shard-serve-xlstm]'s and [shard-serve-audio]'s checks, on every
    rank's results, against their one-process runs (``weights``: the
    one-process weight bytes by key), no attention leaf gathered whole
    among them; returns the ranks' launches of MLA's, hymba's, the
    10-head MLA's and whisper's flash and of hymba's and the xLSTM's
    scans."""
    ranks = [json.loads((work / f"new_rank{r}.json").read_text())
             for r in range(SHARD_NEW_RANKS)]
    n, n_layers = SHARD_NEW_RANKS, SHARD_NEW_LAYERS
    slots = SERVE_PROMPT + SHARD_DECODE_STEPS
    cfgs = dict(SHARD_NEW_SERVES)
    mla_cfg, hyb, xl, au, mla10 = (cfgs[k] for k in (
        "mla", "hyb", "xlstm", "audio", "mla10"))
    mla = mla_cfg.mla
    di = hyb.ssm.expand * hyb.d_model
    ring = Model(hyb, device="meta").cache_slots(slots + hyb.n_meta_tokens)
    xdi = int(xl.xlstm.proj_factor_mlstm * xl.d_model)
    pairs = xl.n_layers // xl.xlstm.slstm_every
    xw = xl.xlstm.conv_width - 1
    frames, au_slots = au.audio.n_audio_ctx, AUDIO_PROMPT + SHARD_DECODE_STEPS
    au_hd = au.resolved_head_dim
    no_scan = dict(scans=([], []), mlstms=([], []))
    want = {
        "mla": dict(
            layout="latent", flash=n_layers, heads=[mla_cfg.n_heads // n],
            kv_heads=[mla_cfg.n_heads // n],
            head_dims=[[mla.qk_nope_head_dim + mla.qk_rope_head_dim,
                        mla.v_head_dim]],
            other={}, per_decode={}, **no_scan,
            cache={"ckv": [n_layers, SERVE_BATCH, slots,
                           mla.kv_lora_rank // n],
                   "kr": [n_layers, SERVE_BATCH, slots,
                          mla.qk_rope_head_dim // n]},
            score_sums=n_layers),
        # the columns form: 7 touched query heads a rank (25 on 4), K and
        # V expanded to one KV head each; the cache a quarter of head_dim
        # of every KV head, one score SUM a layer per decode step
        "hyb": dict(
            layout="head_dim", flash=n_layers,
            heads=[touched(hyb.n_heads, n)], kv_heads=[touched(hyb.n_heads,
                                                               n)],
            head_dims=[[hyb.head_dim, hyb.head_dim]],
            other={"ssm_scan": n_layers},
            per_decode={"ssm_scan": float(n_layers)},
            scans=([[SERVE_BATCH, SERVE_PROMPT + hyb.n_meta_tokens,
                     di // n]], [[SERVE_BATCH, 1, di // n]]),
            mlstms=([], []),
            cache={"k": [n_layers, SERVE_BATCH, ring, hyb.n_kv_heads,
                         hyb.head_dim // n],
                   "ssm_h": [n_layers, SERVE_BATCH, di // n,
                             hyb.ssm.d_state],
                   "ssm_conv": [n_layers, SERVE_BATCH, hyb.ssm.d_conv - 1,
                                di // n]},
            score_sums=n_layers),
        # minicpm3-4b's widths at 10 heads: 2.5 a rank, as the 40 heads on
        # 16 ranks; 3 touched heads a rank, the latent cache as "mla"'s
        "mla10": dict(
            layout="latent", flash=n_layers,
            heads=[touched(mla10.n_heads, n)],
            kv_heads=[touched(mla10.n_heads, n)],
            head_dims=[[mla.qk_nope_head_dim + mla.qk_rope_head_dim,
                        mla.v_head_dim]],
            other={}, per_decode={}, **no_scan,
            cache={"ckv": [n_layers, SERVE_BATCH, slots,
                           mla.kv_lora_rank // n],
                   "kr": [n_layers, SERVE_BATCH, slots,
                          mla.qk_rope_head_dim // n]},
            score_sums=n_layers),
        # the rank's 1 head of 4: the scan on [B * 1, S, 512]; its state
        # and conv window on its head's channels and units
        "xlstm": dict(
            layout="heads", flash=0, heads=[], kv_heads=[], head_dims=[],
            other={"mlstm_scan": pairs},
            per_decode={"mlstm_scan": float(pairs)}, scans=([], []),
            mlstms=([list(MLSTM_TP4[:3])],
                    [[MLSTM_TP4[0], 1, MLSTM_TP4[2]]]),
            cache={"m.c": [pairs, SERVE_BATCH, xl.n_heads // n,
                           MLSTM_TP4[2], MLSTM_TP4[2]],
                   "m.n": [pairs, SERVE_BATCH, xl.n_heads // n,
                           MLSTM_TP4[2]],
                   "m.m": [pairs, SERVE_BATCH, xl.n_heads // n],
                   "m.conv": [pairs, SERVE_BATCH, xw, xdi // n],
                   "s.h": [pairs, SERVE_BATCH, xl.d_model // n],
                   "s.conv": [pairs, SERVE_BATCH, xw, xl.d_model // n]},
            score_sums=None),
        # 2 query and 2 KV heads a rank in each encoder, self and cross
        # attention of a prefill
        "audio": dict(
            layout="heads", flash=3 * au.n_layers,
            heads=[au.n_heads // n], kv_heads=[au.n_kv_heads // n],
            head_dims=[[au_hd, au_hd]], other={}, per_decode={}, **no_scan,
            shapes={f"{frames}x{frames}": au.n_layers,
                    f"{AUDIO_PROMPT}x{AUDIO_PROMPT}": au.n_layers,
                    f"{AUDIO_PROMPT}x{frames}": au.n_layers},
            cache={"k": [au.n_layers, SERVE_BATCH, au_slots,
                         au.n_kv_heads // n, au_hd],
                   "xk": [au.n_layers, SERVE_BATCH, frames,
                          au.n_kv_heads // n, au_hd]},
            score_sums=None)}
    phases = (("mla", "shard-serve-mla"), ("hyb", "shard-serve-hybrid"),
              ("mla10", "shard-serve-mla10"),
              ("xlstm", "shard-serve-xlstm"), ("audio", "shard-serve-audio"))
    for r in ranks:
        bad = []
        for key, phase in phases:
            w, g = want[key], (lambda k, key=key: r[f"{key}_{k}"])
            cfg = cfgs[key]
            checks = {
                "layout": g("layout") == w["layout"],
                # the prefill's attention through the tensor-core kernel
                # on the rank's heads (MLA, whisper) or every head
                # (hymba), the scans on the rank's channels or heads, one
                # launch a layer
                "launches": (g("flash_launches_prefill") == w["flash"]
                             and g("other_launches") == w["other"]
                             and g("launches_per_decode_step")
                             == w["per_decode"]),
                "shapes": (g("flash_heads") == w["heads"]
                           and g("flash_kv_heads") == w["kv_heads"]
                           and g("flash_head_dims") == w["head_dims"]
                           and ("shapes" not in w
                                or g("flash_shapes") == w["shapes"])
                           and [g("scan_shapes_prefill"),
                                g("scan_shapes_decode")] == list(w["scans"])
                           and [g("mlstm_shapes_prefill"),
                                g("mlstm_shapes_decode")]
                           == list(w["mlstms"])),
                "caches": all(g("cache_local")[k] == v
                              for k, v in w["cache"].items()),
                "score_sums": (w["score_sums"] is None
                               or g("collectives_per_decode_step").get(
                                   "score_sum") == w["score_sums"]),
                "syncs": g("prefill_syncs") == 0 and g("decode_syncs") == 0,
                # no attention leaf gathered whole, prefill or decode
                "attn_gathers": (
                    g("collectives_prefill").get("attn_gather", 0) == 0
                    and g("collectives_per_decode_step").get(
                        "attn_gather", 0) == 0),
                # a quarter of every leaf that the rules split over the
                # model axis, each other leaf whole
                "weights": (g("weight_bytes_local")
                            - g("weight_bytes_model_replicated")
                            <= (weights[key]
                                - g("weight_bytes_model_replicated")) / n
                            + 2 ** 20),
                "logits": (g("logits_finite")
                           and g("logits_rel_rms") <= SHARD_LOGITS_REL_RMS
                           and g("broken_rel_rms")
                           > 2 * SHARD_LOGITS_REL_RMS),
            }
            log(phase, rank=r["rank"], config=cfg.name, layers=cfg.n_layers,
                n_heads=cfg.n_heads,
                cut_from=get_config(cfg.name).n_layers, mesh=f"(1, {n})",
                layout=g("layout"), cache_local=g("cache_local"),
                batch=SERVE_BATCH,
                prompt=AUDIO_PROMPT if key == "audio" else SERVE_PROMPT,
                decode_steps=SHARD_DECODE_STEPS,
                weight_bytes_local=g("weight_bytes_local"),
                weight_bytes_model_replicated=g(
                    "weight_bytes_model_replicated"),
                weight_bytes_one=weights[key],
                init_peak=g("init_peak"), serve_peak=g("peak"),
                prefill_ms=f"{g('prefill_ms'):.1f}",
                decode_ms_per_step=f"{g('decode_ms_per_step'):.1f}",
                prefill_syncs=g("prefill_syncs"),
                decode_syncs=g("decode_syncs"),
                sync_sites={**g("prefill_sync_sites"),
                            **g("decode_sync_sites")} or "none",
                flash_launches_prefill=g("flash_launches_prefill"),
                other_launches_prefill=g("other_launches") or "none",
                launches_per_decode_step=(g("launches_per_decode_step")
                                          or "none"),
                flash_shapes=g("flash_shapes") or "none",
                flash_heads=g("flash_heads"),
                flash_kv_heads=g("flash_kv_heads"),
                flash_head_dims=g("flash_head_dims"),
                scan_shapes_prefill=g("scan_shapes_prefill") or "none",
                scan_shapes_decode=g("scan_shapes_decode") or "none",
                mlstm_shapes_prefill=g("mlstm_shapes_prefill") or "none",
                mlstm_shapes_decode=g("mlstm_shapes_decode") or "none",
                collectives_prefill=g("collectives_prefill"),
                collectives_per_decode_step=g(
                    "collectives_per_decode_step"),
                logits_rel_rms=f"{g('logits_rel_rms'):.3e}",
                logits_bar=SHARD_LOGITS_REL_RMS,
                broken_rel_rms=f"{g('broken_rel_rms'):.3e}",
                logits_max_abs=f"{g('logits_max_abs'):.3e}",
                seconds=r["seconds"][key], backend="gloo")
            bad += [f"{phase}:{k}" for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"rank {r['rank']} failed {bad}")

    def scans(key, kernel):         # a prefill's and the timed steps'
        return sum(r[f"{key}_other_launches"][kernel]
                   + round(r[f"{key}_launches_per_decode_step"][kernel]
                           * (SHARD_DECODE_STEPS - 1)) for r in ranks)

    # every rank's launches on the main path: MLA's and whisper's flash on
    # their heads, hymba's and the 10-head MLA's on their touched heads,
    # hymba's scan on its channels, the xLSTM's on its heads
    return {"flash_mla": sum(r["mla_flash_launches_prefill"] for r in ranks),
            "flash_hyb": sum(r["hyb_flash_launches_prefill"] for r in ranks),
            "flash_mla10": sum(r["mla10_flash_launches_prefill"]
                               for r in ranks),
            "flash_audio": sum(r["audio_flash_launches_prefill"]
                               for r in ranks),
            "ssm_hyb": scans("hyb", "ssm_scan"),
            "mlstm_xlstm": scans("xlstm", "mlstm_scan")}


def check_shard_hd(work, cfg, one_weights, est, est_s, est_glm4):
    """[shard-serve-hd]'s checks, on every rank's results: the serve on
    ``cfg`` against its one-process run (``one_weights`` bytes), each
    train rank's peak against ``est`` (`shard_hd_estimate`'s record,
    costed in ``est_s`` seconds; ``est_glm4`` glm4-9b's cell at 4 layers,
    printed beside it)."""
    ranks = [json.loads((work / f"hd_rank{r}.json").read_text())
             for r in range(SHARD_HD_RANKS)]
    n, hd = cfg.n_layers, cfg.resolved_head_dim
    estimate = est["argument_bytes"] + est["temp_bytes"]
    for r in ranks:
        peak_ratio = r["train_peak_bytes"] / estimate
        checks = {
            "serve": (r["serve_layout"] == "head_dim"
                      and not r["serve_heads_aligned"]
                      and r["serve_head_dim_split"]
                      and r["serve_flash_launches_prefill"] == n
                      and not r["serve_other_launches"]
                      and r["serve_flash_heads"] == [
                          cfg.n_heads // SHARD_HD_RANKS]
                      and r["serve_flash_kv_heads"] == [1]
                      and r["serve_cache_k_local"] == [
                          n, SERVE_BATCH, SERVE_PROMPT + SHARD_DECODE_STEPS,
                          cfg.n_kv_heads, hd // SHARD_HD_RANKS]
                      and r["serve_collectives_per_decode_step"].get(
                          "score_sum") == n
                      and r["serve_weight_bytes_local"]
                      <= one_weights / SHARD_HD_RANKS + 2 ** 20
                      and r["serve_logits_finite"]
                      and r["serve_logits_rel_rms"] <= SHARD_LOGITS_REL_RMS
                      and r["serve_broken_rel_rms"]
                      > 2 * SHARD_LOGITS_REL_RMS),
            "train": (all(np.isfinite(r["train_losses"]))
                      and all(np.isfinite(r["train_grad_norms"]))
                      and abs(peak_ratio - 1) <= PEAK_TOL
                      and 0 < r["train_gathered_peak_bytes"]
                      <= r["train_layer_gathered_bytes"]
                      # the loss on the rank's vocab columns
                      and r["train_unembed_gathers"] == 0),
        }
        log("shard-serve-hd", rank=r["rank"], config=SHARD_HD_ARCH,
            layers=n, cut_from=get_config(SHARD_HD_ARCH).n_layers,
            mesh=f"(1, {SHARD_HD_RANKS})", layout=r["serve_layout"],
            heads_aligned=r["serve_heads_aligned"],
            cache_k_local=r["serve_cache_k_local"], batch=SERVE_BATCH,
            prompt=SERVE_PROMPT, decode_steps=SHARD_DECODE_STEPS,
            weight_bytes_local=r["serve_weight_bytes_local"],
            weight_bytes_one=one_weights,
            init_peak=r["serve_init_peak"], serve_peak=r["serve_peak"],
            prefill_ms=f"{r['serve_prefill_ms']:.1f}",
            decode_ms_per_step=f"{r['serve_decode_ms_per_step']:.1f}",
            flash_launches_prefill=r["serve_flash_launches_prefill"],
            flash_heads=r["serve_flash_heads"],
            flash_kv_heads=r["serve_flash_kv_heads"],
            collectives_prefill=r["serve_collectives_prefill"],
            collectives_per_decode_step=r[
                "serve_collectives_per_decode_step"],
            logits_rel_rms=f"{r['serve_logits_rel_rms']:.3e}",
            logits_bar=SHARD_LOGITS_REL_RMS,
            broken_rel_rms=f"{r['serve_broken_rel_rms']:.3e}",
            logits_max_abs=f"{r['serve_logits_max_abs']:.3e}",
            backend="gloo")
        log("shard-train-hd", rank=r["rank"], config=SHARD_HD_TRAIN_ARCH,
            layers=SHARD_HD_TRAIN_LAYERS,
            cut_from=get_config(SHARD_HD_TRAIN_ARCH).n_layers,
            mesh=r["train_mesh"],
            batch=SERVE_BATCH, seq=SERVE_PROMPT, grad_accum=SHARD_HD_ACCUM,
            losses=r["train_losses"], grad_norms=r["train_grad_norms"],
            step_ms=[f"{v:.1f}" for v in r["train_ms"]],
            peak_bytes=r["train_peak_bytes"],
            argument_bytes=r["train_argument_bytes"],
            dryrun_estimate_bytes=estimate,
            dryrun_argument_bytes=est["argument_bytes"],
            peak_over_estimate=f"{peak_ratio:.4f}", peak_tol=PEAK_TOL,
            layer_gathered_bytes=r["train_layer_gathered_bytes"],
            gathered_peak_bytes=r["train_gathered_peak_bytes"],
            unembed_gathers=r["train_unembed_gathers"],
            collectives_per_step=r["train_collectives_per_step"],
            collective_bytes_per_step=r["train_collective_bytes_per_step"],
            all_gather_bytes_per_step_before=(
                SHARD_HD_TRAIN_GATHER_BYTES_BEFORE),
            glm4_train_cell_4_layers_estimate_bytes=(
                est_glm4["argument_bytes"] + est_glm4["temp_bytes"]),
            dryrun_s=f"{est_s:.1f}", seconds=r["seconds"])
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"[shard-serve-hd] rank {r['rank']} failed "
                                 f"{bad}")


def check_shard_vlm(work, cfg, one_weights):
    """[shard-serve-vlm]'s checks, on every rank's results: the VLM's
    tensor-parallel serve on ``cfg`` against its one-process run
    (``one_weights`` bytes)."""
    ranks = [json.loads((work / f"hd_rank{r}.json").read_text())
             for r in range(SHARD_HD_RANKS)]
    hd, n = cfg.resolved_head_dim, SHARD_HD_RANKS
    per = cfg.vision.cross_attn_every
    n_groups = cfg.n_layers // per
    n_self = n_groups * (per - 1)
    slots = SERVE_PROMPT + SHARD_DECODE_STEPS
    for r in ranks:
        checks = {
            "layout": (r["vlm_layout"] == "heads" and r["vlm_heads_aligned"]),
            # each layer's prefill through the tensor-core kernel, on the
            # rank's heads: the self layers causal at 2,048, the cross
            # block 2,048 x 6,404
            "flash": (r["vlm_flash_launches_prefill"] == cfg.n_layers
                      and not r["vlm_other_launches"]
                      and r["vlm_flash_heads"] == [cfg.n_heads // n]
                      and r["vlm_flash_kv_heads"] == [cfg.n_kv_heads // n]
                      and r["vlm_flash_shapes"] == {
                          f"{SERVE_PROMPT}x{SERVE_PROMPT}": n_self,
                          f"{SERVE_PROMPT}x{cfg.vision.n_patches}":
                              n_groups}),
            "syncs": r["vlm_prefill_syncs"] == 0,
            "caches": (r["vlm_cache_k_local"] == [
                           n_self, SERVE_BATCH, slots, cfg.n_kv_heads // n, hd]
                       and r["vlm_cache_xk_local"] == [
                           n_groups, SERVE_BATCH, cfg.vision.n_patches,
                           cfg.n_kv_heads // n, hd]),
            "weights": (r["vlm_weight_bytes_local"]
                        <= one_weights / n + 2 ** 20),
            "logits": (r["vlm_logits_finite"]
                       and r["vlm_logits_rel_rms"] <= SHARD_LOGITS_REL_RMS
                       and r["vlm_broken_rel_rms"]
                       > 2 * SHARD_LOGITS_REL_RMS),
        }
        log("shard-serve-vlm", rank=r["rank"], config=VLM_ARCH,
            layers=cfg.n_layers, cut_from=get_config(VLM_ARCH).n_layers,
            mesh=f"(1, {n})", layout=r["vlm_layout"],
            cache_k_local=r["vlm_cache_k_local"],
            cache_xk_local=r["vlm_cache_xk_local"], slots=slots,
            batch=SERVE_BATCH, prompt=SERVE_PROMPT,
            patches=cfg.vision.n_patches, decode_steps=SHARD_DECODE_STEPS,
            weight_bytes_local=r["vlm_weight_bytes_local"],
            weight_bytes_one=one_weights,
            params_one=one_weights // 4,
            init_peak=r["vlm_init_peak"], serve_peak=r["vlm_peak"],
            prefill_ms=f"{r['vlm_prefill_ms']:.1f}",
            decode_ms_per_step=f"{r['vlm_decode_ms_per_step']:.1f}",
            prefill_syncs=r["vlm_prefill_syncs"],
            prefill_sync_sites=r["vlm_prefill_sync_sites"] or "none",
            prefill_sync_messages=r["vlm_prefill_sync_messages"] or "none",
            flash_launches_prefill=r["vlm_flash_launches_prefill"],
            flash_shapes=r["vlm_flash_shapes"],
            flash_heads=r["vlm_flash_heads"],
            flash_kv_heads=r["vlm_flash_kv_heads"],
            collectives_prefill=r["vlm_collectives_prefill"],
            collectives_per_decode_step=r["vlm_collectives_per_decode_step"],
            logits_rel_rms=f"{r['vlm_logits_rel_rms']:.3e}",
            logits_bar=SHARD_LOGITS_REL_RMS,
            broken_rel_rms=f"{r['vlm_broken_rel_rms']:.3e}",
            logits_max_abs=f"{r['vlm_logits_max_abs']:.3e}",
            backend="gloo")
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"[shard-serve-vlm] rank {r['rank']} failed "
                                 f"{bad}")


def phase_batch_devices():
    """`simulate_batch` over devices on a one-card machine: devices=None
    equals devices=1, bit for bit; devices=2 raises ValueError."""
    horizon = 30
    spec = WorkloadSpec(n_users=3, horizon=horizon, cpu_total=32, seed=SEED,
                        arrival_rate=0.15, mean_work=20,
                        class_mix=(0.15, 0.35, 0.5))
    users = make_users(spec)
    jobs = make_jobs(spec, users)[:30]
    cells = [engine.BatchCell(users=users, jobs=jobs, policy=p)
             for p in POLICIES]
    cfg = SchedulerConfig(cpu_total=32, quantum=3)
    one = engine.simulate_batch(cells, cfg, horizon, devices=1, device=DEV)
    auto = engine.simulate_batch(cells, cfg, horizon, device=DEV)
    for a, b in zip(auto, one):
        if not (all(torch.equal(x, y) for x, y in zip(a.table, b.table))
                and np.array_equal(a.busy, b.busy)):
            raise AssertionError(f"devices=None differs for {a.policy}")
    try:
        engine.simulate_batch(cells, cfg, horizon, devices=2, device=DEV)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("devices=2 ran on a one-card machine")
    log("batch-devices", cells=len(cells),
        device_count=torch.cuda.device_count(), none_equals_one=True,
        devices_2=f"ValueError: {refused[:60]}")


# ---------------------------------------------------------------------------
# the dry run: costing at production scale without allocating
# ---------------------------------------------------------------------------

#: the dry run's cells on the (16, 16) mesh: a dense train step and an MoE
#: decode step, each in its own process, the two at once
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k"),
                ("deepseek-moe-16b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300
#: how far a peak on the card may lie from the dry run's estimate
PEAK_TOL = 0.10


def start_dryrun(tmp):
    """[dryrun]'s processes, started: ``python -m repro_torch.launch.dryrun``
    for each of DRYRUN_CELLS, its record into ``tmp``.  They use the host
    only, so the script runs them beside [train], whose step is bound by
    the card (busy 0.97): the phase then costs the limit nothing."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    return time.perf_counter(), [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", tmp], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, shape in DRYRUN_CELLS]


def phase_dryrun(started, tmp):
    """[dryrun]: waits for `start_dryrun`'s processes: the dry run of
    DRYRUN_CELLS on the (16, 16) production mesh (a fake world of 256
    ranks, meta tensors: nothing reaches the card).  Per cell the three
    roofline terms, the peak per device, the bottleneck, MF% and the
    seconds; raises unless every record is ok and every term finite and
    positive.  The terms are estimates from the H100's datasheet
    constants (`launch/mesh.py`), not measurements."""
    t0, procs = started
    waited = time.perf_counter()
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    done = time.perf_counter()
    for (arch, shape), p, (out, err) in zip(DRYRUN_CELLS, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"dryrun {arch} {shape}: exit "
                                 f"{p.returncode}\n{out}\n{err[-3000:]}")
        rec = json.loads((Path(tmp) / f"{arch}__{shape}__16x16.json")
                         .read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape}: {rec}")
        rf = rec["roofline"]
        terms = {k: rf[k] for k in ("compute_s", "memory_s", "collective_s")}
        if not all(np.isfinite(v) and v > 0 for v in terms.values()):
            raise AssertionError(f"dryrun {arch} {shape}: terms {terms}")
        log("dryrun", config=arch, shape=shape, mesh=rec["mesh"],
            n_devices=rec["n_devices"], grad_accum=rec["grad_accum"],
            **{k: f"{v * 1e3:.4f}ms" for k, v in terms.items()},
            bottleneck=rf["bottleneck"],
            peak_per_device_bytes=rec["memory"]["peak_estimate_bytes"],
            model_flops_ratio=f"{rf['model_flops_ratio']:.4f}",
            coll_breakdown={k: int(v) for k, v in
                            rec["coll_breakdown"].items()},
            production_s=rec["compile_s"],
            costing_s=rec["costing_compile_s"], assumed=rec["reason"],
            terms="estimates from the H100 datasheet constants")
    log("dryrun", cells=len(DRYRUN_CELLS), all_ok=True,
        seconds=f"{done - t0:.1f}", beside="[train]",
        waited_after_train_s=f"{done - waited:.1f}")


def phase_dryrun_vs_card(model, tokens, train_peak, train_ms):
    """[dryrun-vs-card]: two internlm2-1.8b steps costed on one rank on
    meta tensors by `launch.dryrun` — [serve]'s prefill (SERVE_BATCH x
    SERVE_PROMPT onto a cache of SERVE_PROMPT slots) and [train]'s step
    (TRAIN_BATCH x TRAIN_SEQ, the launcher's chunks, no accumulation) —
    held against the card: ``model`` (the [serve] phase's) runs the same
    prefill under the same `counting.costing`, whose matmul and kernel
    FLOPs must equal the meta count and whose peak (the memory it
    allocated above what was allocated before it, plus its arguments)
    must lie within PEAK_TOL of the dry run's estimate (arguments plus
    temp); [train]'s peak ``train_peak`` within PEAK_TOL of the train
    step's.  The compute and memory terms are printed beside the measured
    prefill (timed here, uncounted) and ``train_ms`` ([train]'s median
    step) as the share of it each reaches."""
    t0 = time.perf_counter()
    saved = kernel_counts()
    chunks = {"q_chunk": model.q_chunk, "kv_chunk": model.kv_chunk}
    shapes = {"prefill": ShapeSpec("serve_prefill", seq_len=SERVE_PROMPT,
                                   global_batch=SERVE_BATCH, kind="prefill"),
              "train": ShapeSpec("train_step", seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, kind="train")}
    meta, meta_s = {}, {}
    # [train] runs TRAIN_LAYERS of the train arch's layers
    tunes = {"prefill": dict(chunks, grad_accum=1),
             "train": dict(chunks, grad_accum=1,
                           cfg={"n_layers": TRAIN_LAYERS})}
    for kind, arch in (("prefill", SERVE_ARCH), ("train", TRAIN_ARCH)):
        ts = time.perf_counter()
        meta[kind] = dryrun.count_cell(dryrun.build_cell(
            arch, shapes[kind], None, tunes[kind]))
        meta_s[kind] = time.perf_counter() - ts
    step = make_prefill_step(model)
    batch = {"tokens": tokens}
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT)
    args = (sum(p.numel() * p.element_size() for p in model.parameters())
            + cache_bytes(cache) + tokens.numel() * tokens.element_size())
    step(batch, cache)                                   # warm-up
    torch.cuda.synchronize()
    ts = time.perf_counter()
    step(batch, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - ts) * 1e3
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with counting.costing() as card:
        out = step(batch, cache)
        torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    del out, cache
    collect_garbage()
    set_kernel_counts(saved)
    pre = meta["prefill"]
    if (card.matmul_flops, card.kernel_flops) != (pre.matmul_flops,
                                                  pre.kernel_flops):
        raise AssertionError(
            f"dryrun-vs-card: the card counted {card.matmul_flops} matmul "
            f"and {card.kernel_flops} kernel FLOPs, meta {pre.matmul_flops} "
            f"and {pre.kernel_flops}")
    if args != pre.argument_bytes:
        raise AssertionError(f"dryrun-vs-card: the prefill's arguments are "
                             f"{args} bytes on the card, {pre.argument_bytes} "
                             "on meta")
    rows = {}
    for kind, measured, ms in (("prefill", args + rise, prefill_ms),
                               ("train", train_peak, train_ms)):
        mem = roofline.memory_stats(meta[kind])
        est = mem["argument_bytes"] + mem["temp_bytes"]
        rf = roofline.analyze(meta[kind], n_devices=1)
        rows[kind] = dict(
            measured_peak_bytes=measured, estimate_bytes=est,
            peak_over_estimate=f"{measured / est:.4f}",
            compute_ms=f"{rf.compute_s * 1e3:.3f}",
            memory_ms=f"{rf.memory_s * 1e3:.3f}", measured_ms=f"{ms:.3f}",
            compute_share=f"{rf.compute_s * 1e3 / ms:.4f}",
            memory_share=f"{rf.memory_s * 1e3 / ms:.4f}",
            matmul_flops=int(meta[kind].matmul_flops),
            kernel_flops=int(meta[kind].kernel_flops),
            op_bytes=int(meta[kind].op_bytes),
            meta_count_s=f"{meta_s[kind]:.1f}")
        if abs(measured / est - 1) > PEAK_TOL:
            raise AssertionError(f"dryrun-vs-card: {kind} peak {measured} "
                                 f"against the estimate {est}")
    log("dryrun-vs-card", config=SERVE_ARCH, step="prefill",
        batch=SERVE_BATCH, prompt=SERVE_PROMPT,
        card_matmul_flops=int(card.matmul_flops),
        card_kernel_flops=int(card.kernel_flops),
        card_op_bytes=int(card.op_bytes), flops_equal=True,
        card_rise_bytes=rise, meta_temp_bytes=int(
            roofline.memory_stats(pre)["temp_bytes"]),
        argument_bytes=args, kernels=card.kernels, **rows["prefill"])
    log("dryrun-vs-card", config=TRAIN_ARCH, layers=TRAIN_LAYERS,
        step="train", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        train_peak_from="[train]",
        **rows["train"], peak_tol=PEAK_TOL,
        terms="estimates from the H100 datasheet constants",
        seconds=f"{time.perf_counter() - t0:.1f}")


def kernel_entry(name, source, replaces, launches, err, t, extra=()):
    """One kernel's entry in the JSON record: ``t`` holds its ms, plain_ms,
    bound_ms, bound_by and library_ms (None where no library call computes
    the same function), and the keys named in ``extra``, which the entry
    also carries."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), **{k: t[k] for k in extra}}


def multi_device_phases():
    """[ep-compare], [ep-ranks], [shard-serve], [shard-serve-hd] (with
    [shard-train-hd]), [shard-serve-vlm], [shard-serve-mla],
    [shard-serve-hybrid], [shard-serve-mla10], [shard-serve-xlstm],
    [shard-serve-audio] and [batch-devices]; returns [ep-compare]'s
    record of the expert-parallel dispatch and the new ranks' kernel
    launches (`check_shard_new`)."""
    with scratch_dir() as tmp:
        work = Path(tmp)
        ep = phase_ep_compare(work)
        ranks = phase_shard_ranks(work)
    phase_batch_devices()
    return ep, ranks


def main():
    smi = phase_env()
    phase_build()
    if sys.argv[1:] == ["--multi-device-only"]:
        # a partial run for work on these phases: no result line
        multi_device_phases()
        print(smi)
        return
    err = phase_kernel_compare()
    batch_err = phase_batch_kernel_compare()
    runs, launches = phase_fleet()
    timing = phase_kernel_on_fleet(runs["omfs", "cuda"])
    plain_device_us = phase_fleet_profile()
    phase_policy_syncs(runs)
    phase_policy_matrix(runs)
    phase_audit()
    events_workload, card_logs = phase_events()
    phase_events_fleet(runs["omfs", "cuda"], plain_device_us)
    batch_launches, captured = phase_batch_fleet(runs)
    del runs
    batch_timing = phase_batch_kernel_time(captured)
    del captured
    phase_batch_events(events_workload, card_logs)
    phase_batch_sweep()
    phase_stream_fleet()
    phase_launcher()
    phase_sched_status()
    codec_err = phase_codec_compare()
    phase_train_vs_cpu()
    with scratch_dir() as dryrun_dir:
        started = start_dryrun(dryrun_dir)
        try:
            rec, train_peak, train_ms = phase_train()
        except BaseException:
            for p in started[1]:
                p.kill()
                p.wait()
            raise
        phase_dryrun(started, dryrun_dir)
    codec = phase_codec_state(rec.state, rec.cfg)
    train_losses = rec.losses
    del rec
    phase_executor(train_losses, train_peak)
    phase_cr_fast_tier()
    cr_launches = phase_cr_path()
    for arch in (MOE_ARCH, HYBRID_ARCH, XLSTM_ARCH):
        phase_train_vs_cpu("train-families-vs-cpu", arch,
                           FAMILIES_CPU_LAYERS[arch], ("float32",))
    moe_cfg, moe_losses, moe_peak = phase_train_families()
    phase_executor_moe(moe_cfg, moe_losses, moe_peak)
    # slice 10's rest: one seeded frontend per family, shared by its
    # training, -vs-cpu, serve and profile phases
    frontends = {arch: seeded_frontend(get_config(arch), SERVE_BATCH,
                                       SEED + 7)
                 for arch in (VLM_ARCH, AUDIO_ARCH)}
    for arch in (MLA_ARCH, VLM_ARCH, AUDIO_ARCH):
        phase_train_vs_cpu("train-new-families-vs-cpu", arch,
                           NEW_CPU_LAYERS[arch], ("float32",),
                           frontend=frontends.get(arch))
    phase_train_new_families(frontends)
    attn_err = phase_attn_compare()
    attn = phase_attn_time()
    n_dense = get_config(SERVE_ARCH).n_layers
    dense_cpu = phase_vs_cpu(SERVE_ARCH, "serve-vs-cpu",
                             {"flash_attention": CPU_LAYERS}, {})
    # bf16 serving: flash through the tensor-core kernel
    dense_prefill = {"flash_attention_wgmma": n_dense}
    model, tokens, dense = phase_serve(SERVE_ARCH, "serve", dense_prefill, {})
    phase_prefill_syncs(model, tokens)
    phase_profile("serve", SERVE_ARCH, model, tokens, ("flash_fwd",),
                  dense_prefill, {})
    phase_dryrun_vs_card(model, tokens, train_peak, train_ms)
    del model
    collect_garbage()
    torch.cuda.empty_cache()
    ssm_err = phase_ssm_compare()
    ssm = phase_ssm_time()
    mlstm_err = phase_mlstm_compare()
    mlstm = phase_mlstm_time()
    n_hybrid = _HYMBA.n_layers
    n_mlstm = XLSTM_SERVE_LAYERS // _XLSTM.xlstm.slstm_every
    phase_vs_cpu(HYBRID_ARCH, "hybrid-vs-cpu",
                 {"flash_attention": CPU_LAYERS, "ssm_scan": CPU_LAYERS},
                 {"ssm_scan": CPU_LAYERS})
    phase_vs_cpu(XLSTM_ARCH, "xlstm-vs-cpu", {"mlstm_scan": CPU_LAYERS // 2},
                 {"mlstm_scan": CPU_LAYERS // 2})
    recurrent = {}
    for arch, phase, per_prefill, per_decode, names, layers in (
            (HYBRID_ARCH, "serve-hymba",
             {"flash_attention_wgmma": n_hybrid, "ssm_scan": n_hybrid},
             {"ssm_scan": n_hybrid}, ("flash_fwd", "ssm_scan_fwd"), None),
            (XLSTM_ARCH, "serve-xlstm", {"mlstm_scan": n_mlstm},
             {"mlstm_scan": n_mlstm},
             ("mlstm_gates", "mlstm_carry", "mlstm_out"),
             XLSTM_SERVE_LAYERS)):
        model, tokens, recurrent[arch] = phase_serve(
            arch, phase, per_prefill, per_decode, layers=layers)
        if arch == XLSTM_ARCH:
            phase_xlstm_syncs(model, tokens)
        phase_profile(phase, arch, model, tokens, names, per_prefill,
                      per_decode)
        del model
        collect_garbage()
        torch.cuda.empty_cache()
    phase_moe_memory()
    gmm_err = phase_moe_compare()
    gmm = phase_moe_time()
    n_moe = _MOE.n_layers
    moe_cpu = phase_vs_cpu(
        MOE_ARCH, "moe-vs-cpu",
        {"flash_attention": CPU_LAYERS, "moe_gmm": 3 * CPU_LAYERS},
        {"moe_gmm": 3 * CPU_LAYERS})
    per_prefill = {"flash_attention_wgmma": n_moe, "moe_gmm_wgmma": 3 * n_moe}
    per_decode = {"moe_gmm_wgmma": 3 * n_moe}
    model, tokens, moe = phase_serve(MOE_ARCH, "serve-moe", per_prefill,
                                     per_decode)
    phase_profile("serve-moe", MOE_ARCH, model, tokens, ("moe_gmm",),
                  per_prefill, per_decode)
    del model
    collect_garbage()
    torch.cuda.empty_cache()
    new_flash = phase_new_families_serve(frontends)
    ep, ranks = multi_device_phases()
    flash_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    gmm_src = "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu"
    record = {"kernels": [kernel_entry(
        "sched_select",
        "src/repro_torch/kernels/sched_select/csrc/sched_select.cu",
        "src/repro/kernels/sched_select/kernel.py:59", launches,
        max(err, timing["max_abs_err"]), timing,
        extra=("host_ms", "floor_ms")), kernel_entry(
        "sched_select_batched",
        "src/repro_torch/kernels/sched_select/csrc/sched_select.cu",
        "src/repro/kernels/sched_select/kernel.py:59", batch_launches,
        max(batch_err, batch_timing["max_abs_err"]), batch_timing,
        extra=("host_ms", "singles_ms"))] + [kernel_entry(
            f"ckpt_{name}",
            "src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu",
            f"src/repro/kernels/ckpt_codec/kernel.py:{line}",
            cr_launches[name], max(codec_err, codec[name]["max_abs_err"]),
            codec[name])
        for name, line in (("quantize", 22), ("dequantize", 30))] + [
        # the SIMT kernels' launches: the fp32 serve paths ([serve-vs-cpu],
        # [mla-vs-cpu], [vlm-vs-cpu], [audio-vs-cpu])
        kernel_entry("flash_attention_fwd", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     dense_cpu["flash_attention"]
                     + new_flash["flash_attention"], attn_err["simt"],
                     attn["internlm2"]["simt"]),
        kernel_entry("flash_attention_fwd_wgmma", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     dense["flash_attention_wgmma"]
                     + new_flash["flash_attention_wgmma"], attn_err["wgmma"],
                     attn["internlm2"]["wgmma"]),
        # [shard-serve-mla]'s launches on a rank's 10 heads, all ranks
        kernel_entry("flash_attention_fwd_wgmma_mla_rank", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     ranks["flash_mla"], attn_err["wgmma"],
                     attn["mla_tp4"]["wgmma"]),
        # the columns form's launches on a rank's touched heads, all
        # ranks: [shard-serve-hybrid]'s 7 of 25, [shard-serve-mla10]'s 3
        # of 10
        kernel_entry("flash_attention_fwd_wgmma_hybrid_rank", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     ranks["flash_hyb"], attn_err["wgmma"],
                     attn["hymba_tp4"]["wgmma"]),
        kernel_entry("flash_attention_fwd_wgmma_mla10_rank", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     ranks["flash_mla10"], attn_err["wgmma"],
                     attn["mla10_tp4"]["wgmma"]),
        # [shard-serve-audio]'s launches on a rank's 2 heads, timed at
        # its encoder's shape
        kernel_entry("flash_attention_fwd_wgmma_audio_rank", flash_src,
                     "src/repro/kernels/flash_attention/kernel.py:34",
                     ranks["flash_audio"], attn_err["wgmma"],
                     attn["whisper_enc_tp4"]["wgmma"]),
        kernel_entry("ssm_scan",
                     "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:25",
                     recurrent[HYBRID_ARCH]["ssm_scan"], ssm_err,
                     ssm["prefill"], extra=("host_ms",)),
        # [shard-serve-hybrid]'s launches on a rank's 800 channels
        kernel_entry("ssm_scan_rank",
                     "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:25",
                     ranks["ssm_hyb"], ssm_err, ssm["tp4_prefill"],
                     extra=("host_ms",)),
        kernel_entry("mlstm_scan",
                     "src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
                     "src/repro/kernels/mlstm_scan/kernel.py:46",
                     recurrent[XLSTM_ARCH]["mlstm_scan"], mlstm_err,
                     # every serving prefill passes the cache's state
                     mlstm["prefill_carried"],
                     extra=("host_ms", "floor_ms")),
        # [shard-serve-xlstm]'s launches on a rank's 1 head of 4
        kernel_entry("mlstm_scan_rank",
                     "src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
                     "src/repro/kernels/mlstm_scan/kernel.py:46",
                     ranks["mlstm_xlstm"], mlstm_err, mlstm["rank_carried"],
                     extra=("host_ms", "floor_ms")),
        kernel_entry("moe_gmm", gmm_src,
                     "src/repro/kernels/moe_gmm/kernel.py:25",
                     moe_cpu["moe_gmm"], gmm_err["simt"],
                     gmm["prefill"]["simt"]),
        kernel_entry("moe_gmm_wgmma", gmm_src,
                     "src/repro/kernels/moe_gmm/kernel.py:25",
                     moe["moe_gmm_wgmma"], gmm_err["wgmma"],
                     gmm["prefill"]["wgmma"]),
        # the expert-parallel dispatch: E_local 64, C_e 960 buffers
        kernel_entry("moe_gmm_wgmma_ep", gmm_src,
                     "src/repro/kernels/moe_gmm/kernel.py:25",
                     ep["launches"], ep["err"], ep["timing"])]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
