"""Dispatch auditor: run the passes and the models under a
``TorchDispatchMode`` and hold what they dispatch (the counterpart of
``repro.analysis.jaxpr_audit``; the port compiles nothing, so what the
reference reads from a jaxpr is read here from the ops a run dispatches).

Three rules:

* **dispatch-float-cast** — running every registered policy pass over the
  fixture (tiered, so placement is live) dispatches NO op that takes only
  integer/bool tensors and returns a floating one, and every `JobTable`
  column is still an integer type after the run.  A float entering the
  /256 cost grid rounds differently from the Python backend's integer
  arithmetic: schedules drift without a test failing.
* **branch-confinement** — in the incremental OMFS passes (``omfs``,
  ``omfs_cheap_victim``) the victim sort and the plan
  (`omfs_torch.plan_evictions`, `ops.plan_evictions_fused`) run only
  inside the eviction branch (`omfs_torch._evict_branch`): every
  ``aten::sort`` outside it is the queue's own (`queue_order`), and a tick
  whose positions all admit without eviction dispatches no victim sort
  and no plan.  In every pass the plans equal `PassStats.evict_branches`.
* **dispatch-host-reads** — the runtime side of ``host-read``: the ops
  that read a tensor back to the host (``aten::_local_scalar_dense``,
  ``aten::nonzero``, ``aten::masked_select``, ``aten::equal``, a copy
  from the card to the host, and ``Tensor.tolist``, which dispatches
  nothing on a CPU tensor and is patched to count).  A pass's run makes
  exactly ``PassStats.host_syncs + PassStats.place_reads`` of them; a smoke
  prefill and 4 greedy decode steps of each family (dense, MLA, MoE,
  hybrid, xLSTM, VLM, audio) make exactly the prefill's
  ``models.moe.HOST_READS`` and none in decode.

On CPU tensors a kernel's wrapper runs the kernel's plain version, which
may read the host (the bounded placement, the CPU-only count check of
``moe_gmm``); a read of a CPU tensor under a ``kernels/<name>/ops.py``
frame stands in for the kernel and is kept apart (``stand_in_reads``).
On the card the same wrappers launch the kernels, and every read counts.

The fixture is the reference's (J = 12, a T = 3 lattice with tight fast
tiers so spilling happens, delta-aware recurrent saves), run for
`HORIZON` ticks under both ``SchedulerConfig.kernel_backend``s:
``"cuda"`` (the plain plan on CPU tensors, the `sched_select` kernel on
CUDA ones) and ``"torch"``.

The reference's ``retrace`` rule has no counterpart: the port compiles
nothing, so nothing can retrace.  It comes with CUDA graphs.

Every entry point takes an explicit ``device``, the card by default;
``device="cpu"`` runs the plain versions, as the tests do.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.base import Violation, register

ENGINE = "src/repro_torch/core/engine.py"
OMFS_TORCH = "src/repro_torch/core/omfs_torch.py"
MODEL = "src/repro_torch/models/model.py"

#: policies whose per-queue-position loop keeps the victim machinery
#: inside the eviction branch (backfill's once-per-tick reservation sort is
#: by design)
CONFINED_POLICIES = ("omfs", "omfs_cheap_victim")
#: the two kernel-dispatch paths every pass rule audits
BACKENDS = ("cuda", "torch")
#: ticks of each audited run: every planner takes eviction branches and
#: a checkpoint spills past the fast tier
HORIZON = 12
#: one arch of each family, served at its smoke size
FAMILY_ARCHS = ("internlm2-1.8b", "minicpm3-4b", "deepseek-moe-16b",
                "hymba-1.5b", "xlstm-350m", "llama-3.2-vision-11b",
                "whisper-base")
#: the smoke prompt: B x S above the MoE's 64-row tile, so that its
#: prefill reads the capacity (decode takes C = T without a read)
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE_STEPS = 2, 40, 4

_SRC = Path(__file__).resolve().parent.parent        # src/repro_torch
_SRC_PREFIX = str(_SRC) + "/"
_ANALYSIS_PREFIX = str(Path(__file__).resolve().parent) + "/"


# ---------------------------------------------------------------------------
# The mode
# ---------------------------------------------------------------------------


def _port_frames():
    """The port's frames on the stack, innermost first (the analyzer's
    own left out)."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_SRC_PREFIX) and not name.startswith(
                _ANALYSIS_PREFIX):
            yield f
        f = f.f_back


def _site() -> str:
    for f in _port_frames():
        return (f"{Path(f.f_code.co_filename).relative_to(_SRC.parent)}:"
                f"{f.f_lineno}")
    return "<outside the port>"


def _under_kernel_wrapper() -> bool:
    return any(f.f_code.co_filename.startswith(_SRC_PREFIX + "kernels/")
               and f.f_code.co_filename.endswith("/ops.py")
               for f in _port_frames())


def _on_host(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"


def _tensors(*groups) -> List[torch.Tensor]:
    """The tensors among ``groups`` of op arguments or outputs, and in
    their lists and tuples (an op's arguments nest no deeper)."""
    out = []
    for group in groups:
        for x in (group if isinstance(group, (list, tuple)) else (group,)):
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class HostReads(TorchDispatchMode):
    """Counts the reads of a tensor back to the host: the ops in
    ``READS``, a copy from the card to the host, and ``Tensor.tolist``
    (patched while the mode is on: it reads a CPU tensor without a
    dispatched op).  ``count`` is their number and ``sites`` where the port
    made them; a read of a CPU tensor under a kernel's launch wrapper is
    the kernel's plain version standing in for it, and goes to
    ``stand_in`` instead."""

    READS = {"aten::_local_scalar_dense", "aten::nonzero",
             "aten::masked_select", "aten::equal"}

    def __init__(self):
        super().__init__()
        self.count = 0
        self.stand_in = 0
        self.sites: List[str] = []
        self._tolist = None
        self._in_tolist = False

    def _read(self, tensor) -> None:
        if _on_host(tensor) and _under_kernel_wrapper():
            self.stand_in += 1
            return
        self.count += 1
        self.sites.append(_site())

    def __enter__(self):
        mode = self
        tolist = self._tolist = torch.Tensor.tolist

        def counted(t):
            if mode._in_tolist:
                return tolist(t)
            mode._read(t)
            mode._in_tolist = True      # its own copy to the host is one
            try:
                return tolist(t)
            finally:
                mode._in_tolist = False

        torch.Tensor.tolist = counted
        try:
            return super().__enter__()
        except BaseException:
            torch.Tensor.tolist = tolist
            raise

    def __exit__(self, *exc):
        torch.Tensor.tolist = self._tolist
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if not self._in_tolist:
            if name in self.READS:
                self._read(args[0])
            elif name == "aten::_to_copy" and not _on_host(args[0]) and str(
                    kwargs.get("device", "")) == "cpu":
                self._read(args[0])
            elif name == "aten::copy_" and _on_host(args[0]) and not \
                    _on_host(args[1]):
                self._read(args[1])
        return self.observe(func, args, kwargs, func(*args, **kwargs))

    def observe(self, func, args, kwargs, out):
        return out


def _is_int(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


class _PassMode(HostReads):
    """`HostReads` plus what the pass rules read: int-only ops that return
    a float, and sorts outside `queue_order` and the eviction branch."""

    def __init__(self):
        super().__init__()
        self.float_ops: List[str] = []
        self.stray_sorts: List[str] = []

    def observe(self, func, args, kwargs, out):
        ins = _tensors(args, tuple(kwargs.values()))
        outs = _tensors(out)
        if ins and all(_is_int(x.dtype) for x in ins) and any(
                not _is_int(y.dtype) for y in outs):
            self.float_ops.append(f"{func._schema.name} at {_site()}")
        if func._schema.name == "aten::sort":
            names = {f.f_code.co_name for f in _port_frames()}
            if not names & {"queue_order", "_evict_branch"}:
                self.stray_sorts.append(_site())
        return out


class _PlanWatch:
    """Counts the plans of a run (calls of `omfs_torch.plan_evictions`, one
    per planned cell) and records the calls of it and of
    ``ops.plan_evictions_fused`` made outside `omfs_torch._evict_branch`:
    both entry points are wrapped where the passes look them up while the
    watch is on."""

    def __init__(self):
        from repro_torch.core import omfs_torch, policies_torch
        from repro_torch.kernels.sched_select import ops

        self._branch = omfs_torch._evict_branch.__code__
        self._sites = [(omfs_torch, "plan_evictions"),
                       (policies_torch, "plan_evictions"),
                       (ops, "plan_evictions_fused")]
        self._saved = []
        self.plans = 0
        self.outside: List[str] = []

    def _inside_branch(self) -> bool:
        f = sys._getframe(2)
        while f is not None:
            if f.f_code is self._branch:
                return True
            f = f.f_back
        return False

    def _wrap(self, fn, fused: bool):
        def watched(*args, **kwargs):
            if not fused:
                cells = kwargs.get("cells", args[7] if len(args) > 7
                                   else None)
                tbl = kwargs.get("tbl", args[1] if len(args) > 1 else None)
                self.plans += (len(cells) if cells is not None
                               else tbl.cpus.shape[0])
            if not self._inside_branch():
                caller = sys._getframe(1)
                self.outside.append(f"{Path(caller.f_code.co_filename).name}"
                                    f":{caller.f_lineno}")
            return fn(*args, **kwargs)

        return watched

    def __enter__(self):
        for mod, name in self._sites:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(fn, name.endswith("_fused")))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()
        return False


# ---------------------------------------------------------------------------
# The fixture and the runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Fixture:
    """The audited workload, built on ``device``: ``(tbl, ent)`` at the
    fixture's cluster, and ``idle`` (``(tbl, ent, cfg)``) on a cluster
    large enough that every queue position admits without eviction."""

    device: torch.device
    users: list
    jobs: list
    cfg: object
    tbl: object
    ent: torch.Tensor
    idle: tuple


def fixture(device="cuda") -> Fixture:
    """The reference's audit workload (``jaxpr_audit._fixture``: its
    spec, lattice and config) on ``device``: J = 12, a T = 3 lattice with
    tight fast tiers and delta-aware recurrent saves."""
    from repro_torch.core import omfs_torch
    from repro_torch.core.crcost import (
        UNBOUNDED,
        CRCostModel,
        TieredCRCostModel,
    )
    from repro_torch.core.types import SchedulerConfig
    from repro_torch.core.workload import WorkloadSpec, make_jobs, make_users

    dev = omfs_torch.resolve_device(device)
    spec = WorkloadSpec(n_users=3, horizon=40, cpu_total=16, seed=7,
                        arrival_rate=0.3, mean_work=12,
                        class_mix=(0.1, 0.2, 0.7))
    users = make_users(spec)
    # the 12 earliest submissions, of every user: the reference's first 12
    # jobs are all one user's, which OMFS never evicts for (a trace needs
    # no eviction; a run does)
    jobs = sorted(make_jobs(spec, users),
                  key=lambda j: (j.submit_time, j.id))[:12]
    tiers = TieredCRCostModel(
        tiers=(CRCostModel(save_mib_per_tick=256, restore_mib_per_tick=256,
                           delta_num=141, delta_den=256),
               CRCostModel(save_mib_per_tick=64, restore_mib_per_tick=64,
                           delta_num=182, delta_den=256),
               CRCostModel(save_mib_per_tick=32, restore_mib_per_tick=32,
                           save_base=1, restore_base=1,
                           delta_num=182, delta_den=256)),
        capacity_mib=(48, 96, UNBOUNDED))
    cfg = SchedulerConfig(cpu_total=16, quantum=2, cr_overhead=1,
                          cr_tiers=tiers)
    tbl, ent = omfs_torch.table_from_jobs(jobs, users, cfg.cpu_total, cfg,
                                          dev)
    roomy = dataclasses.replace(cfg, cpu_total=1 << 20)
    itbl, ient = omfs_torch.table_from_jobs(jobs, users, roomy.cpu_total,
                                            roomy, dev)
    return Fixture(dev, users, jobs, cfg, tbl, ent, (itbl, ient, roomy))


@dataclasses.dataclass
class PassRun:
    """One policy's audited run: its `PassStats`, the reads, plans and
    stray sorts it dispatched, the float ops, and the table's float
    columns after it."""

    policy: str
    backend: str
    ticks: int
    stats: object
    reads: int
    stand_in_reads: int
    read_sites: List[str]
    plans: int
    plans_outside: List[str]
    stray_sorts: List[str]
    float_ops: List[str]
    float_columns: List[str]


def run_pass(policy: str, backend: str, fx: Fixture, idle: bool = False
             ) -> PassRun:
    """Run ``policy``'s registered pass on a copy of the fixture's table
    under the audit: `HORIZON` ticks, or with ``idle`` the one tick at
    which the roomy cluster admits every queued job."""
    from repro_torch.core import engine, omfs_torch

    built, ent, cfg = ((fx.idle[0], fx.idle[1], fx.idle[2]) if idle
                       else (fx.tbl, fx.ent, fx.cfg))
    cfg = dataclasses.replace(cfg, kernel_backend=backend)
    tbl = omfs_torch.JobTable(*(c.clone() for c in built))
    pass_fn = engine.POLICIES[policy].torch_factory(None)
    stats = omfs_torch.PassStats()
    t0, ticks = (HORIZON, 1) if idle else (0, HORIZON)
    with _PlanWatch() as plans, _PassMode() as mode:
        tbl, _ = engine.run_table(cfg, ent, tbl, ticks, pass_fn, t0=t0,
                                  stats=stats)
    floats = [f for f, c in zip(omfs_torch.JobTable._fields, tbl)
              if not _is_int(c.dtype)]
    return PassRun(policy, backend, ticks, stats, mode.count, mode.stand_in,
                   mode.sites, plans.plans, plans.outside,
                   mode.stray_sorts, mode.float_ops, floats)


@dataclasses.dataclass
class ModelRun:
    """One family's audited serving: the reads of its prefill, the ones
    `models.moe.HOST_READS` counted there, and the reads of its decode
    steps."""

    arch: str
    family: str
    prefill_reads: int
    prefill_counted: int
    decode_reads: int
    decode_counted: int
    sites: List[str]


def run_model(arch: str, device="cuda") -> ModelRun:
    """A smoke prefill of `SERVE_BATCH` x `SERVE_PROMPT` tokens and
    `SERVE_DECODE_STEPS` greedy decode steps of ``arch`` on ``device``,
    as `launch.serve.generate` runs them, each under `HostReads`."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import resolve_frontend

    cfg = get_smoke_config(arch)
    model = serve.build(cfg, 0, device)
    tokens = serve.prompts(cfg, SERVE_BATCH, SERVE_PROMPT, 1, device)
    batch = {"tokens": tokens}
    frontend = resolve_frontend(cfg, None, SERVE_BATCH, tokens.device)
    if frontend is not None:
        batch["frontend"] = frontend
    cache = model.init_cache(SERVE_BATCH,
                             SERVE_PROMPT + SERVE_DECODE_STEPS + 1)
    counted = moe.HOST_READS
    with HostReads() as pre:
        cache, logits = model.prefill(batch, cache)
    prefill_counted, counted = moe.HOST_READS - counted, moe.HOST_READS
    with HostReads() as dec:
        for _ in range(SERVE_DECODE_STEPS):
            cache, logits = model.decode_step(cache, serve.greedy(logits))
    return ModelRun(arch, cfg.family, pre.count, prefill_counted, dec.count,
                    moe.HOST_READS - counted, pre.sites + dec.sites)


@dataclasses.dataclass
class AuditReport:
    device: str
    passes: List[PassRun]
    idle: List[PassRun]
    models: List[ModelRun]


def audit(device="cuda", backends: Sequence[str] = BACKENDS,
          policies: Optional[Sequence[str]] = None,
          archs: Sequence[str] = FAMILY_ARCHS) -> AuditReport:
    """Run every audited pass (``policies``, default all registered) under
    ``backends``, the confined passes' all-admit tick, and the serving of
    ``archs`` on ``device``."""
    from repro_torch.core import engine

    fx = fixture(device)
    names = sorted(engine.POLICIES) if policies is None else list(policies)
    passes = [run_pass(p, b, fx) for p in names for b in backends]
    idle = [run_pass(p, b, fx, idle=True) for p in names
            if p in CONFINED_POLICIES for b in backends]
    models = [run_model(a, fx.device) for a in archs]
    return AuditReport(str(fx.device), passes, idle, models)


# ---------------------------------------------------------------------------
# The rules: each reads one `AuditReport` (`collect_violations` runs
# `audit` once for the three)
# ---------------------------------------------------------------------------


def float_cast_violations(report: AuditReport, root: Path) -> List[Violation]:
    out = []
    for r in report.passes:
        for op in sorted(set(r.float_ops)):
            out.append(Violation(
                "dispatch-float-cast", str(root / ENGINE), 1,
                f"policy {r.policy!r} ({r.backend}): the run dispatches "
                f"{op}, an op that makes a float of integer tensors — a "
                "float entering the integer cost grid breaks "
                "cross-backend bit-equality"))
        for col in r.float_columns:
            out.append(Violation(
                "dispatch-float-cast", str(root / ENGINE), 1,
                f"policy {r.policy!r} ({r.backend}): JobTable column "
                f"{col!r} is floating after the run; columns must stay "
                "integer"))
    return out


def confinement_violations(report: AuditReport, root: Path
                           ) -> List[Violation]:
    out = []
    path = str(root / OMFS_TORCH)
    for r in report.passes:
        if r.plans != r.stats.evict_branches:
            out.append(Violation(
                "branch-confinement", path, 1,
                f"policy {r.policy!r} ({r.backend}): {r.plans} plans for "
                f"{r.stats.evict_branches} eviction branches — a plan "
                "runs only where a cell takes the branch"))
        if r.policy not in CONFINED_POLICIES:
            continue
        for where in sorted(set(r.plans_outside)):
            out.append(Violation(
                "branch-confinement", path, 1,
                f"policy {r.policy!r} ({r.backend}): a plan at {where} "
                "runs outside the eviction branch (_evict_branch)"))
        for where in sorted(set(r.stray_sorts)):
            out.append(Violation(
                "branch-confinement", path, 1,
                f"policy {r.policy!r} ({r.backend}): a sort at {where} "
                "runs outside the queue order and the eviction branch — "
                "victim machinery on the always-taken path"))
        if r.stats.evict_branches == 0:
            out.append(Violation(
                "branch-confinement", path, 1,
                f"policy {r.policy!r} ({r.backend}): the fixture took no "
                "eviction branch, so the rule saw nothing to confine"))
    for r in report.idle:
        if r.stats.evict_branches or r.plans or r.stray_sorts:
            out.append(Violation(
                "branch-confinement", path, 1,
                f"policy {r.policy!r} ({r.backend}): a tick whose "
                f"positions all admit without eviction made {r.plans} "
                f"plans and {len(r.stray_sorts)} victim sorts"))
    return out


def host_read_violations(report: AuditReport, root: Path) -> List[Violation]:
    out = []
    for r in report.passes:
        counted = r.stats.host_syncs + r.stats.place_reads
        if r.reads != counted:
            sites = ", ".join(sorted(set(r.read_sites))) or "none"
            out.append(Violation(
                "dispatch-host-reads", str(root / ENGINE), 1,
                f"policy {r.policy!r} ({r.backend}): {r.reads} host reads "
                f"in {r.ticks} ticks, PassStats counts {counted} "
                f"(host_syncs {r.stats.host_syncs}, place_reads "
                f"{r.stats.place_reads}); reads at {sites}"))
    for m in report.models:
        if m.prefill_reads != m.prefill_counted or m.decode_reads or \
                m.decode_counted:
            sites = ", ".join(sorted(set(m.sites))) or "none"
            out.append(Violation(
                "dispatch-host-reads", str(root / MODEL), 1,
                f"{m.arch} ({m.family}): prefill reads {m.prefill_reads} "
                f"(moe.HOST_READS counts {m.prefill_counted}), decode "
                f"reads {m.decode_reads} (must be 0); reads at {sites}"))
    return out


@register(
    "dispatch-float-cast", "trace",
    "no dispatched op of a policy pass makes a float of integer tensors; "
    "JobTable columns stay integer")
def check_float_casts(root: Path, report: AuditReport) -> List[Violation]:
    return float_cast_violations(report, root)


@register(
    "branch-confinement", "trace",
    "victim sort and plan run only inside the OMFS eviction branch; plans "
    "equal PassStats.evict_branches")
def check_branch_confinement(root: Path, report: AuditReport
                             ) -> List[Violation]:
    return confinement_violations(report, root)


@register(
    "dispatch-host-reads", "trace",
    "a pass's host reads equal PassStats.host_syncs + place_reads; a "
    "prefill reads only what moe.HOST_READS counts, a decode step nothing")
def check_dispatch_host_reads(root: Path, report: AuditReport
                              ) -> List[Violation]:
    return host_read_violations(report, root)
