"""AST lint rules for the port's scheduler and serving contracts (the
counterpart of ``repro.analysis.ast_rules``).

Three invariants the test suite cannot see but the AST can:

* **host-read** — a read of a tensor back to the host (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``/``bool()``/
  ``float()``, ``torch.equal``, or Python ``if``/``while``/``and``/
  ``or``/``not``/``assert``/``any()``/``all()`` on a tensor) inside a
  scheduling pass, a model's forward or a kernel's launch wrapper.  The
  port runs eagerly, so such a read does not fail: it synchronises the
  host with the card, silently, once per call.  It replaces the
  reference's ``tracer-leak`` and ``host-sync``, which police ``jit``;
  the reads that the design keeps carry a suppression that says where
  they are counted (``PassStats``, ``models.moe.HOST_READS``).
* **cost-grid** — a float literal, true division ``/``, or float cast
  flowing into the integer /256 cost grid (the ``cost_*``/``state_mib``/
  ``overhead`` columns and the `CRCostModel` evaluation functions).  The
  grid is what keeps the Python and torch backends bit-identical; one stray
  float breaks cross-backend equality without failing any unit test.

Plus **mutable-default** (the classic shared-default-argument bug), so the
analyzer holds the line even where ruff is not installed.

Contexts of ``host-read`` are found syntactically:

* functions with a `JobTable` parameter (``tbl``/``table`` or an annotation
  naming ``JobTable``), among them the closures that the pass factories
  (``make_*_pass``) return;
* every function of a ``models/`` module (``Model.prefill`` and
  ``Model.decode_step`` included);
* every function of a kernel's ``kernels/<name>/ops.py`` (the launch
  wrappers).

Tainted are the table parameters, parameters annotated as tensors or used
as one (an unannotated parameter whose ``.shape``, ``.device`` or a tensor
method is touched), the pass's entitlements ``ent``, and the results of
``torch.*`` ops and of any call or operator on a tainted value.
``.shape``/``.dtype``/``.device``/``.ndim``/``.is_cuda`` and ``.dim()``/
``.numel()``/``.size()`` of a tensor are host metadata and carry no taint.
A value a read produced is host data (the reference's ``LAUNDER_CALLS``):
a later ``if`` on it is no second read; so is the result of a function of
the same file whose every return is host data (``engine._table_to_host``),
and of ``np.asarray``.  A read behind a guard that the tensor lies on the
CPU (``x.device.type == "cpu" and ...``, or the body of such an ``if``) is
no device read.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.base import (
    SourceFile,
    Violation,
    dotted,
    register,
    tail,
)

#: tensor attributes that are host metadata
SHAPE_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "grad_fn"}
#: tensor methods whose result is host metadata
SHAPE_METHODS = {"dim", "numel", "size", "nelement", "element_size",
                 "is_contiguous", "data_ptr", "stride", "storage_offset",
                 "get_device", "is_floating_point", "is_complex"}
#: methods that read a tensor back to the host
READ_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_CONVERSIONS = {"int", "bool", "float"}
#: Python builtins that iterate a tensor's values on the host
HOST_REDUCTIONS = {"any", "all"}
#: builtins whose result is host data whatever their argument
HOST_BUILTINS = {"len", "isinstance", "hasattr", "callable", "type", "id"}
#: torch functions whose result is host data
HOST_TORCH = {"torch.is_tensor", "torch.device", "torch.Size", "torch.finfo",
              "torch.iinfo", "torch.get_default_dtype", "torch.is_grad_enabled",
              "torch.promote_types", "torch.result_type", "torch.can_cast",
              "torch.is_floating_point"}
HOST_TORCH_ROOTS = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                    "torch.utils.", "torch.profiler.", "torch.autograd.")
TAINT_ROOTS = ("torch.", "F.")
#: explicit host transfers that launder taint without being a device read
#: here (numpy conversion of a CUDA tensor raises instead of syncing)
LAUNDER_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
TABLE_PARAMS = {"tbl", "table"}
TABLE_ANNOS = {"JobTable"}
#: the pass contract's tensor arguments besides the table
PASS_TENSOR_PARAMS = {"ent"}
#: attribute uses that mark an unannotated parameter as a tensor
TENSOR_USES = SHAPE_ATTRS | SHAPE_METHODS | READ_METHODS | {
    "contiguous", "view", "reshape", "to", "float", "long", "half",
    "bfloat16", "expand", "unsqueeze", "squeeze", "clone", "gather",
    "masked_fill_", "index_add_", "copy_", "scatter_", "new_zeros",
    "new_full", "new_empty", "flatten", "transpose", "permute", "T", "mT"}
# the /256 integer cost grid: JobTable columns priced by core.crcost —
# the [J, T] lattice columns plus the legacy view accessors over them
GRID_NAMES = {"cost_save_lat", "cost_rsave_lat", "cost_restore_lat",
              "cost_save", "cost_restore", "cost_save2", "cost_restore2",
              "state_mib", "overhead"}
# CRCostModel evaluation path: must stay integer end-to-end (calibration
# boundaries like from_measured/measured_delta_num/ticks_from_seconds take
# floats on purpose)
GRID_FUNCTIONS = {"_cost", "save_cost", "recurrent_save_cost",
                  "restore_cost", "compressed_mib", "delta_mib",
                  "_ceil_div", "_saturate", "state_mib_of", "choose_tier",
                  "feasible", "eviction_save_cost", "restart_restore_cost",
                  "effective_save_lat", "tier_occupancy",
                  # the fused victim-select/placement kernel family charges
                  # the same grid (save costs, state_mib occupancy) — one
                  # float in the plan would break the backends' bit-equality
                  "plan_evictions_fused", "plan_evictions_ref",
                  "plan_evictions_batch_ref", "plan_evictions",
                  "greedy_place"}


# ---------------------------------------------------------------------------
# Context discovery
# ---------------------------------------------------------------------------


def _role(path: Path) -> Optional[str]:
    """``"models"`` for a module of a ``models/`` package, ``"ops"`` for a
    kernel's ``kernels/<name>/ops.py``; every function of either is a
    context."""
    parts = path.parts
    if "models" in parts[:-1]:
        return "models"
    if path.name == "ops.py" and len(parts) >= 3 and parts[-3] == "kernels":
        return "ops"
    return None


def _params(fn) -> List[ast.arg]:
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _anno(a: ast.arg) -> str:
    if a.annotation is None:
        return ""
    return ast.unparse(a.annotation)


def _tensor_like(fn) -> Set[str]:
    """Unannotated parameters the body uses as tensors."""
    names = {a.arg for a in _params(fn)
             if a.annotation is None and a.arg not in ("self", "cls")}
    out: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Attribute) and node.attr in TENSOR_USES
                and isinstance(node.value, ast.Name)
                and node.value.id in names):
            out.add(node.value.id)
    return out


def _tainted_params(fn, is_pass: bool = False) -> Set[str]:
    out = set()
    for a in _params(fn):
        anno = _anno(a)
        if (a.arg in TABLE_PARAMS or any(t in anno for t in TABLE_ANNOS)
                or "Tensor" in anno):
            out.add(a.arg)
        elif is_pass and a.arg in PASS_TENSOR_PARAMS:
            out.add(a.arg)
    return out | _tensor_like(fn)


def _has_table_param(fn) -> bool:
    return any(a.arg in TABLE_PARAMS
               or any(t in _anno(a) for t in TABLE_ANNOS)
               for a in _params(fn))


def _is_factory(fn) -> bool:
    return fn.name.startswith("make_") and fn.name.endswith("_pass")


def _find_contexts(sf: SourceFile) -> List[tuple]:
    """Top-level contexts as (fn_node, tainted_params).  Functions nested
    in a context are walked by it (inheriting its closure's taint)."""
    role = _role(sf.path)
    in_factory: Set[int] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                _is_factory(node):
            for sub in ast.walk(node):
                if sub is not node:
                    in_factory.add(id(sub))
    contexts = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        is_pass = id(node) in in_factory
        if role is not None or is_pass or _has_table_param(node):
            contexts.append((node, _tainted_params(node, is_pass)))
    ctx_ids = {id(c[0]) for c in contexts}
    nested: Set[int] = set()
    for fn, _ in contexts:
        for sub in ast.walk(fn):
            if sub is not fn and id(sub) in ctx_ids:
                nested.add(id(sub))
    return [(fn, t) for fn, t in contexts if id(fn) not in nested]


def _is_cpu_guard(e: ast.expr) -> bool:
    """``x.device.type == "cpu"``, ``x.device.type != "cuda"`` or ``not
    x.is_cuda``: the tensor lies on the host, so reading it syncs
    nothing."""
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
        return tail(e.operand) == "is_cuda"
    if (isinstance(e, ast.Compare) and len(e.ops) == 1
            and isinstance(e.comparators[0], ast.Constant)
            and dotted(e.left) and dotted(e.left).endswith(".device.type")):
        want = e.comparators[0].value
        return ((isinstance(e.ops[0], ast.Eq) and want == "cpu")
                or (isinstance(e.ops[0], ast.NotEq) and want == "cuda"))
    if isinstance(e, ast.BoolOp) and isinstance(e.op, ast.And):
        return any(_is_cpu_guard(v) for v in e.values)
    return False


# ---------------------------------------------------------------------------
# Taint propagation + sink detection within one context
# ---------------------------------------------------------------------------


class _Taint:
    def __init__(self, sf: SourceFile, tainted: Set[str],
                 out: List[Violation], host_fns: Set[str]):
        self.sf = sf
        self.tainted = set(tainted)
        self.out = out
        self.host_fns = host_fns
        self.returns: List[bool] = []

    # -- expression taint ---------------------------------------------------
    def _is_read(self, e: ast.Call) -> bool:
        """A call whose result a device read produced (host data)."""
        d = dotted(e.func)
        fn = tail(e.func)
        if isinstance(e.func, ast.Attribute) and fn in READ_METHODS:
            return True
        if isinstance(e.func, ast.Name) and fn in (
                HOST_CONVERSIONS | HOST_REDUCTIONS):
            return True
        return d == "torch.equal"

    def is_tainted(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in SHAPE_ATTRS:
                return False
            return self.is_tainted(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tainted(e.value) or self.is_tainted(e.slice)
        if isinstance(e, ast.Call):
            d = dotted(e.func) or ""
            fn = tail(e.func)
            if self._is_read(e) or d in LAUNDER_CALLS:
                return False
            if isinstance(e.func, ast.Attribute) and fn in SHAPE_METHODS:
                return False
            if isinstance(e.func, ast.Name) and (
                    fn in HOST_BUILTINS or fn in self.host_fns):
                return False
            if fn == "getattr" and len(e.args) == 3:
                return False             # a probe of an optional attribute
            if d in HOST_TORCH or d.startswith(HOST_TORCH_ROOTS):
                return False
            if d.startswith(TAINT_ROOTS):
                return True
            if self.is_tainted(e.func):
                return True
            return any(self.is_tainted(a) for a in e.args) or any(
                self.is_tainted(k.value) for k in e.keywords)
        if isinstance(e, ast.BinOp):
            return self.is_tainted(e.left) or self.is_tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tainted(e.operand)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False      # `x is None` is a host identity test
            if (all(isinstance(op, (ast.In, ast.NotIn)) for op in e.ops)
                    and isinstance(e.left, ast.Constant)):
                return False      # `"key" in cache` looks up a dict
            return self.is_tainted(e.left) or any(
                self.is_tainted(c) for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tainted(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tainted(e.body) or self.is_tainted(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.is_tainted(v) for v in e.values)
        if isinstance(e, ast.Starred):
            return self.is_tainted(e.value)
        return False

    # -- sinks --------------------------------------------------------------
    def _flag(self, node: ast.AST, msg: str):
        self.out.append(Violation(
            "host-read", str(self.sf.path), node.lineno,
            f"{msg} — a host read of a tensor (a device sync on the card) in "
            "a pass, a model or a launch wrapper; keep it on the device, or "
            "count it and suppress with the counter as reason"))

    def check_expr_sinks(self, e: ast.expr):
        guarded: Set[int] = set()
        for node in ast.walk(e):
            if id(node) in guarded or isinstance(node, ast.Lambda):
                continue
            if isinstance(node, ast.BoolOp):
                if isinstance(node.op, ast.And):
                    for i, v in enumerate(node.values):
                        if _is_cpu_guard(v):
                            # the operands after a CPU guard read the host
                            for rest in node.values[i + 1:]:
                                guarded.update(id(n) for n in ast.walk(rest))
                            break
                live = [v for v in node.values if id(v) not in guarded]
                if any(self.is_tainted(v) for v in live):
                    op = "and" if isinstance(node.op, ast.And) else "or"
                    self._flag(node, f"Python `{op}` over a tensor")
            elif isinstance(node, ast.Call):
                fn = tail(node.func)
                args_tainted = any(self.is_tainted(a) for a in node.args)
                if isinstance(node.func, ast.Name) and args_tainted and (
                        fn in HOST_CONVERSIONS or fn in HOST_REDUCTIONS):
                    self._flag(node, f"{fn}() of a tensor")
                elif (isinstance(node.func, ast.Attribute)
                      and fn in READ_METHODS
                      and self.is_tainted(node.func.value)):
                    self._flag(node, f".{fn}() of a tensor")
                elif (dotted(node.func) == "torch.equal"
                      and args_tainted):
                    self._flag(node, "torch.equal (a bool on the host)")
            elif (isinstance(node, ast.UnaryOp)
                  and isinstance(node.op, ast.Not)
                  and self.is_tainted(node.operand)):
                self._flag(node, "Python `not` on a tensor")
            elif isinstance(node, ast.IfExp) and self.is_tainted(node.test):
                self._flag(node, "a conditional expression on a tensor")

    # -- statement walk -----------------------------------------------------
    def _assign_names(self, target: ast.expr) -> List[str]:
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out = []
            for e in target.elts:
                out.extend(self._assign_names(e))
            return out
        if isinstance(target, ast.Starred):
            return self._assign_names(target.value)
        return []

    def _for_targets(self, target: ast.expr, it: ast.expr) -> List[str]:
        """The loop variables a tainted ``iter`` taints: position by
        position over a literal of equal-length tuples (``for name, t in
        (("q", q), ...)``), else all of them."""
        rows = it.elts if isinstance(it, (ast.Tuple, ast.List)) else None
        if (isinstance(target, ast.Tuple) and rows and all(
                isinstance(r, ast.Tuple) and len(r.elts) == len(target.elts)
                for r in rows)):
            out = []
            for k, tgt in enumerate(target.elts):
                if any(self.is_tainted(r.elts[k]) for r in rows):
                    out.extend(self._assign_names(tgt))
            return out
        return self._assign_names(target) if self.is_tainted(it) else []

    def run(self, body: List[ast.stmt]):
        # propagation passes to fixpoint (names assigned late in a loop body
        # taint earlier uses on the next iteration), then one checking pass
        for _ in range(4):
            before = set(self.tainted)
            self._walk(body, check=False)
            if self.tainted == before:
                break
        self._walk(body, check=True)

    def _walk(self, body: List[ast.stmt], check: bool):
        for stmt in body:
            self._stmt(stmt, check)

    def _stmt(self, stmt: ast.stmt, check: bool):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested function: its tensor parameters are tainted and its
            # body inherits the enclosing closure's taint
            sub = _Taint(self.sf, self.tainted | _tainted_params(stmt),
                         self.out if check else [], self.host_fns)
            sub._walk(stmt.body, check)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is None:
                return
            if check:
                self.check_expr_sinks(value)
            t = self.is_tainted(value)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for tgt in targets:
                for name in self._assign_names(tgt):
                    if t:
                        self.tainted.add(name)
                    elif not isinstance(stmt, ast.AugAssign):
                        self.tainted.discard(name)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            guard = isinstance(stmt, ast.If) and _is_cpu_guard(stmt.test)
            if check:
                if not guard and self.is_tainted(stmt.test):
                    kind = "if" if isinstance(stmt, ast.If) else "while"
                    self._flag(stmt, f"Python `{kind}` on a tensor")
                self.check_expr_sinks(stmt.test)
            # the body of a CPU guard reads host tensors: walk it for taint
            # only
            self._walk(stmt.body, check and not guard)
            self._walk(stmt.orelse, check)
            return
        if isinstance(stmt, ast.Assert):
            if check:
                if self.is_tainted(stmt.test):
                    self._flag(stmt, "Python `assert` on a tensor")
                self.check_expr_sinks(stmt.test)
            return
        if isinstance(stmt, ast.For):
            if check:
                self.check_expr_sinks(stmt.iter)
            for name in self._for_targets(stmt.target, stmt.iter):
                self.tainted.add(name)
            self._walk(stmt.body, check)
            self._walk(stmt.orelse, check)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                if check:
                    self.check_expr_sinks(stmt.value)
                self.returns.append(self.is_tainted(stmt.value))
            return
        if isinstance(stmt, ast.Expr):
            if check:
                self.check_expr_sinks(stmt.value)
            return
        if isinstance(stmt, ast.Raise):
            return                  # an error path reads nothing per call
        if isinstance(stmt, ast.With):
            if check:
                for item in stmt.items:
                    self.check_expr_sinks(item.context_expr)
            self._walk(stmt.body, check)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, check)
            for h in stmt.handlers:
                self._walk(h.body, check)
            self._walk(stmt.orelse, check)
            self._walk(stmt.finalbody, check)
            return


def _host_functions(sf: SourceFile) -> Set[str]:
    """Functions of the file whose every return is host data whatever
    their arguments (every parameter tainted): a call of one launders."""
    fns: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef):
            fns.setdefault(node.name, node)
    host: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, fn in fns.items():
            if name in host:
                continue
            probe = _Taint(sf, {a.arg for a in _params(fn)}, [], host)
            probe.run(fn.body)
            if probe.returns and not any(probe.returns):
                host.add(name)
                changed = True
    return host


@register(
    "host-read", "file",
    "no .item()/.tolist()/.cpu()/.numpy()/int()/bool()/torch.equal or "
    "Python control flow on a tensor inside a pass, a model or a launch "
    "wrapper, except the counted reads")
def check_host_read(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    contexts = _find_contexts(sf)
    if not contexts:
        return out
    host_fns = _host_functions(sf)
    for fn, tainted in contexts:
        _Taint(sf, tainted, out, host_fns).run(fn.body)
    # one finding per line and message
    seen, uniq = set(), []
    for v in out:
        if (v.line, v.message) not in seen:
            seen.add((v.line, v.message))
            uniq.append(v)
    return uniq


def _contains_float_or_div(expr: ast.expr) -> Optional[ast.AST]:
    for node in ast.walk(expr):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            return node
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            return node
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "float":
                return node
            if (tail(node.func) == "astype" and node.args
                    and "float" in str(dotted(node.args[0]) or "")):
                return node
        if isinstance(node, ast.Attribute) and node.attr in (
                "float32", "float64", "float16", "bfloat16"):
            return node
    return None


@register(
    "cost-grid", "file",
    "float literals / true division / float casts reaching the /256 "
    "integer cost grid (cost_* columns, CRCostModel evaluation)")
def check_cost_grid(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []

    def flag(node: ast.AST, where: str):
        out.append(Violation(
            "cost-grid", str(sf.path), node.lineno,
            f"float/true-division reaches the integer /256 cost grid "
            f"({where}) — use integer arithmetic "
            "(`(a + b - 1) // b` for ceil) so both backends stay "
            "bit-identical"))

    for node in ast.walk(sf.tree):
        # writes into grid-named columns/keywords (JobTable(...), _replace,
        # update_state_mib scatters, plain assignments)
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg in GRID_NAMES:
                    bad = _contains_float_or_div(kw.value)
                    if bad is not None:
                        flag(bad, f"keyword `{kw.arg}`")
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = {tail(t) for t in targets}
            hit = names & GRID_NAMES
            if hit and node.value is not None:
                bad = _contains_float_or_div(node.value)
                if bad is not None:
                    flag(bad, f"assignment to `{sorted(hit)[0]}`")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in GRID_FUNCTIONS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.BinOp) and isinstance(
                            sub.op, ast.Div):
                        flag(sub, f"cost function `{node.name}`")
                    elif isinstance(sub, ast.Constant) and isinstance(
                            sub.value, float):
                        flag(sub, f"cost function `{node.name}`")
    return out


@register("mutable-default", "file",
          "mutable default argument shared across calls")
def check_mutable_default(sf: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    mutable_calls = {"list", "dict", "set", "OrderedDict", "defaultdict"}
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            continue
        for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and tail(default.func) in mutable_calls)
            if bad:
                name = getattr(node, "name", "<lambda>")
                out.append(Violation(
                    "mutable-default", str(sf.path), default.lineno,
                    f"mutable default argument in `{name}` is shared across "
                    "calls — default to None and construct inside"))
    return out
