"""AST rules over ``src/repro_torch`` (layer 1 of the analyzer; torch
twin of ``repro.analysis.astlint``).

Rules (catalog in ``repro_torch.analysis.RULES``):

* **SPL001** — functions reachable from the step closures must not
  perform host side effects: ``print``, ``time.*``, ``logging``, or obs
  registry/tracer calls. The engines and the fixed-batch decode capture
  those closures as CUDA graphs (``launch/graphs.py``): a host effect
  runs once at capture and never at replay. Instrumentation brackets the
  compiled calls, it never runs inside them.
* **SPL002** — host-only modules (``serving/scheduler.py``,
  ``serving/kv_pool.py``, ``obs/``) must not launch device ops
  (``torch.<op>`` calls or references, ``.to(...)``, ``.cuda(...)``).
  Scheduler and pool bookkeeping stays host work.
* **SPL003** — host syncs inside step-reachable code: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``; ``float()/int()/bool()`` of a
  tensor expression; Python ``if``/``while`` tests on one; and the ops
  whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``). Each breaks a capture or freezes a
  host value into the graph.
* **SPL004** — metric registration discipline, the reference's rule
  unchanged: every literal name passed to ``.counter()/.gauge()/
  .histogram()`` must match the registry's naming rule, counters must
  end in ``_total``, and the name must be cataloged in
  ``docs/observability.md``.

Roots: the nested defs of the ``make_*`` factories in
``launch/steps.py`` (the closures the engines compile) and any function
passed by name to ``CompiledStep(...)``. The call graph is the
reference's light one: same-module calls by name, cross-module calls
through ``import``/``from`` aliases, plus any known function
*referenced* as a call argument. Method calls on objects are not
followed, so a train-loop method such as ``TrainMesh.any`` is reached
from no root.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding

METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

HOST_ONLY = ("serving/scheduler.py", "serving/kv_pool.py", "obs/")

# obs-object names whose method calls are host side effects
_OBS_NAMES = {"obs", "registry", "tracer"}
# method names that are registry mutations wherever they appear
_OBS_METHODS = {"inc", "observe"}
_TIME_FNS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
             "monotonic_ns", "sleep", "process_time"}
_LOG_NAMES = {"log", "logger", "_log", "_logger", "LOG", "LOGGER"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "exception",
                "critical", "log"}

# torch.<sub>.* namespaces that hold no tensor op
_TORCH_HOST_SUBMODULES = {
    "autograd", "backends", "compiler", "distributed", "fx", "hub", "jit",
    "library", "multiprocessing", "onnx", "overrides", "profiler",
    "testing", "utils", "_dynamo", "_C", "types", "version"}
# torch.<name> (and torch.cuda.<name>) that are types, context managers
# or host queries (and every is_*), not device ops
_TORCH_HOST_NAMES = {
    "Tensor", "Size", "dtype", "device", "Generator", "finfo", "iinfo",
    "no_grad", "enable_grad", "inference_mode", "set_grad_enabled",
    "get_default_dtype", "set_default_dtype", "promote_types",
    "result_type", "can_cast", "manual_seed", "set_printoptions",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "device_count", "current_device", "get_device_name",
    "get_device_properties", "memory_format", "contiguous_format",
    "channels_last", "strided", "layout", "Stream", "cuda", "nn",
    "functional", "float8_e4m3fn", "float8_e5m2"}
_DTYPE_RE = re.compile(r"^(u?int\d+|float\d*|bfloat16|bool|half|double|"
                       r"long|short|int|cfloat|cdouble|complex\d+|qu?int\d+)$")
# methods that return a tensor reduced to few elements: float()/int()/
# bool() or a branch on one reads the device
_REDUCTIONS = {"sum", "max", "min", "any", "all", "amax", "amin", "mean",
               "prod", "norm", "count_nonzero", "argmax", "argmin"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DATA_SHAPE_OPS = {"nonzero", "masked_select", "unique",
                   "unique_consecutive", "argwhere"}


@dataclass
class FuncInfo:
    module: str            # dotted module name, e.g. "repro_torch.kernels.ops"
    path: str              # path relative to the source root
    qualname: str          # e.g. "make_engine_decode.engine_decode"
    node: ast.FunctionDef
    is_root: bool = False
    calls: Set[Tuple[str, str]] = field(default_factory=set)  # (mod, name)


@dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    # alias -> dotted module ("F" -> "torch.nn.functional")
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    # local name -> (source module, symbol) for `from x import y`
    sym_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    functions: Dict[str, FuncInfo] = field(default_factory=dict)


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """`a.b.c` -> ["a", "b", "c"]; None for non-name-rooted chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _dotted(mi: ModuleInfo, chain: List[str]) -> str:
    """The chain with its root alias resolved: ``F.pad`` ->
    ``torch.nn.functional.pad``."""
    return ".".join([mi.mod_aliases.get(chain[0], chain[0])] + chain[1:])


def _is_torch_op(mi: ModuleInfo, chain: List[str]) -> bool:
    """True for a chain naming a torch tensor op: ``torch.zeros``,
    ``F.pad``, ``torch.cuda.synchronize``; False for dtypes, types,
    context managers and host-side namespaces."""
    parts = _dotted(mi, chain).split(".")
    if parts[0] != "torch" or len(parts) < 2:
        return False
    if parts[1] in _TORCH_HOST_SUBMODULES:
        return False
    last = parts[-1]
    return last not in _TORCH_HOST_NAMES and not last.startswith("is_") \
        and not _DTYPE_RE.match(last)


class _Repo:
    """Parsed view of every module of one package under a source root."""

    def __init__(self, src_root: str, package: Optional[str] = None):
        self.src_root = src_root
        self.modules: Dict[str, ModuleInfo] = {}
        top = os.path.join(src_root, package) if package else src_root
        for dirpath, _, names in sorted(os.walk(top)):
            if "__pycache__" in dirpath:
                continue
            for fn in sorted(names):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, src_root)
                dotted = rel[:-3].replace(os.sep, ".")
                if dotted.endswith(".__init__"):
                    dotted = dotted[: -len(".__init__")]
                with open(path) as f:
                    tree = ast.parse(f.read(), filename=path)
                self.modules[dotted] = ModuleInfo(dotted, rel, tree)
        for mi in self.modules.values():
            self._index_module(mi)
        for mi in self.modules.values():
            for fi in mi.functions.values():
                self._collect_calls(mi, fi)

    # -- indexing ----------------------------------------------------
    def _index_module(self, mi: ModuleInfo) -> None:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        mi.mod_aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        mi.mod_aliases[top] = top
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if full in self.modules or a.name == "*" or \
                            node.module.split(".")[0] == "torch":
                        mi.mod_aliases[a.asname or a.name] = full
                    else:
                        mi.sym_imports[a.asname or a.name] = \
                            (node.module, a.name)

        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    mi.functions[q] = FuncInfo(mi.name, mi.path, q, child)
                    visit(child, q)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}.{child.name}"
                          if prefix else child.name)
                else:
                    visit(child, prefix)

        visit(mi.tree, "")
        self._mark_roots(mi)

    def _mark_roots(self, mi: ModuleInfo) -> None:
        # (a) nested defs inside make_* factories in launch/steps.py —
        # the step closures the engines and the fixed-batch decode
        # compile (the reference's rule (b))
        if mi.name.endswith("launch.steps"):
            for q, fi in mi.functions.items():
                parts = q.split(".")
                if len(parts) > 1 and parts[0].startswith("make_"):
                    fi.is_root = True
        # (b) functions passed by name to CompiledStep(...)
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain is None or chain[-1] != "CompiledStep":
                continue
            targets = list(node.args[:1]) + [k.value for k in node.keywords
                                              if k.arg == "fn"]
            for target in targets:
                if isinstance(target, ast.Call):   # partial(step, ...)
                    target = target.args[0] if target.args else target
                tchain = _attr_chain(target)
                if tchain and len(tchain) == 1:
                    for q, fi in mi.functions.items():
                        if q.split(".")[-1] == tchain[0]:
                            fi.is_root = True

    def _resolve(self, mi: ModuleInfo, fi: FuncInfo,
                 name: str) -> Optional[Tuple[str, str]]:
        # innermost enclosing scope first: sibling/nested defs, then
        # module-level defs, then from-imports
        parts = fi.qualname.split(".")
        for depth in range(len(parts), -1, -1):
            q = ".".join(parts[:depth] + [name])
            if q in mi.functions:
                return (mi.name, q)
        if name in mi.sym_imports:
            smod, sym = mi.sym_imports[name]
            if smod in self.modules and sym in self.modules[smod].functions:
                return (smod, sym)
        return None

    def _collect_calls(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            # direct calls: f(...) / mod.f(...)
            if isinstance(node.func, ast.Name):
                tgt = self._resolve(mi, fi, node.func.id)
                if tgt:
                    fi.calls.add(tgt)
            else:
                chain = _attr_chain(node.func)
                if chain and len(chain) == 2 and \
                        chain[0] in mi.mod_aliases:
                    smod = mi.mod_aliases[chain[0]]
                    if smod in self.modules and \
                            chain[1] in self.modules[smod].functions:
                        fi.calls.add((smod, chain[1]))
            # higher-order: any known function referenced as an argument
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name):
                    tgt = self._resolve(mi, fi, arg.id)
                    if tgt:
                        fi.calls.add(tgt)

    def reachable_from_roots(self) -> Set[Tuple[str, str]]:
        seen: Set[Tuple[str, str]] = set()
        frontier = [(mi.name, q) for mi in self.modules.values()
                    for q, fi in mi.functions.items() if fi.is_root]
        seen.update(frontier)
        while frontier:
            mod, q = frontier.pop()
            fi = self.modules[mod].functions[q]
            for tgt in fi.calls:
                if tgt not in seen:
                    seen.add(tgt)
                    frontier.append(tgt)
        return seen


# ---------------------------------------------------------------- rules

def _tensor_expr(mi: ModuleInfo, node: ast.AST) -> Optional[str]:
    """The name of a call in ``node`` that yields a tensor — a torch op
    or a reduction method — or None."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = _attr_chain(sub.func)
        if chain and _is_torch_op(mi, chain):
            return ".".join(chain)
        if isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in _REDUCTIONS:
            return f".{sub.func.attr}()"
    return None


def _check_spl001(repo: _Repo, reachable: Set[Tuple[str, str]],
                  out: List[Finding]) -> None:
    for mod, q in sorted(reachable):
        mi = repo.modules[mod]
        fi = mi.functions[q]
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            msg = None
            if isinstance(node.func, ast.Name):
                if node.func.id == "print":
                    msg = "print() call in captured code"
                elif node.func.id in _TIME_FNS and \
                        node.func.id in mi.sym_imports and \
                        mi.sym_imports[node.func.id][0] == "time":
                    msg = f"time.{node.func.id}() call in captured code"
            else:
                chain = _attr_chain(node.func)
                if chain:
                    root = mi.mod_aliases.get(chain[0], chain[0])
                    if root == "time" and chain[-1] in _TIME_FNS:
                        msg = f"time.{chain[-1]}() call in captured code"
                    elif root == "logging" or (
                            chain[0] in _LOG_NAMES and len(chain) == 2
                            and chain[-1] in _LOG_METHODS):
                        msg = (f"logging call {'.'.join(chain)}() in "
                               "captured code")
                    elif any(p in _OBS_NAMES for p in chain[:-1]):
                        msg = (f"obs call {'.'.join(chain)}() in captured "
                               "code (instrumentation must stay host-side)")
                    elif chain[-1] in _OBS_METHODS:
                        msg = (f"metric mutation .{chain[-1]}() in captured "
                               "code")
            if msg:
                out.append(Finding(
                    "SPL001", f"{fi.path}::{q}",
                    f"{fi.path}:{node.lineno}", f"{msg} (in `{q}`)"))


def _enclosing(mi: ModuleInfo, lineno: int) -> str:
    best = ""
    for q, fi in mi.functions.items():
        n = fi.node
        if n.lineno <= lineno <= (n.end_lineno or n.lineno) and \
                len(q) > len(best):
            best = q
    return best or "<module>"


def _check_spl002(repo: _Repo, out: List[Finding]) -> None:
    for mi in repo.modules.values():
        if not any(mi.path.startswith(p) or f"/{p}" in f"/{mi.path}"
                   for p in HOST_ONLY):
            continue
        for node in ast.walk(mi.tree):
            what = None
            if isinstance(node, ast.Attribute) and \
                    not isinstance(getattr(node, "_parent", None),
                                   ast.Attribute):
                chain = _attr_chain(node)
                if chain and _is_torch_op(mi, chain):
                    what = f"device op {'.'.join(chain)}"
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("to", "cuda"):
                what = f"device transfer .{node.func.attr}()"
            if what:
                fn = _enclosing(mi, node.lineno)
                out.append(Finding(
                    "SPL002", f"{mi.path}::{fn}",
                    f"{mi.path}:{node.lineno}",
                    f"{what} in host-only module (in `{fn}`)"))


def _check_spl003(repo: _Repo, reachable: Set[Tuple[str, str]],
                  out: List[Finding]) -> None:
    for mod, q in sorted(reachable):
        mi = repo.modules[mod]
        fi = mi.functions[q]
        for node in ast.walk(fi.node):
            msg = None
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _SYNC_METHODS and not node.args:
                    msg = (f".{node.func.attr}() reads a device value on "
                           "the host")
                elif isinstance(node.func, ast.Name) and \
                        node.func.id in ("float", "int", "bool") and \
                        node.args and _tensor_expr(mi, node.args[0]):
                    msg = (f"{node.func.id}() of a tensor expression "
                           f"({_tensor_expr(mi, node.args[0])}) reads it "
                           "on the host")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _DATA_SHAPE_OPS and \
                        mi.mod_aliases.get(chain[0] if chain else "",
                                           "torch").startswith("torch"):
                    # torch.unique(x) or x.unique(), not np.unique(x)
                    msg = (f"{node.func.attr}() has a data-dependent "
                           "output shape")
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                name = _tensor_expr(mi, node.test)
                if name:
                    msg = f"Python control flow on a tensor ({name}(...))"
            if msg:
                out.append(Finding(
                    "SPL003", f"{fi.path}::{q}",
                    f"{fi.path}:{node.lineno}", f"{msg} (in `{q}`)"))


def _check_spl004(repo: _Repo, docs_path: str,
                  out: List[Finding]) -> None:
    docs = ""
    if os.path.exists(docs_path):
        with open(docs_path) as f:
            docs = f.read()
    for mi in repo.modules.values():
        if mi.name.endswith("obs.metrics") or mi.name.endswith(".obs"):
            # the registry implementation itself (its internal helper
            # calls are not registrations); other obs/ modules
            # (attribution, slo, ...) register real metrics and must
            # catalog them like everyone else
            continue
        for node in ast.walk(mi.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge", "histogram")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            prov = f"{mi.path}:{node.lineno}"
            key = f"{mi.path}::{name}"
            if not METRIC_NAME_RE.match(name):
                out.append(Finding(
                    "SPL004", key, prov,
                    f"metric name `{name}` violates ^[a-z][a-z0-9_]*$"))
            if node.func.attr == "counter" and \
                    not name.endswith("_total"):
                out.append(Finding(
                    "SPL004", key, prov,
                    f"counter `{name}` should end in `_total`"))
            if docs and f"`{name}`" not in docs:
                out.append(Finding(
                    "SPL004", key, prov,
                    f"metric `{name}` is not cataloged in "
                    "docs/observability.md"))


def _mark_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._parent = node


def run(src_root: str, docs_path: str = "",
        package: Optional[str] = "repro_torch") -> List[Finding]:
    """Run all AST rules over ``package`` under ``src_root`` (the whole
    root with ``package=None``). Returns raw findings — allowlist
    application happens in the caller."""
    repo = _Repo(src_root, package)
    for mi in repo.modules.values():
        _mark_parents(mi.tree)
    reachable = repo.reachable_from_roots()
    out: List[Finding] = []
    _check_spl001(repo, reachable, out)
    _check_spl002(repo, out)
    _check_spl003(repo, reachable, out)
    _check_spl004(repo, docs_path, out)
    return out
