"""The framework-aware checkers (+ chart/values cross-check), the port
of ``eksml_tpu/analysis/checkers.py`` reading PyTorch's idioms.

Each checker encodes an invariant of this codebase.  They are
deliberately *framework-aware*: the patterns key off the port's idioms —
``cfg.update_args`` as the override point, ``torch.utils.checkpoint``
and ``torch.autograd.Function`` as the code autograd runs again,
``signal.signal`` registration, the write-then-``os.replace`` artifact
idiom (``fsio.atomic_write_text``), and the ``named_scope`` ↔
``SCOPE_RULES`` contract.

``jit-purity`` and ``signal-safety`` run on the whole-program
cross-module call graph (:mod:`eksml_tpu_torch.analysis.graph` —
import-alias resolution, ``__init__.py`` re-exports, relative imports),
so an impure helper one import away is inside the checked set.  The
four SPMD-safety rules (:mod:`eksml_tpu_torch.analysis.spmd`) and the
three thread-topology rules (:mod:`eksml_tpu_torch.analysis.concurrency`)
ride the same graph.  The remaining rules stay per-module/per-project
where the pattern and its hazard share a file.
"""

from __future__ import annotations

import ast
import importlib.util
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from eksml_tpu_torch.analysis.concurrency import (
    CONCURRENCY_RULES, build_concurrency_checkers)
from eksml_tpu_torch.analysis.engine import Finding, ModuleInfo
from eksml_tpu_torch.analysis.graph import (FuncInfo, ProjectGraph,
                                            chain_of as _chain, children,
                                            unparse as _unparse, walk)
from eksml_tpu_torch.analysis.spmd import SPMD_RULES, build_spmd_checkers

RULE_JIT = "jit-purity"
RULE_DRIFT = "config-drift"
RULE_SIGNAL = "signal-safety"
RULE_ATOMIC = "atomic-write"
RULE_SCOPE = "scope-coverage"
RULE_VALUES = "values-config-sync"

ALL_RULES = (RULE_JIT, RULE_DRIFT, RULE_SIGNAL, RULE_ATOMIC,
             RULE_SCOPE, RULE_VALUES) + SPMD_RULES + CONCURRENCY_RULES


# -- 1. jit-purity ----------------------------------------------------

#: os helpers that touch the filesystem — host I/O in recomputed code.
_OS_IO = ("replace", "remove", "rename", "makedirs", "unlink", "rmdir",
          "mkdir", "symlink")
_ENV_MUTATORS = ("update", "setdefault", "pop", "clear", "popitem")
#: Canonical names of activation checkpointing (REMAT).
_CHECKPOINT_CALLS = ("torch.utils.checkpoint.checkpoint",
                     "torch.utils.checkpoint.checkpoint_sequential")


def _is_autograd_function(graph: ProjectGraph, path: str,
                          cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        canon = graph.canonical(path, base) or ""
        if canon.endswith("autograd.Function") \
                or canon.endswith("autograd.function.Function"):
            return True
    return False


class JitPurityChecker:
    """What autograd runs twice must be pure.

    The port has no ``jit``; its counterpart is the code autograd runs
    again: a callable passed to ``torch.utils.checkpoint.checkpoint``
    (REMAT, ``models/mask_rcnn.py``) is run once in the forward and
    again in the backward's recompute, and a ``torch.autograd.Function``
    subclass's ``forward``/``backward`` (the ROIAlign function) is
    autograd's own code path.  A ``time.*`` read, a host RNG draw
    (``numpy.random``, ``random``; torch's own RNG state is restored by
    the checkpoint), an ``os.environ`` mutation, or host I/O there gives
    a recompute that differs from its forward, or a side effect done
    twice.  The rule keeps the reference's name so suppressions and
    ``--rules`` read the same in both packages.

    Reachability runs on the cross-module graph, and impurity
    classification resolves import aliases through
    :meth:`ProjectGraph.canonical`, so ``import numpy.random as nr``
    cannot hide a draw; messages keep the raw source spelling.  A
    ``checkpoint(recomputed(self.backbone), x)`` target is unwrapped to
    ``self.backbone``, and ``self.<attr>`` assigned from a project
    class in the same class resolves to that class's ``forward``.
    """

    rule = RULE_JIT

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        reported: set = set()  # (node id, what) — two roots reaching
        for path, mod in graph.mods.items():  # one helper → one report
            roots: List[Tuple[str, FuncInfo]] = []
            for node in walk(mod.tree):
                if isinstance(node, ast.ClassDef) \
                        and _is_autograd_function(graph, path, node):
                    for meth in ("forward", "backward"):
                        fi = graph.class_method(path, node.name, meth)
                        if fi is not None:
                            roots.append((f"{node.name}.{meth}", fi))
                elif isinstance(node, ast.Call) and (
                        graph.canonical(path, node.func)
                        in _CHECKPOINT_CALLS):
                    roots.extend(self._call_roots(graph, path, node))
            for root_name, root in roots:
                for fi, _chain_to in graph.reachable([root]).values():
                    findings.extend(self._scan(graph, fi, root_name,
                                               reported))
        return findings

    @staticmethod
    def _call_roots(graph: ProjectGraph, path: str, node: ast.Call
                    ) -> List[Tuple[str, FuncInfo]]:
        if not node.args:
            return []
        target = node.args[0]
        # checkpoint(recomputed(fn), ...), checkpoint(partial(fn, a), ...)
        while isinstance(target, ast.Call) and target.args:
            target = target.args[0]
        if isinstance(target, ast.Lambda):
            return [("<lambda>", FuncInfo(path, "<lambda>", target))]
        name = None
        if isinstance(target, ast.Name):
            name = target.id
        elif isinstance(target, ast.Attribute):
            name = target.attr      # checkpoint(self._block, ...)
        if name is None:
            return []
        fis = graph.resolve_name_ref(path, name)
        if not fis and isinstance(target, ast.Attribute):
            fis = JitPurityChecker._module_forward(graph, path, node,
                                                   target)
        return [(name, fi) for fi in fis]

    @staticmethod
    def _module_forward(graph: ProjectGraph, path: str, call: ast.Call,
                        target: ast.Attribute) -> List[FuncInfo]:
        """``self.<attr>`` → ``forward`` of the project class the
        enclosing class assigns to ``self.<attr>``."""
        if _chain(target) != ("self", target.attr):
            return []
        for cls in walk(graph.mods[path].tree):
            if not isinstance(cls, ast.ClassDef) or not any(
                    n is call for n in walk(cls)):
                continue
            for n in walk(cls):
                if not (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)
                        and any(_chain(t) == ("self", target.attr)
                                for t in n.targets)):
                    continue
                c = _chain(n.value.func)
                r = (graph.resolve_symbol(path, c[0])
                     if c and len(c) == 1 else None)
                if r is not None and r[0] == "class":
                    fi = graph.class_method(r[1][0], r[1][1], "forward")
                    if fi is not None:
                        return [fi]
        return []

    def _scan(self, graph: ProjectGraph, fi: FuncInfo, root: str,
              reported: set) -> List[Finding]:
        out: List[Finding] = []
        mod = graph.mods.get(fi.path)

        def flag(node: ast.AST, what: str) -> None:
            if (id(node), what) in reported or mod is None:
                return
            reported.add((id(node), what))
            out.append(mod.finding(
                self.rule, node.lineno,
                f"{what} inside code reachable from '{root}', which "
                "autograd runs again (a torch.utils.checkpoint recompute "
                "or an autograd.Function's forward/backward) — the "
                "recompute differs from its forward or the side effect "
                "happens twice; hoist it out of the recomputed code"))

        for node in walk(fi.node):
            if isinstance(node, ast.Call):
                c = _chain(node.func)
                if c is None:
                    continue
                disp = ".".join(c)
                canon = graph.canonical(fi.path, node.func) or disp
                cc = tuple(canon.split("."))
                if cc[0] == "time" and len(cc) == 2:
                    flag(node, f"wall-clock read {disp}()")
                elif cc[0] in ("np", "numpy") and len(cc) >= 2 \
                        and cc[1] == "random":
                    flag(node, f"host RNG {disp}()")
                elif cc[0] == "random" and len(cc) == 2:
                    flag(node, f"host RNG {disp}()")
                elif cc[:2] == ("os", "environ") and len(cc) == 3 \
                        and cc[2] in _ENV_MUTATORS:
                    flag(node, f"os.environ mutation .{cc[2]}()")
                elif cc in (("os", "putenv"), ("os", "unsetenv")):
                    flag(node, f"{disp}() env mutation")
                elif cc[0] == "os" and len(cc) == 2 \
                        and cc[1] in _OS_IO:
                    flag(node, f"host I/O {disp}()")
                elif cc[0] == "shutil":
                    flag(node, f"host I/O {disp}()")
                elif cc in (("open",), ("print",)):
                    flag(node, f"host I/O {cc[0]}()")
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.Delete)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [getattr(node, "target", None)]
                           if not isinstance(node, ast.Delete)
                           else node.targets)
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and _chain(t.value) == ("os", "environ"):
                        flag(node, "os.environ[...] mutation")
        return out


# -- 2. config-drift --------------------------------------------------

_CFG_ROOTS = ("cfg", "config", "_C")


def _is_cfg_root(name: str) -> bool:
    return name in _CFG_ROOTS or "cfg" in name.lower()


def _args_reads(node: ast.AST) -> List[Tuple[str, int]]:
    """[(attr, lineno)] for every ``args.X`` load / getattr(args, "X")
    in *node*'s subtree (stores excluded)."""
    out = []
    for n in walk(node):
        if (isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name)
                and n.value.id == "args"
                and isinstance(n.ctx, ast.Load)):
            out.append((n.attr, n.lineno))
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
              and n.func.id == "getattr" and len(n.args) >= 2
              and isinstance(n.args[0], ast.Name)
              and n.args[0].id == "args"
              and isinstance(n.args[1], ast.Constant)
              and isinstance(n.args[1].value, str)):
            out.append((n.args[1].value, n.lineno))
    return out


class ConfigDriftChecker:
    """No ``args.X`` reads after ``--config`` overrides land.

    When a function copies ``args.X`` into the config tree and then
    applies ``cfg.update_args(args.config)``, the config — not the
    argparse namespace — is the source of truth: a ``--config``
    override may have shadowed the flag (a benchmark that measures the
    replicated path while its record claims fsdp, or prices the wrong
    peak-flops row).  Re-read the ``cfg.*`` path instead.
    """

    rule = RULE_DRIFT

    def check(self, mod: ModuleInfo) -> List[Finding]:
        findings: List[Finding] = []
        if "update_args" not in mod.source \
                and "apply_overrides" not in mod.source:
            return findings     # no override point: nothing can drift
        for fn in walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_fn(mod, fn))
        return findings

    def _check_fn(self, mod: ModuleInfo, fn: ast.AST) -> List[Finding]:
        shadow: Dict[str, Tuple[int, str]] = {}
        override_line = None
        for node in walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    c = _chain(t) if isinstance(t, ast.Attribute) else None
                    if c and _is_cfg_root(c[0]):
                        for attr, _ in _args_reads(node.value):
                            if attr not in shadow:
                                shadow[attr] = (node.lineno,
                                                _unparse(t))
            elif isinstance(node, ast.Call):
                c = _chain(node.func)
                if c and ((c[-1] == "update_args"
                           and len(c) >= 2 and _is_cfg_root(c[0]))
                          or c[-1] == "apply_overrides"):
                    if override_line is None \
                            or node.lineno < override_line:
                        override_line = node.lineno
        if override_line is None or not shadow:
            return []
        out = []
        for attr, lineno in _args_reads(fn):
            if attr in shadow and lineno > override_line:
                copy_line, cfg_path = shadow[attr]
                out.append(mod.finding(
                    self.rule, lineno,
                    f"args.{attr} read after --config overrides "
                    f"landed (line {override_line}); line {copy_line} "
                    f"copied it into {cfg_path}, so an override may "
                    f"have shadowed the flag — read {cfg_path} "
                    "instead"))
        return out


# -- 3. signal-safety -------------------------------------------------

_LOG_ROOTS = ("log", "logger", "logging")
_TELEMETRY_ROOTS = ("telemetry", "recorder", "registry", "metrics")
_METRIC_OPS = ("inc", "dec", "observe", "event", "add_event")


class SignalSafetyChecker:
    """``signal.signal`` handlers must be flag-only.

    A handler runs between bytecodes ON the interrupted main thread.
    Anything that takes a lock the interrupted code may already hold —
    the telemetry registry/recorder, the logging module, an explicit
    ``.acquire()`` — deadlocks before the flag is set and the forced
    checkpoint never happens (a SIGTERM deadlock).  Set a flag;
    publish at the next step boundary.
    """

    rule = RULE_SIGNAL

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        reported: set = set()  # node ids — one handler registered for
        for path, mod in graph.mods.items():  # N signals reports once
            for node in walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and _chain(node.func) == ("signal", "signal")
                        and len(node.args) >= 2):
                    continue
                handler = node.args[1]
                roots: List[FuncInfo] = []
                if isinstance(handler, ast.Lambda):
                    roots = [FuncInfo(path, "<lambda>", handler)]
                else:
                    name = None
                    if isinstance(handler, ast.Name):
                        name = handler.id
                    elif isinstance(handler, ast.Attribute):
                        name = handler.attr
                    if name is not None:
                        roots = graph.resolve_name_ref(path, name)
                    # unresolved (restoring a saved previous handler,
                    # signal.SIG_DFL/SIG_IGN) — nothing to check
                for root in roots:
                    root_name = root.name
                    # cross-module walk: a handler calling an imported
                    # publish helper is checked through the import
                    for fi, _c in graph.reachable([root]).values():
                        findings.extend(self._scan(graph, fi,
                                                   root_name,
                                                   reported))
        return findings

    def _scan(self, graph: ProjectGraph, fi: FuncInfo, root: str,
              reported: set) -> List[Finding]:
        out: List[Finding] = []
        mod = graph.mods.get(fi.path)
        if mod is None:
            return out
        fn = fi.node

        def flag(node: ast.AST, what: str) -> None:
            if (id(node), what) in reported:
                return
            reported.add((id(node), what))
            out.append(mod.finding(
                self.rule, node.lineno,
                f"{what} in signal handler '{root}' call graph — "
                "handlers run between bytecodes on the interrupted "
                "thread and deadlock on any lock it already holds; "
                "set a flag and publish at the next step boundary"))

        for node in walk(fn):
            if isinstance(node, ast.Call):
                c = _chain(node.func)
                if c is None:
                    # chained call results (registry.counter(...).inc())
                    # have no Name root; the method name still tells
                    if isinstance(node.func, ast.Attribute):
                        attr = node.func.attr
                        if attr in _METRIC_OPS:
                            flag(node, f"telemetry call .{attr}()")
                        elif attr == "acquire":
                            flag(node, f"lock acquisition .{attr}()")
                    continue
                if c[0] in _LOG_ROOTS and len(c) >= 2:
                    flag(node, f"logging call {'.'.join(c)}()")
                elif c[-1] == "acquire":
                    flag(node, f"lock acquisition {'.'.join(c)}()")
                elif c[-1] in _METRIC_OPS and len(c) >= 2:
                    # receiver required: a bare Name call resolves
                    # through the call graph instead, so a local
                    # helper named event()/inc() is judged by what
                    # it actually does, not by its name
                    flag(node, f"telemetry call {'.'.join(c)}()")
                elif c[0] in _TELEMETRY_ROOTS and len(c) >= 2:
                    flag(node, f"telemetry call {'.'.join(c)}()")
                elif c == ("open",) or c == ("print",):
                    flag(node, f"host I/O {c[0]}() ")
            elif isinstance(node, ast.With):
                for item in node.items:
                    src = _unparse(item.context_expr).lower()
                    if "lock" in src or "condition" in src:
                        flag(node, f"lock acquisition "
                                   f"'with {_unparse(item.context_expr)}'")
        return out


# -- 4. atomic-write --------------------------------------------------

class AtomicWriteChecker:
    """Artifact writes must be write-then-``os.replace``.

    A plain ``open(path, "w")`` truncates in place: a concurrent
    reader (bench_gate tailing a bank, a scraper polling a port file,
    a resumed run loading a baseline) sees an empty or torn file, and
    a crash mid-write destroys the previous good artifact.  Write to
    a temp name in the same directory, then ``os.replace(tmp, path)``
    — atomic on POSIX.  Append-mode streams (``"a"``) are exempt: the
    jsonl mirror idiom is line-buffered appends.
    """

    rule = RULE_ATOMIC

    def check(self, mod: ModuleInfo) -> List[Finding]:
        # innermost enclosing function per node (ast.walk is outer-
        # first, so nested defs overwrite their own nodes' owner);
        # None = module level.  The compliance window for an open() is
        # its own scope: the tmp-write and the os.replace of the same
        # expression belong together.
        owner: Dict[int, ast.AST] = {}

        def own(node: ast.AST, fn: Optional[ast.AST]) -> None:
            for child in children(node):
                if fn is not None:
                    owner[id(child)] = fn
                own(child, child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else fn)

        own(mod.tree, None)

        opens: List[Tuple[ast.Call, Optional[ast.AST]]] = []
        replaced: Dict[Optional[int], set] = {}
        for node in walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            c = _chain(node.func)
            scope = owner.get(id(node))
            if c == ("open",) and self._write_mode(node):
                opens.append((node, scope))
            elif c in (("os", "replace"), ("os", "rename"),
                       ("shutil", "move")) and node.args:
                replaced.setdefault(
                    id(scope) if scope else None,
                    set()).add(_unparse(node.args[0]))

        out = []
        for node, scope in opens:
            path_src = _unparse(node.args[0]) if node.args else "?"
            scope_replaced = replaced.get(
                id(scope) if scope else None, set())
            if path_src in scope_replaced:
                continue
            if "devnull" in path_src or "/dev/null" in path_src:
                continue
            out.append(mod.finding(
                self.rule, node.lineno,
                f"open({path_src}, 'w') without write-then-os.replace"
                " — a concurrent reader sees a torn/empty artifact "
                "and a crash mid-write destroys the previous good "
                "one; write to a '.tmp' sibling and os.replace it"))
        return out

    @staticmethod
    def _write_mode(node: ast.Call) -> bool:
        mode = None
        if len(node.args) >= 2 and isinstance(node.args[1],
                                              ast.Constant):
            mode = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        return isinstance(mode, str) and mode.startswith("w")


# -- 5. scope-coverage ------------------------------------------------

_SCOPE_DIRS = ("eksml_tpu_torch/models/", "eksml_tpu_torch/ops/")
_SCOPE_FILES = ("eksml_tpu_torch/train.py",)
_ATTRIBUTION = "eksml_tpu_torch/profiling/attribution.py"
#: the scope helpers: the port's ``profiling.scopes.named_scope`` and
#: ``torch.profiler.record_function`` (what it opens)
_SCOPE_CALLS = ("named_scope", "record_function")


def _load_file(name: str, path: str):
    """A module from its file, without importing its package (the
    attribution rules and the chart renderer import only the standard
    library and yaml; their packages' ``__init__`` imports torch)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _literal_name(node: ast.AST) -> Optional[str]:
    """Constant str, or an f-string with formatted parts → "0" (so
    ``f"cascade{i}"`` matches the ``cascade\\d*`` rule pattern)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("0")
        return "".join(parts)
    return None


class ScopeCoverageChecker:
    """The ``named_scope`` ↔ ``SCOPE_RULES`` contract, statically.

    Two drift directions, both of which silently inflate attribution's
    "other" bucket (the roofline/perf-gate stack keys off component
    shares):

    1. a scope name in the tree that no ``SCOPE_RULES`` pattern
       resolves — its cost lands in "other";
    2. a ``SCOPE_RULES`` component with no remaining anchor in the
       tree (scope renamed/removed in code but not in the rules) —
       the component silently reads zero.

    Anchors are ``named_scope`` / ``torch.profiler.record_function``
    literals (decorator or ``with`` form) in ``eksml_tpu_torch/models/``,
    ``ops/`` and ``train.py``, plus ``name="..."`` kwargs there; the
    rules are ``eksml_tpu_torch/profiling/attribution.py``'s
    ``SCOPE_RULES``.
    """

    rule = RULE_SCOPE

    def check_project(self, mods: Dict[str, ModuleInfo],
                      repo_root: str) -> List[Finding]:
        try:
            attribution = _load_file(
                "eksml_lint_attribution",
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), "profiling",
                    "attribution.py"))
            SCOPE_RULES = attribution.SCOPE_RULES
            resolve_component = attribution.resolve_component
        except Exception as e:  # noqa: BLE001 — degrade loudly
            return [Finding(self.rule, _ATTRIBUTION, 0,
                            f"cannot import SCOPE_RULES: {e}",
                            context="import SCOPE_RULES")]

        scopes: List[Tuple[str, ModuleInfo, int]] = []
        anchors: List[str] = []
        for path, mod in mods.items():
            in_scope = (path in _SCOPE_FILES
                        or any(path.startswith(d) for d in _SCOPE_DIRS))
            if not in_scope:
                continue
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                c = _chain(node.func)
                if c and c[-1] in _SCOPE_CALLS and node.args:
                    lit = _literal_name(node.args[0])
                    if lit is not None:
                        scopes.append((lit, mod, node.lineno))
                        anchors.append(lit)
                for kw in node.keywords:
                    if kw.arg == "name":
                        lit = _literal_name(kw.value)
                        if lit is not None:
                            anchors.append(lit)

        findings: List[Finding] = []
        for lit, mod, lineno in scopes:
            if resolve_component(lit.lower()) is None:
                findings.append(mod.finding(
                    self.rule, lineno,
                    f"named_scope({lit!r}) resolves to no "
                    "SCOPE_RULES component — its cost lands in "
                    "attribution's 'other' bucket; add a rule in "
                    "profiling/attribution.py or reuse an existing "
                    "scope name"))

        # rule-anchor direction needs the real attribution module in
        # the linted set (fixture trees check direction 1 only)
        attr_mod = mods.get(_ATTRIBUTION)
        if attr_mod is not None:
            lowered = [a.lower() for a in anchors]
            for comp, pat, _bwd in SCOPE_RULES:
                rx = re.compile(pat)
                if not any(rx.search(a) for a in lowered):
                    findings.append(attr_mod.finding(
                        self.rule,
                        self._rule_line(attr_mod, comp),
                        f"SCOPE_RULES component {comp!r} has no "
                        "anchoring named_scope or record_function in "
                        "models//ops//train.py — the component "
                        "silently reads zero; re-anchor the scope or "
                        "drop the rule"))
        return findings

    @staticmethod
    def _rule_line(mod: ModuleInfo, comp: str) -> int:
        needle = f'("{comp}"'
        for i, line in enumerate(mod.lines, start=1):
            if needle in line:
                return i
        return 0


# -- 6. values-config-sync --------------------------------------------

_CONFIG_KEY_RE = re.compile(r"^([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)=")
_RENDERER = "eksml_tpu_torch/tools/render_charts.py"


class ValuesConfigSyncChecker:
    """Chart values render into config keys that actually exist.

    The GPU charts' values.yaml keys become ``--config KEY=VALUE`` argv
    via the templates; ``AttrDict.update_args`` raises on an unknown
    key, so drift between a chart and ``eksml_tpu_torch/config.py`` is a
    pod that dies at start.  Checked by rendering every chart of
    ``eksml_tpu_torch/tools/render_charts.py``'s ``CHART_SPECS`` with
    that renderer (loaded from the linted tree) and resolving every
    rendered KEY against the port's default config tree.  Also flags
    values.yaml keys the template never references (dead values keys —
    the other drift direction).
    """

    rule = RULE_VALUES

    def check_project(self, mods: Dict[str, ModuleInfo],
                      repo_root: str) -> List[Finding]:
        if not os.path.isdir(os.path.join(repo_root, "charts")):
            return []
        try:
            rc = self._load_render_charts(repo_root)
            import yaml
        except Exception as e:  # noqa: BLE001 — degrade loudly
            return [Finding(self.rule, _RENDERER, 0,
                            f"cannot load chart resolver: {e}")]
        from eksml_tpu_torch.config import config as default_cfg
        from eksml_tpu_torch.config import AttrDict

        findings: List[Finding] = []
        for chart, spec in rc.CHART_SPECS.items():
            values_rel = f"{chart}/values.yaml"
            # the main template/values key from the renderer's own spec
            # table: ONE table teaches the golden render and this
            # checker together
            main = spec.get("main", "maskrcnn")
            try:
                main_doc = rc.render(chart)
            except Exception as e:  # noqa: BLE001
                findings.append(Finding(
                    self.rule, values_rel, 0,
                    f"chart fails to render: {e}",
                    context=f"render {chart}"))
                continue
            for key in self._rendered_config_keys(yaml, main_doc):
                try:
                    leaf = default_cfg.get_path(key)
                    if isinstance(leaf, AttrDict):
                        raise AttributeError("not a leaf")
                except (AttributeError, KeyError):
                    # anchor at the SOURCE of the key — the template
                    # line rendering it, or the values.yaml line
                    # (extra_config) — so path/line/context are real
                    # and baseline keys stay per-defect unique
                    path, lineno, ctx = self._key_source(
                        repo_root, chart, key)
                    findings.append(Finding(
                        self.rule, path, lineno,
                        f"chart renders --config {key}=… but "
                        "eksml_tpu_torch/config.py has no such knob — "
                        "the trainer dies at startup with 'unknown "
                        "config key'; sync the template/values with "
                        "config.py",
                        context=ctx))
            findings.extend(self._dead_values_keys(
                yaml, repo_root, chart, values_key=main))
        return findings

    @staticmethod
    def _key_source(repo_root: str, chart: str, key: str
                    ) -> Tuple[str, int, str]:
        """Locate ``KEY=`` in the chart sources (templates first, then
        values.yaml for extra_config keys)."""
        candidates = []
        tdir = os.path.join(repo_root, chart, "templates")
        try:
            for name in sorted(os.listdir(tdir)):
                candidates.append(f"{chart}/templates/{name}")
        except OSError:
            pass  # templates-less chart: fall through to values.yaml
        candidates.append(f"{chart}/values.yaml")
        for rel in candidates:
            try:
                with open(os.path.join(repo_root, rel)) as f:
                    for i, line in enumerate(f, start=1):
                        if f"{key}=" in line:
                            return rel, i, line.strip()
            except OSError:
                continue
        return f"{chart}/values.yaml", 0, f"--config {key}"

    @staticmethod
    def _load_render_charts(repo_root: str):
        return _load_file("eksml_lint_render_charts",
                          os.path.join(repo_root, _RENDERER))

    @staticmethod
    def _rendered_config_keys(yaml, manifest_text: str) -> List[str]:
        """Every KEY rendered after ``--config`` in any container
        command of the manifest."""
        keys: List[str] = []

        def walk(node):
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                if "--config" in node:
                    start = node.index("--config") + 1
                    for item in node[start:]:
                        if not isinstance(item, str):
                            continue
                        m = _CONFIG_KEY_RE.match(item)
                        if m:
                            keys.append(m.group(1))
                for v in node:
                    walk(v)

        for doc in yaml.safe_load_all(manifest_text):
            if doc:
                walk(doc)
        return keys

    def _dead_values_keys(self, yaml, repo_root: str, chart: str,
                          values_key: str = "maskrcnn"
                          ) -> List[Finding]:
        values_rel = f"{chart}/values.yaml"
        values_abs = os.path.join(repo_root, values_rel)
        template_text = ""
        tdir = os.path.join(repo_root, chart, "templates")
        for name in sorted(os.listdir(tdir)):
            with open(os.path.join(tdir, name)) as f:
                template_text += f.read()
        with open(values_abs) as f:
            values_src = f.read()
        values = yaml.safe_load(values_src)
        out = []
        for key in (values.get(values_key) or {}):
            # \b: `chips` must not count as referenced just because
            # `chips_per_host` is (prefix keys exist in both charts)
            if re.search(r"\.Values\." + re.escape(values_key) + r"\."
                         + re.escape(key) + r"\b", template_text):
                continue
            lineno, ctx = 0, f"{values_key}.{key}:"
            for i, line in enumerate(values_src.splitlines(), start=1):
                if line.strip().startswith(f"{key}:"):
                    lineno, ctx = i, line.strip()
                    break
            out.append(Finding(
                self.rule, values_rel, lineno,
                f"values key {values_key}.{key} is never referenced "
                "by the chart templates — dead knob (operators "
                "setting it silently change nothing); wire it or "
                "drop it",
                context=ctx))
        return out


# -- registry ---------------------------------------------------------

def build_checkers(rules: Optional[Sequence[str]] = None):
    """(module_checkers, graph_checkers, project_checkers) filtered by
    rule name.  Graph checkers run on one shared
    :class:`~eksml_tpu_torch.analysis.graph.ProjectGraph` built by the
    engine: jit-purity and signal-safety plus the four SPMD rules and
    the three concurrency rules."""
    module_checkers = [ConfigDriftChecker(), AtomicWriteChecker()]
    graph_checkers = [JitPurityChecker(), SignalSafetyChecker()]
    graph_checkers += build_spmd_checkers()
    graph_checkers += build_concurrency_checkers()
    project_checkers = [ScopeCoverageChecker(),
                        ValuesConfigSyncChecker()]
    if rules is not None:
        wanted = set(rules)
        unknown = wanted - set(ALL_RULES)
        if unknown:
            raise ValueError(
                f"unknown rule(s) {sorted(unknown)}; "
                f"known: {list(ALL_RULES)}")
        module_checkers = [c for c in module_checkers
                           if c.rule in wanted]
        graph_checkers = [c for c in graph_checkers
                          if c.rule in wanted]
        project_checkers = [c for c in project_checkers
                            if c.rule in wanted]
    return module_checkers, graph_checkers, project_checkers
