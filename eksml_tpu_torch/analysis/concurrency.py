"""Thread-topology concurrency analysis (the port of
``eksml_tpu/analysis/concurrency.py``).

The host side of the trainer is a real concurrent program: loader
producer threads, the decode executor, the ``DevicePrefetcher`` H2D
thread, the OpenMetrics ``ThreadingHTTPServer`` handlers, the hang
watchdog, the eval pipeline executors, the serving engine's device
thread, the operator's rank supervisors and the signal handlers all
share state.  A signal-context deadlock, a prefetcher exhaustion hang
and a leaked-tracer flush are the classes this module finds at review
time, the way Eraser-style lockset analysis and lock-order-graph
deadlock detection do dynamically — but statically, on the existing
whole-program :class:`~eksml_tpu_torch.analysis.graph.ProjectGraph`:

- **thread-root inventory** — functions that start a thread of
  control: ``threading.Thread(target=...)`` targets, executor
  ``.submit``/``.map`` callees, ``BaseHTTPRequestHandler`` subclass
  ``do_*`` methods, ``signal.signal`` handlers, ``atexit`` hooks,
  plus the main-thread entry points (``Trainer.fit``, ``train.main``,
  and the ``main`` of ``tools/bench.py``, ``launch.py`` and
  ``tools/eksml_operator.py``).  All main-thread entries share ONE
  root identity (``main`` calling ``fit`` is one thread, not two).
- **lock inventory** — ``self.<attr>`` and module-global names
  assigned from ``threading.Lock/RLock/Condition/Semaphore``,
  alias-resolved through :meth:`ProjectGraph.canonical` and matched
  at use sites through the class hierarchy (``Counter`` methods find
  ``_Series._lock``).  An acquisition through an attribute the
  inventory cannot place still synthesizes a per-class lock identity,
  so code under an unknown lock is never misread as unlocked.

Three rules run over a shared per-root reachability walk that carries
the set of locks held across call edges:

- ``lock-order``          — the combined lock-acquisition-order graph
  over every thread root must be acyclic; a cycle (``A`` then ``B``
  on one path, ``B`` then ``A`` on another) is a potential deadlock,
  reported with BOTH root→acquire chains at file:line.
- ``unlocked-shared-state`` — an attribute mutated from ≥2 thread
  roots where the intersection of the locksets held across all
  mutation sites is empty (the classic Eraser lockset going empty).
  Constructor paths (``__init__`` and its callees) are exempt:
  object construction happens-before publication.
- ``blocking-under-lock`` — a call that can block indefinitely
  (``queue.get``/``join``/``wait``/``result`` without timeout,
  socket/HTTP ops, ``torch.distributed`` collectives and DTensor
  ``redistribute``/``full_tensor``, subprocess waits)
  reachable while holding a lock that a DIFFERENT thread root also
  acquires: if the call never returns, the lock is never released
  and the other root wedges behind it.

Findings carry the structural ``chain`` (path:line per hop) exactly
like the SPMD rules, so ``tools/run_report.py`` can cross-link a
watchdog hang report's stalled stacks against a matching finding.

Known blind spots: locks
passed as function arguments, locks created in loops or stored in
containers, ``Condition``'s shared underlying lock, C-extension
blocking calls, executor ``shutdown(wait=True)``/``with`` joins,
per-instance lock identity (two instances of one class are modeled
as one), and same-root self-races inside a multi-worker executor.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from eksml_tpu_torch.analysis.engine import Finding
from eksml_tpu_torch.analysis.graph import (ChainEntry, FuncInfo,
                                            ProjectGraph, chain_dicts,
                                            chain_of, format_chain,
                                            children, iter_scope,
                                            scope_parents, walk)
from eksml_tpu_torch.analysis.spmd import (COLLECTIVE_ATTRS,
                                           is_dist_collective)

RULE_LOCK_ORDER = "lock-order"
RULE_LOCKSET = "unlocked-shared-state"
RULE_BLOCKING = "blocking-under-lock"

CONCURRENCY_RULES = (RULE_LOCK_ORDER, RULE_LOCKSET, RULE_BLOCKING)

#: Canonical constructors whose result is a mutual-exclusion object.
_LOCK_FACTORIES = ("threading.Lock", "threading.RLock",
                   "threading.Condition", "threading.Semaphore",
                   "threading.BoundedSemaphore")
_LOCK_NAMES = tuple(f.rsplit(".", 1)[-1] for f in _LOCK_FACTORIES)

#: Main-thread entry points, seeded like the SPMD hot roots so probe
#: copies linted from another root still engage the rules.
_MAIN_ROOTS: Sequence[Tuple[str, Tuple[str, ...]]] = (
    ("eksml_tpu_torch/train.py", ("Trainer.fit", "main")),
    ("eksml_tpu_torch/tools/bench.py", ("main",)),
    ("eksml_tpu_torch/launch.py", ("main",)),
    ("eksml_tpu_torch/tools/eksml_operator.py", ("main",)),
)

#: Canonical dotted calls that block on an external peer.
_BLOCKING_CANONICAL = ("subprocess.run", "subprocess.call",
                       "subprocess.check_call",
                       "subprocess.check_output")
_BLOCKING_CANONICAL_PREFIXES = ("socket.", "urllib.request.",
                                "http.client.", "requests.")
#: Attribute calls that block indefinitely UNLESS bounded by a
#: timeout: Thread.join / Event.wait / Condition.wait /
#: Future.result / Popen.communicate.  (str.join / os.path.join take
#: positional arguments and never match the zero-arg form.)
_BLOCKING_WAIT_ATTRS = ("join", "wait", "result", "communicate")
#: ``.get()`` blocks only on queue-ish receivers (``q``, ``_q``,
#: ``queue``, ``batch_queue`` …) — dict.get must not match.
_QUEUEISH = re.compile(r"(^|_)q\d*$|queue", re.IGNORECASE)

#: Method names that collide with stdlib concurrency-primitive APIs
#: (Event.wait, Queue.get/put, Thread.join/start, file write/flush…).
#: A call through an OPAQUE receiver (``self._stop.wait()``) must not
#: unique-fallback-resolve to a same-named project def — the false
#: edge would attribute one thread root's whole footprint to another
#: (``watchdog._stop.wait`` would resolve to
#: ``CheckpointManager.wait``).  Direct and
#: typed resolutions are unaffected; only the last-resort fallback is
#: blocked for these names.
_GENERIC_METHODS = frozenset((
    "wait", "get", "put", "join", "acquire", "release", "set",
    "clear", "start", "stop", "close", "submit", "map", "result",
    "read", "write", "flush", "send", "recv", "shutdown", "run",
    "append", "pop", "update", "items", "keys", "values", "is_set",
    "is_alive", "cancel", "notify", "notify_all",
))


class LockInfo:
    """One inventoried (or synthesized) lock identity."""

    __slots__ = ("lid", "kind", "path", "line", "cls", "name",
                 "display")

    def __init__(self, lid: str, kind: str, path: str, line: int,
                 cls: Optional[str], name: str, display: str):
        self.lid = lid
        self.kind = kind          # "attr" | "global" | "synthesized"
        self.path = path
        self.line = line
        self.cls = cls
        self.name = name
        self.display = display

    def __repr__(self) -> str:
        return f"<lock {self.display}>"


class ThreadRoot:
    """One function that starts a thread of control."""

    __slots__ = ("fi", "kind", "label", "site", "ident", "concurrent")

    def __init__(self, fi: FuncInfo, kind: str, site: Tuple[str, int]):
        self.fi = fi
        self.kind = kind  # thread|executor|handler|signal|atexit|main
        self.site = site
        # every main-thread entry is the SAME thread: main() calling
        # Trainer.fit() must not read as two racing roots
        self.ident = ("main" if kind == "main"
                      else f"{fi.path}::{fi.qualname}")
        self.concurrent = kind != "main"
        self.label = f"{fi.qualname} [{kind} @ {site[0]}:{site[1]}]"

    def __repr__(self) -> str:
        return f"<root {self.label}>"


# -- inventories ------------------------------------------------------


def _callable_targets(graph: ProjectGraph, scope: FuncInfo,
                      expr: ast.AST) -> List[FuncInfo]:
    """A callable REFERENCE (thread target, submit callee, handler
    argument) → FuncInfos.  Names resolve through the symbol table
    and the module name index (nested worker defs included);
    ``self.m``/``cls.m`` through the enclosing class."""
    c = chain_of(expr)
    if c is None:
        return []
    if len(c) == 1:
        return graph.resolve_name_ref(scope.path, c[0], cls=scope.cls)
    if c[0] in ("self", "cls") and len(c) == 2:
        m = graph.class_method(scope.path, scope.cls, c[1])
        if m is not None:
            return [m]
        return graph.resolve_name_ref(scope.path, c[1], cls=scope.cls)
    r = graph.resolve_symbol(scope.path, c[0])
    if r is not None and r[0] == "module":
        return graph._resolve_dotted(r[1], c[1:])
    return []


def _is_request_handler(graph: ProjectGraph, path: str, cls: str,
                        _seen: Optional[Set] = None) -> bool:
    """True when *cls* (transitively) subclasses a
    ``*HTTPRequestHandler`` — its ``do_*`` methods run on server
    threads."""
    if _seen is None:
        _seen = set()
    if (path, cls) in _seen:
        return False
    _seen.add((path, cls))
    for base in graph.class_bases(path, cls):
        canon = graph.canonical(path, base) or ""
        if canon.endswith("HTTPRequestHandler"):
            return True
        c = chain_of(base)
        if c and c[-1].endswith("HTTPRequestHandler"):
            return True
        r = graph.resolve_symbol(path, c[0]) if c and len(c) == 1 \
            else None
        if r is not None and r[0] == "class":
            bpath, bcls = r[1]
            if _is_request_handler(graph, bpath, bcls, _seen):
                return True
    return False


def _may_name(graph: ProjectGraph, path: str, func: ast.AST,
              names: Sequence[str]) -> bool:
    """Whether a call through ``func`` can canonicalise to a name ending
    in one of ``names`` — the cheap test before :meth:`canonical`: the
    last attribute, or a bare name bound by an import (an alias)."""
    c = chain_of(func)
    return c is not None and (c[-1] in names or (
        len(c) == 1 and graph.imported(path, c[0])))


def discover_thread_roots(graph: ProjectGraph) -> List[ThreadRoot]:
    """The thread-root inventory (see module docstring)."""
    roots: List[ThreadRoot] = []
    seen: Set[Tuple[int, str]] = set()

    def add(fis: List[FuncInfo], kind: str, path: str,
            line: int) -> None:
        for fi in fis:
            key = (id(fi.node), kind)
            if key not in seen:
                seen.add(key)
                roots.append(ThreadRoot(fi, kind, (path, line)))

    for scope in graph.scopes():
        for n in iter_scope(scope.node):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("submit", "map") and n.args:
                # over-approximation: any .submit/.map first-arg that
                # resolves to a project function is an executor callee
                # (receivers are usually locals — ThreadPoolExecutor
                # instances the symbol table cannot type)
                add(_callable_targets(graph, scope, n.args[0]),
                    "executor", scope.path, n.lineno)
                continue
            if not _may_name(graph, scope.path, n.func,
                             ("Thread", "signal", "register")):
                continue
            canon = graph.canonical(scope.path, n.func) or ""
            if canon.endswith("threading.Thread") \
                    or canon == "threading.Thread":
                for kw in n.keywords:
                    if kw.arg == "target":
                        add(_callable_targets(graph, scope, kw.value),
                            "thread", scope.path, n.lineno)
            elif canon == "signal.signal" and len(n.args) >= 2:
                add(_callable_targets(graph, scope, n.args[1]),
                    "signal", scope.path, n.lineno)
            elif canon == "atexit.register" and n.args:
                add(_callable_targets(graph, scope, n.args[0]),
                    "atexit", scope.path, n.lineno)
    # BaseHTTPRequestHandler subclasses: do_* run on server threads
    for path, mod in graph.mods.items():
        for node in walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not _is_request_handler(graph, path, node.name):
                continue
            for child in node.body:
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                        and child.name.startswith("do_"):
                    fi = graph.func_for_node(child)
                    if fi is not None:
                        add([fi], "handler", path, child.lineno)
    for contract, quals in _MAIN_ROOTS:
        for path in [p for p in graph.mods
                     if p == contract or p.endswith("/" + contract)]:
            for q in quals:
                fi = graph.lookup(path, q)
                if fi is not None:
                    add([fi], "main", path, fi.node.lineno)
    return roots


class LockInventory:
    """Locks declared in the linted set + use-site resolution."""

    def __init__(self, graph: ProjectGraph):
        self.graph = graph
        self.by_cls_attr: Dict[Tuple[str, str], LockInfo] = {}
        self.by_attr: Dict[str, List[LockInfo]] = {}
        self.by_global: Dict[Tuple[str, str], LockInfo] = {}
        self.by_dotted: Dict[str, LockInfo] = {}
        self.locks: List[LockInfo] = []
        self._bases: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        self._synth: Dict[str, LockInfo] = {}
        self._scan()

    def _scan(self) -> None:
        g = self.graph
        for scope in g.scopes():
            for n in iter_scope(scope.node):
                if not isinstance(n, ast.Assign):
                    continue
                if not isinstance(n.value, ast.Call) or not _may_name(
                        g, scope.path, n.value.func, _LOCK_NAMES):
                    continue
                canon = g.canonical(scope.path, n.value.func) or ""
                if canon not in _LOCK_FACTORIES:
                    continue
                for t in n.targets:
                    self._add_target(scope, t, n.value.lineno)
        # class hierarchy for attr-lock resolution through subclasses
        for path, mod in g.mods.items():
            for node in walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases: List[Tuple[str, str]] = []
                for b in node.bases:
                    c = chain_of(b)
                    if c is None or len(c) != 1:
                        continue
                    r = g.resolve_symbol(path, c[0])
                    if r is not None and r[0] == "class":
                        bases.append(r[1])
                self._bases[(path, node.name)] = bases

    def _add_target(self, scope: FuncInfo, target: ast.AST,
                    line: int) -> None:
        g = self.graph
        c = chain_of(target)
        if c is None:
            return
        if len(c) == 2 and c[0] == "self" and scope.cls is not None:
            display = f"{scope.cls}.{c[1]}"
            info = LockInfo(f"{scope.path}::{display}", "attr",
                            scope.path, line, scope.cls, c[1], display)
            self.by_cls_attr.setdefault((scope.cls, c[1]), info)
            self.by_attr.setdefault(c[1], []).append(info)
            self.locks.append(info)
        elif len(c) == 1 and scope.is_module:
            mod = g.modname[scope.path]
            display = f"{mod}.{c[0]}"
            info = LockInfo(f"{scope.path}::{c[0]}", "global",
                            scope.path, line, None, c[0], display)
            self.by_global.setdefault((scope.path, c[0]), info)
            self.by_dotted.setdefault(display, info)
            self.by_attr.setdefault(c[0], []).append(info)
            self.locks.append(info)
        # locals / deeper chains: documented blind spot (locks created
        # in loops or attached to foreign objects)

    def _attr_via_bases(self, path: str, cls: Optional[str],
                        attr: str) -> Optional[LockInfo]:
        seen: Set[Tuple[str, str]] = set()
        todo = [(path, cls)] if cls is not None else []
        while todo:
            p, c = todo.pop(0)
            if c is None or (p, c) in seen:
                continue
            seen.add((p, c))
            info = self.by_cls_attr.get((c, attr))
            if info is not None:
                return info
            todo.extend(self._bases.get((p, c), ()))
        return None

    def _synthesize(self, lid: str, path: str, line: int,
                    cls: Optional[str], name: str,
                    display: str) -> LockInfo:
        info = self._synth.get(lid)
        if info is None:
            info = LockInfo(lid, "synthesized", path, line, cls, name,
                            display)
            self._synth[lid] = info
        return info

    def resolve_use(self, scope: FuncInfo,
                    expr: ast.AST) -> Optional[LockInfo]:
        """A ``with <expr>:`` / ``<expr>.acquire()`` target → the lock
        it denotes, or a synthesized per-class/per-scope identity when
        the expression is lock-shaped (named ``*lock*``/``*sem*``/
        ``*cond*``) but the creation site is out of view.  Returns
        None for expressions that are not locks at all."""
        g = self.graph
        c = chain_of(expr)
        if c is None:
            return None
        lockish = re.search(r"lock|mutex|sem$|cond$", c[-1],
                            re.IGNORECASE) is not None
        if len(c) >= 2 and c[0] == "self":
            info = self._attr_via_bases(scope.path, scope.cls, c[-1])
            if info is not None:
                return info
            cands = self.by_attr.get(c[-1], ())
            if len(cands) == 1:
                return cands[0]
            if lockish and scope.cls is not None and len(c) == 2:
                display = f"{scope.cls}.{c[-1]}"
                return self._synthesize(
                    f"{scope.path}::{display}", scope.path,
                    expr.lineno, scope.cls, c[-1], display)
            return None
        if len(c) == 1:
            info = self.by_global.get((scope.path, c[0]))
            if info is not None:
                return info
            cands = self.by_attr.get(c[0], ())
            if len(cands) == 1 and cands[0].kind == "global":
                return cands[0]
            return None
        canon = g.canonical(scope.path, expr)
        if canon is not None and canon in self.by_dotted:
            return self.by_dotted[canon]
        cands = self.by_attr.get(c[-1], ())
        if len(cands) == 1:
            return cands[0]
        return None


# -- per-scope lexical analysis ---------------------------------------


class _ScopeInfo:
    """Lock/mutation/blocking/call sites of ONE lexical scope, each
    annotated with the locks held lexically at that site."""

    __slots__ = ("acquisitions", "mutations", "blockings", "calls")

    def __init__(self):
        # (LockInfo, line, frozenset[lid] held-at-acquisition)
        self.acquisitions: List[Tuple[LockInfo, int, FrozenSet[str]]] = []
        # (attr, recv_cls|None, line, frozenset[lid])
        self.mutations: List[Tuple[str, Optional[str], int,
                                   FrozenSet[str]]] = []
        # (description, line, frozenset[lid])
        self.blockings: List[Tuple[str, int, FrozenSet[str]]] = []
        # (call node, callee FuncInfo, frozenset[lid] at the call)
        self.calls: List[Tuple[ast.Call, FuncInfo, FrozenSet[str]]] = []


def _has_timeout(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg in ("timeout", "timeout_in_ms"):
            return True
        # block=False is non-blocking; block=True (or a dynamic
        # value) keeps the call unbounded and must NOT exempt it
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


def _blocking_call(graph: ProjectGraph, path: str,
                   call: ast.Call) -> Optional[str]:
    """A description when *call* can block indefinitely, else None."""
    c = chain_of(call.func)
    canon = graph.canonical(path, call.func)
    # a collective blocks until every rank arrives (the list is the
    # collective-order checker's), so under a lock it is a blocking
    # call whatever its nominal timeout
    name = is_dist_collective(canon) if canon else None
    if name is not None:
        return f"collective {name}()"
    for cand in filter(None, (canon, ".".join(c) if c else None)):
        if cand in _BLOCKING_CANONICAL and not _has_timeout(call):
            return f"{cand}() without timeout"
        for prefix in _BLOCKING_CANONICAL_PREFIXES:
            if cand.startswith(prefix):
                return f"{cand}() (socket/HTTP I/O)"
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in COLLECTIVE_ATTRS:
        return f".{attr}() (DTensor collective)"
    if attr == "serve_forever":
        return ".serve_forever()"
    if attr in _BLOCKING_WAIT_ATTRS and not call.args \
            and not _has_timeout(call):
        return f".{attr}() without timeout"
    if attr == "get":
        bounded = _has_timeout(call) or len(call.args) >= 2
        if len(call.args) == 1:
            # Queue.get(block[, timeout]): a literal True first
            # positional is still an unbounded wait; anything else
            # (False = non-blocking, or a dynamic value) is treated
            # as bounded — err toward silence on unknowns
            first = call.args[0]
            bounded = bounded or not (isinstance(first, ast.Constant)
                                      and first.value is True)
        if not bounded:
            rc = chain_of(call.func.value)
            if rc is not None and _QUEUEISH.search(rc[-1]):
                return f"{'.'.join(rc)}.get() without timeout"
    return None


def _scope_nodes(fi: FuncInfo):
    """One lexical scope's nodes, lambdas included, nested defs
    excluded (they are their own scopes in the walk)."""
    todo = list(children(fi.node))
    while todo:
        n = todo.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        todo.extend(children(n))


class ConcurrencyAnalysis:
    """The shared walk all three rules read from.  Built once per
    :class:`ProjectGraph` and cached on it (three thin checkers pull
    their findings without re-walking)."""

    def __init__(self, graph: ProjectGraph):
        self.graph = graph
        self.roots = discover_thread_roots(graph)
        self.locks = LockInventory(graph)
        self._root_target_ids = {id(r.fi.node) for r in self.roots
                                 if r.kind != "main"}
        self._scope_cache: Dict[int, _ScopeInfo] = {}
        self._with_locks: Dict[int, List[LockInfo]] = {}
        # accumulators, filled by _walk():
        #   acquired[ident][lid] = (root, chain to first acquisition)
        self.acquired: Dict[str, Dict[str, Tuple[ThreadRoot,
                                                 List[ChainEntry]]]] = {}
        #   edges[(lid_a, lid_b)] = [(root, chain to b-acquisition)]
        self.edges: Dict[Tuple[str, str],
                         List[Tuple[ThreadRoot, List[ChainEntry]]]] = {}
        #   mutations[attr] = [(root, recv_cls, path, line, lockset,
        #                       chain)]
        self.mutations: Dict[str, List[Tuple[ThreadRoot, Optional[str],
                                             str, int, FrozenSet[str],
                                             List[ChainEntry]]]] = {}
        #   blockings = [(root, path, line, what, heldset, chain)]
        self.blockings: List[Tuple[ThreadRoot, str, int, str,
                                   FrozenSet[str],
                                   List[ChainEntry]]] = []
        self.lock_by_id: Dict[str, LockInfo] = {}
        for root in self.roots:
            self._walk(root)

    # -- lexical scope analysis ---------------------------------------

    def _held_from_withs(self, node: ast.AST, parents) -> Set[str]:
        held: Set[str] = set()
        cur = node
        while id(cur) in parents:
            parent, field = parents[id(cur)]
            if isinstance(parent, (ast.With, ast.AsyncWith)) \
                    and field == "body":
                for info in self._with_locks.get(id(parent), ()):
                    held.add(info.lid)
            cur = parent
        return held

    def _scope_info(self, fi: FuncInfo) -> _ScopeInfo:
        cached = self._scope_cache.get(id(fi.node))
        if cached is not None:
            return cached
        g, out = self.graph, _ScopeInfo()
        parents = scope_parents(fi.node)
        nodes = list(iter_scope(fi.node) if fi.is_module
                     else _scope_nodes(fi))
        # pass 1: resolve `with` items so held-ancestry can see them
        for n in nodes:
            if isinstance(n, (ast.With, ast.AsyncWith)):
                infos = []
                for item in n.items:
                    info = self.locks.resolve_use(fi, item.context_expr)
                    if info is not None:
                        infos.append(info)
                if infos:
                    self._with_locks[id(n)] = infos
        # pass 2: explicit acquire()/release() events, in line order
        acq_events: List[Tuple[int, LockInfo, int]] = []
        for n in nodes:
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("acquire", "release"):
                info = self.locks.resolve_use(fi, n.func.value)
                if info is not None:
                    acq_events.append(
                        (n.lineno, info,
                         1 if n.func.attr == "acquire" else -1))
        acq_events.sort(key=lambda e: e[0])

        def held_at(node: ast.AST) -> FrozenSet[str]:
            held = self._held_from_withs(node, parents)
            line = getattr(node, "lineno", 0)
            balance: Dict[str, int] = {}
            for ln, info, delta in acq_events:
                if ln < line:
                    balance[info.lid] = balance.get(info.lid, 0) + delta
            held.update(lid for lid, b in balance.items() if b > 0)
            return frozenset(held)

        for n in nodes:
            if isinstance(n, (ast.With, ast.AsyncWith)):
                infos = self._with_locks.get(id(n), [])
                under = set(held_at(n))
                for info in infos:  # `with a, b:` acquires in order
                    out.acquisitions.append(
                        (info, n.lineno, frozenset(under)))
                    under.add(info.lid)
            elif isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "acquire":
                    info = self.locks.resolve_use(fi, n.func.value)
                    if info is not None:
                        out.acquisitions.append(
                            (info, n.lineno, held_at(n)))
                        continue
                what = _blocking_call(g, fi.path, n)
                if what is not None:
                    out.blockings.append((what, n.lineno, held_at(n)))
                for callee in self._resolve_call(fi, n):
                    out.calls.append((n, callee, held_at(n)))
            targets: List[ast.AST] = []
            if isinstance(n, ast.Assign):
                targets = list(n.targets)
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                for sub in walk(t):
                    # Store context marks exactly the written-to
                    # attribute of each chain: in `self.a.b = x` only
                    # `.b` is a Store (`self.a` is a Load), and a
                    # tuple target `self.a, self.b = …` carries one
                    # Store per element — every one is a mutation
                    if not isinstance(sub, ast.Attribute) \
                            or not isinstance(sub.ctx, ast.Store):
                        continue
                    c = chain_of(sub)
                    if c is None or len(c) < 2:
                        continue
                    attr = c[-1]
                    if self.locks.by_attr.get(attr):
                        continue  # (re)binding a lock attr ≠ state
                    recv_cls = (fi.cls if len(c) == 2
                                and c[0] == "self" else None)
                    out.mutations.append(
                        (attr, recv_cls, sub.lineno, held_at(sub)))
        self._scope_cache[id(fi.node)] = out
        return out

    def _resolve_call(self, fi: FuncInfo,
                      call: ast.Call) -> List[FuncInfo]:
        """Call resolution with the SPMD checkers' unique-name
        fallback, EXCEPT for concurrency-generic method names (see
        :data:`_GENERIC_METHODS`) where a false edge would attribute
        one root's lock/mutation footprint to another."""
        g = self.graph
        out = g.resolve_call(fi.path, call, cls=fi.cls, scope=fi)
        if out:
            return out
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _GENERIC_METHODS:
            return []
        return g.resolve_call(fi.path, call, cls=fi.cls,
                              unique_fallback=True, scope=fi)

    # -- the per-root reachability walk -------------------------------

    def _walk(self, root: ThreadRoot) -> None:
        acquired = self.acquired.setdefault(root.ident, {})
        seen: Set[Tuple[int, FrozenSet[str], bool]] = set()
        queue: List[Tuple[FuncInfo, FrozenSet[str], List[ChainEntry],
                          bool]] = [
            (root.fi, frozenset(), [], root.fi.name == "__init__")]
        while queue:
            fi, held, chain, in_init = queue.pop(0)
            key = (id(fi.node), held, in_init)
            if key in seen:
                continue
            seen.add(key)
            info = self._scope_info(fi)
            for lock, line, under in info.acquisitions:
                self.lock_by_id.setdefault(lock.lid, lock)
                full = held | under
                acq_chain = chain + [(fi.path, line,
                                      f"acquire {lock.display}")]
                if lock.lid not in acquired:
                    acquired[lock.lid] = (root, acq_chain)
                for a in full:
                    if a != lock.lid:
                        self.edges.setdefault((a, lock.lid), []).append(
                            (root, acq_chain))
            if not in_init:
                for attr, recv_cls, line, lex in info.mutations:
                    self.mutations.setdefault(attr, []).append(
                        (root, recv_cls, fi.path, line, held | lex,
                         chain + [(fi.path, line, f"mutate .{attr}")]))
            for what, line, lex in info.blockings:
                full = held | lex
                if full:
                    self.blockings.append(
                        (root, fi.path, line, what, full,
                         chain + [(fi.path, line, what)]))
            for call, callee, lex in info.calls:
                queue.append((callee, held | lex,
                              chain + [(fi.path, call.lineno,
                                        callee.qualname)],
                              in_init or callee.name == "__init__"))
            # nested worker defs run when invoked; defs that are
            # thread TARGETS run on their own thread and are walked as
            # their own roots, never folded into the spawner
            for child in self.graph.nested_defs(fi):
                if id(child.node) in self._root_target_ids:
                    continue
                queue.append((child, held,
                              chain + [(fi.path, child.node.lineno,
                                        f"{child.qualname} (nested)")],
                              in_init))


def analysis_for(graph: ProjectGraph) -> ConcurrencyAnalysis:
    cached = getattr(graph, "_concurrency_analysis", None)
    if cached is None:
        cached = ConcurrencyAnalysis(graph)
        graph._concurrency_analysis = cached
    return cached


def _finding(graph: ProjectGraph, rule: str, path: str, line: int,
             message: str, chain: List[ChainEntry]) -> Finding:
    mod = graph.mods.get(path)
    ctx = mod.line_text(line) if mod is not None else ""
    return Finding(rule, path, line, message, context=ctx,
                   chain=chain_dicts(chain) if chain else None)


# -- rule 1: lock-order -----------------------------------------------


class LockOrderChecker:
    """The combined per-root lock-acquisition-order graph must be
    acyclic.  ``A`` then ``B`` on one chain and ``B`` then ``A`` on
    another is the textbook two-lock deadlock: each thread holds its
    first lock and waits forever for the other's.  A cycle confined
    to one single-instance main-thread root cannot interleave with
    itself and is not reported; anything involving a spawned thread,
    executor callee, or handler can."""

    rule = RULE_LOCK_ORDER

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        a = analysis_for(graph)
        out: List[Finding] = []
        reported: Set[FrozenSet[str]] = set()
        for (la, lb), recs in sorted(a.edges.items()):
            if (lb, la) not in a.edges or la >= lb:
                continue  # report each inversion pair once
            cycle_key = frozenset((la, lb))
            if cycle_key in reported:
                continue
            reported.add(cycle_key)
            back = a.edges[(lb, la)]
            roots = {r.ident for r, _ in recs} \
                | {r.ident for r, _ in back}
            concurrent = any(r.concurrent for r, _ in recs) \
                or any(r.concurrent for r, _ in back)
            if len(roots) < 2 and not concurrent:
                continue  # one main thread cannot deadlock itself
            root1, chain1 = recs[0]
            root2, chain2 = back[0]
            lock_a = a.lock_by_id[la]
            lock_b = a.lock_by_id[lb]
            path, line = chain1[-1][0], chain1[-1][1]
            out.append(_finding(
                graph, self.rule, path, line,
                f"lock-order inversion between '{lock_a.display}' and "
                f"'{lock_b.display}': {root1.label} acquires "
                f"'{lock_b.display}' while holding "
                f"'{lock_a.display}' (chain: {format_chain(chain1)}) "
                f"but {root2.label} acquires '{lock_a.display}' while "
                f"holding '{lock_b.display}' (chain: "
                f"{format_chain(chain2)}) — with both threads between "
                "their first and second acquisition each waits "
                "forever for the other's lock; pick ONE global order "
                "(or release the first lock before taking the "
                "second)",
                chain=chain1 + chain2))
        out.extend(self._long_cycles(graph, a, reported))
        return out

    def _long_cycles(self, graph: ProjectGraph, a: ConcurrencyAnalysis,
                     reported: Set[FrozenSet[str]]) -> List[Finding]:
        """Cycles of length ≥3 (A→B→C→A without any direct
        inversion pair): DFS over the combined order graph; every
        cycle not already covered by a 2-cycle report gets one
        finding stitching the per-edge chains together."""
        adj: Dict[str, List[str]] = {}
        for (la, lb) in a.edges:
            adj.setdefault(la, []).append(lb)
        out: List[Finding] = []

        def dfs(start: str, cur: str, path: List[str],
                on_path: Set[str]) -> None:
            for nxt in sorted(adj.get(cur, ())):
                if nxt == start and len(path) >= 3:
                    key = frozenset(path)
                    if key in reported:
                        continue
                    reported.add(key)
                    edges = [(path[i], path[(i + 1) % len(path)])
                             for i in range(len(path))]
                    recs = [a.edges[e][0] for e in edges]
                    roots = {r.ident for r, _ in recs}
                    if len(roots) < 2 \
                            and not any(r.concurrent for r, _ in recs):
                        continue
                    names = " -> ".join(
                        a.lock_by_id[l].display for l in path
                        + [path[0]])
                    hops = "; ".join(
                        f"'{a.lock_by_id[e[1]].display}' under "
                        f"'{a.lock_by_id[e[0]].display}' by "
                        f"{r.label} (chain: {format_chain(ch)})"
                        for e, (r, ch) in zip(edges, recs))
                    anchor = recs[0][1][-1]
                    chain: List[ChainEntry] = []
                    for _, ch in recs:
                        chain.extend(ch)
                    out.append(_finding(
                        graph, self.rule, anchor[0], anchor[1],
                        f"lock-order cycle {names}: {hops} — a cycle "
                        "in the acquisition-order graph deadlocks "
                        "once each edge's thread sits between its "
                        "first and second lock; break the cycle with "
                        "one global acquisition order",
                        chain=chain))
                elif nxt not in on_path and nxt > start:
                    # canonical form: only walk nodes > start so each
                    # cycle is discovered once, from its minimum node
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out


# -- rule 2: unlocked-shared-state ------------------------------------


class LocksetChecker:
    """Eraser-style lockset intersection over attribute mutations.

    An attribute mutated from ≥2 distinct thread roots must keep at
    least one lock common to EVERY mutation path; when the
    intersection goes empty, some interleaving writes unprotected.
    Constructor chains are exempt (happens-before publication), and
    mutations are clustered by receiver class so same-named fields of
    unrelated classes never merge."""

    rule = RULE_LOCKSET

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        a = analysis_for(graph)
        out: List[Finding] = []
        for attr in sorted(a.mutations):
            sites = a.mutations[attr]
            classes = sorted({cls for _, cls, *_ in sites
                              if cls is not None})
            clusters = classes or [None]
            for cluster in clusters:
                csites = [s for s in sites
                          if s[1] == cluster or s[1] is None]
                f = self._check_cluster(graph, attr, cluster, csites)
                if f is not None:
                    out.append(f)
        return out

    def _check_cluster(self, graph: ProjectGraph, attr: str,
                       cluster: Optional[str],
                       sites) -> Optional[Finding]:
        idents = {root.ident for root, *_ in sites}
        if len(idents) < 2:
            return None
        common: Optional[Set[str]] = None
        for _, _, _, _, lockset, _ in sites:
            common = (set(lockset) if common is None
                      else common & set(lockset))
        if common:
            return None
        # anchor at the barest site (prefer a lock-free mutation)
        anchor = min(sites, key=lambda s: (len(s[4]), s[2], s[3]))
        root, _, path, line, lockset, chain = anchor
        a = analysis_for(graph)
        others = []
        seen_idents = {root.ident}
        for r, _, p, ln, ls, _ in sites:
            if r.ident in seen_idents:
                continue
            seen_idents.add(r.ident)
            locks = ", ".join(sorted(
                a.lock_by_id[l].display for l in ls)) or "no lock"
            others.append(f"{r.label} at {p}:{ln} (holding {locks})")
        held = ", ".join(sorted(
            a.lock_by_id[l].display for l in lockset)) or "no lock"
        target = f"{cluster}.{attr}" if cluster else f".{attr}"
        return _finding(
            graph, self.rule, path, line,
            f"attribute '{target}' is mutated from "
            f"{len(idents)} thread roots with no lock common to all "
            f"paths (lockset intersection is empty): {root.label} "
            f"mutates it at {path}:{line} holding {held}; also "
            f"mutated by {'; '.join(others)} — interleaved writes "
            "race; guard every mutation with one shared lock, or "
            "suppress inline with the happens-before argument. "
            f"chain: {format_chain(chain)}",
            chain=chain)


# -- rule 3: blocking-under-lock --------------------------------------


class BlockingUnderLockChecker:
    """A potentially-unbounded blocking call while holding a lock
    another thread root also takes: if the call never returns (peer
    death, empty queue, wedged collective) the lock is never released
    and the OTHER root hangs behind it — the static form of a
    signal-registry deadlock.  Bounded waits (an explicit timeout)
    and locks private to one root are not findings."""

    rule = RULE_BLOCKING

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        a = analysis_for(graph)
        out: List[Finding] = []
        reported: Set[Tuple[str, int, str]] = set()
        for root, path, line, what, heldset, chain in a.blockings:
            shared = None
            other = None
            for lid in sorted(heldset):
                for ident, acq in a.acquired.items():
                    if ident != root.ident and lid in acq:
                        shared, other = lid, acq[lid][0]
                        break
                if shared is not None:
                    break
            if shared is None:
                continue
            key = (path, line, shared)
            if key in reported:
                continue
            reported.add(key)
            lock = a.lock_by_id[shared]
            out.append(_finding(
                graph, self.rule, path, line,
                f"blocking call {what} at {path}:{line} runs while "
                f"holding '{lock.display}', a lock {other.label} also "
                "acquires — if the call never returns the lock is "
                "never released and that thread wedges behind it; "
                "bound the wait with a timeout or move the blocking "
                "call outside the critical section. "
                f"chain: {format_chain(chain)}",
                chain=chain))
        return out


def build_concurrency_checkers() -> List[object]:
    return [LockOrderChecker(), LocksetChecker(),
            BlockingUnderLockChecker()]
