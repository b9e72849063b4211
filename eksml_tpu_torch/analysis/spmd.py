"""The four SPMD-safety checkers over the port's ``torch.distributed``
code (the port of ``eksml_tpu/analysis/spmd.py``: the same four rules,
each reading PyTorch's primitives where the reference reads JAX's).

Each encodes a cross-rank invariant of synchronous data-parallel
training whose violation the runtime layers can only diagnose AFTER the
fact (the hang watchdog reports a wedged collective post-mortem; the
bit-identity tests catch RNG drift only when a test runs both sides):

- ``collective-order``  — a collective every rank must enter together
  (a ``torch.distributed`` collective, DTensor's ``redistribute`` /
  ``full_tensor``, the port's wrappers that hide one) must not be
  reachable only under a rank-divergent conditional (``dist.get_rank()``,
  ``process_index()``, ``is_coordinator()``, ``RANK``/``LOCAL_RANK``
  from the environment), inside an ``except`` handler (exceptions fire
  on the raising rank only), or after a rank-divergent early
  ``return``/``raise`` that a collective can follow.  The static form
  of the distributed-hang class.
- ``rng-discipline``    — the zero-RNG contract set (loader quarantine
  substitution, span tracing, telemetry aggregation) must not reach a
  host or torch RNG draw through ANY call chain: one draw on one rank
  shifts that rank's stream and the cross-rank batch schedule breaks.
- ``host-sync``         — device syncs (``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``Event``/``Stream.synchronize``, ``np.asarray`` of a tensor,
  ``float``/``int``/``bool`` of a tensor) reachable from the hot step
  path (``Trainer.fit``, ``DevicePrefetcher``) stall the step loop once
  per step; the known-legal sites carry inline suppressions with
  justifications.
- ``recompile-hazard``  — in the port a "compile" is the first forward
  at a new input shape under cuDNN autotune: a batch-content ``len()``
  or ``.shape[i]`` that sizes a tensor reaching the training step or a
  model forward outside the bucketed schedule (``PREPROC.BUCKETS``)
  autotunes a new shape on the request path.

All four run on the cross-module graph (:mod:`.graph`), so the
divergent/impure call can live any number of imports away; findings
carry the ``path:line`` call chain root → sink (``--json`` exposes it
as ``chain`` so ``tools/run_report.py`` can cross-link a watchdog hang
report).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from eksml_tpu_torch.analysis.engine import Finding, ModuleInfo
from eksml_tpu_torch.analysis.graph import (ChainEntry, FuncInfo,
                                            ProjectGraph, chain_dicts,
                                            chain_of, format_chain,
                                            iter_scope, scope_parents,
                                            children, unparse, walk)

RULE_COLLECTIVE = "collective-order"
RULE_RNG = "rng-discipline"
RULE_SYNC = "host-sync"
RULE_RECOMPILE = "recompile-hazard"

SPMD_RULES = (RULE_COLLECTIVE, RULE_RNG, RULE_SYNC, RULE_RECOMPILE)


def _finding(mod_lookup: Dict[str, ModuleInfo], rule: str, path: str,
             line: int, message: str,
             chain: Optional[List[ChainEntry]] = None) -> Finding:
    mod = mod_lookup.get(path)
    ctx = mod.line_text(line) if mod is not None else ""
    return Finding(rule, path, line, message, context=ctx,
                   chain=chain_dicts(chain) if chain else None)


def _paths_matching(graph: ProjectGraph, contract: str) -> List[str]:
    """Linted paths matching a contract path — suffix-tolerant so a
    probe copy of a contract module linted from another root (the
    acceptance injections, fixture packages) still engages the rule."""
    return [p for p in graph.mods
            if p == contract or p.endswith("/" + contract)]


# -- 1. collective-order ----------------------------------------------

#: ``torch.distributed`` collectives, matched on the canonical name
#: (``import torch.distributed as dist`` resolves through the graph).
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                    "all_gather_object", "broadcast",
                    "broadcast_object_list", "reduce_scatter",
                    "reduce_scatter_tensor", "gather", "scatter",
                    "all_to_all", "barrier", "monitored_barrier")
_DIST_MODULES = ("torch.distributed.",
                 "torch.distributed.distributed_c10d.")
#: DTensor methods that run a collective over the tensor's mesh, matched
#: by bare method name (the receiver is a DTensor the graph cannot type).
COLLECTIVE_ATTRS = ("redistribute", "full_tensor")
#: The port's entry points whose collective the pattern cannot see (a
#: DTensor gathered through an autograd Function, a wrapper whose
#: collective sits behind a call the graph does not resolve).  Their
#: callers are ordered around a collective.
_SEED_COLLECTIVE_DEFS = (
    ("eksml_tpu_torch/parallel/collectives.py", "cross_host_sum"),
    ("eksml_tpu_torch/parallel/collectives.py", "assert_replicas_in_sync"),
    ("eksml_tpu_torch/parallel/collectives.py", "warm_mesh_collectives"),
    ("eksml_tpu_torch/utils/checkpoint.py", "full_state_dict"),
    ("eksml_tpu_torch/utils/checkpoint.py", "full_optimizer_state"),
    ("eksml_tpu_torch/utils/checkpoint.py", "load_full_state"),
    ("eksml_tpu_torch/parallel/sharding.py", "_Whole.forward"),
    ("eksml_tpu_torch/parallel/sharding.py", "_Whole.backward"),
    ("eksml_tpu_torch/parallel/sharding.py", "_whole_param"),
    ("eksml_tpu_torch/evalcoco/runner.py", "_gather_detection_lists"),
)
#: Calls whose result differs per rank (the port's wrappers too).
_DIVERGENT_CALLS = ("get_rank", "get_local_rank", "process_index",
                    "is_coordinator")
#: Names that mean "this rank" wherever they appear (the reference's).
_DIVERGENT_NAMES = ("host_id", "host_rank", "rank_id")
#: Environment variables that hold this process's rank.
_RANK_ENV = ("RANK", "LOCAL_RANK", "PROCESS_ID")


def is_dist_collective(canonical: str) -> Optional[str]:
    """The collective's name when ``canonical`` is a ``torch.distributed``
    collective, else None."""
    for prefix in _DIST_MODULES:
        if canonical.startswith(prefix):
            name = canonical[len(prefix):]
            if name in DIST_COLLECTIVES:
                return name
    return None


def _env_rank_read(n: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("LOCAL_RANK")``,
    ``os.getenv("RANK")``."""
    if isinstance(n, ast.Subscript):
        c = chain_of(n.value)
        key = n.slice
        return (c is not None and c[-1] == "environ"
                and isinstance(key, ast.Constant) and key.value in _RANK_ENV)
    if isinstance(n, ast.Call) and n.args:
        c = chain_of(n.func)
        first = n.args[0]
        return (c is not None
                and (c[-2:] == ("environ", "get") or c[-1] == "getenv")
                and isinstance(first, ast.Constant)
                and first.value in _RANK_ENV)
    return False


def divergent_marker(test: ast.AST,
                     local_names: Set[str] = frozenset()) -> Optional[str]:
    """The rank marker in ``test``, or None when it reads the same on
    every rank."""
    for n in walk(test):
        if _env_rank_read(n):
            return unparse(n)
        if isinstance(n, ast.Call):
            c = chain_of(n.func)
            if c and c[-1] in _DIVERGENT_CALLS:
                return ".".join(c) + "()"
        elif isinstance(n, ast.Name) and (n.id in _DIVERGENT_NAMES
                                          or n.id in local_names):
            return n.id
        elif isinstance(n, ast.Attribute):
            if n.attr in _DIVERGENT_NAMES:
                return n.attr
            if n.attr == "rank" and chain_of(n) == ("self", "rank"):
                return "self.rank"
    return None


def _facts(test: ast.AST, value: bool, out: Dict[str, bool]) -> None:
    """What holds on the branch where ``test`` is ``value``:
    ``{predicate source: truth}``, through ``not`` and ``and``/``or``."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        _facts(test.operand, not value, out)
    elif isinstance(test, ast.BoolOp) and (
            isinstance(test.op, ast.And) == value):
        for v in test.values:
            _facts(v, value, out)
    else:
        out[unparse(test)] = value


class CollectiveOrderChecker:
    """No collective behind a rank-divergent branch — statically.

    The watchdog diagnoses the resulting hang post-mortem (one rank
    waits in the collective forever, the rest have moved on or
    exited); this is the same bug at review time.  Uniform predicates
    (``dist.is_initialized()``, ``get_world_size()``, step counters,
    config reads) never flag — divergence requires a rank marker.
    Exception handlers count as divergent per se: an exception is a
    rank-local event, so a collective inside a handler splits the
    group.  A ``return``/``raise`` under a divergent guard or in a
    handler is a finding only when a collective can follow it: a
    collective whose enclosing branches contradict the exit's on a
    uniform predicate (the exit under ``not dist.is_initialized()``,
    the collective under ``dist.is_initialized()``) cannot.
    """

    rule = RULE_COLLECTIVE

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        chains = self._collective_chains(graph)
        findings: List[Finding] = []
        reported: Set[Tuple[int, str]] = set()
        for scope in graph.scopes():
            findings.extend(self._check_scope(graph, scope, chains,
                                              reported))
        return findings

    # -- collective discovery -----------------------------------------

    def _primitive_label(self, graph: ProjectGraph, path: str,
                         call: ast.Call) -> Optional[str]:
        c = chain_of(call.func)
        if c is None or (c[-1] not in DIST_COLLECTIVES
                         and c[-1] not in COLLECTIVE_ATTRS
                         and not (len(c) == 1
                                  and graph.imported(path, c[0]))):
            return None     # cannot name a collective, even aliased
        canon = graph.canonical(path, call.func)
        if canon is not None:
            name = is_dist_collective(canon)
            if name is not None:
                return name
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in COLLECTIVE_ATTRS):
            return call.func.attr
        return None

    def _collective_chains(self, graph: ProjectGraph
                           ) -> Dict[int, List[ChainEntry]]:
        """{id(func node): call chain func → primitive} for every
        function that (transitively) executes a collective."""
        chains: Dict[int, List[ChainEntry]] = {}
        for fi in graph.functions:
            sites = []
            for n in walk(fi.node):
                if isinstance(n, ast.Call):
                    label = self._primitive_label(graph, fi.path, n)
                    if label is not None:
                        sites.append((n.lineno, label))
            if sites:
                line, label = min(sites)
                chains[id(fi.node)] = [(fi.path, line, label)]
        for seed_path, qual in _SEED_COLLECTIVE_DEFS:
            for path in _paths_matching(graph, seed_path):
                fi = graph.lookup(path, qual)
                if fi is not None and id(fi.node) not in chains:
                    chains[id(fi.node)] = [(path, fi.node.lineno,
                                            f"{qual} (collective)")]
        # reverse closure: callers of collective-reaching functions
        changed = True
        while changed:
            changed = False
            for fi in graph.functions:
                if id(fi.node) in chains:
                    continue
                for call, callee in graph.calls_from(
                        fi, unique_fallback=True):
                    sub = chains.get(id(callee.node))
                    if sub is not None:
                        chains[id(fi.node)] = [
                            (fi.path, call.lineno, callee.qualname)
                        ] + sub
                        changed = True
                        break
        return chains

    # -- per-scope context checks -------------------------------------

    @staticmethod
    def _local_divergent_names(scope: FuncInfo) -> Set[str]:
        """Names assigned from a rank expression in this scope
        (``rank = dist.get_rank()``) become divergence markers."""
        out: Set[str] = set()
        for n in iter_scope(scope.node):
            if isinstance(n, ast.Assign) \
                    and divergent_marker(n.value) is not None:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        return out

    def _ancestor_context(self, node: ast.AST, parents, local_names
                          ) -> Tuple[Optional[ast.If], Optional[str],
                                     Optional[ast.ExceptHandler]]:
        """(divergent If ancestor, its marker, ExceptHandler ancestor)
        — only body/orelse membership counts for the If (sitting in
        the TEST of a rank conditional is how uniform code inspects
        rank, not divergence)."""
        guard = marker = handler = None
        cur = node
        while id(cur) in parents:
            parent, field = parents[id(cur)]
            if (isinstance(parent, ast.If) and field in ("body",
                                                         "orelse")
                    and guard is None):
                m = divergent_marker(parent.test, local_names)
                if m is not None:
                    guard, marker = parent, m
            elif isinstance(parent, ast.IfExp) and guard is None:
                m = divergent_marker(parent.test, local_names)
                if m is not None and field in ("body", "orelse"):
                    guard, marker = parent, m
            elif (isinstance(parent, ast.ExceptHandler)
                  and handler is None):
                handler = parent
            cur = parent
        return guard, marker, handler

    def _uniform_facts(self, node: ast.AST, parents,
                       local_names) -> Dict[str, bool]:
        """The uniform predicates the branches around ``node`` fix."""
        out: Dict[str, bool] = {}
        cur = node
        while id(cur) in parents:
            parent, field = parents[id(cur)]
            if (isinstance(parent, (ast.If, ast.IfExp))
                    and field in ("body", "orelse")
                    and divergent_marker(parent.test,
                                         local_names) is None):
                _facts(parent.test, field == "body", out)
            cur = parent
        return out

    @staticmethod
    def _contradict(a: Dict[str, bool], b: Dict[str, bool]) -> bool:
        return any(k in b and b[k] != v for k, v in a.items())

    def _check_scope(self, graph: ProjectGraph, scope: FuncInfo,
                     chains: Dict[int, List[ChainEntry]],
                     reported: Set[Tuple[int, str]]) -> List[Finding]:
        # collective call sites lexically in this scope
        sites: List[Tuple[ast.Call, List[ChainEntry]]] = []
        for n in iter_scope(scope.node):
            if not isinstance(n, ast.Call):
                continue
            label = self._primitive_label(graph, scope.path, n)
            if label is not None:
                sites.append((n, [(scope.path, n.lineno, label)]))
                continue
            for callee in graph.resolve_call(scope.path, n,
                                             cls=scope.cls,
                                             unique_fallback=True,
                                             scope=scope):
                sub = chains.get(id(callee.node))
                if sub is not None:
                    sites.append((n, [(scope.path, n.lineno,
                                       callee.qualname)] + sub))
                    break
        if not sites:
            return []

        mods = graph.mods
        parents = scope_parents(scope.node)
        local_names = self._local_divergent_names(scope)
        out: List[Finding] = []
        for call, chain in sites:
            sink = chain[-1][2]
            guard, marker, handler = self._ancestor_context(
                call, parents, local_names)
            if guard is not None:
                key = (id(call), "guard")
                if key not in reported:
                    reported.add(key)
                    out.append(_finding(
                        mods, self.rule, scope.path, call.lineno,
                        f"collective '{sink}' is reachable only on "
                        f"ranks passing the rank-divergent guard at "
                        f"{scope.path}:{guard.lineno} ({marker!r}) — "
                        "the other ranks skip it and the group "
                        "deadlocks in the collective (the hang class "
                        "the watchdog can only report post-mortem); "
                        "run it unconditionally or gate on a rank-"
                        "uniform predicate (dist.is_initialized(), "
                        "get_world_size(), step counters, config). "
                        f"chain: {format_chain(chain)}",
                        chain=chain))
            elif handler is not None:
                key = (id(call), "except")
                if key not in reported:
                    reported.add(key)
                    out.append(_finding(
                        mods, self.rule, scope.path, call.lineno,
                        f"collective '{sink}' inside the exception "
                        f"handler at {scope.path}:{handler.lineno} — "
                        "exceptions are rank-local events, so only "
                        "the raising rank enters the collective and "
                        "the group deadlocks; record the error and "
                        "agree on it collectively outside the handler "
                        "(the eval gather's failed flag, "
                        "evalcoco/runner.py). "
                        f"chain: {format_chain(chain)}",
                        chain=chain))
        # rank-divergent early exits BEFORE a collective in this scope
        for n in iter_scope(scope.node):
            if not isinstance(n, (ast.Return, ast.Raise)):
                continue
            exit_facts = self._uniform_facts(n, parents, local_names)
            later = [(c, ch) for c, ch in sites if c.lineno > n.lineno
                     and not self._contradict(exit_facts,
                                              self._uniform_facts(
                                                  c, parents,
                                                  local_names))]
            if not later:
                continue
            call, chain = min(later, key=lambda s: s[0].lineno)
            guard, marker, handler = self._ancestor_context(
                n, parents, local_names)
            reason = None
            if guard is not None:
                reason = (f"rank-divergent guard at {scope.path}:"
                          f"{guard.lineno} ({marker!r})")
            elif handler is not None:
                reason = (f"exception handler at {scope.path}:"
                          f"{handler.lineno} (a rank-local event)")
            if reason is None:
                continue
            kind = ("return" if isinstance(n, ast.Return) else "raise")
            key = (id(n), "early-exit")
            if key in reported:
                continue
            reported.add(key)
            out.append(_finding(
                mods, self.rule, scope.path, n.lineno,
                f"early {kind} under the {reason} exits before the "
                f"collective '{chain[-1][2]}' at {scope.path}:"
                f"{call.lineno} — ranks taking this path skip the "
                "collective while the rest block in it forever; "
                "make the exit rank-uniform or move it after the "
                "collective. "
                f"chain: {format_chain(chain)}",
                chain=chain))
        return out


# -- 2. rng-discipline ------------------------------------------------

#: (repo path, qualnames | "*") — the zero-RNG contract set: the code
#: whose cross-rank schedule and bit-identical-loss tests depend on
#: consuming no RNG.  "*" = every function in the module plus its
#: top-level code.
_RNG_CONTRACT: Sequence[Tuple[str, object]] = (
    ("eksml_tpu_torch/data/loader.py", ("DetectionLoader._materialize",
                                        "DetectionLoader._substitute_for",
                                        "DetectionLoader._resolve_image")),
    ("eksml_tpu_torch/telemetry/tracing.py", "*"),
    ("eksml_tpu_torch/telemetry/aggregate.py", "*"),
)
#: Host RNG modules, by canonical or raw dotted prefix.
_RNG_PREFIXES = ("numpy.random.", "np.random.", "random.",
                 "torch.random.")
#: torch's sampling functions and seeding, by canonical name.
_TORCH_DRAWS = frozenset("torch." + n for n in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
    "manual_seed", "seed"))
#: In-place draws on a tensor, by method name (any receiver).
_INPLACE_DRAWS = ("uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "log_normal_", "cauchy_")
#: Method calls on an RNG-ish receiver: self.rng.shuffle(...),
#: self.generator.manual_seed(...) — the loader's numpy streams and the
#: trainer's ``torch.Generator``.
_RNG_RECEIVER = re.compile(r"(^|_)(rng|random_state|gen|generator)$")


class RngDisciplineChecker:
    """The zero-RNG contract set stays RNG-free through any chain.

    The loader substitutes a quarantined record by walking dedicated
    cursors precisely so batch shapes and the cross-rank bucket/draw
    schedule survive a single-rank quarantine; tracing and aggregation
    ride the hot path under bit-identical-loss tests.  ONE draw — even
    two modules away — shifts that rank's RNG stream and the group's
    schedule agreement silently breaks (the deadlock surfaces steps
    later, far from the cause).  A draw is a ``numpy.random``,
    ``random`` or ``torch.random`` call, one of torch's samplers
    (``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
    ``bernoulli``/``multinomial``/``manual_seed`` …), an in-place draw
    on a tensor (``uniform_``, ``normal_``, ``random_``, ``bernoulli_``,
    ``exponential_`` …), or any method on an RNG or
    ``torch.Generator`` receiver (``rng``, ``gen``, ``generator``).
    """

    rule = RULE_RNG

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        reported: Set[int] = set()
        for contract, quals in _RNG_CONTRACT:
            for path in _paths_matching(graph, contract):
                roots: List[FuncInfo] = []
                if quals == "*":
                    roots = [fi for fi in graph.functions
                             if fi.path == path]
                    roots.append(graph.module_scopes[path])
                else:
                    for q in quals:
                        fi = graph.lookup(path, q)
                        if fi is not None:
                            roots.append(fi)
                for fi, chain in graph.reachable(
                        roots, unique_fallback=True).values():
                    findings.extend(self._scan(graph, fi, chain,
                                               contract, reported))
        return findings

    def _scan(self, graph: ProjectGraph, fi: FuncInfo,
              chain: List[ChainEntry], contract_path: str,
              reported: Set[int]) -> List[Finding]:
        out: List[Finding] = []
        nodes = (iter_scope(fi.node) if fi.is_module
                 else walk(fi.node))
        for n in nodes:
            if not isinstance(n, ast.Call) or id(n) in reported:
                continue
            what = self._rng_call(graph, fi.path, n)
            if what is None:
                continue
            reported.add(id(n))
            full = chain + [(fi.path, n.lineno, what)]
            out.append(_finding(
                graph.mods, self.rule, fi.path, n.lineno,
                f"RNG draw {what} is reachable from the zero-RNG "
                f"contract set ({contract_path}) — quarantine "
                "substitution, span tracing and telemetry aggregation "
                "must consume NO RNG or the cross-rank batch schedule "
                "and the bit-identical losses silently break; use "
                "deterministic cursors (loader _sub_pos pattern) or "
                "hoist the draw out of the contract path. "
                f"chain: {format_chain(full)}",
                chain=full))
        return out

    def _rng_call(self, graph: ProjectGraph, path: str,
                  call: ast.Call) -> Optional[str]:
        c = chain_of(call.func)
        canon = graph.canonical(path, call.func)
        for cand in filter(None, (canon, ".".join(c) if c else None)):
            if cand in _TORCH_DRAWS or any(cand.startswith(prefix)
                                           for prefix in _RNG_PREFIXES):
                disp = ".".join(c) if c else cand
                return f"{disp}()"
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INPLACE_DRAWS:
            return (".".join(c) if c else "." + call.func.attr) + "()"
        if c is not None and len(c) >= 2 \
                and _RNG_RECEIVER.search(c[-2]):
            return ".".join(c) + "()"
        return None


# -- 3. host-sync ------------------------------------------------------

_HOT_ROOTS: Sequence[Tuple[str, Tuple[str, ...]]] = (
    ("eksml_tpu_torch/train.py", ("Trainer.fit",)),
    ("eksml_tpu_torch/data/loader.py", ("DevicePrefetcher.__next__",
                                        "DevicePrefetcher._produce")),
)
#: Once-per-incident / once-per-run boundaries the hot-path walk does
#: not enter: restore, rollback, eval, capture set-up and teardown,
#: graceful exit, the first step's roofline count — and the log-step
#: aggregation collective (its blocking is the price of the cross-rank
#: view, paid at LOG_PERIOD cadence).  The replica sync check is
#: SYNC_CHECK_PERIOD-gated debug mode — a deliberate sync.  Every name
#: is a def of the port (``tests/test_torch_analysis_spmd.py`` holds
#: that).
SYNC_COLD = frozenset((
    "restore_or_init", "init_state", "_rollback", "_graceful_exit",
    "_run_eval", "_start_capture", "_finish_capture", "_counted_step",
    "aggregate_host_scalars", "assert_replicas_in_sync",
))
#: Canonical calls that wait for the device.
_SYNC_CANONICAL = ("torch.cuda.synchronize",)
#: Host copies of their argument: a sync when it is a tensor.
_HOST_COPIES = ("numpy.asarray", "numpy.array", "np.asarray", "np.array")
#: Tensor methods that copy to the host (``.cpu()`` of a CUDA tensor
#: waits for the stream) — matched with no arguments, or ``numpy``'s
#: ``force=``.
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: Names that hold the step's tensors in the port (``metrics``,
#: ``losses``, ``grad_norm`` …): the static stand-in for a type.
_TENSORISH = re.compile(
    r"(^|_)(metrics|losses?|logits|grads?|grad_norm|norm|tensors?)$")
#: Tensor methods whose result is still a tensor.
_TENSOR_METHODS = frozenset((
    "sum", "mean", "max", "min", "amax", "amin", "norm", "abs", "any",
    "all", "isfinite", "detach", "float", "double", "half", "to",
    "cuda", "clone", "sqrt", "square", "argmax", "argmin", "std",
))


def _is_tensor_expr(graph: ProjectGraph, path: str, node: ast.AST,
                    tensor_names: Set[str]) -> bool:
    """Whether ``node`` is (statically) a tensor: a ``torch.*`` call, a
    tensor method's result, or a name (or subscript of one) that holds
    the step's tensors."""
    for n in walk(node):
        if isinstance(n, ast.Call):
            canon = graph.canonical(path, n.func) or ""
            if canon.startswith("torch.") \
                    and not canon.startswith("torch.cuda."):
                return True
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _TENSOR_METHODS
                    and not canon.startswith(("numpy.", "np.", "math."))
                    and _is_tensor_expr(graph, path, n.func.value,
                                        tensor_names)):
                return True
        elif isinstance(n, ast.Name) and (n.id in tensor_names
                                          or _TENSORISH.search(n.id)):
            return True
        elif isinstance(n, ast.Attribute) and _TENSORISH.search(n.attr):
            return True
    return False


def _tensor_targets(loop) -> Set[str]:
    """The targets of a ``for`` or comprehension over a tensor-ish
    mapping (``for k, v in metrics.items()``): they hold tensors too."""
    it = loop.iter.func if isinstance(loop.iter, ast.Call) else loop.iter
    c = chain_of(it)
    if not c or not any(_TENSORISH.search(p) for p in c):
        return set()
    return {t.id for t in walk(loop.target) if isinstance(t, ast.Name)}


def _tensor_names(fi: FuncInfo) -> Dict[int, Set[str]]:
    """{id(call): tensor-holding loop names visible at the call}: a
    ``for`` loop's targets over the whole function, a comprehension's
    inside that comprehension only."""
    scope: Set[str] = set()
    for n in walk(fi.node):
        if isinstance(n, ast.For):
            scope |= _tensor_targets(n)
    out: Dict[int, Set[str]] = {}
    for n in walk(fi.node):
        if isinstance(n, ast.Call):
            out.setdefault(id(n), set()).update(scope)
        elif isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp,
                            ast.GeneratorExp)):
            names: Set[str] = set()
            for gen in n.generators:
                names |= _tensor_targets(gen)
            if names:
                for sub in walk(n):
                    if isinstance(sub, ast.Call):
                        out.setdefault(id(sub), set()).update(names)
    return out


class HostSyncChecker:
    """Per-step host syncs on the hot loop are findings by default.

    A ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` of a CUDA
    tensor, ``torch.cuda.synchronize()``, an ``Event``/``Stream``
    ``.synchronize()``, ``np.asarray``/``np.array`` of a tensor or a
    ``float``/``int``/``bool`` of one stalls the host until the card
    catches up — once per step, it serializes dispatch against
    execution and the async prefetch win evaporates.  "A tensor" is
    decided statically: a ``torch.*`` call, a tensor method's result,
    or a name matching the port's tensor names (``metrics``,
    ``losses``, ``grads`` …) and the loop variables over them.  The
    rule is deliberately strict inside the narrow hot set; the legal
    sites (loss materialization at log steps, the sentinel's
    observation at its cadence) carry inline
    ``# eksml-lint: disable=host-sync`` suppressions whose comments
    justify the cadence.
    """

    rule = RULE_SYNC

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        roots: List[FuncInfo] = []
        for contract, quals in _HOT_ROOTS:
            for path in _paths_matching(graph, contract):
                for q in quals:
                    fi = graph.lookup(path, q)
                    if fi is not None:
                        roots.append(fi)
        findings: List[Finding] = []
        reported: Set[int] = set()
        for fi, chain in graph.reachable(
                roots, unique_fallback=True,
                stop_names=SYNC_COLD).values():
            findings.extend(self._scan(graph, fi, chain, reported))
        return findings

    def _scan(self, graph: ProjectGraph, fi: FuncInfo,
              chain: List[ChainEntry],
              reported: Set[int]) -> List[Finding]:
        out: List[Finding] = []
        tensor_names = _tensor_names(fi)
        for n in walk(fi.node):
            if not isinstance(n, ast.Call) or id(n) in reported:
                continue
            what = self._sync_call(graph, fi.path, n,
                                   tensor_names.get(id(n), set()))
            if what is None:
                continue
            reported.add(id(n))
            full = chain + [(fi.path, n.lineno, what)]
            out.append(_finding(
                graph.mods, self.rule, fi.path, n.lineno,
                f"per-step host sync {what} reachable from the hot "
                "step path — the host blocks until the device drains, "
                "serializing dispatch against execution every step; "
                "move it behind a log/checkpoint-period predicate, or "
                "if this site's cadence is already bounded, suppress "
                "inline with a justification "
                "(# eksml-lint: disable=host-sync). "
                f"chain: {format_chain(full)}",
                chain=full))
        return out

    def _sync_call(self, graph: ProjectGraph, path: str, call: ast.Call,
                   tensor_names: Set[str]) -> Optional[str]:
        c = chain_of(call.func)
        canon = graph.canonical(path, call.func)
        disp = ".".join(c) if c else unparse(call.func)
        for cand in filter(None, (canon, ".".join(c) if c else None)):
            if cand in _SYNC_CANONICAL:
                return disp + "()"
            if cand in _HOST_COPIES and call.args and _is_tensor_expr(
                    graph, path, call.args[0], tensor_names):
                return disp + "()"
        if isinstance(call.func, ast.Name) \
                and call.func.id in ("float", "int", "bool") \
                and len(call.args) == 1 and _is_tensor_expr(
                    graph, path, call.args[0], tensor_names):
            return f"{call.func.id}({unparse(call.args[0])})"
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _SYNC_METHODS and not call.args and (
                    not call.keywords or attr == "numpy"):
                return f".{attr}()"
            if attr == "synchronize" and not call.args:
                return disp + "()"
        return None


# -- 4. recompile-hazard -----------------------------------------------

#: Factories whose result is the training step (a name assigned from
#: one is a watched callable).
STEP_FACTORIES = ("make_train_step",)
#: Constructors whose size arguments make a new shape.
_SIZED_CTORS = frozenset("torch." + n for n in (
    "zeros", "empty", "full", "ones", "arange", "rand", "randn",
    "randint"))
_SIZED_METHODS = ("new_zeros", "new_empty", "new_full", "new_ones")
_PAD_CALLS = ("torch.nn.functional.pad",)


def _cfg_exempt(node: ast.AST) -> bool:
    """len/shape of config-derived values is rank-uniform and stable
    across batches — the static-shape schedule itself lives in cfg
    (PREPROC.BUCKETS), so cfg-rooted scalars never autotune a new
    shape."""
    for n in walk(node):
        if isinstance(n, ast.Name) and "cfg" in n.id.lower():
            return True
        if isinstance(n, ast.Name) and n.id in ("config", "_C"):
            return True
        if isinstance(n, ast.Attribute) and n.attr.lower() == "buckets":
            return True
    return False


def _batch_scalar(node: ast.AST) -> Optional[str]:
    """The first batch-content ``len(...)`` or ``.shape[i]`` in
    ``node`` (cfg-derived ones exempt), as source."""
    for n in walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "len" and n.args
                and not _cfg_exempt(n.args[0])):
            return f"len({unparse(n.args[0])})"
        if (isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "shape"
                and not isinstance(n.slice, ast.Slice)
                and not _cfg_exempt(n.value)):
            return unparse(n)
    return None


class RecompileHazardChecker:
    """Batch-content Python scalars must not size what reaches the
    training step or a model forward.

    The port has no compile cache: its "compile" is the first forward
    at a new input shape under cuDNN autotune (``serve/engine.py``
    counts it as ``request_path_compiles``; a new shape costs seconds at
    flagship sizes, 12 s at 1344² on the H100).  Every distinct
    ``len(batch)``/``tensor.shape[i]`` value that sizes a tensor
    (``torch.zeros/empty/full/ones``, ``new_zeros``…, a slice bound,
    ``F.pad``) fed to such a call is a new shape — the failure mode the
    bucketed-padding schedule (``PREPROC.BUCKETS`` → loader
    ``assign_bucket``) exists to prevent.  The sizing expression may sit
    in the argument or in a name of the same scope bound to it.

    Watched calls: names assigned from ``make_train_step(...)``,
    ``model(...)``/``self.model(...)`` and ``*.model.predict(...)``/
    ``model.predict(...)``.  PyTorch has no pytree-structure key, so the
    reference's per-batch dict-key case has no counterpart.
    """

    rule = RULE_RECOMPILE

    def check_graph(self, graph: ProjectGraph) -> List[Finding]:
        findings: List[Finding] = []
        for path, mod in graph.mods.items():
            findings.extend(self._check_module(graph, path, mod))
        return findings

    @staticmethod
    def _watched(call: ast.Call, steps: Set[str]) -> Optional[str]:
        c = chain_of(call.func)
        if c is None:
            return None
        if c[-1] in steps:
            return c[-1]
        if c[-1] == "model" or (len(c) >= 2 and c[-2:] ==
                                ("model", "predict")):
            return ".".join(c)
        return None

    def _check_module(self, graph: ProjectGraph, path: str,
                      mod: ModuleInfo) -> List[Finding]:
        steps: Set[str] = set()
        for n in walk(mod.tree):
            if isinstance(n, ast.Assign) and isinstance(n.value,
                                                        ast.Call):
                c = chain_of(n.value.func)
                if c and c[-1] in STEP_FACTORIES:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            steps.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            steps.add(t.attr)
        out: List[Finding] = []
        # one pass: each scope's name bindings and watched calls
        bound: Dict[int, Dict[str, List[ast.AST]]] = {}
        watched: List[Tuple[ast.Call, str, int]] = []

        def visit(node: ast.AST, scope: int) -> None:
            for child in children(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    inner = id(child)
                elif isinstance(child, ast.Assign):
                    for t in child.targets:
                        if isinstance(t, ast.Name):
                            bound.setdefault(scope, {}).setdefault(
                                t.id, []).append(child.value)
                elif isinstance(child, ast.Call):
                    name = self._watched(child, steps)
                    if name is not None:
                        watched.append((child, name, scope))
                visit(child, inner)

        visit(mod.tree, id(mod.tree))
        for call, name, scope in watched:
            out.extend(self._check_args(graph, path, call, name,
                                        bound.get(scope, {})))
        return out

    def _sizing(self, graph: ProjectGraph, path: str,
                expr: ast.AST) -> Optional[Tuple[ast.AST, str]]:
        """(node, description) of the first tensor sized by a batch
        scalar in ``expr``."""
        for n in walk(expr):
            sizes: List[ast.AST] = []
            if isinstance(n, ast.Call):
                canon = graph.canonical(path, n.func) or ""
                if canon in _SIZED_CTORS:
                    sizes = list(n.args) + [kw.value for kw in n.keywords
                                            if kw.arg == "size"]
                elif canon in _PAD_CALLS or (
                        canon.endswith(".pad") and canon.startswith(
                            ("F.", "torch.nn.functional."))):
                    sizes = list(n.args[1:2]) + [
                        kw.value for kw in n.keywords if kw.arg == "pad"]
                elif (isinstance(n.func, ast.Attribute)
                      and n.func.attr in _SIZED_METHODS):
                    sizes = list(n.args[:1])
            elif isinstance(n, ast.Subscript):
                for sl in walk(n.slice):
                    if isinstance(sl, ast.Slice):
                        sizes += [b for b in (sl.lower, sl.upper)
                                  if b is not None]
            for size in sizes:
                what = _batch_scalar(size)
                if what is not None:
                    return n, what
        return None

    def _check_args(self, graph: ProjectGraph, path: str,
                    call: ast.Call, name: str,
                    bound: Dict[str, List[ast.AST]]) -> List[Finding]:
        out: List[Finding] = []
        args = list(call.args) + [kw.value for kw in call.keywords]
        for i, arg in enumerate(args):
            # the argument and what its names are bound to, transitively
            exprs: List[ast.AST] = [arg]
            seen: Set[str] = set()
            for expr in exprs:
                for n in walk(expr):
                    if isinstance(n, ast.Name) and n.id not in seen:
                        seen.add(n.id)
                        exprs.extend(bound.get(n.id, ()))
            for expr in exprs:
                hit = self._sizing(graph, path, expr)
                if hit is None:
                    continue
                node, what = hit
                out.append(_finding(
                    graph.mods, self.rule, path, node.lineno,
                    f"argument {i} of '{name}' is sized by a batch-"
                    f"content Python scalar ({what}) — every distinct "
                    "value is a new input shape, which cuDNN autotunes "
                    "anew on the request path; route shapes through the "
                    "static-shape schedule (PREPROC.BUCKETS -> "
                    "data/loader.py assign_bucket, the engine's batch "
                    "rungs) or size from config, not batch content"))
                break   # one finding per argument is enough
        return out


def build_spmd_checkers() -> List[object]:
    return [CollectiveOrderChecker(), RngDisciplineChecker(),
            HostSyncChecker(), RecompileHazardChecker()]
