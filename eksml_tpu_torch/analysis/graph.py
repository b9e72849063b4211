"""Cross-module call graph: the whole-program half of eksml-lint (the
port of ``eksml_tpu/analysis/graph.py``, unchanged in behaviour).

A per-module checker resolves calls within one module (plain ``f()``
plus ``self.m()``/``cls.m()``); its escape hatch is an impure or
divergent helper *one import away*.  This module closes it: imports
are resolved across the linted set — ``import a.b as c``, ``from x
import y`` aliasing (including transitive re-exports through
``__init__.py``), relative imports — calls resolve to :class:`FuncInfo`
nodes in other modules, and reachability records the call chain
root → sink so a finding can name every hop.

Resolution rules, in order (a miss falls through to the next):

1. ``f()`` — the module's symbol table: top-level defs, then imported
   names following re-export chains (cycle-guarded); else any
   same-named def in the module (an over-approximation).
2. ``self.m()`` / ``cls.m()`` — methods of the enclosing class, else
   same-module defs, else (checkers that opt into
   ``unique_fallback``) the project-wide unique def of that name.
3. ``mod.sub.f()`` — resolve ``mod`` through the symbol table, descend
   submodules; a final hit on an internal def resolves.  External
   heads yield a *canonical* dotted name for the pattern checkers
   (``np.random.rand`` → ``numpy.random.rand``), so aliasing can't
   hide a pattern.
4. ``obj.m()`` on an unresolvable receiver — only with
   ``unique_fallback``: resolve iff exactly ONE def in the linted set
   bears that name (errs toward checking more code, never less).

Known blind spots: dynamic
``getattr`` dispatch, callables stored in containers/closures or
returned by factories, duck-typed receivers whose method name has
multiple defs, ``*args`` forwarding.  The over-approximations widen
what a checker sees; the blind spots bound it — neither silently
disables a rule.
"""

from __future__ import annotations

import ast
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from eksml_tpu_torch.analysis.engine import ModuleInfo


def children(node: ast.AST) -> List[ast.AST]:
    """``list(children(node))``, computed once per node: every
    rule walks the same trees, many of them more than once."""
    try:
        return node._lint_children
    except AttributeError:
        out = []
        for name in node._fields:
            value = getattr(node, name, None)
            if isinstance(value, ast.AST):
                out.append(value)
            elif isinstance(value, list):
                out.extend(v for v in value if isinstance(v, ast.AST))
        node._lint_children = out
        return out


def walk(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` (the same order) over :func:`children`."""
    todo = deque([node])
    while todo:
        n = todo.popleft()
        todo.extend(children(n))
        yield n


def chain_of(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` → ("a", "b", "c"); None when the root isn't a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — diagnostics only
        return "<expr>"


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                ast.Lambda)


def iter_scope(root: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ONE lexical scope: no descent into nested function/
    class/lambda bodies (they are their own scopes/FuncInfos)."""
    todo = list(children(root))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, _SCOPE_NODES):
            todo.extend(children(n))


def _iter_own(root: ast.AST,
              with_lambdas: bool = True) -> Iterator[ast.AST]:
    """Like :func:`iter_scope` but descending into lambda bodies —
    inline lambdas (``tree.map(lambda x: …)``) execute in the
    enclosing function's dynamic extent, so their calls belong to it."""
    todo = list(children(root))
    while todo:
        n = todo.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(n, ast.Lambda) and not with_lambdas:
            continue
        todo.extend(children(n))


def _binding_names(target: ast.AST) -> Iterator[str]:
    for n in walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def scope_parents(root: ast.AST) -> Dict[int, Tuple[ast.AST, str]]:
    """{id(node): (parent, field)} within one scope — the ancestor map
    the context checks (divergent ``if`` branch, ``except`` handler)
    walk.  Nested defs appear as children but are not entered."""
    out: Dict[int, Tuple[ast.AST, str]] = {}

    def rec(n: ast.AST) -> None:
        for field, value in ast.iter_fields(n):
            kids = value if isinstance(value, list) else [value]
            for ch in kids:
                if isinstance(ch, ast.AST):
                    out[id(ch)] = (n, field)
                    if not isinstance(ch, _SCOPE_NODES):
                        rec(ch)

    rec(root)
    return out


class FuncInfo:
    """One function/method (or a module's top-level scope)."""

    __slots__ = ("path", "qualname", "name", "node", "cls",
                 "is_module", "parent")

    def __init__(self, path: str, qualname: str, node: ast.AST,
                 cls: Optional[str] = None, is_module: bool = False,
                 parent: Optional["FuncInfo"] = None):
        self.path = path
        self.qualname = qualname
        self.name = qualname.rsplit(".", 1)[-1]
        self.node = node
        self.cls = cls          # innermost enclosing class (for self.)
        self.is_module = is_module
        self.parent = parent    # lexically enclosing function, if any

    def __repr__(self) -> str:
        return f"<{self.path}:{self.qualname}>"


#: A call-chain entry: (path, call-site line, callee description).
ChainEntry = Tuple[str, int, str]


def chain_dicts(chain: Iterable[ChainEntry]) -> List[dict]:
    return [{"path": p, "line": l, "name": n} for p, l, n in chain]


def format_chain(chain: Iterable[ChainEntry]) -> str:
    return " -> ".join(f"{p}:{l} {n}" for p, l, n in chain)


class ProjectGraph:
    """Symbol tables + call resolution over the whole linted set."""

    def __init__(self, mods: Dict[str, ModuleInfo]):
        self.mods = mods
        self.modname: Dict[str, str] = {}
        self.path_of: Dict[str, str] = {}
        for path in mods:
            name = path[:-3] if path.endswith(".py") else path
            name = name.replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self.modname[path] = name
            self.path_of[name] = path

        self._raw: Dict[str, Dict[str, tuple]] = {}
        self._top_funcs: Dict[str, Dict[str, FuncInfo]] = {}
        self._classes: Dict[str, Dict[str, Dict[str, FuncInfo]]] = {}
        self._name_index: Dict[str, Dict[str, List[FuncInfo]]] = {}
        self._by_name: Dict[str, List[FuncInfo]] = {}
        self.functions: List[FuncInfo] = []
        self.module_scopes: Dict[str, FuncInfo] = {}
        self._sym_cache: Dict[Tuple[str, str], Optional[tuple]] = {}
        self._calls_cache: Dict[Tuple[int, bool],
                                List[Tuple[ast.Call, FuncInfo]]] = {}
        self._by_node: Dict[int, FuncInfo] = {}
        self._children: Dict[int, List[FuncInfo]] = {}
        self._locals_cache: Dict[int, set] = {}
        self._resolve_cache: Dict[tuple, List[FuncInfo]] = {}
        for path, mod in mods.items():
            self._scan(path, mod)

    # -- construction --------------------------------------------------

    def _scan(self, path: str, mod: ModuleInfo) -> None:
        raw: Dict[str, tuple] = {}
        topf: Dict[str, FuncInfo] = {}
        classes: Dict[str, Dict[str, FuncInfo]] = {}
        idx: Dict[str, List[FuncInfo]] = {}

        def rec(node: ast.AST, stack: List[str], cls: Optional[str],
                in_class_body: bool,
                parent: Optional[FuncInfo]) -> None:
            for child in children(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qual = ".".join(stack + [child.name])
                    fi = FuncInfo(path, qual, child, cls=cls,
                                  parent=parent)
                    self.functions.append(fi)
                    self._by_node[id(child)] = fi
                    if parent is not None:
                        self._children.setdefault(
                            id(parent.node), []).append(fi)
                    idx.setdefault(child.name, []).append(fi)
                    self._by_name.setdefault(child.name, []).append(fi)
                    if not stack:
                        topf[child.name] = fi
                    if in_class_body and cls is not None:
                        classes.setdefault(cls, {})[child.name] = fi
                    rec(child, stack + [child.name], cls, False, fi)
                elif isinstance(child, ast.ClassDef):
                    classes.setdefault(child.name, {})
                    # a class body is not a closure scope: methods'
                    # enclosing VARIABLE scope stays `parent`
                    rec(child, stack + [child.name], child.name, True,
                        parent)
                else:
                    rec(child, stack, cls, in_class_body, parent)

        rec(mod.tree, [], None, False, None)

        for node in walk(mod.tree):
            # imports anywhere (the repo's deferred-import idiom) bind
            # into one flat module namespace — an over-approximation
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        raw[a.asname] = ("module", a.name)
                    else:
                        root = a.name.split(".")[0]
                        raw.setdefault(root, ("module", root))
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(path, node)
                for a in node.names:
                    if a.name != "*":
                        raw[a.asname or a.name] = ("from", base, a.name)

        self._raw[path] = raw
        self._top_funcs[path] = topf
        self._classes[path] = classes
        self._name_index[path] = idx
        self.module_scopes[path] = FuncInfo(path, "<module>", mod.tree,
                                            is_module=True)

    def _from_base(self, path: str, node: ast.ImportFrom) -> str:
        if not node.level:
            return node.module or ""
        parts = self.modname[path].split(".")
        drop = node.level - (1 if path.endswith("__init__.py") else 0)
        if drop > 0:
            parts = parts[: max(0, len(parts) - drop)]
        base = ".".join(parts)
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
        return base

    # -- symbol / name resolution --------------------------------------

    def resolve_symbol(self, path: str, name: str,
                       _seen: Optional[set] = None) -> Optional[tuple]:
        """A module-level name → ("func", FuncInfo) | ("class",
        (path, clsname)) | ("module", dotted) | ("external", dotted)
        | None, following re-export chains with a cycle guard."""
        key = (path, name)
        if key in self._sym_cache:
            return self._sym_cache[key]
        if _seen is None:
            _seen = set()
        if key in _seen:
            return None
        _seen.add(key)
        out: Optional[tuple] = None
        fi = self._top_funcs.get(path, {}).get(name)
        if fi is not None:
            out = ("func", fi)
        elif name in self._classes.get(path, {}):
            out = ("class", (path, name))
        else:
            rawb = self._raw.get(path, {}).get(name)
            if rawb is not None:
                out = self._resolve_raw(rawb, _seen)
        self._sym_cache[key] = out
        return out

    def _resolve_raw(self, rawb: tuple, _seen: set) -> Optional[tuple]:
        if rawb[0] == "module":
            dotted = rawb[1]
            return (("module", dotted) if dotted in self.path_of
                    else ("external", dotted))
        _, base, name = rawb
        if base in self.path_of:
            r = self.resolve_symbol(self.path_of[base], name, _seen)
            if r is not None:
                return r
            if f"{base}.{name}" in self.path_of:
                return ("module", f"{base}.{name}")
            return ("external", f"{base}.{name}")
        return ("external", f"{base}.{name}" if base else name)

    def canonical(self, path: str, expr: ast.AST) -> Optional[str]:
        """Dotted call target with import aliases resolved to canonical
        names (``np.random.rand`` → ``numpy.random.rand``); unbound
        heads (builtins, locals) pass through verbatim."""
        c = chain_of(expr)
        if c is None:
            return None
        head = self.resolve_symbol(path, c[0])
        if head is None:
            return ".".join(c)
        kind, val = head
        if kind in ("module", "external"):
            return ".".join((val,) + c[1:])
        if kind == "func":
            fi = val
            base = f"{self.modname[fi.path]}.{fi.qualname}"
            return ".".join((base,) + c[1:])
        cpath, cname = val
        base = f"{self.modname[cpath]}.{cname}"
        return ".".join((base,) + c[1:])

    def _unique(self, name: str) -> List[FuncInfo]:
        fis = self._by_name.get(name, ())
        return list(fis) if len(fis) == 1 else []

    def _class_init(self, cpath: str, cname: str) -> List[FuncInfo]:
        init = self._classes.get(cpath, {}).get(cname, {}).get("__init__")
        return [init] if init is not None else []

    def _resolve_dotted(self, dotted: str,
                        attrs: Tuple[str, ...]) -> List[FuncInfo]:
        cur = dotted
        for i, a in enumerate(attrs):
            mpath = self.path_of.get(cur)
            if mpath is None:
                return []
            if i == len(attrs) - 1:
                r = self.resolve_symbol(mpath, a)
                if r is not None and r[0] == "func":
                    return [r[1]]
                if r is not None and r[0] == "class":
                    return self._class_init(*r[1])
                return []
            r = self.resolve_symbol(mpath, a)
            if r is not None and r[0] == "module":
                cur = r[1]
            elif f"{cur}.{a}" in self.path_of:
                cur = f"{cur}.{a}"
            else:
                return []
        return []

    def resolve_name_ref(self, path: str, name: str,
                         cls: Optional[str] = None) -> List[FuncInfo]:
        """A bare function REFERENCE (jit target, handler arg) → defs:
        symbol table first, then the module name index, then the
        enclosing class's methods."""
        r = self.resolve_symbol(path, name)
        if r is not None and r[0] == "func":
            return [r[1]]
        out = list(self._name_index.get(path, {}).get(name, ()))
        if not out and cls is not None:
            m = self._classes.get(path, {}).get(cls, {}).get(name)
            if m is not None:
                out = [m]
        return out

    def _own_locals(self, fi: FuncInfo) -> set:
        """Names BOUND in *fi*'s own scope (params, assignments, loop/
        with/except targets) — a call through such a name must not
        resolve to a same-named module-level def or import (the
        ``main = piecewise_constant_schedule(...)`` shadow class)."""
        cached = self._locals_cache.get(id(fi.node))
        if cached is not None:
            return cached
        out: set = set()
        args = getattr(fi.node, "args", None)
        if args is not None and not fi.is_module:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                out.add(a.arg)
            if args.vararg:
                out.add(args.vararg.arg)
            if args.kwarg:
                out.add(args.kwarg.arg)
        if not fi.is_module:
            for n in _iter_own(fi.node, with_lambdas=False):
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        out.update(_binding_names(t))
                elif isinstance(n, (ast.AnnAssign, ast.AugAssign,
                                    ast.NamedExpr)):
                    out.update(_binding_names(n.target))
                elif isinstance(n, (ast.For, ast.AsyncFor)):
                    out.update(_binding_names(n.target))
                elif isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        if item.optional_vars is not None:
                            out.update(_binding_names(
                                item.optional_vars))
                elif isinstance(n, ast.ExceptHandler) and n.name:
                    out.add(n.name)
        self._locals_cache[id(fi.node)] = out
        return out

    def _is_shadowed(self, scope: Optional[FuncInfo],
                     name: str) -> bool:
        cur = scope
        while cur is not None:
            if name in self._own_locals(cur):
                return True
            cur = cur.parent
        return False

    def resolve_call(self, path: str, call: ast.Call,
                     cls: Optional[str] = None,
                     unique_fallback: bool = False,
                     scope: Optional[FuncInfo] = None
                     ) -> List[FuncInfo]:
        key = (path, id(call), cls, unique_fallback,
               id(scope.node) if scope is not None else None)
        cached = self._resolve_cache.get(key)
        if cached is None:
            cached = self._resolve_call(path, call, cls, unique_fallback,
                                        scope)
            self._resolve_cache[key] = cached
        return list(cached)

    def imported(self, path: str, name: str) -> bool:
        """Whether ``name`` is bound by an import in ``path`` (a call
        through it may be an alias of any external function)."""
        return name in self._raw.get(path, ())

    def _resolve_call(self, path: str, call: ast.Call,
                      cls: Optional[str], unique_fallback: bool,
                      scope: Optional[FuncInfo]) -> List[FuncInfo]:
        f = call.func
        out: List[FuncInfo] = []
        if isinstance(f, ast.Name):
            if self._is_shadowed(scope, f.id):
                pass        # a local callable — opaque by design
            else:
                r = self.resolve_symbol(path, f.id)
                if r is not None and r[0] == "func":
                    out = [r[1]]
                elif r is not None and r[0] == "class":
                    out = self._class_init(*r[1])
                elif r is None:
                    out = list(self._name_index.get(path,
                                                    {}).get(f.id, ()))
        elif isinstance(f, ast.Attribute):
            c = chain_of(f)
            if c is not None and c[0] in ("self", "cls") and len(c) == 2:
                m = (self._classes.get(path, {}).get(cls, {}).get(c[1])
                     if cls is not None else None)
                if m is not None:
                    out = [m]
                else:
                    out = list(self._name_index.get(path, {})
                               .get(c[1], ()))
                    if not out and unique_fallback:
                        out = self._unique(c[1])
            elif c is not None:
                head = (None if self._is_shadowed(scope, c[0])
                        else self.resolve_symbol(path, c[0]))
                if head is not None and head[0] == "module":
                    out = self._resolve_dotted(head[1], c[1:])
                elif (head is not None and head[0] == "class"
                      and len(c) == 2):
                    cpath, cname = head[1]
                    m = self._classes.get(cpath, {}).get(cname,
                                                         {}).get(c[1])
                    out = [m] if m is not None else []
                elif head is None and unique_fallback:
                    # local-var / self.attr-chained receiver
                    out = self._unique(c[-1])
            elif unique_fallback:
                # non-Name-rooted receiver: x().m(), a[0].m()
                out = self._unique(f.attr)
        seen, deduped = set(), []
        for fi in out:
            if id(fi.node) not in seen:
                seen.add(id(fi.node))
                deduped.append(fi)
        return deduped

    # -- call graph ----------------------------------------------------

    def calls_from(self, fi: FuncInfo, unique_fallback: bool = False
                   ) -> List[Tuple[ast.Call, FuncInfo]]:
        """Resolved call sites inside *fi*.  A function's edges are its
        own scope's calls (inline lambdas included) PLUS its nested
        defs' edges — closures are almost always invoked — each
        resolved in the INNERMOST scope so local shadowing is honored.
        Module scopes walk top-level code only (functions are their
        own scopes)."""
        key = (id(fi.node), unique_fallback)
        cached = self._calls_cache.get(key)
        if cached is not None:
            return cached
        nodes = (iter_scope(fi.node) if fi.is_module
                 else _iter_own(fi.node))
        out: List[Tuple[ast.Call, FuncInfo]] = []
        for n in nodes:
            if isinstance(n, ast.Call):
                for callee in self.resolve_call(
                        fi.path, n, cls=fi.cls,
                        unique_fallback=unique_fallback, scope=fi):
                    out.append((n, callee))
        if not fi.is_module:
            for child in self._children.get(id(fi.node), ()):
                out.extend(self.calls_from(child, unique_fallback))
        self._calls_cache[key] = out
        return out

    def nested_defs(self, fi: FuncInfo) -> List[FuncInfo]:
        """Functions defined directly inside *fi* (closures/workers)."""
        return list(self._children.get(id(fi.node), ()))

    def class_method(self, path: str, cls: Optional[str],
                     name: str) -> Optional[FuncInfo]:
        """Method *name* of class *cls* in *path*, if both exist."""
        if cls is None:
            return None
        return self._classes.get(path, {}).get(cls, {}).get(name)

    def class_bases(self, path: str, cls: str) -> List[ast.expr]:
        """Base-class expressions of a ClassDef (for checkers that
        classify subclass trees, e.g. BaseHTTPRequestHandler do_*)."""
        for node in walk(self.mods[path].tree):
            if isinstance(node, ast.ClassDef) and node.name == cls:
                return list(node.bases)
        return []

    def reachable(self, roots: Iterable[FuncInfo],
                  unique_fallback: bool = False,
                  stop_names: Iterable[str] = ()
                  ) -> Dict[int, Tuple[FuncInfo, List[ChainEntry]]]:
        """BFS over the call graph from *roots*; every reached function
        carries the call chain (path, line, callee) that found it.
        ``stop_names``: bare function names NOT descended into (a
        checker's documented cold/legal boundary)."""
        stop = set(stop_names)
        seen: Dict[int, Tuple[FuncInfo, List[ChainEntry]]] = {}
        queue: List[FuncInfo] = []
        for r in roots:
            if id(r.node) not in seen:
                seen[id(r.node)] = (r, [])
                queue.append(r)
        while queue:
            fi = queue.pop(0)
            chain = seen[id(fi.node)][1]
            for call, callee in self.calls_from(fi, unique_fallback):
                if callee.name in stop or id(callee.node) in seen:
                    continue
                seen[id(callee.node)] = (
                    callee,
                    chain + [(fi.path, call.lineno, callee.qualname)])
                queue.append(callee)
        return seen

    def scopes(self) -> List[FuncInfo]:
        """Every lexical scope: all functions plus one module scope per
        file (module-level guards around collectives are real bugs —
        the runtime hang pin reproduces exactly that form)."""
        return self.functions + list(self.module_scopes.values())

    def lookup(self, path: str, qualname: str) -> Optional[FuncInfo]:
        for fi in self.functions:
            if fi.path == path and fi.qualname == qualname:
                return fi
        return None

    def func_for_node(self, node: ast.AST) -> Optional[FuncInfo]:
        return self._by_node.get(id(node))
