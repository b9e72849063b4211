"""Lint engine: file walking, suppressions, baseline, output (the port
of ``eksml_tpu/analysis/engine.py``; the port lints its own tree).

Checkers are AST visitors (or whole-project checks) registered in
:mod:`eksml_tpu_torch.analysis.checkers`; this module owns everything
rule-agnostic so a new checker is one class, not plumbing:

- **suppressions** — ``# eksml-lint: disable=<rule>[,<rule>...]`` on
  the finding's line or the line directly above silences it (``all``
  matches every rule).  A suppression is a reviewed, in-place decision
  — prefer it over the baseline for deliberate exceptions.
- **baseline** — a committed JSON list of grandfathered findings keyed
  by ``(rule, path, context)`` where *context* is the stripped source
  line, so the entry survives unrelated edits moving line numbers but
  dies with the offending code.  The baseline is for pre-existing debt
  only; the shipped file stays empty/near-empty.
- **output** — human ``path:line: rule: message`` lines or a JSON
  payload (``--json``) for tooling.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Production code the default lint pass covers: the port's package
#: (its tools live inside it).  tests/ is excluded on purpose: fixtures
#: simulate violations, and test code may freely read clocks or write
#: files non-atomically.
DEFAULT_TARGETS = ("eksml_tpu_torch",)

_SUPPRESS_RE = re.compile(r"#\s*eksml-lint:\s*disable=([\w\-,]+)")


class Finding:
    """One lint result, line-number independent for baselining."""

    __slots__ = ("rule", "path", "line", "message", "severity",
                 "context", "chain")

    def __init__(self, rule: str, path: str, line: int, message: str,
                 severity: str = "error", context: str = "",
                 chain: Optional[List[dict]] = None):
        self.rule = rule
        self.path = path          # repo-relative, "/"-separated
        self.line = line          # 1-based
        self.message = message
        self.severity = severity
        self.context = context    # stripped source line at `line`
        # call chain root → sink for the cross-module rules:
        # [{"path":…, "line":…, "name":…}, …] — rendered into --json so
        # run_report.py can cross-link a watchdog hang report to the
        # matching static finding.  Not part of the baseline key.
        self.chain = chain or None

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "severity": self.severity, "message": self.message,
             "context": self.context}
        if self.chain:
            d["chain"] = list(self.chain)
        return d

    def __repr__(self) -> str:  # debugging/pytest output
        return (f"{self.path}:{self.line}: {self.rule}: "
                f"{self.message}")


class ModuleInfo:
    """A parsed source file handed to checkers."""

    __slots__ = ("path", "abspath", "source", "tree", "lines")

    def __init__(self, path: str, abspath: str, source: str,
                 tree: ast.AST):
        self.path = path
        self.abspath = abspath
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, lineno: int, message: str,
                severity: str = "error") -> Finding:
        return Finding(rule, self.path, lineno, message, severity,
                       context=self.line_text(lineno))


class LintResult:
    def __init__(self, findings: List[Finding],
                 suppressed: List[Finding],
                 baselined: List[Finding],
                 files: List[str]):
        self.findings = findings        # actionable (gate nonzero)
        self.suppressed = suppressed
        self.baselined = baselined
        self.files = files

    def to_dict(self) -> dict:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "baselined": [f.to_dict() for f in self.baselined],
            "checked_files": len(self.files),
        }


def _suppressions(source: str) -> Dict[int, set]:
    """{lineno: {rule, ...}} for every disable comment in *source*."""
    out: Dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _is_suppressed(f: Finding, supp: Dict[int, set]) -> bool:
    for lineno in (f.line, f.line - 1):
        rules = supp.get(lineno)
        if rules and (f.rule in rules or "all" in rules):
            return True
    return False


def iter_python_files(targets: Sequence[str], repo_root: str
                      ) -> Tuple[List[str], List[str]]:
    """Expand files/dirs into (.py paths, targets that matched none).

    An empty target is surfaced, not swallowed: a mistyped path in a
    scoped CI invocation must fail the gate, not pass it forever by
    linting nothing.
    """
    out, empty = [], []
    for t in targets:
        abspath = t if os.path.isabs(t) else os.path.join(repo_root, t)
        if os.path.isfile(abspath):
            out.append(abspath)
            continue
        found = False
        for dirpath, dirnames, filenames in os.walk(abspath):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
                    found = True
        if not found:
            empty.append(t)
    return sorted(set(out)), empty


def load_modules(files: Iterable[str], repo_root: str
                 ) -> Tuple[Dict[str, ModuleInfo], List[Finding]]:
    mods: Dict[str, ModuleInfo] = {}
    errors: List[Finding] = []
    for abspath in files:
        rel = os.path.relpath(abspath, repo_root).replace(os.sep, "/")
        try:
            with open(abspath) as f:
                source = f.read()
            tree = ast.parse(source, filename=abspath)
        except (OSError, SyntaxError) as e:
            errors.append(Finding("parse-error", rel,
                                  getattr(e, "lineno", 0) or 0,
                                  f"cannot parse: {e}"))
            continue
        mods[rel] = ModuleInfo(rel, abspath, source, tree)
    return mods, errors


def run_lint(targets: Optional[Sequence[str]] = None,
             repo_root: Optional[str] = None,
             rules: Optional[Sequence[str]] = None,
             baseline: Optional[Iterable[Tuple[str, str, str]]] = None,
             only_paths: Optional[Iterable[str]] = None,
             ) -> LintResult:
    """Run the checkers over *targets* (default: the production tree).

    ``rules`` filters by rule name (fixture tests isolate one checker);
    ``baseline`` is a set of grandfathered :meth:`Finding.key` tuples.
    ``only_paths`` (the ``--changed`` fast path) reports findings only
    for those repo-relative paths — the cross-module graph is still
    built over the full target set, so a changed caller is checked
    against its unchanged callees.
    """
    from eksml_tpu_torch.analysis.checkers import build_checkers

    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    files, empty = iter_python_files(targets or DEFAULT_TARGETS,
                                     repo_root)
    mods, raw = load_modules(files, repo_root)
    for t in empty:
        raw.append(Finding("parse-error", t, 0,
                           f"target {t!r} matches no .py files — "
                           "mistyped path? (an empty scope must not "
                           "pass the gate)", context=t))

    module_checkers, graph_checkers, project_checkers = \
        build_checkers(rules)
    for mod in mods.values():
        for checker in module_checkers:
            raw.extend(checker.check(mod))
    if graph_checkers:
        from eksml_tpu_torch.analysis.graph import ProjectGraph

        graph = ProjectGraph(mods)
        for checker in graph_checkers:
            raw.extend(checker.check_graph(graph))
    for checker in project_checkers:
        raw.extend(checker.check_project(mods, repo_root))

    baseline_keys = set(baseline or ())
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    supp_cache: Dict[str, Dict[int, set]] = {}
    seen = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        # backstop only — the call-graph checkers dedupe shared
        # helpers at node level themselves (their messages name the
        # root, so identical-message collisions are already rare)
        dedupe = (f.rule, f.path, f.line, f.message)
        if dedupe in seen:
            continue
        seen.add(dedupe)
        mod = mods.get(f.path)
        if mod is not None:
            supp = supp_cache.setdefault(f.path, _suppressions(mod.source))
            if _is_suppressed(f, supp):
                suppressed.append(f)
                continue
        if f.key() in baseline_keys:
            baselined.append(f)
            continue
        findings.append(f)
    if only_paths is not None:
        keep = set(only_paths)
        findings = [f for f in findings if f.path in keep]
        suppressed = [f for f in suppressed if f.path in keep]
        baselined = [f for f in baselined if f.path in keep]
    return LintResult(findings, suppressed, baselined,
                      [m.path for m in mods.values()])


# -- baseline file ----------------------------------------------------

def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    """Committed baseline JSON → list of finding keys.

    Format: ``[{"rule":…, "path":…, "context":…, "reason":…}, …]`` —
    every entry carries a ``reason`` justifying why the debt is
    grandfathered rather than fixed.
    """
    if not os.path.exists(path):
        return []
    with open(path) as f:
        entries = json.load(f)
    return [(e["rule"], e["path"], e["context"]) for e in entries]


def write_baseline(path: str, findings: Iterable[Finding],
                   active_rules: Optional[Sequence[str]] = None,
                   checked_paths: Optional[Iterable[str]] = None,
                   ) -> None:
    """(Re)write the baseline, merging with the existing file.

    - a persisting finding keeps its hand-written ``reason``;
    - an entry outside this run's scope (rule not active, or a module
      path that wasn't checked) is retained untouched — a scoped
      ``--rules``/targets update must not silently drop grandfathered
      debt elsewhere;
    - an in-scope entry whose finding vanished is dropped (the
      baseline dies with the offending code).
    """
    prev = []
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
    prev_by_key = {(e["rule"], e["path"], e["context"]): e
                   for e in prev}
    entries = []
    current_keys = set()
    for f in findings:
        current_keys.add(f.key())
        old = prev_by_key.get(f.key())
        entries.append({"rule": f.rule, "path": f.path,
                        "context": f.context,
                        "reason": (old or {}).get("reason")
                        or "TODO: justify or fix"})
    active = set(active_rules) if active_rules is not None else None
    checked = set(checked_paths) if checked_paths is not None else None
    for key, e in prev_by_key.items():
        if key in current_keys:
            continue
        rule_scoped = active is not None and e["rule"] not in active
        # project rules (values-config-sync) anchor findings at
        # non-.py chart paths that never appear in checked_paths;
        # their re-check is rule-gated, not path-gated
        path_scoped = (checked is not None
                       and e["path"].endswith(".py")
                       and e["path"] not in checked)
        if rule_scoped or path_scoped:
            entries.append(e)
    entries.sort(key=lambda e: (e["path"], e["rule"], e["context"]))
    from eksml_tpu_torch.fsio import atomic_write_text

    atomic_write_text(path, json.dumps(entries, indent=1) + "\n")


# -- output -----------------------------------------------------------

def format_human(result: LintResult) -> str:
    lines = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}: {f.rule}: {f.message}")
    lines.append(
        f"eksml-lint: {len(result.findings)} finding(s), "
        f"{len(result.baselined)} baselined, "
        f"{len(result.suppressed)} suppressed, "
        f"{len(result.files)} files checked")
    return "\n".join(lines)
