"""Render the port's GPU charts to concrete manifests, with no helm.

The three charts that launch the port on ``nvidia.com/gpu`` nodes
(``charts/maskrcnn-gpu``, ``charts/serve-gpu``, ``charts/autoscaler-gpu``)
are rendered here by the subset of Go templates and sprig that they use
(assignments, if/else, range, include/define, the sprig calls of their
``_helpers.tpl``), with a pinned release name and timestamp.  The engine
is the port's own copy of ``tools/render_charts.py``'s.

Each chart's default values, and each overlay listed in ``GOLDENS``, are
rendered into ``charts/golden-gpu/``, and so are the training chart's
subcharts (Jupyter and TensorBoard, ``SUBCHART_GOLDENS``) under both of
its installs; the committed files are held by
``--check`` and by ``tests/test_torch_charts.py``, so any template or
values change shows up as a manifest diff.  :func:`render` takes values
files and ``--set``-style overrides as ``helm template -f`` / ``--set``
do; ``chip_smoke.py``'s charts phase renders a one-card install with it.

Usage::

    python3 -m eksml_tpu_torch.tools.render_charts --update  # write goldens
    python3 -m eksml_tpu_torch.tools.render_charts --check   # diff them
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import sys
from typing import Dict, Mapping, Optional, Sequence

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: per chart: the template (and values key) it renders, and its
#: subcharts (``charts/<name>/``, each rendered with the values under its
#: name and ``global``, as helm gives a subchart)
CHART_SPECS = {
    "charts/maskrcnn-gpu": {"main": "maskrcnn",
                            "subcharts": ("jupyter", "tensorboard")},
    "charts/serve-gpu": {"main": "serve", "subcharts": ()},
    "charts/autoscaler-gpu": {"main": "autoscaler", "subcharts": ()},
}
#: golden file name -> (chart, values files over the chart's values.yaml)
GOLDENS = {
    "maskrcnn-gpu__maskrcnn.yaml": ("charts/maskrcnn-gpu", ()),
    "maskrcnn-gpu__maskrcnn-optimized.yaml": (
        "charts/maskrcnn-gpu", ("values-optimized.yaml",)),
    "serve-gpu__serve.yaml": ("charts/serve-gpu", ()),
    "autoscaler-gpu__autoscaler.yaml": ("charts/autoscaler-gpu", ()),
}
#: golden file name -> (chart, values files, subchart)
SUBCHART_GOLDENS = {
    f"maskrcnn-gpu__{prefix}{sub}.yaml": ("charts/maskrcnn-gpu", files, sub)
    for prefix, files in (("", ()), ("maskrcnn-optimized__",
                                     ("values-optimized.yaml",)))
    for sub in CHART_SPECS["charts/maskrcnn-gpu"]["subcharts"]}
GOLDEN_DIR = os.path.join("charts", "golden-gpu")
# pinned render identity: goldens must be byte-stable
RELEASE = "eksml"
TIMESTAMP = "2026-01-01-00-00-00"
IMAGE = "ACCOUNT.dkr.ecr.REGION.amazonaws.com/eksml-gpu:golden"
VIZ_IMAGE = "ACCOUNT.dkr.ecr.REGION.amazonaws.com/eksml-gpu-viz:golden"
# install-time values an operator must supply (the charts keep them ""
# and `required`), pinned as a `helm template -f` values file would
GOLDEN_VALUES = {
    "maskrcnn": {"maskrcnn": {"image": IMAGE},
                 "jupyter": {"image": VIZ_IMAGE}},
    # canary.enabled here (the chart's default is off) so the goldens and
    # the tests read the canary track's template and --config keys too
    "serve": {"serve": {"image": IMAGE, "canary": {"enabled": True}}},
    "autoscaler": {"autoscaler": {"image": IMAGE}},
}


def _merge(base: dict, over: Mapping) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


class RenderError(Exception):
    pass


# ---------------------------------------------------------------------
# tokenizer / parser for the Go-template subset
# ---------------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


def _tokenize(text: str):
    """[(kind, value)] with kind in {'text', 'action'};
    trim markers applied to neighboring text tokens (Go semantics:
    '{{-' eats preceding whitespace, '-}}' eats following)."""
    tokens = []
    pos = 0
    for m in _ACTION_RE.finditer(text):
        lead = text[pos:m.start()]
        if m.group(1) == "-":
            lead = lead.rstrip()
        if lead:
            tokens.append(("text", lead))
        tokens.append(("action", m.group(2)))
        pos = m.end()
        if m.group(3) == "-":
            while pos < len(text) and text[pos] in " \t\r\n":
                pos += 1
    tail = text[pos:]
    if tail:
        tokens.append(("text", tail))
    return tokens


def _parse(tokens, i=0, stop=("end",)):
    """Token stream → node list; returns (nodes, next_index,
    stop_keyword)."""
    nodes = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
            continue
        if val.startswith("/*"):
            i += 1
            continue
        head = val.split(None, 1)[0] if val.split() else ""
        if head in stop or head == "end":
            return nodes, i + 1, head
        if head == "if":
            body, i, stopped = _parse(tokens, i + 1,
                                      stop=("end", "else"))
            else_body = []
            if stopped == "else":
                else_body, i, _ = _parse(tokens, i, stop=("end",))
            nodes.append(("if", val.split(None, 1)[1], body, else_body))
        elif head == "range":
            body, i, _ = _parse(tokens, i + 1, stop=("end",))
            nodes.append(("range", val.split(None, 1)[1], body))
        elif head == "define":
            name = _split_args(val.split(None, 1)[1])[0].strip('"')
            body, i, _ = _parse(tokens, i + 1, stop=("end",))
            nodes.append(("define", name, body))
        elif re.match(r"^\$[\w]+\s*:?=", val):
            var, expr = re.split(r":?=", val, 1)
            nodes.append(("assign", var.strip(), expr.strip()))
            i += 1
        else:
            nodes.append(("out", val))
            i += 1
    return nodes, i, None


def _split_args(s: str):
    """Split a command on spaces, honoring quotes and parens."""
    args, buf, depth, q = [], "", 0, None
    for ch in s:
        if q:
            buf += ch
            if ch == q and not buf.endswith("\\" + q):
                q = None
            continue
        if ch in "\"'":
            q = ch
            buf += ch
        elif ch == "(":
            depth += 1
            buf += ch
        elif ch == ")":
            depth -= 1
            buf += ch
        elif ch.isspace() and depth == 0:
            if buf:
                args.append(buf)
            buf = ""
        else:
            buf += ch
    if buf:
        args.append(buf)
    return args


def _split_pipeline(s: str):
    """Split on top-level '|'."""
    parts, buf, depth, q = [], "", 0, None
    for ch in s:
        if q:
            buf += ch
            if ch == q:
                q = None
            continue
        if ch in "\"'":
            q = ch
            buf += ch
        elif ch == "(":
            depth += 1
            buf += ch
        elif ch == ")":
            depth -= 1
            buf += ch
        elif ch == "|" and depth == 0:
            parts.append(buf.strip())
            buf = ""
        else:
            buf += ch
    parts.append(buf.strip())
    return parts


_NOW = object()  # sentinel: `now`, formatted by `date`


def _is_empty(v) -> bool:
    return v in (None, "", 0, False) or (isinstance(v, (list, dict))
                                         and not v)


def _fmt_printf(fmt: str, *args):
    out, ai = "", 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            spec = fmt[i + 1]
            if spec == "%":
                out += "%"
            elif spec == "q":
                out += '"%s"' % args[ai]
                ai += 1
            elif spec == "d":
                out += str(int(args[ai]))
                ai += 1
            else:  # %s and friends
                out += str(args[ai])
                ai += 1
            i += 2
            continue
        out += ch
        i += 1
    return out


class Engine:
    def __init__(self, root, helpers=None):
        self.root = root
        self.helpers = dict(helpers or {})

    # -- evaluation ----------------------------------------------------

    def _field(self, path: str, dot):
        if path == ".":
            return dot
        node = self.root if path.startswith(".") and not \
            path.startswith("..") else dot
        for part in path.strip(".").split("."):
            if part == "":
                continue
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                raise RenderError(f"unknown field {path!r}")
        return node

    def _atom(self, tok: str, scope):
        if tok.startswith('"') and tok.endswith('"'):
            return tok[1:-1].replace('\\"', '"')
        if tok.startswith("(") and tok.endswith(")"):
            return self.eval_pipeline(tok[1:-1], scope)
        if re.fullmatch(r"-?\d+", tok):
            return int(tok)
        if tok.startswith("$"):
            if tok not in scope["vars"]:
                raise RenderError(f"undefined variable {tok}")
            return scope["vars"][tok]
        if tok.startswith("."):
            return self._field(tok, scope["dot"])
        if tok == "now":
            return _NOW
        raise RenderError(f"cannot evaluate atom {tok!r}")

    def _call(self, name: str, args, scope):
        E = _is_empty
        if name == "include":
            tpl = self.helpers.get(args[0])
            if tpl is None:
                raise RenderError(f"no template {args[0]!r}")
            return self.render_nodes(
                tpl, {"dot": args[1], "vars": {}}).strip()
        fns = {
            "int": lambda x: int(float(x)) if str(x).strip() else 0,
            "default": lambda d, v: d if E(v) else v,
            "quote": lambda v: '"%s"' % str(v).replace('"', '\\"'),
            "required": self._required,
            "printf": _fmt_printf,
            "gt": lambda a, b: a > b,
            "ge": lambda a, b: a >= b,
            "lt": lambda a, b: a < b,
            "le": lambda a, b: a <= b,
            "eq": lambda a, b: a == b,
            "ne": lambda a, b: a != b,
            "add": lambda *a: sum(a),
            "sub": lambda a, b: int(a) - int(b),
            "mul": lambda *a: _reduce_mul(a),
            "div": lambda a, b: int(a) // int(b),
            "mod": lambda a, b: int(a) % int(b),
            "max": lambda *a: max(int(x) for x in a),
            "min": lambda *a: min(int(x) for x in a),
            "splitList": lambda sep, s: str(s).split(sep),
            "join": lambda sep, xs: sep.join(str(x) for x in xs),
            "keys": lambda d: list(d.keys()),
            "sortAlpha": lambda xs: sorted(xs),
            "get": lambda d, k: d.get(k, ""),
            "dict": _mk_dict,
            "regexReplaceAll": lambda pat, s, repl:
                re.sub(pat, repl.replace("$", "\\"), str(s)),
            "fail": self._fail,
            "date": lambda fmt, t: TIMESTAMP,
            "not": lambda v: E(v),
            "and": lambda *a: a[-1] if all(not E(x) for x in a) else
                next((x for x in a if E(x)), a[-1]),
            "or": lambda *a: next((x for x in a if not E(x)), a[-1]),
        }
        if name not in fns:
            raise RenderError(f"unsupported function {name!r}")
        return fns[name](*args)

    @staticmethod
    def _required(msg, val):
        if _is_empty(val):
            raise RenderError(f"required value missing: {msg}")
        return val

    @staticmethod
    def _fail(msg):
        raise RenderError(f"template fail: {msg}")

    def eval_command(self, cmd: str, scope, piped=None):
        toks = _split_args(cmd)
        extra = [] if piped is None else [piped]
        head = toks[0]
        if (head[0] in '".($-' or head[0].isdigit() or head == "now") \
                and head not in ("not",):
            if len(toks) > 1 or extra:
                raise RenderError(f"cannot call value {cmd!r}")
            return self._atom(head, scope)
        args = [self._atom(t, scope) if not t[0].isalpha()
                or re.fullmatch(r"-?\d+", t) or t == "now"
                else self._maybe_atom(t, scope)
                for t in toks[1:]]
        return self._call(head, args + extra, scope)

    def _maybe_atom(self, tok, scope):
        # bare words inside calls are string literals in our subset
        # (dict keys are quoted in the charts, so this only catches
        # helper names — already quoted — and true atoms)
        try:
            return self._atom(tok, scope)
        except RenderError:
            return tok

    def eval_pipeline(self, expr: str, scope):
        val = None
        for i, cmd in enumerate(_split_pipeline(expr)):
            val = self.eval_command(cmd, scope,
                                    piped=None if i == 0 else val)
        return val

    # -- rendering -----------------------------------------------------

    def render_nodes(self, nodes, scope) -> str:
        out = []
        for node in nodes:
            kind = node[0]
            if kind == "text":
                out.append(node[1])
            elif kind == "out":
                val = self.eval_pipeline(node[1], scope)
                if val is _NOW:
                    val = TIMESTAMP
                if val is True:
                    val = "true"
                elif val is False:
                    val = "false"
                out.append("" if val is None else str(val))
            elif kind == "assign":
                scope["vars"][node[1]] = self.eval_pipeline(node[2],
                                                            scope)
            elif kind == "if":
                cond = self.eval_pipeline(node[1], scope)
                body = node[2] if not _is_empty(cond) else node[3]
                out.append(self.render_nodes(body, scope))
            elif kind == "range":
                seq = self.eval_pipeline(node[1], scope)
                for item in seq or ():
                    sub = {"dot": item, "vars": scope["vars"]}
                    out.append(self.render_nodes(node[2], sub))
            elif kind == "define":
                self.helpers[node[1]] = node[2]
        return "".join(out)

    def render(self, text: str) -> str:
        nodes, _, _ = _parse(_tokenize(text))
        # two passes so defines anywhere are visible (helm behavior)
        self.render_nodes([n for n in nodes if n[0] == "define"],
                          {"dot": self.root, "vars": {}})
        body = [n for n in nodes if n[0] != "define"]
        return self.render_nodes(body, {"dot": self.root, "vars": {}})


def _reduce_mul(args):
    out = 1
    for a in args:
        out *= int(a)
    return out


def _mk_dict(*kv):
    return {kv[i]: kv[i + 1] for i in range(0, len(kv), 2)}


# ---------------------------------------------------------------------
# chart rendering
# ---------------------------------------------------------------------

def _read(rel: str) -> str:
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def set_values(values: Mapping, overrides: Mapping[str, object]) -> dict:
    """``values`` with ``--set``-style ``{"a.b.c": value}`` overrides
    applied (a string value is read as YAML, as helm types ``--set``)."""
    out = dict(values)
    for key, value in overrides.items():
        if isinstance(value, str):
            value = yaml.safe_load(value) if value else ""
        nested: object = value
        for part in reversed(key.split(".")):
            nested = {part: nested}
        out = _merge(out, nested)
    return out


def chart_values(chart: str, values_files: Sequence[str] = (),
                 overrides: Optional[Mapping[str, object]] = None) -> dict:
    """The values a chart renders with: its ``values.yaml``, the golden
    install-time values, then each of ``values_files`` (paths relative to
    the chart, as ``helm -f``), then ``overrides`` (as ``--set``)."""
    main = CHART_SPECS[chart]["main"]
    values = _merge(yaml.safe_load(_read(f"{chart}/values.yaml")),
                    GOLDEN_VALUES[main])
    for name in values_files:
        values = _merge(values, yaml.safe_load(_read(f"{chart}/{name}")))
    return set_values(values, overrides or {})


def render(chart: str, values_files: Sequence[str] = (),
           overrides: Optional[Mapping[str, object]] = None,
           release: str = RELEASE, subchart: Optional[str] = None) -> str:
    """The manifest of ``chart``'s template under :func:`chart_values`,
    installed as ``release`` (which names the training run's directory);
    with ``subchart``, that subchart's template under its own
    ``values.yaml``, the chart's values under its name and the chart's
    ``global``.  Raises :class:`RenderError` on a template ``fail`` or a
    missing ``required`` value, and when the output is not a stream of
    k8s documents."""
    values = chart_values(chart, values_files, overrides)
    if subchart is None:
        base, name = chart, CHART_SPECS[chart]["main"]
    else:
        if subchart not in CHART_SPECS[chart]["subcharts"]:
            raise RenderError(f"{chart} has no subchart {subchart!r}")
        base, name = f"{chart}/charts/{subchart}", subchart
        values = dict(_merge(yaml.safe_load(_read(f"{base}/values.yaml")),
                             values.get(subchart) or {}),
                      **{"global": values["global"]})
    helpers = {}
    if os.path.exists(os.path.join(REPO, base, "templates",
                                   "_helpers.tpl")):
        nodes, _, _ = _parse(_tokenize(
            _read(f"{base}/templates/_helpers.tpl")))
        helpers = {n[1]: n[2] for n in nodes if n[0] == "define"}
    eng = Engine({"Values": values, "Release": {"Name": release}}, helpers)
    text = eng.render(_read(f"{base}/templates/{name}.yaml"))
    docs = [d for d in yaml.safe_load_all(text) if d]
    if not docs or any("kind" not in d for d in docs):
        raise RenderError(f"{chart}: the rendered manifest is not a k8s "
                          "document stream")
    return text


def render_all() -> Dict[str, str]:
    """{golden file name: rendered text} for every entry of ``GOLDENS``
    and ``SUBCHART_GOLDENS``."""
    out = {name: render(chart, files)
           for name, (chart, files) in GOLDENS.items()}
    out.update({name: render(chart, files, subchart=sub)
                for name, (chart, files, sub) in SUBCHART_GOLDENS.items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m eksml_tpu_torch.tools.render_charts",
        description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--update", action="store_true",
                      help=f"write the golden manifests to {GOLDEN_DIR}/")
    mode.add_argument("--check", action="store_true",
                      help="diff the current render against the goldens")
    args = p.parse_args(argv)

    rendered = render_all()
    golden_abs = os.path.join(REPO, GOLDEN_DIR)
    if args.update:
        os.makedirs(golden_abs, exist_ok=True)
        for name, text in sorted(rendered.items()):
            dest = os.path.join(golden_abs, name)
            with open(dest + ".tmp", "w") as f:
                f.write(text)
            os.replace(dest + ".tmp", dest)
            print(f"wrote {GOLDEN_DIR}/{name}")
        return 0
    rc = 0
    for name, text in sorted(rendered.items()):
        path = os.path.join(golden_abs, name)
        want = ""
        if os.path.exists(path):
            with open(path) as f:
                want = f.read()
        if text != want:
            rc = 1
            sys.stdout.writelines(difflib.unified_diff(
                want.splitlines(True), text.splitlines(True),
                f"golden/{name}", f"rendered/{name}"))
    if rc:
        print("\ngoldens stale: run python3 -m "
              "eksml_tpu_torch.tools.render_charts --update")
    else:
        print(f"{len(rendered)} golden manifests up to date")
    return rc


if __name__ == "__main__":
    sys.exit(main())
