"""The port's eksml-lint (``eksml_tpu_torch/analysis/``) against the
reference's (``eksml_tpu/analysis/``), on the CPU.

- **the graph**: over the modules of ``eksml_tpu/`` and of
  ``eksml_tpu_torch/``, the port's ``ProjectGraph`` resolves the same call
  edges as the reference's, with and without the unique-name fallback;
- **the six rules that carry over unchanged** (``config-drift``,
  ``signal-safety``, ``atomic-write``, ``lock-order``,
  ``unlocked-shared-state``, ``blocking-under-lock``): on the reference's
  fixture trees (``tests/test_lint.py``, ``tests/test_lint_spmd.py``,
  ``tests/test_lint_concurrency.py``) both engines report the same
  ``(rule, path, line)`` set and the same suppressed set (over
  ``eksml_tpu_torch/`` they give identical results:
  ``tests/test_torch_analysis_spmd.py``);
- **the translated module and project rules** (``jit-purity``,
  ``scope-coverage``, ``values-config-sync``): each reference fixture has
  a PyTorch translation (``torch.utils.checkpoint``,
  ``torch.autograd.Function``, ``named_scope``/``record_function``, the
  GPU charts), and the port flags it where the reference flags the JAX
  original, positives and negatives alike;
- **the engine and the CLI** (``python -m eksml_tpu_torch.tools.eksml_lint``):
  suppressions, the baseline by context, ``--json`` with the
  root→collective ``chain``, ``--changed`` in a temporary git repository,
  ``--update-baseline``, the empty shipped baseline, and a torch
  collective under a lock as a blocking call.

The SPMD rules' translations and the injection probes are in
``tests/test_torch_analysis_spmd.py``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu.analysis import engine as ref_engine  # noqa: E402
from eksml_tpu.analysis import graph as ref_graph  # noqa: E402
from eksml_tpu.analysis import run_lint as ref_lint  # noqa: E402
from eksml_tpu.analysis import ALL_RULES as REF_RULES  # noqa: E402
from eksml_tpu_torch.analysis import ALL_RULES, run_lint  # noqa: E402
from eksml_tpu_torch.analysis import engine, graph  # noqa: E402
from eksml_tpu_torch.analysis.engine import (  # noqa: E402
    Finding, format_human, load_baseline, write_baseline)
from eksml_tpu_torch.tools import eksml_lint  # noqa: E402

UNCHANGED = ("config-drift", "signal-safety", "atomic-write", "lock-order",
             "unlocked-shared-state", "blocking-under-lock")


def write_tree(root, files):
    """{relpath: source} → files under ``root``; returns ``root``."""
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return root


def lint(lint_fn, root, files, rules, targets=None):
    write_tree(root, files)
    return lint_fn(targets=targets or sorted(files), repo_root=str(root),
                   rules=rules)


def keys(findings, rename=("eksml_tpu/", "eksml_tpu_torch/")):
    """{(rule, path, line)} with the reference's package paths renamed
    to the port's."""
    return {(f.rule, f.path.replace(*rename) if f.path.startswith(
        rename[0]) else f.path, f.line) for f in findings}


def test_the_rule_names_are_the_references():
    assert ALL_RULES == REF_RULES and len(ALL_RULES) == 13


# ---------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    """Both engines' graphs over the modules of both packages."""
    out = {}
    targets = ("eksml_tpu", "eksml_tpu_torch")
    files, empty = engine.iter_python_files(targets, REPO)
    assert not empty and files == ref_engine.iter_python_files(
        targets, REPO)[0]
    mods, errors = engine.load_modules(files, REPO)
    assert not errors
    # one parse: the graphs read only each module's path and tree
    for name, gr in (("ref", ref_graph), ("port", graph)):
        out[name] = gr.ProjectGraph(mods)
    return out


def _edges(g, prefix, unique_fallback):
    out = set()
    for fi in g.functions + list(g.module_scopes.values()):
        if not fi.path.startswith(prefix):
            continue
        for call, callee in g.calls_from(fi, unique_fallback):
            out.add((fi.path, fi.qualname, call.lineno, callee.path,
                     callee.qualname))
    return out


@pytest.mark.parametrize("unique_fallback", (False, True))
@pytest.mark.parametrize("package", ("eksml_tpu/", "eksml_tpu_torch/"))
def test_the_graph_resolves_the_references_call_edges(graphs, package,
                                                      unique_fallback):
    ref = _edges(graphs["ref"], package, unique_fallback)
    port = _edges(graphs["port"], package, unique_fallback)
    assert len(ref) > 1000
    assert port == ref


@pytest.mark.parametrize("package", ("eksml_tpu/", "eksml_tpu_torch/"))
def test_the_graph_canonicalises_as_the_reference(graphs, package):
    import ast

    ref, port = graphs["ref"], graphs["port"]
    n = 0
    for path, mod in port.mods.items():
        if not path.startswith(package):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                n += 1
                assert port.canonical(path, node.func) == \
                    ref.canonical(path, node.func), (path, node.lineno)
    assert n > 1000


# ---------------------------------------------------------------------
# the six unchanged rules, on the reference's fixtures
# ---------------------------------------------------------------------

DRIFT_SRC = """
    def run(args, cfg):
        cfg.TRAIN.PRECISION = args.precision
        cfg.TRAIN.REMAT = bool(args.remat)
        cfg.update_args(args.config)
        return args.precision
    """

INVERSION_SRC = """
    import threading

    A = threading.Lock()
    B = threading.Lock()

    def w1():
        with A:
            with B:
                pass

    def w2():
        with B:
            with A:
                pass

    threading.Thread(target=w1).start()
    threading.Thread(target=w2).start()
    """

BLOCKING_SRC = """
    import queue
    import threading

    L = threading.Lock()
    q = queue.Queue()

    def consumer():
        with L:
            item = q.get()
        return item

    def other():
        with L:
            pass

    threading.Thread(target=consumer).start()
    threading.Thread(target=other).start()
    """

UNCHANGED_FIXTURES = {
    "drift_shadowed_read": ({"mod.py": DRIFT_SRC}, "config-drift"),
    "drift_getattr": ({"mod.py": """
        def run(args, cfg):
            cfg.TRAIN.PARAM_DTYPE = getattr(args, "param_dtype", "f32")
            cfg.update_args(args.config)
            return getattr(args, "param_dtype", "f32")
        """}, "config-drift"),
    "drift_negatives": ({"mod.py": """
        def before(args, cfg):
            cfg.TRAIN.PRECISION = args.precision
            p = args.precision            # read BEFORE override: ok
            cfg.update_args(args.config)
            return cfg.TRAIN.PRECISION

        def unshadowed(args, cfg):
            cfg.TRAIN.PRECISION = args.precision
            cfg.update_args(args.config)
            return args.steps             # never copied into cfg: ok

        def no_override(args, cfg):
            cfg.TRAIN.PRECISION = args.precision
            return args.precision         # no update_args here: ok
        """}, "config-drift"),
    "signal_logging_locks_telemetry": ({"mod.py": """
        import signal, logging

        log = logging.getLogger(__name__)

        class H:
            def _on_signal(self, signum, frame):
                self._flag.set()
                log.warning("got %d", signum)
                with self._lock:
                    pass
                registry.counter("sigterm").inc()

            def install(self):
                signal.signal(signal.SIGTERM, self._on_signal)
        """}, "signal-safety"),
    "signal_call_graph": ({"mod.py": """
        import signal

        def publish():
            recorder.event("sigterm")

        def on_signal(signum, frame):
            publish()

        signal.signal(signal.SIGTERM, on_signal)
        """}, "signal-safety"),
    "signal_flag_only": ({"mod.py": """
        import signal, time

        class H:
            def _on_signal(self, signum, frame):
                first = not self._flag.is_set()
                self._flag.set()          # Event.set is THE idiom
                if first:
                    self.signal_time = time.time()

            def install(self):
                signal.signal(signal.SIGTERM, self._on_signal)

            def uninstall(self, prev):
                signal.signal(signal.SIGTERM, prev)   # unresolvable: ok
        """}, "signal-safety"),
    "signal_one_import_away": ({
        "pub.py": """
            def publish():
                recorder.event("sigterm")
            """,
        "main.py": """
            import signal
            from pub import publish

            def on_signal(signum, frame):
                publish()

            signal.signal(signal.SIGTERM, on_signal)
            """}, "signal-safety"),
    "atomic_plain_write": ({"mod.py": """
        import json, os

        def bank(path, payload):
            with open(path, "w") as f:
                json.dump(payload, f)
        """}, "atomic-write"),
    "atomic_idiom_append_read": ({"mod.py": """
        import json, os

        def bank(path, payload):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)

        def mirror(path, line):
            with open(path, "a") as f:     # jsonl append stream: ok
                f.write(line)

        def load(path):
            with open(path) as f:          # read: ok
                return json.load(f)
        """}, "atomic-write"),
    "atomic_per_function": ({"mod.py": """
        import os

        def two_writes(a, b):
            tmp = a + ".tmp"
            with open(tmp, "w") as f:
                f.write("x")
            os.replace(tmp, a)
            with open(b, "w") as f:        # no replace for b
                f.write("y")

        def nested(c):
            def inner():
                with open(c, "w") as f:
                    f.write("z")
            tmp = c + ".tmp"
            os.replace(tmp, c)
            return inner
        """}, "atomic-write"),
    "atomic_suppressions": ({"mod.py": """
        import json, os

        def bank(path, payload):
            with open(path, "w") as f:  # eksml-lint: disable=atomic-write
                json.dump(payload, f)

        def bank2(path, payload):
            # eksml-lint: disable=atomic-write
            with open(path, "w") as f:
                json.dump(payload, f)

        def bank3(path, payload):
            # eksml-lint: disable=config-drift   (wrong rule: no effect)
            with open(path, "w") as f:
                json.dump(payload, f)
        """}, "atomic-write"),
    "lock_inversion": ({"mod.py": INVERSION_SRC}, "lock-order"),
    "lock_consistent": ({"mod.py": INVERSION_SRC.replace(
        "        with B:\n            with A:",
        "        with A:\n            with B:")}, "lock-order"),
    "lock_through_calls": ({"mod.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def helper():
            with B:
                pass

        def w1():
            with A:
                helper()

        def w2():
            with B:
                with A:
                    pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, "lock-order"),
    "lock_single_main_root": ({"bench.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def one():
            with A:
                with B:
                    pass

        def two():
            with B:
                with A:
                    pass

        def main():
            one()
            two()
        """}, "lock-order"),
    "lock_three_cycle": ({"mod.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()
        C = threading.Lock()

        def w1():
            with A:
                with B:
                    pass

        def w2():
            with B:
                with C:
                    pass

        def w3():
            with C:
                with A:
                    pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        threading.Thread(target=w3).start()
        """}, "lock-order"),
    "lock_suppression": ({"mod.py": INVERSION_SRC.replace(
        "        with A:\n            with B:",
        "        with A:\n            # eksml-lint: disable=lock-order"
        "\n            with B:")}, "lock-order"),
    "lock_acquire_release": ({"mod.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def w1():
            A.acquire()
            with B:
                pass
            A.release()

        def w2():
            A.acquire()
            A.release()
            with B:
                with A:
                    pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, "lock-order"),
    "lock_released_first": ({"mod.py": """
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def w1():
            A.acquire()
            A.release()
            with B:
                pass

        def w2():
            with B:
                with A:
                    pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, "lock-order"),
    "lockset_base_class": ({"mod.py": """
        import threading

        class Base:
            def __init__(self):
                self._lock = threading.Lock()
                self.v = 0

        class Counter(Base):
            def inc(self):
                with self._lock:
                    self.v += 1

        class Gauge(Base):
            def set(self):
                with self._lock:
                    self.v = 2

        c = Counter()
        g = Gauge()

        def w1():
            c.inc()

        def w2():
            g.set()

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, "unlocked-shared-state"),
    "lockset_two_root_unlocked": ({"mod.py": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def locked_inc(self):
                with self._lock:
                    self.count += 1

            def unlocked_set(self):
                self.count = 5

            def start(self):
                threading.Thread(target=self.locked_inc).start()
                threading.Thread(target=self.unlocked_set).start()
        """}, "unlocked-shared-state"),
    "lockset_common_lock": ({"mod.py": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0

            def a(self):
                with self._lock:
                    self.count += 1

            def b(self):
                with self._lock:
                    self.count = 0

            def start(self):
                threading.Thread(target=self.a).start()
                threading.Thread(target=self.b).start()
        """}, "unlocked-shared-state"),
    "lockset_single_root_and_init": ({"mod.py": """
        import threading

        class W:
            def __init__(self):
                self.count = 0
                self._setup()

            def _setup(self):
                self.count = 1

            def only_writer(self):
                self.count += 1

            def start(self):
                threading.Thread(target=self.only_writer).start()
                threading.Thread(target=self.reader).start()

            def reader(self):
                return self.count
        """}, "unlocked-shared-state"),
    "lockset_unrelated_classes": ({"mod.py": """
        import threading

        class P:
            def run(self):
                self.state = 1

        class Q:
            def run2(self):
                self.state = 2

        threading.Thread(target=P().run).start()

        def spawn():
            q = Q()
            threading.Thread(target=q.run2).start()
        """}, "unlocked-shared-state"),
    "lockset_through_call_edge": ({"mod.py": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def _bump_locked(self):
                self.n += 1

            def a(self):
                with self._lock:
                    self._bump_locked()

            def b(self):
                with self._lock:
                    self._bump_locked()

            def start(self):
                threading.Thread(target=self.a).start()
                threading.Thread(target=self.b).start()
        """}, "unlocked-shared-state"),
    "lockset_tuple_target": ({"mod.py": """
        import threading

        class W:
            def a(self):
                self.first, self.second = 1, 2

            def b(self):
                self.second = 3

            def start(self):
                threading.Thread(target=self.a).start()
                threading.Thread(target=self.b).start()
        """}, "unlocked-shared-state"),
    "lockset_suppression": ({"mod.py": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.flag = False

            def a(self):
                with self._lock:
                    self.flag = True

            def b(self):
                # idempotent sticky flag, benign race
                self.flag = True  # eksml-lint: disable=unlocked-shared-state

            def start(self):
                threading.Thread(target=self.a).start()
                threading.Thread(target=self.b).start()
        """}, "unlocked-shared-state"),
    "lockset_generic_method_names": ({"mod.py": """
        import threading

        class Manager:
            def wait(self):
                self.pending = 1

        class Watcher:
            def __init__(self):
                self._stop = threading.Event()

            def _run(self):
                self._stop.wait()

            def start(self):
                threading.Thread(target=self._run).start()

        def other_writer(m):
            m2 = Manager()
            m2.wait()

        threading.Thread(target=other_writer).start()
        """}, "unlocked-shared-state"),
    "blocking_queue_get": ({"mod.py": BLOCKING_SRC}, "blocking-under-lock"),
    "blocking_private_lock": ({"mod.py": BLOCKING_SRC.replace(
        "        with L:\n            pass", "        pass")},
        "blocking-under-lock"),
    "blocking_join_via_helper": ({"mod.py": """
        import threading

        L = threading.Lock()

        def w1(x, t):
            with L:
                t.join()
            return x

        def w2():
            with L:
                pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, "blocking-under-lock"),
    "blocking_suppression": ({"mod.py": BLOCKING_SRC.replace(
        "        item = q.get()",
        "        item = q.get()  # eksml-lint: disable=blocking-under-lock")},
        "blocking-under-lock"),
}
for _spelling in ("q.get(timeout=5.0)", "q.get(block=True)", "q.get(True)",
                  "q.get(block=False)", "q.get(False)", "q.get(True, 5.0)"):
    UNCHANGED_FIXTURES[f"blocking_{_spelling}"] = (
        {"mod.py": BLOCKING_SRC.replace("q.get()", _spelling)},
        "blocking-under-lock")


@pytest.mark.parametrize("name", sorted(UNCHANGED_FIXTURES))
def test_an_unchanged_rule_reports_as_the_reference(tmp_path, name):
    files, rule = UNCHANGED_FIXTURES[name]
    ref = lint(ref_lint, tmp_path / "ref", files, [rule])
    port = lint(run_lint, tmp_path / "port", files, [rule])
    assert keys(port.findings) == keys(ref.findings)
    assert keys(port.suppressed) == keys(ref.suppressed)
    assert [f.message for f in port.findings] == \
        [f.message for f in ref.findings]


# ---------------------------------------------------------------------
# jit-purity: what autograd runs twice
# ---------------------------------------------------------------------

JIT_PAIRS = {
    "impurity_through_call_graph": ({"mod.py": """
        import time, os
        import numpy as np
        import jax

        def helper():
            return time.time()

        def train_step(params, batch):
            helper()
            np.random.seed(0)
            os.environ["X"] = "1"
            return params

        step = jax.jit(train_step, donate_argnums=(0,))
        """}, {"mod.py": """
        import time, os
        import numpy as np
        from torch.utils.checkpoint import checkpoint

        def helper():
            return time.time()

        def train_step(params, batch):
            helper()
            np.random.seed(0)
            os.environ["X"] = "1"
            return params

        step = checkpoint(train_step, None, None, use_reentrant=False)
        """}),
    "decorator_forms_as_autograd_function": ({"mod.py": """
        from functools import partial
        import jax


        @jax.jit
        def a(x):
            print(x)
            return x



        @partial(jax.jit, static_argnums=(1,))
        def b(x, n):
            open("/tmp/f", "w")
            return x
        """}, {"mod.py": """
        import torch


        class A(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                print(x)
                return x

            # the backward: autograd's code path too

            @staticmethod
            def backward(ctx, g):
                open("/tmp/f", "w")
                return g
        """}),
    "method_target": ({"mod.py": """
        import time

        class Trainer:
            def _train_step(self, state, batch):
                t = time.perf_counter()
                return state

            def compiled_step(self):
                return self.plan.jit(self._train_step,
                                     donate_argnums=(0,))
        """}, {"mod.py": """
        import time
        from torch.utils.checkpoint import checkpoint
        class Trainer:
            def _train_step(self, state, batch):
                t = time.perf_counter()
                return state

            def compiled_step(self, state, batch):
                return checkpoint(self._train_step, state, batch,
                                  use_reentrant=False)
        """}),
    "shared_helper_reports_once": ({"mod.py": """
        import time
        import jax

        def helper():
            return time.time()

        @jax.jit
        def step_a(x):
            return helper()

        @jax.jit
        def step_b(x):
            return helper()
        """}, {"mod.py": """
        import time
        import torch.utils.checkpoint as cp

        def helper():
            return time.time()


        def step_a(x):
            return helper()


        def step_b(x):
            return helper()

        ab = cp.checkpoint(step_a, 1) + cp.checkpoint(step_b, 2)
        """}),
    "negative_host_code_and_env_reads": ({"mod.py": """
        import os, time
        import jax

        def host_loop():
            t = time.time()          # host side: fine
            os.environ["A"] = "1"    # host side: fine

        def train_step(params):
            backend = os.environ.get("EKSML_ROI_BACKEND")  # read: ok
            key = jax.random.PRNGKey(0)                    # jax rng: ok
            return params

        step = jax.jit(train_step)
        """}, {"mod.py": """
        import os, time
        import torch

        def host_loop():
            t = time.time()          # host side: fine
            os.environ["A"] = "1"    # host side: fine

        def train_step(params):
            backend = os.environ.get("EKSML_ROI_BACKEND")  # read: ok
            key = torch.rand(2)                            # torch rng: ok
            return params

        step = torch.utils.checkpoint.checkpoint(train_step, 1)
        """}),
    "two_modules_away": ({
        "pkg/__init__.py": "",
        "pkg/mid.py": """
            from pkg.leaf import stamp

            def middle(x):
                return stamp(x)
            """,
        "pkg/leaf.py": """
            import time

            def stamp(x):
                return x + time.time()
            """,
        "main.py": """
            import jax
            from pkg.mid import middle

            @jax.jit
            def step(x):
                return middle(x)
            """}, {
        "pkg/__init__.py": "",
        "pkg/mid.py": """
            from pkg.leaf import stamp

            def middle(x):
                return stamp(x)
            """,
        "pkg/leaf.py": """
            import time

            def stamp(x):
                return x + time.time()
            """,
        "main.py": """
            import torch
            from pkg.mid import middle

            class Step(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x):
                    return middle(x)
            """}),
    "local_shadowing_is_not_the_module_def": ({"mod.py": """
        import jax, time

        def main():
            time.sleep(1)

        def make():
            return lambda s: s

        @jax.jit
        def step(x):
            main = make()
            return main(x)
        """}, {"mod.py": """
        import torch, time

        def main():
            time.sleep(1)

        def make():
            return lambda s: s


        def step(x):
            main = make()
            return main(x)

        y = torch.utils.checkpoint.checkpoint(step, 1)
        """}),
}


@pytest.mark.parametrize("name", sorted(JIT_PAIRS))
def test_jit_purity_flags_the_translation_where_the_reference_does(
        tmp_path, name):
    ref_files, port_files = JIT_PAIRS[name]
    ref = lint(ref_lint, tmp_path / "ref", ref_files, ["jit-purity"])
    port = lint(run_lint, tmp_path / "port", port_files, ["jit-purity"])
    assert keys(port.findings) == keys(ref.findings)
    what = sorted(f.message.split(" inside code")[0] for f in port.findings)
    assert what == sorted(f.message.split(" inside code")[0]
                          for f in ref.findings)


def test_jit_purity_reads_the_ports_remat_and_roi_align_function(graphs):
    """The port's own roots: REMAT's ``checkpoint(recomputed(self.backbone),
    ...)`` and ``checkpoint(recomputed(self.fpn), ...)`` reach the
    backbone's and the FPN's ``forward``; the ROIAlign and DTensor
    gather functions' ``forward``/``backward`` are roots too."""
    from eksml_tpu_torch.analysis.checkers import JitPurityChecker

    g = graphs["port"]
    seen = []
    orig = g.reachable

    def spy(roots, *a, **k):
        seen.extend((r.path, r.qualname) for r in roots)
        return orig(roots, *a, **k)

    g.reachable = spy
    try:
        assert JitPurityChecker().check_graph(g) == []
    finally:
        del g.reachable
    assert {("eksml_tpu_torch/models/resnet.py", "ResNetBackbone.forward"),
            ("eksml_tpu_torch/models/fpn.py", "FPN.forward"),
            ("eksml_tpu_torch/ops/cuda/roi_align_kernel.py",
             "RoiAlignFunction.forward"),
            ("eksml_tpu_torch/ops/cuda/roi_align_kernel.py",
             "RoiAlignFunction.backward"),
            ("eksml_tpu_torch/parallel/sharding.py", "_Whole.forward"),
            } <= set(seen), sorted(set(seen))


# ---------------------------------------------------------------------
# scope-coverage: named_scope / record_function against SCOPE_RULES
# ---------------------------------------------------------------------


def test_scope_coverage_flags_an_unresolvable_scope(tmp_path):
    ref = lint(ref_lint, tmp_path / "ref", {"eksml_tpu/models/fixture.py": """
        import jax

        @jax.named_scope("totally_unknown_scope")
        def f(x):
            return x
        """}, ["scope-coverage"])
    port = lint(run_lint, tmp_path / "port", {
        "eksml_tpu_torch/models/fixture.py": """
        from eksml_tpu_torch.profiling.scopes import named_scope

        @named_scope("totally_unknown_scope")
        def f(x):
            return x
        """}, ["scope-coverage"])
    assert keys(port.findings) == keys(ref.findings) and port.findings
    assert "'other' bucket" in port.findings[0].message
    assert "totally_unknown_scope" in port.findings[0].message


def test_scope_coverage_negative_known_scopes(tmp_path):
    ref = lint(ref_lint, tmp_path / "ref", {"eksml_tpu/ops/fixture.py": """
        import jax

        @jax.named_scope("roi_align")
        def f(x):
            with jax.named_scope("rpn_nms"):
                return x
        """}, ["scope-coverage"])
    port = lint(run_lint, tmp_path / "port", {
        "eksml_tpu_torch/ops/fixture.py": """
        import torch

        @named_scope("roi_align")
        def f(x):
            with torch.profiler.record_function("rpn_nms"):
                return x
        """}, ["scope-coverage"])
    assert ref.findings == [] and port.findings == []


def test_scope_coverage_flags_an_unknown_record_function(tmp_path):
    port = lint(run_lint, tmp_path, {"eksml_tpu_torch/train.py": """
        import torch

        def step():
            with torch.profiler.record_function("optimiser"):
                pass
        """}, ["scope-coverage"])
    assert [f.line for f in port.findings] == [5]


@pytest.mark.parametrize("which", ("ref", "port"))
def test_scope_coverage_rule_anchor_direction(tmp_path, which):
    """A tree that keeps SCOPE_RULES but lost its scopes: every
    component is reported as un-anchored, at its rule's line."""
    pkg = "eksml_tpu" if which == "ref" else "eksml_tpu_torch"
    dst = tmp_path / pkg / "profiling"
    dst.mkdir(parents=True)
    shutil.copy(os.path.join(REPO, pkg, "profiling", "attribution.py"),
                dst / "attribution.py")
    (tmp_path / pkg / "models").mkdir()
    (tmp_path / pkg / "models" / "empty.py").write_text("")
    fn = ref_lint if which == "ref" else run_lint
    r = fn(targets=[pkg], repo_root=str(tmp_path), rules=["scope-coverage"])
    comps = {f.message.split("'")[1] for f in r.findings}
    from eksml_tpu_torch.profiling.attribution import SCOPE_RULES

    assert comps == {c for c, _, _ in SCOPE_RULES}
    assert all(f.path.endswith("attribution.py") and f.line > 0
               for f in r.findings)


def test_scope_coverage_real_trees_are_covered():
    assert ref_lint(targets=["eksml_tpu"], repo_root=REPO,
                    rules=["scope-coverage"]).findings == []
    assert run_lint(targets=["eksml_tpu_torch"], repo_root=REPO,
                    rules=["scope-coverage"]).findings == []


# ---------------------------------------------------------------------
# values-config-sync: the GPU charts against the port's config.py
# ---------------------------------------------------------------------


@pytest.fixture()
def chart_repos(tmp_path):
    """Minimal clones: the charts and each package's renderer."""
    out = {}
    for which, renderer in (("ref", "tools/render_charts.py"),
                            ("port",
                             "eksml_tpu_torch/tools/render_charts.py")):
        root = tmp_path / which
        shutil.copytree(os.path.join(REPO, "charts"), root / "charts")
        (root / os.path.dirname(renderer)).mkdir(parents=True)
        shutil.copy(os.path.join(REPO, renderer), root / renderer)
        out[which] = (root, os.path.dirname(renderer))
    return out


def _values_lint(chart_repos, which):
    root, target = chart_repos[which]
    fn = ref_lint if which == "ref" else run_lint
    return fn(targets=[target], repo_root=str(root),
              rules=["values-config-sync"])


def test_values_sync_clean_on_the_real_charts(chart_repos):
    assert _values_lint(chart_repos, "ref").findings == []
    assert _values_lint(chart_repos, "port").findings == []


def _edit(path, old, new):
    text = path.read_text()
    assert old in text, (path, old)
    path.write_text(text.replace(old, new))


@pytest.mark.parametrize("chart", ("maskrcnn", "serve"))
def test_values_sync_flags_a_typo_and_a_dead_key_as_the_reference(
        chart_repos, chart):
    """Both drift directions, on the reference's chart and on its GPU
    counterpart: a rendered --config key config.py lacks (anchored at the
    template line), and a values key no template reads."""
    edits = {"maskrcnn": ("maskrcnn", "TRAIN.PRECISION={{ .Values.maskrcnn"
                          ".precision }}", "TRAIN.TYPO_PRECISION={{ .Values"
                          ".maskrcnn.precision }}", "  data_val: val2017",
                          "dead_knob_xyz"),
             "serve": ("serve", "SERVE.MAX_QUEUE={{ int .Values.serve"
                       ".max_queue }}", "SERVE.MAX_QUEUE_TYPO={{ int .Values"
                       ".serve.max_queue }}", "  port: 8081",
                       "dead_serve_knob")}
    main, old, new, anchor, dead = edits[chart]
    got = {}
    for which, suffix in (("ref", ""), ("port", "-gpu")):
        root = chart_repos[which][0] / "charts" / (chart + suffix)
        _edit(root / "templates" / f"{main}.yaml", old, new)
        _edit(root / "values.yaml", anchor, f"{anchor}\n  {dead}: 1")
        r = _values_lint(chart_repos, which)
        typo = [f for f in r.findings if "TYPO" in f.message]
        dead_f = [f for f in r.findings if f"{main}.{dead}" in f.message]
        assert typo and dead_f, r.findings
        assert typo[0].path == f"charts/{chart}{suffix}/templates/{main}.yaml"
        assert typo[0].line > 0 and "TYPO" in typo[0].context
        assert dead_f[0].path == f"charts/{chart}{suffix}/values.yaml"
        assert dead_f[0].line > 0 and dead in dead_f[0].context
        got[which] = sorted("typo" if "TYPO" in f.message else "dead"
                            for f in r.findings)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("chart", ("maskrcnn-gpu", "serve-gpu",
                                   "autoscaler-gpu"))
def test_values_sync_reads_every_gpu_chart(chart_repos, chart):
    """Every chart of the port's renderer (``CHART_SPECS``) is rendered
    and its --config keys resolved against the port's config.py: a key
    it lacks, put after the template's --config, is the one finding."""
    tpl = chart_repos["port"][0] / "charts" / chart / "templates" / (
        chart[:-len("-gpu")] + ".yaml")
    lines = tpl.read_text().splitlines(keepends=True)
    at = next(i for i, ln in enumerate(lines) if ln.strip() == "- --config")
    indent = lines[at][:len(lines[at]) - len(lines[at].lstrip())]
    lines.insert(at + 1, f"{indent}- RPN.NO_SUCH_KNOB=1\n")
    tpl.write_text("".join(lines))
    r = _values_lint(chart_repos, "port")
    assert [(f.path, f.line, f.message.split("--config ")[1][:16])
            for f in r.findings] == [
        (f"charts/{chart}/templates/{tpl.name}", at + 2, "RPN.NO_SUCH_KNOB")]


def test_jit_purity_unwraps_a_checkpointed_submodule(tmp_path):
    """``checkpoint(recomputed(self.block), x)``: the target is the
    ``forward`` of the class the module assigns to ``self.block``."""
    r = lint(run_lint, tmp_path, {"mod.py": """
        import time
        import torch
        from torch.utils.checkpoint import checkpoint

        class Block(torch.nn.Module):
            def forward(self, x):
                t = time.time()
                return x

        class Net(torch.nn.Module):
            def __init__(self):
                self.block = Block()

            def forward(self, x):
                return checkpoint(recomputed(self.block), x,
                                  use_reentrant=False)
        """}, ["jit-purity"])
    assert [(f.line, f.message.split(" inside")[0]) for f in r.findings] \
        == [(8, "wall-clock read time.time()")]
    assert "'block'" in r.findings[0].message


# ---------------------------------------------------------------------
# the engine: suppressions, baseline, output
# ---------------------------------------------------------------------


def test_baseline_grandfathers_by_context_not_line(tmp_path):
    src = """
        import json

        def bank(path, payload):
            with open(path, "w") as f:
                json.dump(payload, f)
        """
    r = lint(run_lint, tmp_path, {"mod.py": src}, ["atomic-write"])
    assert len(r.findings) == 1
    baseline = [f.key() for f in r.findings]
    (tmp_path / "mod.py").write_text("\n\n" + textwrap.dedent(src))
    r2 = run_lint(targets=[str(tmp_path / "mod.py")],
                  repo_root=str(tmp_path), rules=["atomic-write"],
                  baseline=baseline)
    assert r2.findings == [] and len(r2.baselined) == 1
    (tmp_path / "mod.py").write_text(textwrap.dedent(src).replace(
        'open(path, "w")', 'open(other, "w")'))
    r3 = run_lint(targets=[str(tmp_path / "mod.py")],
                  repo_root=str(tmp_path), rules=["atomic-write"],
                  baseline=baseline)
    assert len(r3.findings) == 1


def test_baseline_update_merges_reasons_and_out_of_scope(tmp_path):
    path = str(tmp_path / "baseline.json")
    f_atomic = Finding("atomic-write", "eksml_tpu_torch/x.py", 5, "m",
                       context='with open(p, "w") as fh:')
    f_drift = Finding("config-drift", "eksml_tpu_torch/y.py", 9, "m",
                      context="return args.precision")
    write_baseline(path, [f_atomic, f_drift])
    assert load_baseline(path) == [f_atomic.key(), f_drift.key()]
    entries = json.load(open(path))
    for e in entries:
        e["reason"] = f"justified: {e['rule']}"
    with open(path, "w") as f:
        json.dump(entries, f)
    write_baseline(path, [f_atomic], active_rules=["atomic-write"],
                   checked_paths=["eksml_tpu_torch/x.py"])
    by_rule = {e["rule"]: e for e in json.load(open(path))}
    assert by_rule["atomic-write"]["reason"] == "justified: atomic-write"
    assert by_rule["config-drift"]["reason"] == "justified: config-drift"
    write_baseline(path, [f_drift], active_rules=list(ALL_RULES),
                   checked_paths=["eksml_tpu_torch/x.py",
                                  "eksml_tpu_torch/y.py"])
    assert [e["rule"] for e in json.load(open(path))] == ["config-drift"]
    assert load_baseline(str(tmp_path / "missing.json")) == []


def test_an_empty_target_and_an_unknown_rule_fail(tmp_path):
    r = run_lint(targets=["no/such/dir"], repo_root=str(tmp_path),
                 rules=["atomic-write"])
    assert [f.rule for f in r.findings] == ["parse-error"]
    assert "matches no .py files" in r.findings[0].message
    with pytest.raises(ValueError, match="unknown rule"):
        run_lint(targets=["no/such/dir"], repo_root=str(tmp_path),
                 rules=["no-such-rule"])


def test_the_default_targets_are_the_port(tmp_path):
    assert engine.DEFAULT_TARGETS == ("eksml_tpu_torch",)
    r = run_lint(repo_root=REPO, rules=["config-drift"])
    assert r.files and all(p.startswith("eksml_tpu_torch/")
                           for p in r.files)
    assert f"eksml-lint: 0 finding(s), 0 baselined, 0 suppressed, " \
        f"{len(r.files)} files checked" in format_human(r)


def test_a_torch_collective_under_a_shared_lock_is_blocking(tmp_path):
    """The concurrency rules take the SPMD rule's collective list: a
    ``torch.distributed`` collective (or a DTensor ``full_tensor``)
    under a lock another thread takes blocks until every rank arrives."""
    r = lint(run_lint, tmp_path, {"mod.py": """
        import threading
        import torch.distributed as dist

        L = threading.Lock()

        def sync_all(x):
            dist.all_reduce(x)
            return x.full_tensor()

        def w1(x):
            with L:
                return sync_all(x)

        def w2():
            with L:
                pass

        threading.Thread(target=w1).start()
        threading.Thread(target=w2).start()
        """}, ["blocking-under-lock"])
    whats = sorted(f.message.split(" at ")[0] for f in r.findings)
    assert whats == ["blocking call .full_tensor() (DTensor collective)",
                     "blocking call collective all_reduce()"], whats
    assert any("sync_all" in c["name"] for c in r.findings[0].chain)


def test_the_main_roots_are_the_ports_entry_points(graphs):
    from eksml_tpu_torch.analysis.concurrency import (_MAIN_ROOTS,
                                                      discover_thread_roots)

    roots = [r for r in discover_thread_roots(graphs["port"])
             if r.fi.path.startswith("eksml_tpu_torch/")]
    mains = {(r.fi.path, r.fi.qualname) for r in roots if r.kind == "main"}
    want = {(p, q) for p, quals in _MAIN_ROOTS for q in quals}
    assert mains == want and len(want) == 5
    kinds = {r.kind for r in roots}
    assert {"thread", "executor", "handler", "signal", "main"} <= kinds


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------


def test_cli_json_carries_the_root_to_collective_chain(tmp_path, capsys):
    write_tree(tmp_path, {"main.py": """
        import torch.distributed as dist

        def gather_all(x):
            dist.all_reduce(x)
            return x

        def log_step(x):
            if dist.get_rank() == 0:
                return gather_all(x)
            return x
        """})
    rc = eksml_lint.main(["--rules", "collective-order", "--json",
                          str(tmp_path / "main.py")])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    (finding,) = payload["findings"]
    chain = finding["chain"]
    assert [c["name"] for c in chain] == ["gather_all", "all_reduce"]
    assert all(set(c) == {"path", "line", "name"} for c in chain)
    assert chain[0]["line"] == finding["line"] == 10


def test_cli_changed_limits_findings_to_the_diffed_files(tmp_path, capsys):
    def git(*args):
        subprocess.run(["git", "-c", "user.email=t@t", "-c",
                        "user.name=t", *args], cwd=tmp_path, check=True,
                       capture_output=True)

    bad = ('def bank(path, p):\n    with open(path, "w") as f:\n'
           "        f.write(p)\n")
    (tmp_path / "mod_a.py").write_text(
        "def load(path):\n    return open(path).read()\n")
    (tmp_path / "mod_b.py").write_text(bad)   # debt already committed
    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    root = str(tmp_path)

    def run(*argv):
        rc = eksml_lint.main(list(argv), repo=root)
        return rc, capsys.readouterr().out

    rc, out = run("--rules", "atomic-write", "mod_a.py", "mod_b.py",
                  "--changed")
    assert rc == 0 and "nothing to lint" in out
    (tmp_path / "mod_a.py").write_text(bad)
    rc, out = run("--rules", "atomic-write", "mod_a.py", "mod_b.py",
                  "--changed", "HEAD")
    assert rc == 1 and "mod_a.py" in out and "mod_b.py" not in out
    rc, out = run("--rules", "atomic-write", "mod_a.py", "mod_b.py")
    assert rc == 1 and "mod_b.py" in out
    assert run("--changed", "--update-baseline", "mod_a.py")[0] == 2


def test_cli_update_baseline_then_clean(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(
        'import json\n\ndef bank(path, payload):\n'
        '    with open(path, "w") as f:\n        json.dump(payload, f)\n')
    baseline = str(tmp_path / "baseline.json")
    common = ["--rules", "atomic-write", "--baseline", baseline,
              str(tmp_path / "mod.py")]
    assert eksml_lint.main(common + ["--update-baseline"]) == 0
    assert json.load(open(baseline))[0]["reason"]
    assert eksml_lint.main(common) == 0
    assert eksml_lint.main(common + ["--no-baseline"]) == 1
    capsys.readouterr()


def test_the_shipped_baseline_is_empty():
    with open(eksml_lint.DEFAULT_BASELINE) as f:
        assert json.load(f) == []
    assert eksml_lint.DEFAULT_BASELINE == os.path.join(
        REPO, "eksml_tpu_torch", "tools", "lint_baseline.json")
