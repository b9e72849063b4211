"""The port's four SPMD-safety rules (``eksml_tpu_torch/analysis/spmd.py``)
against the reference's, on the CPU.

- **translations**: each reference fixture of ``collective-order``,
  ``rng-discipline``, ``host-sync`` and ``recompile-hazard``
  (``tests/test_lint_spmd.py``) has a PyTorch translation
  (``torch.distributed`` collectives and DTensor gathers, rank markers,
  torch draws, torch syncs, tensors sized by batch content reaching the
  training step or a forward), and the port flags it at the lines where
  the reference flags the JAX original, positives, negatives and
  suppressions alike;
- **the eval gather**: ``evalcoco/runner.py`` catches a rank's error,
  raises in the handler only without a process group, and then gathers
  on every rank — clean, because no collective can follow that raise;
  the same rule without that path check flags it;
- **the injection probes** (as the reference's acceptance probes), on
  copies of port files: a ``dist.get_rank() == 0`` guard around
  ``telemetry/aggregate.py``'s all-gather, a ``torch.rand`` draw in the
  loader's substitution path, and a ``return`` in ``runner.py``'s
  handler before ``_gather_detection_lists`` each exit 1 naming the rule,
  the ``file:line`` and the chain;
- **the port's tree**: clean under the four rules with an empty
  baseline, its justified host-sync suppressions visible, every name of
  the hot walk's cold set a def of the port, and identical results
  under both engines for the six rules that carry over unchanged.
"""

import os
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu.analysis import run_lint as ref_lint  # noqa: E402
from eksml_tpu_torch.analysis import run_lint  # noqa: E402
from eksml_tpu_torch.analysis import spmd  # noqa: E402
from eksml_tpu_torch.tools import eksml_lint  # noqa: E402

SPMD_RULES = ["collective-order", "rng-discipline", "host-sync",
              "recompile-hazard"]
UNCHANGED = ("config-drift", "signal-safety", "atomic-write", "lock-order",
             "unlocked-shared-state", "blocking-under-lock")


def write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return root


def lint(lint_fn, root, files, rules, targets=None):
    write_tree(root, files)
    return lint_fn(targets=targets or sorted(files), repo_root=str(root),
                   rules=rules)


def keys(findings):
    return {(f.rule, f.path.replace("eksml_tpu/", "eksml_tpu_torch/", 1)
             if f.path.startswith("eksml_tpu/") else f.path, f.line)
            for f in findings}


# ---------------------------------------------------------------------
# translations: (reference files, port files, rule, targets)
# ---------------------------------------------------------------------

COLLECTIVE_GUARD_SRC = """
    import jax
    from jax.experimental import multihost_utils

    def publish(vec):
        if jax.process_index() == 0:
            return multihost_utils.process_allgather(vec)
        return vec
    """

PORT_GUARD_SRC = """
    import torch.distributed as dist


    def publish(vec):
        if dist.get_rank() == 0:
            return dist.all_reduce(vec)
        return vec
    """

LOADER_FIXTURE = """
    import numpy as np
    from eksml_tpu.data.subhelp import pick_replacement

    class DetectionLoader:
        def _draw(self):
            # NOT in the contract set: the schedule draws are the
            # legitimate RNG consumers
            return int(self.rng.randint(0, 4))

        def _substitute_for(self, failed_rec):
            return pick_replacement(self.records, failed_rec)

        def _materialize(self, rec, image):
            return self._substitute_for(rec)
    """

PORT_LOADER_FIXTURE = LOADER_FIXTURE.replace(
    "from eksml_tpu.data.subhelp", "from eksml_tpu_torch.data.subhelp")


def _pkg(name, files):
    """``files`` under the package ``name`` (with its ``__init__``s)."""
    out = {f"{name}/__init__.py": "", f"{name}/data/__init__.py": ""}
    out.update({f"{name}/{rel}": src for rel, src in files.items()})
    return out


PAIRS = {
    "collective_rank_guard": (
        {"mod.py": COLLECTIVE_GUARD_SRC}, {"mod.py": PORT_GUARD_SRC},
        "collective-order", None),
    "collective_chain_through_other_module": ({
        "pkg/__init__.py": "",
        "pkg/comm.py": """
            from jax.experimental import multihost_utils

            def gather_all(x):
                return multihost_utils.process_allgather(x)
            """,
        "main.py": """
            import jax
            from pkg.comm import gather_all

            def log_step(x):
                pid = jax.process_index()
                if pid == 0:
                    return gather_all(x)
                return x
            """}, {
        "pkg/__init__.py": "",
        "pkg/comm.py": """
            import torch.distributed as dist

            def gather_all(x):
                return dist.all_gather_object([None], x)
            """,
        "main.py": """
            import torch.distributed as dist
            from pkg.comm import gather_all

            def log_step(x):
                pid = dist.get_rank()
                if pid == 0:
                    return gather_all(x)
                return x
            """}, "collective-order", None),
    "collective_in_except_handler": ({"mod.py": """
        from jax.experimental import multihost_utils

        def restore(x):
            try:
                return load(x)
            except Exception:
                multihost_utils.broadcast_one_to_all(x)
                return None
        """}, {"mod.py": """
        import torch.distributed as dist

        def restore(x):
            try:
                return load(x)
            except Exception:
                dist.broadcast(x, 0)
                return None
        """}, "collective-order", None),
    "collective_divergent_early_return": ({"mod.py": """
        import jax
        from jax.experimental import multihost_utils

        def evaluate(x):
            if jax.process_index() == 0:
                if x is None:
                    return {}
            return multihost_utils.process_allgather(x)
        """}, {"mod.py": """
        import os
        import torch.distributed as dist

        def evaluate(x):
            if int(os.environ["RANK"]) == 0:
                if x is None:
                    return {}
            return dist.all_gather_into_tensor(x, x)
        """}, "collective-order", None),
    "collective_negatives": ({"mod.py": """
        import jax
        import logging
        from jax.experimental import multihost_utils

        log = logging.getLogger(__name__)

        def uniform_guard(x):
            # process_count is host-UNIFORM: every host branches alike
            if jax.process_count() > 1:
                return multihost_utils.process_allgather(x)
            return x

        def unconditional(x):
            return multihost_utils.process_allgather(x)

        def rank_guarded_local_work(x):
            # divergent branch around NON-collective work is the
            # normal coordinator pattern, not a finding
            if jax.process_index() == 0:
                log.info("coordinator: %s", x)
            return x

        def collective_in_test_position(x):
            # inspecting an agreed verdict IS the fix pattern
            if uniform_guard(x) is None:
                return None
            return x
        """}, {"mod.py": """
        import logging
        import torch.distributed as dist

        log = logging.getLogger(__name__)

        def uniform_guard(x):
            # get_world_size is rank-UNIFORM: every rank branches alike
            if dist.is_initialized() and dist.get_world_size() > 1:
                return dist.all_reduce(x)
            return x

        def unconditional(x):
            return dist.reduce_scatter_tensor(x, x)

        def rank_guarded_local_work(x):
            # divergent branch around NON-collective work is the
            # normal coordinator pattern, not a finding
            if dist.get_rank() == 0:
                log.info("coordinator: %s", x)
            return x

        def collective_in_test_position(x):
            # inspecting an agreed verdict IS the fix pattern
            if uniform_guard(x) is None:
                return None
            return x
        """}, "collective-order", None),
    "collective_suppression": ({"mod.py": COLLECTIVE_GUARD_SRC.replace(
        "return multihost_utils.process_allgather(vec)",
        "return multihost_utils.process_allgather(vec)"
        "  # eksml-lint: disable=collective-order")},
        {"mod.py": PORT_GUARD_SRC.replace(
            "return dist.all_reduce(vec)",
            "return dist.all_reduce(vec)"
            "  # eksml-lint: disable=collective-order")},
        "collective-order", None),
    "collective_module_level_guard": ({"worker.py": """
        import jax
        import numpy as np
        from jax.experimental import multihost_utils

        if jax.process_index() == 0:
            out = multihost_utils.process_allgather(np.int32(1))
        """}, {"worker.py": """
        import os
        import torch
        import torch.distributed as dist

        if os.environ.get("LOCAL_RANK") == "0":
            out = dist.barrier()
        """}, "collective-order", None),
    "collective_attribute_rank_marker": ({"mod.py": """
        from jax.experimental import multihost_utils

        class T:
            def log(self, x):
                if self.host_rank == 0:
                    multihost_utils.sync_global_devices("x")
        """}, {"mod.py": """
        import torch.distributed as dist

        class T:
            def log(self, x):
                if self.rank == 0:
                    dist.monitored_barrier()
        """}, "collective-order", None),
    "collective_coordinator_guard_around_a_gather": ({"mod.py": """
        from eksml_tpu.parallel.distributed import is_coordinator
        from jax.experimental import multihost_utils

        def save(x):
            if is_coordinator():
                x = multihost_utils.process_allgather(x)
            return x
        """}, {"mod.py": """
        from eksml_tpu_torch.parallel.distributed import is_coordinator


        def save(x):
            if is_coordinator():
                x = x.full_tensor()
            return x
        """}, "collective-order", None),
    "rng_draw_two_modules_away": (_pkg("eksml_tpu", {
        "data/loader.py": LOADER_FIXTURE,
        "data/subhelp.py": """
            import numpy as np
            from eksml_tpu.data.deeper import jitter

            def pick_replacement(records, failed):
                return records[jitter(len(records))]
            """,
        "data/deeper.py": """
            import numpy as np

            def jitter(n):
                return np.random.randint(0, n)
            """}), _pkg("eksml_tpu_torch", {
        "data/loader.py": PORT_LOADER_FIXTURE,
        "data/subhelp.py": """
            import numpy as np
            from eksml_tpu_torch.data.deeper import jitter

            def pick_replacement(records, failed):
                return records[jitter(len(records))]
            """,
        "data/deeper.py": """
            import torch

            def jitter(n):
                return int(torch.randint(0, n, ()))
            """}), "rng-discipline", "pkg"),
    "rng_receiver_method": (_pkg("eksml_tpu", {"data/loader.py": """
        class DetectionLoader:
            def _substitute_for(self, failed_rec):
                self.rng.shuffle(self._order)
                return self.records[0]
        """}), _pkg("eksml_tpu_torch", {"data/loader.py": """
        class DetectionLoader:
            def _substitute_for(self, failed_rec):
                self.generator.manual_seed(int(failed_rec["id"]))
                return self.records[0]
        """}), "rng-discipline", "pkg"),
    "rng_inplace_draw": (_pkg("eksml_tpu", {"data/loader.py": """
        import numpy as np

        class DetectionLoader:
            def _resolve_image(self, rec, image):
                return image + np.random.uniform(0, 1, image.shape)
        """}), _pkg("eksml_tpu_torch", {"data/loader.py": """
        import torch

        class DetectionLoader:
            def _resolve_image(self, rec, image):
                return image + torch.empty(image.shape).uniform_(0, 1)
        """}), "rng-discipline", "pkg"),
    "rng_tracing_module_scope": (_pkg("eksml_tpu", {
        "telemetry/__init__.py": "",
        "telemetry/tracing.py": """
            import random

            _SALT = random.random()

            def span(name):
                return name
            """}), _pkg("eksml_tpu_torch", {
        "telemetry/__init__.py": "",
        "telemetry/tracing.py": """
            import torch

            _SALT = torch.rand(())

            def span(name):
                return name
            """}), "rng-discipline", "pkg"),
    "rng_negative_draw_outside_contract": (_pkg("eksml_tpu", {
        "data/subhelp.py": "def pick_replacement(r, f):\n    return r[0]\n",
        "data/loader.py": LOADER_FIXTURE}), _pkg("eksml_tpu_torch", {
        "data/subhelp.py": "def pick_replacement(r, f):\n    return r[0]\n",
        "data/loader.py": PORT_LOADER_FIXTURE.replace(
            "int(self.rng.randint(0, 4))",
            "int(torch.randint(0, 4, (), generator=self.gen))")}),
        "rng-discipline", "pkg"),
    "sync_hot_loop_and_helper": (_pkg("eksml_tpu", {
        "train.py": """
            import jax
            import numpy as np
            from eksml_tpu.helper import materialize

            class Trainer:
                def fit(self, batches):
                    for batch in batches:
                        state, metrics = self._step(state, batch)
                        loss = metrics["total_loss"].item()
                        materialize(metrics)

                def _graceful_exit(self, metrics):
                    # once-per-incident exit path: cold by design
                    return float(np.asarray(metrics["total_loss"]))
            """,
        "helper.py": """
            import jax

            def materialize(tree):
                jax.block_until_ready(tree)
            """}), _pkg("eksml_tpu_torch", {
        "train.py": """
            import torch
            import numpy as np
            from eksml_tpu_torch.helper import materialize

            class Trainer:
                def fit(self, batches):
                    for batch in batches:
                        state, metrics = self._step(state, batch)
                        loss = metrics["total_loss"].item()
                        materialize(metrics)

                def _graceful_exit(self, metrics):
                    # once-per-incident exit path: cold by design
                    return float(metrics["total_loss"])
            """,
        "helper.py": """
            import torch

            def materialize(tree):
                torch.cuda.synchronize()
            """}), "host-sync", "pkg"),
    "sync_suppression": (_pkg("eksml_tpu", {"train.py": """
        import numpy as np

        class Trainer:
            def fit(self, batches):
                for step, batch in enumerate(batches):
                    metrics = self._step(batch)
                    if step % 100 == 0:
                        # log-step materialization, bounded cadence
                        loss = float(np.asarray(metrics["l"]))  # eksml-lint: disable=host-sync
        """}), _pkg("eksml_tpu_torch", {"train.py": """
        import numpy as np

        class Trainer:
            def fit(self, batches):
                for step, batch in enumerate(batches):
                    metrics = self._step(batch)
                    if step % 100 == 0:
                        # log-step materialization, bounded cadence
                        loss = float(metrics["l"])  # eksml-lint: disable=host-sync
        """}), "host-sync", "pkg"),
    "sync_prefetcher_root": (_pkg("eksml_tpu", {"data/loader.py": """
        import numpy as np

        class DevicePrefetcher:
            def __next__(self):
                batch = self._q.get()
                return {k: np.asarray(v) for k, v in batch.items()}
        """}), _pkg("eksml_tpu_torch", {"data/loader.py": """
        import torch

        class DevicePrefetcher:
            def __next__(self):
                batch = self._q.get()
                return {k: v.cpu() for k, v in batch.items()}
        """}), "host-sync", "pkg"),
    "sync_stream_and_loop_variables": (_pkg("eksml_tpu", {"train.py": """
        import jax
        import numpy as np

        class Trainer:
            def fit(self, batches):
                for batch in batches:
                    metrics = self._step(batch)
                    jax.block_until_ready(metrics)
                    row = {k: np.asarray(v) for k, v in metrics.items()}
        """}), _pkg("eksml_tpu_torch", {"train.py": """
        import torch
        import numpy as np

        class Trainer:
            def fit(self, batches):
                for batch in batches:
                    metrics = self._step(batch)
                    self.stream.synchronize()
                    row = {k: float(v) for k, v in metrics.items()}
        """}), "host-sync", "pkg"),
    "recompile_len_shape_and_slice": ({"mod.py": """
        import jax

        def f(x, n):
            return x

        step = jax.jit(f)

        def run(batch, imgs):
            step(imgs, len(batch["ids"]))
            step(imgs, imgs.shape[0])
            step({k: v for k, v in batch.items()}, 0)
        """}, {"mod.py": """
        import torch
        from eksml_tpu_torch.train import make_train_step

        step = make_train_step(model, optimizer, sched)



        def run(batch, imgs):
            step(torch.zeros(len(batch["ids"]), 3), None, 0)
            step(torch.empty(imgs.shape[0], 4), None, 0)
            step(imgs[:, :batch["hw"].shape[0]], None, 0)
        """}, "recompile-hazard", None),
    "recompile_attribute_and_forward": ({"mod.py": """
        import jax

        class T:
            def compile(self, fn):
                self._jit_step = jax.jit(fn)

            def run(self, state, batch):
                return self._jit_step(state, len(batch))

        def once(fn, batch):
            return jax.jit(fn)(batch, len(batch))
        """}, {"mod.py": """
        import torch.nn.functional as F

        class T:
            def compile(self, model, opt, sched):
                self._step = make_train_step(model, opt, sched)

            def run(self, state, batch):
                return self._step(state.new_zeros(len(batch)), None, 0)

        def once(model, x, batch):
            return model.predict(F.pad(x, (0, len(batch))), None)
        """}, "recompile-hazard", None),
    "recompile_negatives": ({"mod.py": """
        import jax

        def f(x, n):
            return x

        step = jax.jit(f, static_argnums=(1,))

        def run(cfg, state, batch):
            step(state, batch)                      # plain pytrees: ok
            step(state, len(cfg.PREPROC.BUCKETS))   # cfg-derived: ok
            step(state, cfg.DATA.MAX_GT_BOXES)      # config knob: ok

        def host_side(batch):
            return len(batch)                       # not a jit call
        """}, {"mod.py": """
        import torch

        step = make_train_step(model, optimizer, sched)



        def run(cfg, state, batch):
            step(state, batch, 0)                   # plain tensors: ok
            step(torch.zeros(len(cfg.PREPROC.BUCKETS)), batch, 0)  # cfg
            step(torch.zeros(cfg.DATA.MAX_GT_BOXES), batch, 0)  # knob

        def host_side(batch):
            return torch.zeros(len(batch))          # not a step call
        """}, "recompile-hazard", None),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_the_port_flags_the_translation_where_the_reference_does(
        tmp_path, name):
    ref_files, port_files, rule, targets = PAIRS[name]
    ref = lint(ref_lint, tmp_path / "ref", ref_files, [rule],
               ["eksml_tpu"] if targets else None)
    port = lint(run_lint, tmp_path / "port", port_files, [rule],
                ["eksml_tpu_torch"] if targets else None)
    assert keys(port.findings) == keys(ref.findings)
    assert keys(port.suppressed) == keys(ref.suppressed)
    # the chains have the reference's shape: as many hops, on the same
    # lines of the same files
    assert sorted([(c["path"].replace("eksml_tpu/", "eksml_tpu_torch/"),
                    c["line"]) for c in f.chain or []]
                  for f in ref.findings) == sorted(
        [(c["path"], c["line"]) for c in f.chain or []]
        for f in port.findings)


def test_the_collective_chain_names_the_guard_and_the_hops(tmp_path):
    _, files, _, _ = PAIRS["collective_chain_through_other_module"]
    r = lint(run_lint, tmp_path, files, ["collective-order"])
    (f,) = r.findings
    assert f.path == "main.py" and "'pid'" in f.message
    assert "main.py:7" in f.message          # the guard's file:line
    assert [c["name"] for c in f.chain] == ["gather_all",
                                           "all_gather_object"]
    assert f.chain[1]["path"] == "pkg/comm.py"


def test_a_sizing_bound_to_a_local_name_reaches_the_step(tmp_path):
    """The port's rule follows a name of the same scope: the canvas is
    sized from the batch, then handed to the step."""
    r = lint(run_lint, tmp_path, {"mod.py": """
        import torch

        class T:
            def run(self, batch, priorities, step):
                canvas = torch.zeros((len(batch["images"]), 3, 64, 64))
                padded = canvas
                return self._step({"images": padded}, priorities, step)

            def build(self, model, opt, sched):
                self._step = make_train_step(model, opt, sched)
        """}, ["recompile-hazard"])
    assert [(f.line, "len(batch['images'])" in f.message)
            for f in r.findings] == [(6, True)]


def test_host_sync_reads_no_host_array_as_a_tensor(tmp_path):
    r = lint(run_lint, tmp_path, _pkg("eksml_tpu_torch", {"train.py": """
        import numpy as np

        class Trainer:
            def fit(self, batches):
                for batch in batches:
                    images = np.asarray(batch["images"])
                    lr = float(self.cfg.TRAIN.BASE_LR)
                    n = int(images.shape[0])
                    ok = bool(self.data_health.scalars())
                    row = {k: float(v) for k, v in batch.items()}
                    losses = self._step(images)
                    total = float(losses["total_loss"])
        """}), ["host-sync"], ["eksml_tpu_torch"])
    assert [(f.line, f.message.split(" reachable")[0]) for f in r.findings] \
        == [(13, "per-step host sync float(losses['total_loss'])")]


# ---------------------------------------------------------------------
# the eval gather: a raise that no collective can follow
# ---------------------------------------------------------------------

RUNNER = os.path.join(REPO, "eksml_tpu_torch", "evalcoco", "runner.py")
HANDLER = ("        log.exception(\"eval on rank %d failed; entering the "
           "gather so the \"\n                      \"other ranks do not "
           "wait forever\", rank)\n")


def test_the_eval_gather_is_clean_and_a_naive_rule_would_flag_it(
        tmp_path, monkeypatch):
    src = open(RUNNER).read()
    assert HANDLER in src, "runner.py changed; update this test"
    assert "        if not dist.is_initialized():\n            raise\n" in src
    clean = tmp_path / "runner.py"
    clean.write_text(src)
    r = run_lint(targets=[str(clean)], repo_root=str(tmp_path),
                 rules=["collective-order"])
    assert r.findings == [] and r.suppressed == []
    # the same rule without the path check: the handler's raise is
    # taken to precede the gather
    monkeypatch.setattr(spmd.CollectiveOrderChecker, "_contradict",
                        staticmethod(lambda a, b: False))
    r = run_lint(targets=[str(clean)], repo_root=str(tmp_path),
                 rules=["collective-order"])
    assert [f.message.split(" exits")[0] for f in r.findings] == [
        "early raise under the exception handler at runner.py:"
        f"{src[:src.index('    except Exception as e:')].count(chr(10)) + 1}"
        " (a rank-local event)"]


def test_a_uniform_exit_the_collective_cannot_follow(tmp_path):
    r = lint(run_lint, tmp_path, {"mod.py": """
        import torch.distributed as dist

        def gather(x, failed):
            try:
                x = work(x)
            except Exception:
                if not dist.is_initialized():
                    raise
                failed = True
            if dist.is_initialized():
                dist.all_gather_object([None], (x, failed))
            return x

        def split(x):
            try:
                x = work(x)
            except Exception:
                if dist.is_initialized():
                    raise
            if dist.is_initialized():
                dist.all_reduce(x)
            return x

        def rank_predicate(x):
            if dist.get_rank() == 0:
                return x
            if dist.get_rank() != 0:
                dist.all_reduce(x)
            return x
        """}, ["collective-order"])
    # split(): the raise runs exactly where the collective does; a rank
    # predicate never excuses an exit, nor guards a collective
    assert sorted(f.line for f in r.findings) == [20, 27, 29]


# ---------------------------------------------------------------------
# the injection probes
# ---------------------------------------------------------------------


def _cli(capsys, *argv):
    rc = eksml_lint.main(list(argv))
    return rc, capsys.readouterr().out


def test_probe_rank_guard_on_the_aggregate_all_gather(tmp_path, capsys):
    src = open(os.path.join(REPO, "eksml_tpu_torch", "telemetry",
                            "aggregate.py")).read()
    needle = "    dist.all_gather(gathered, mine)\n"
    assert needle in src, "aggregate.py changed; update this probe"
    injected = src.replace(needle, "    if dist.get_rank() == 0:\n    "
                           + needle)
    target = tmp_path / "aggregate_copy.py"
    target.write_text(injected)
    rc, out = _cli(capsys, "--rules", "collective-order", str(target))
    assert rc == 1, out
    (line,) = [ln for ln in out.splitlines() if "collective-order" in ln]
    guard = injected.splitlines().index("    if dist.get_rank() == 0:") + 1
    assert f"aggregate_copy.py:{guard + 1}: collective-order" in line
    assert f"aggregate_copy.py:{guard} ('dist.get_rank()')" in line
    assert f"chain: " in line and f"{guard + 1} all_gather" in line
    target.write_text(src)
    assert _cli(capsys, "--rules", "collective-order",
                str(target))[0] == 0


def test_probe_torch_rand_in_the_loader_substitution(tmp_path, capsys):
    src = open(os.path.join(REPO, "eksml_tpu_torch", "data",
                            "loader.py")).read()
    needle = "        cycles.append((-1, self._order))\n"
    assert needle in src, "loader.py changed; update this probe"
    dst = tmp_path / "eksml_tpu_torch" / "data"
    dst.mkdir(parents=True)
    (tmp_path / "eksml_tpu_torch" / "__init__.py").write_text("")
    (dst / "__init__.py").write_text("")
    injected = src.replace(
        needle, needle + "        skew = torch.rand(3)\n")
    (dst / "loader.py").write_text(injected)
    rc, out = _cli(capsys, "--rules", "rng-discipline",
                   str(tmp_path / "eksml_tpu_torch"))
    assert rc == 1, out
    (line,) = [ln for ln in out.splitlines() if "rng-discipline" in ln]
    at = injected.splitlines().index("        skew = torch.rand(3)") + 1
    assert f"loader.py:{at}: rng-discipline: RNG draw torch.rand()" in line
    assert f"chain: " in line and f"loader.py:{at} torch.rand()" in line
    (dst / "loader.py").write_text(src)
    assert _cli(capsys, "--rules", "rng-discipline",
                str(tmp_path / "eksml_tpu_torch"))[0] == 0


def test_probe_a_handler_return_before_the_eval_gather(tmp_path, capsys):
    src = open(RUNNER).read()
    assert HANDLER in src, "runner.py changed; update this probe"
    injected = src.replace(HANDLER, HANDLER + "        return {}\n")
    target = tmp_path / "runner_copy.py"
    target.write_text(injected)
    rc, out = _cli(capsys, "--rules", "collective-order", str(target))
    assert rc == 1, out
    (line,) = [ln for ln in out.splitlines() if "collective-order" in ln]
    lines = injected.splitlines()
    ret = lines.index("        return {}") + 1
    handler = lines.index("    except Exception as e:  # noqa: BLE001 — "
                          "re-raised after the gather") + 1
    assert f"runner_copy.py:{ret}: collective-order: early return" in line
    assert f"exception handler at " in line and \
        f"runner_copy.py:{handler}" in line
    assert "_gather_detection_lists" in line and "all_gather" in line
    assert "chain: " in line
    target.write_text(src)
    assert _cli(capsys, "--rules", "collective-order",
                str(target))[0] == 0


# ---------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------


def test_the_ports_tree_is_clean_under_the_spmd_rules(capsys):
    import json

    rc, out = _cli(capsys, "--rules", ",".join(SPMD_RULES), "--json")
    assert rc == 0, out
    payload = json.loads(out)
    assert payload["findings"] == [] and payload["baselined"] == []
    sync = [s for s in payload["suppressed"] if s["rule"] == "host-sync"]
    # the sentinel's read and the log step's in fit, the preemption
    # agreement's read-back, the checkpoint snapshot's synchronize
    assert sorted((s["path"], s["context"].split("#")[0].strip())
                  for s in sync) == [
        ("eksml_tpu_torch/parallel/collectives.py", "vec = vec.cpu()"),
        ("eksml_tpu_torch/train.py",
         'loss = float(metrics["total_loss"])'),
        ("eksml_tpu_torch/train.py",
         "row = {k: float(v) for k, v in metrics.items()}"),
        ("eksml_tpu_torch/utils/checkpoint.py",
         "torch.cuda.synchronize(dev)")]
    assert all(len(s["chain"]) >= 1 for s in sync)
    assert sorted(s["path"] for s in payload["suppressed"]
                  if s["rule"] == "collective-order") == [
        "eksml_tpu_torch/tools/eval_ckpt.py", "eksml_tpu_torch/train.py"]


def test_the_unchanged_rules_agree_over_the_port():
    """The six rules that carry over unchanged give identical results
    under both engines over the port's tree."""
    ref = ref_lint(targets=("eksml_tpu_torch",), repo_root=REPO,
                   rules=UNCHANGED)
    port = run_lint(targets=("eksml_tpu_torch",), repo_root=REPO,
                    rules=UNCHANGED)
    assert [f.to_dict() for f in port.findings] == \
        [f.to_dict() for f in ref.findings]
    assert [f.to_dict() for f in port.suppressed] == \
        [f.to_dict() for f in ref.suppressed]
    assert sorted(port.files) == sorted(ref.files)
    assert len(port.suppressed) == 2


def test_every_cold_name_is_a_def_of_the_port():
    import ast

    defs = set()
    for root, _, files in os.walk(os.path.join(REPO, "eksml_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    defs |= {n.name for n in ast.walk(ast.parse(f.read()))
                             if isinstance(n, ast.FunctionDef)}
    assert spmd.SYNC_COLD and spmd.SYNC_COLD <= defs, \
        sorted(spmd.SYNC_COLD - defs)
    for contract, quals in spmd._RNG_CONTRACT + tuple(spmd._HOT_ROOTS):
        assert os.path.exists(os.path.join(REPO, contract)), contract
        if quals != "*":
            assert {q.rsplit(".", 1)[-1] for q in quals} <= defs, quals
    for path, qual in spmd._SEED_COLLECTIVE_DEFS:
        assert os.path.exists(os.path.join(REPO, path)), path
        assert qual.rsplit(".", 1)[-1] in defs, qual
