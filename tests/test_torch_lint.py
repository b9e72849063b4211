"""The concurrency and durability lint rules over the port.

``eksml_tpu.analysis`` (the reference's static checkers) run over
``eksml_tpu_torch``: signal handlers only set flags, artifacts are written
then ``os.replace``d, locks are taken in one order, shared state is
guarded, and nothing blocks while holding a lock.  This covers the
operator's SIGTERM handlers, its rank processes and the serving tracks'
locks.  A true negative is marked where it stands with
``# eksml-lint: disable=<rule>`` and one line on why."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu.analysis.engine import run_lint  # noqa: E402

RULES = ("signal-safety", "atomic-write", "lock-order",
         "unlocked-shared-state", "blocking-under-lock")


def test_the_port_has_no_lint_finding():
    result = run_lint(targets=("eksml_tpu_torch",), repo_root=REPO,
                      rules=RULES)
    assert len(result.files) > 60, result.files
    assert [str(f) for f in result.findings] == []
    # every suppression is one the port states on its line
    assert {f.rule for f in result.suppressed} <= set(RULES)
