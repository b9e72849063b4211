"""The port's own eksml-lint over the port.

``eksml_tpu_torch.analysis`` (the port of the reference's static
checkers, with the same thirteen rules reading PyTorch's primitives)
runs over ``eksml_tpu_torch`` with every rule: no ``torch.distributed``
collective behind a rank-divergent branch, the zero-RNG contract set
draws nothing, the hot loop's syncs are the justified ones, batch
content sizes no step or forward input outside the bucket schedule,
what autograd runs twice is pure, signal handlers only set flags,
artifacts are written then ``os.replace``d, scopes and chart values stay
in sync, locks are taken in one order, shared state is guarded, and
nothing blocks while holding a lock.  A true negative is marked where it
stands with ``# eksml-lint: disable=<rule>`` and one line on why."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from eksml_tpu_torch.analysis import ALL_RULES, run_lint  # noqa: E402


def test_the_port_has_no_lint_finding():
    result = run_lint(targets=("eksml_tpu_torch",), repo_root=REPO,
                      rules=ALL_RULES)
    assert len(ALL_RULES) == 13
    assert len(result.files) > 60, result.files
    assert [str(f) for f in result.findings] == []
    assert result.baselined == []
    # every suppression is one the port states on its line, with the
    # reason on the line itself or the comment line above it
    with_reason = 0
    for f in result.suppressed:
        with open(os.path.join(REPO, f.path)) as fh:
            lines = fh.read().splitlines()
        here, above = lines[f.line - 1], lines[f.line - 2].strip()
        assert f"disable={f.rule}" in here or f"disable={f.rule}" in above
        with_reason += above.startswith("#") or (
            here.split("# eksml-lint:")[0].strip().endswith("#"))
    assert with_reason == len(result.suppressed), result.suppressed
