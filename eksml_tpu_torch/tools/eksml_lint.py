"""eksml-lint for the port: framework-invariant static analysis as a
gate (the port of ``tools/eksml_lint.py``).

Runs the thirteen rules in ``eksml_tpu_torch/analysis/`` over the port's
tree (``eksml_tpu_torch/``; tests are excluded on purpose) and exits
nonzero on any finding that is neither suppressed inline
(``# eksml-lint: disable=<rule>``) nor grandfathered in the committed
baseline (``eksml_tpu_torch/tools/lint_baseline.json``): the six
module/project rules, the four SPMD-safety rules over
``torch.distributed`` on the cross-module call graph, and the three
thread-topology rules (lock-order, unlocked-shared-state,
blocking-under-lock).  ``tests/test_torch_lint.py`` runs it over the real
tree, which makes every invariant a tier-1 gate; ``chip_smoke.py``'s
reports phase runs it on the card's machine, which has no JAX.

Usage::

    python -m eksml_tpu_torch.tools.eksml_lint                 # full gate
    python -m eksml_tpu_torch.tools.eksml_lint --json          # machine output
    python -m eksml_tpu_torch.tools.eksml_lint --rules atomic-write \\
        eksml_tpu_torch/utils/
    python -m eksml_tpu_torch.tools.eksml_lint --changed       # findings
        # only in files changed vs HEAD (--changed BASE for a ref)
    python -m eksml_tpu_torch.tools.eksml_lint --update-baseline
        # grandfather debt (then justify every entry!)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from eksml_tpu_torch.analysis import ALL_RULES, load_baseline, run_lint
from eksml_tpu_torch.analysis.engine import format_human, write_baseline

#: the root the default targets and the reported paths are relative to:
#: the directory that holds the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")


def changed_paths(base: str, repo: str = REPO) -> list:
    """Repo-relative paths of files changed vs *base* (``git diff
    --name-only``) plus untracked files — the pre-commit scope."""
    out = subprocess.run(["git", "diff", "--name-only", base, "--"],
                         cwd=repo, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {base} failed: "
            f"{out.stderr.strip() or out.stdout.strip()}")
    paths = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    untracked = subprocess.run(
        ["git", "ls-files", "--others", "--exclude-standard"],
        cwd=repo, capture_output=True, text=True)
    if untracked.returncode == 0:
        paths += [ln.strip() for ln in untracked.stdout.splitlines()
                  if ln.strip()]
    return sorted(set(paths))


def main(argv=None, repo: str = REPO) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eksml_tpu_torch.tools.eksml_lint",
        description=__doc__.splitlines()[0])
    p.add_argument("targets", nargs="*", default=None,
                   help="files/dirs to lint (default: eksml_tpu_torch/)")
    p.add_argument("--rules", default=None,
                   help=f"comma list of {list(ALL_RULES)} "
                        "(default: all)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="grandfathered-findings file [%(default)s]")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (show total debt)")
    p.add_argument("--update-baseline", action="store_true",
                   help="write current findings to the baseline; "
                        "every entry then needs a justified 'reason'")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--changed", nargs="?", const="HEAD", default=None,
                   metavar="BASE",
                   help="report findings only for files in `git diff "
                        "--name-only BASE` (default HEAD) plus "
                        "untracked files — the fast pre-commit path. "
                        "The cross-module graph is still built over "
                        "the full tree, so a changed caller is "
                        "checked against unchanged callees")
    args = p.parse_args(argv)

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    baseline = ([] if (args.no_baseline or args.update_baseline)
                else load_baseline(args.baseline))
    if args.changed is not None and args.update_baseline:
        # the merge in write_baseline keys "still present" off the
        # checked files; a path-filtered result would silently kill
        # grandfathered entries for unchanged files
        print("eksml-lint: --changed cannot be combined with "
              "--update-baseline (a scoped result would drop "
              "out-of-scope baseline entries)", file=sys.stderr)
        return 2
    only_paths = None
    if args.changed is not None:
        try:
            only_paths = changed_paths(args.changed, repo)
        except RuntimeError as e:
            print(f"eksml-lint: {e}", file=sys.stderr)
            return 2
        if not only_paths:
            print(f"eksml-lint: no files changed vs {args.changed} — "
                  "nothing to lint")
            return 0
    result = run_lint(targets=args.targets or None, repo_root=repo,
                      rules=rules, baseline=baseline,
                      only_paths=only_paths)

    if args.update_baseline:
        # scoped updates merge: out-of-scope grandfathered entries and
        # hand-written reasons survive (see write_baseline)
        write_baseline(args.baseline, result.findings,
                       active_rules=rules or list(ALL_RULES),
                       checked_paths=result.files)
        print(f"eksml-lint: baselined {len(result.findings)} "
              f"finding(s) into {args.baseline} — justify every "
              "entry's 'reason' or fix it", file=sys.stderr)
        return 0

    if args.as_json:
        print(json.dumps(result.to_dict(), indent=1))
    else:
        print(format_human(result))
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
