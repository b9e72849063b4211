"""Run a notebook's code cells in order, in this process, as a script.

    python3 -m eksml_tpu_torch.tools.run_notebook NOTEBOOK.ipynb

For machines without Jupyter's kernel machinery (no ``nbclient`` or
``ipykernel``, as the GPU hosts that run ``chip_smoke.py``): the code
cells of the notebook run one after another in one namespace, as a
kernel would run them, each under a ``[cell N]`` header; the value of a
cell's last expression is printed as its ``repr`` (where a notebook
would display it).  The first cell that raises ends the run with the
exception.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from typing import Dict


def code_cells(path: str):
    """The source of each code cell of the notebook at ``path``."""
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def run(path: str) -> Dict:
    """Execute the code cells of ``path`` in one new namespace and return
    it."""
    ns = {"__name__": "__main__"}
    for i, src in enumerate(code_cells(path)):
        print(f"[cell {i}]", flush=True)
        tree = ast.parse(src, filename=f"{path}:cell{i}")
        last = None
        if tree.body and isinstance(tree.body[-1], ast.Expr):
            last = ast.Expression(tree.body.pop().value)
        exec(compile(tree, f"{path}:cell{i}", "exec"), ns)
        if last is not None:
            value = eval(compile(last, f"{path}:cell{i}", "eval"), ns)
            if value is not None:
                print(repr(value), flush=True)
    return ns


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("notebook")
    args = p.parse_args(argv)
    run(args.notebook)
    return 0


if __name__ == "__main__":
    sys.exit(main())
