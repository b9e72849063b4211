"""Atomic artifact writes (the port of ``eksml_tpu/fsio.py``).

Write the payload to a ``.tmp`` sibling in the same directory, then
``os.replace`` it over the destination: atomic on POSIX, so a
concurrent reader (a scraper polling a port file, an operator tailing a
bank) never sees a torn or empty file, and a crash mid-write never
destroys the previous good artifact.  The ``atomic-write`` lint rule
holds the package to this idiom (``tests/test_torch_lint.py``).

Stdlib only: the tools and the build helpers import it without torch.
"""

from __future__ import annotations

import json
import os
from typing import Any


def atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: Any, indent: int = 1,
                      **kwargs: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent, **kwargs)
    os.replace(tmp, path)
