"""Build-and-load of the port's C++ host libraries (``eksml_tpu/_native.py``
``NativeLib``): the mask/RLE eval ops (``evalcoco/native_src/maskops.cc``)
and the input pipeline's resize (``data/native_src/imageops.cc``).

Each source has a plain ``extern "C"`` interface, is compiled by ``g++``
into ``eksml_tpu_torch/_build/lib<name>-<digest>.so`` and is loaded with
ctypes.  The digest covers the source and the flags, so an edited source
builds anew and is loaded in place of the stale library; an unchanged
one is reused.  Nothing is built at import time.

- :meth:`NativeLib.get` builds at first use (thread-safe: loader and
  eval worker threads can race into the first load).  A build writes a
  temporary file and renames it, so two processes that build at once
  never load half a library.
- :func:`build_all` is the collective form: with a process group of
  more than one rank up, local rank 0 of each host builds and the other
  ranks load after a barrier (as ``ops/cuda/build.py`` does).  Every
  rank must call it, at the same point; the lazy :meth:`NativeLib.get`
  never enters a collective.
- When the build or the load fails, ``get`` returns None and the
  callers take their numpy versions (the reference's semantics for
  these host ops).  ``loaded`` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

#: every library made through :class:`NativeLib`, by name
LIBRARIES: Dict[str, "NativeLib"] = {}


def cxx_path() -> str:
    found = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no C++ compiler: install g++ or set CXX")
    return found


class NativeLib:
    """One C++ source, built into ``_build/`` at first use and loaded.

    ``declare`` receives the loaded CDLL to set argtypes/restype; an
    AttributeError there (a symbol missing from the binary) falls back
    to the numpy versions like a failed build."""

    def __init__(self, name: str, src: str,
                 declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.src = src
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._attempted = False
        #: g++ wall seconds in this process (0.0 when the library was reused)
        self.build_seconds = 0.0
        self.error: Optional[str] = None
        LIBRARIES[name] = self

    @property
    def lib_path(self) -> str:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
        with open(self.src, "rb") as f:
            h.update(f.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:16]}.so")

    @property
    def loaded(self) -> bool:
        """True once :meth:`get` mapped the library (False: the numpy
        versions run)."""
        return self._lib is not None

    def build(self) -> str:
        """The library's path, compiling it when no up-to-date one
        exists.  Raises with the compiler's output on failure."""
        path = self.lib_path
        if os.path.isfile(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([cxx_path(), *CXX_FLAGS, "-o", tmp, self.src],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{self.name}: g++ exited {proc.returncode}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)    # a concurrent loader never maps half a file
        self.build_seconds = time.perf_counter() - t0
        return path

    def get(self) -> Optional[ctypes.CDLL]:
        if self._attempted:      # no lock once resolved
            return self._lib
        with self._lock:
            if not self._attempted:
                self._lib = self._load()
                self._attempted = True
            return self._lib

    def _load(self) -> Optional[ctypes.CDLL]:
        try:
            lib = ctypes.CDLL(self.build())
            self._declare(lib)
            return lib
        except (OSError, AttributeError, RuntimeError,
                subprocess.SubprocessError) as e:
            self.error = str(e)
            log.warning("%s unavailable (%s); using the numpy version",
                        self.name, e)
            return None


def _all() -> List[NativeLib]:
    # importing the bridges registers their libraries
    from eksml_tpu_torch.data import native as _data_native  # noqa: F401
    from eksml_tpu_torch.evalcoco import native as _eval_native  # noqa: F401

    return [LIBRARIES[k] for k in sorted(LIBRARIES)]


def build_all() -> Dict[str, NativeLib]:
    """Build and load every host library; returns them by name (check
    ``loaded``).  Under a process group of more than one rank this is a
    collective: local rank 0 builds, the others load after a barrier."""
    import torch.distributed as dist

    libs = _all()
    if dist.is_initialized() and dist.get_world_size() > 1:
        from eksml_tpu_torch.parallel.distributed import barrier, local_rank

        if local_rank() == 0:
            for lib in libs:
                lib.get()
        barrier()
    for lib in libs:
        lib.get()
    return {lib.name: lib for lib in libs}
