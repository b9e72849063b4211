"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and builds
alone into ``_build/lib<name>-<digest>.so`` (the digest covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds and an unchanged one is reused).  :func:`build` starts
one ``nvcc`` per source, all at once, and waits for all of them.
With a process group up, local rank 0 of each host builds and the
other ranks wait at a barrier, then load what it built.  Nothing is
built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

from eksml_tpu_torch.fsio import atomic_write_text

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildResult:
    name: str
    path: str
    seconds: float   # nvcc wall time in this process (0.0 when reused)
    log: str         # nvcc's output: the -Xptxas -v register/spill summary
    reused: bool


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the port's CUDA kernels are built from csrc/)")


def _target(name: str):
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Build every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Raises with
    nvcc's output if any build fails.  Under a process group of more
    than one rank this is a collective: every rank must call it."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _build(names)
    from eksml_tpu_torch.parallel.distributed import barrier, local_rank

    err = None
    if local_rank() == 0:
        try:
            results = _build(names)
        except RuntimeError as e:    # the others must still pass the barrier
            err = e
    barrier()
    if err is not None:
        raise err
    if local_rank() != 0:
        results = _build(names)      # local rank 0's libraries, reused
    return results


def _build(names: Sequence[str]) -> Dict[str, BuildResult]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        src, lib = _target(name)
        if os.path.isfile(lib):
            log = ""
            if os.path.isfile(lib + ".log"):
                with open(lib + ".log") as f:
                    log = f.read()
            results[name] = BuildResult(name, lib, 0.0, log, True)
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failures = []
    for name, (proc, tmp, lib, t0) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        atomic_write_text(lib + ".log", out)
        # rename last: a concurrent builder never loads a partial file
        os.replace(tmp, lib)
        results[name] = BuildResult(name, lib, seconds, out, False)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return results


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name].path)
            _LIBS[name] = lib
        return lib
