"""Build the port's CUDA sources with ``nvcc`` into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, at first
use, into ``build/repro_torch/lib<name>-<digest>.so`` under the repository
root (``build/`` is git-ignored).  The digest covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel never loads a
stale library.  Nothing here runs
at import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fused_agg", "group_agg", "chunk_agg", "decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``CUDA_HOME``'s, else the one on PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [str(Path(CUDA_HOME) / "bin" / "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together.  Returns {name: seconds from the start until its
    build was seen to end, waiting on them in order} (0.0 when the library
    was already there); raises with the compiler's output if a build
    fails.  ``-Xptxas -v``'s register and shared-memory report is kept
    beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out.with_suffix(".log"), "w") as log:  # the child keeps its own handle
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, out)
    secs = dict.fromkeys(names, 0.0)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        proc.wait()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            log = out.with_suffix(".log").read_text()
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
