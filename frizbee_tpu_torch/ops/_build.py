"""Build and load the package's CUDA kernels (``frizbee_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Builds land in
``frizbee_tpu_torch/_build/`` (ignored by git), keyed by a hash of the
source and flags, so an edited source rebuilds and an unchanged one loads
at once. Nothing builds at import: the first launch builds its library,
and :func:`build` builds several at once with one ``nvcc`` per source,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry point and ctypes argtypes per library; every pointer (and the
# stream) is c_void_p so no 64-bit value is cut to an int
SIGNATURES = {
    "colstream_fuzzy": (
        "colstream_fuzzy_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    ),
    "row_gather": (
        "row_gather_launch",
        [_P, _P, _P, _I, _L, _P],
    ),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only on a host with "
            "the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha1(
            fh.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all running at once. Returns per
    name {"path", "seconds", "log"} (``log`` is nvcc's ptxas report;
    ``seconds`` is 0.0 for a library that was already built). Raises
    with the compiler's output when a build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {
            "path": path, "seconds": time.perf_counter() - t0, "log": log,
        }
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


def entry(name: str):
    """The C entry point of kernel ``name``, argtypes set."""
    return getattr(library(name), SIGNATURES[name][0])
