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

import torch

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
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
         _P, _P],
    ),
    "colstream_literal": (
        "colstream_literal_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
         _P],
    ),
    "row_gather": (
        "row_gather_launch",
        [_P, _P, _P, _I, _L, _P],
    ),
    "match_units": (
        "match_units_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
         _P],
    ),
    "lane_contract": (
        "lane_contract_launch",
        [_P, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
         _P],
    ),
}

# launch counters beside the libraries': the int16-lane instantiations of
# the two DP kernels count apart from their int32 siblings, so a run can
# tell which one served
INSTANTIATIONS = ("match_units_i16", "colstream_fuzzy_i16")

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
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


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


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address for a C entry point (NULL for None)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_operands(device, operands) -> None:
    """Raise unless every given (name, tensor, dtype, shape) operand is a
    contiguous tensor of that dtype and shape on ``device``."""
    for name, t, dt, shp in operands:
        if t is None:
            continue
        if (t.device != device or t.dtype != dt
                or tuple(t.shape) != tuple(shp) or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dt} {tuple(shp)} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def scoring_arg(scoring):
    """(keep-alive buffer, pointer) of the (9,) int32 scoring vector."""
    sc = (ctypes.c_int * 9)(*(int(s) for s in scoring))
    return sc, ctypes.cast(sc, ctypes.c_void_p)


def launch(name: str, device, *args, call=None, count=None) -> None:
    """Call kernel ``name``'s C entry point on ``device`` and count the
    launch in ``LAUNCHES[count or name]``; raises when the launch is
    refused. ``call`` is the wrapper's (args, kwargs), kept in ``CAPTURE``
    (under the same counter name) when that is a list."""
    with torch.cuda.device(device):
        rc = entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[count or name] += 1
    if CAPTURE is not None:
        CAPTURE.append((count or name, call))


# Kernel launches per kernel (plain-version calls never count): a run
# sets them to 0, drives a path and reads which kernels it went through
LAUNCHES = {name: 0 for name in (*SIGNATURES, *INSTANTIATIONS)}

# None, or a list to which every launch appends (kernel name, (args,
# kwargs) of its wrapper call): a run can then replay exactly the
# launches that a path made
CAPTURE = None
