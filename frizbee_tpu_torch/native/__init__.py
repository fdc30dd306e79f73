"""Native host components: the corpus packer, the batched host match and
literal pipelines and the batched traceback (``packer.cpp``, through
ctypes), and the C ``Match`` type with its bulk builder (``fastmatch.c``,
a CPython extension).

Both build from this directory's sources with the system toolchain on first
use (``g++`` with OpenMP for the packer, ``gcc`` for the extension) into
``frizbee_tpu_torch/_build/native/<host tag>/``, keyed by a hash of the
source and the flags. The host tag keys the CPU: the packer is built with
``-march=native``, so a build copied to another CPU class is never loaded.
Concurrent builders (test workers on a cold build directory) each compile
to a temporary file of their own and install it with one atomic rename.

A failed build or load raises with the compiler's output; nothing falls
back. The NumPy and per-row Python twins of these paths (the differential
oracles) are reached only through the test hook ``_FORCE_NUMPY`` below,
which the engines and the packer read, and ``traceback._FORCE_NUMPY`` for
the traceback. ctypes releases the GIL for the length of each call, so
packing in a worker thread overlaps the caller's work.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import platform
import subprocess
import sys
import sysconfig
import threading
import time
from typing import Dict, Optional

import numpy as np

# Test hook: route the engines' host batches, the XL-blob path and
# ``pack_corpus`` through their NumPy / per-row Python twins.
_FORCE_NUMPY = False

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
PACKER_SRC = os.path.join(_DIR, "packer.cpp")
FASTMATCH_SRC = os.path.join(_DIR, "fastmatch.c")
PACKER_CMD = ("g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
FASTMATCH_CMD = ("gcc", "-O2", "-shared", "-fPIC")
FASTMATCH_MODULE = "frizbee_tpu_torch.native.fastmatch"

# seconds each library's compile took in this process (absent when it
# was already built)
BUILD_SECONDS: Dict[str, float] = {}

_LOCK = threading.Lock()
_lib = None
_fastmatch = None


def _host_tag() -> str:
    """Machine, processor and CPU flags, hashed: the ``-march=native``
    build is keyed by it so a build directory copied to another host
    class never loads a mismatched binary (SIGILL on first use)."""
    parts = [platform.machine(), platform.processor()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    parts.append(line.strip())
                    break
    except OSError:
        pass
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:10]


def build_dir() -> str:
    """Where this host's native builds live."""
    return os.path.join(_PKG, "_build", "native", _host_tag())


def _compile(src: str, stem: str, suffix: str, cmd_head) -> str:
    """Path of ``src`` built by ``cmd_head``, compiling it first when this
    source and these flags have no build yet. Raises with the compiler's
    output when the build fails."""
    h = hashlib.sha1(" ".join(cmd_head).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    out_dir = build_dir()
    out = os.path.join(out_dir, f"{stem}_{h.hexdigest()[:12]}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [*cmd_head, src, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build: {cmd[0]} not found") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"native build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_SECONDS[stem] = time.perf_counter() - t0
    return out


_V = ctypes.c_void_p
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_CS = ctypes.c_char_p

# C entry point -> argtypes (every entry point returns void but the last)
_SIGNATURES = {
    "pack_rows_u8": [_CS, _I64P, _I64P, _I64, _I64, _V],
    "pack_rows_u32": [_V, _I64P, _I64P, _I64, _I64, _V],
    "utf8_lengths": [_V, _I64P, _I64, _I64P],
    "sw_indices_batch": (
        [_V] * 8 + [_I64, _I64] + [_V] * 2 + [_I64, _V, _I64] + [_V] * 3
        + [_I64]
    ),
    "host_match_batch": (
        [_CS, _I64P, _I64P, _I64] + [_V, _V, _I64] + [_V] + [_I64] * 3
        + [_CS, _I64] + [_V] * 4 + [_V, _V, _I64]
    ),
    "host_match_batch_u32": (
        [_CS, _I64P, _V, _I64P, _I64P, _I64] + [_V, _V, _I64] * 2 + [_V]
        + [_I64] * 3 + [_CS, _I64] + [_V] * 4 + [_V, _V, _I64]
    ),
    "host_literal_batch": (
        [_CS, _I64P, _I64P, _I64] + [_CS, _I64P, _CS, _I64P] + [_I64, _I64]
        + [_V, _I64] + [_V] * 3
    ),
    "native_omp_threads": [],
}


def get_lib() -> ctypes.CDLL:
    """The packer library, built and loaded on first use."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(
                    _compile(PACKER_SRC, "packer", ".so", PACKER_CMD))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = None
                lib.native_omp_threads.restype = ctypes.c_int64
                _lib = lib
    return _lib


def get_fastmatch():
    """The fastmatch extension module (C ``Match`` type and
    ``build_matches``), built and imported on first use. It is
    registered in ``sys.modules`` under its canonical name, so the class
    resolves by module path in any process."""
    global _fastmatch
    if _fastmatch is None:
        with _LOCK:
            if _fastmatch is None:
                tag = sysconfig.get_config_var("SOABI") or "py3"
                inc = sysconfig.get_paths()["include"]
                so = _compile(FASTMATCH_SRC, "fastmatch", f".{tag}.so",
                              (*FASTMATCH_CMD, f"-I{inc}"))
                spec = importlib.util.spec_from_file_location(
                    FASTMATCH_MODULE, so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                sys.modules[FASTMATCH_MODULE] = mod
                _fastmatch = mod
    return _fastmatch


def omp_threads() -> int:
    """OpenMP threads a parallel region of the packer library uses."""
    return int(get_lib().native_omp_threads())


def encode_rows(rows, unicode: bool):
    """The native batches' ragged buffers of ``rows``: (joined UTF-8
    bytes, starts (R+1,) int64 byte offsets, joined_u32 UTF-32
    codepoints, ustarts (R+1,) int64), the UTF-32 pair None unless
    ``unicode``."""
    data = [h.encode("utf-8") for h in rows]
    starts = np.zeros(len(data) + 1, np.int64)
    np.cumsum([len(d) for d in data], out=starts[1:])
    joined_u32 = ustarts = None
    if unicode:
        u32 = [np.frombuffer(h.encode("utf-32-le"), np.uint32) for h in rows]
        ustarts = np.zeros(len(u32) + 1, np.int64)
        np.cumsum([len(u) for u in u32], out=ustarts[1:])
        joined_u32 = np.concatenate(u32) if u32 else np.zeros(0, np.uint32)
    return b"".join(data), starts, joined_u32, ustarts


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _vp(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(_V)


def _c32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _offsets(starts, n_units: int, rows=None, pad_ok=False):
    """(starts, rows) as contiguous int64, checked: ``starts`` is a
    nondecreasing (R+1,) offset table into a buffer of ``n_units`` units
    and every selected row (``rows``; -1 marks a padding row where
    ``pad_ok``) lies in it."""
    starts = np.ascontiguousarray(starts, np.int64)
    if (starts.ndim != 1 or starts.size == 0 or starts[0] < 0
            or starts[-1] > n_units or np.any(np.diff(starts) < 0)):
        raise ValueError("native: bad row offset table")
    if rows is not None:
        rows = np.ascontiguousarray(rows, np.int64)
        if rows.size and (int(rows.max()) >= starts.size - 1
                          or int(rows.min()) < (-1 if pad_ok else 0)):
            raise IndexError("native: row index outside the offset table")
    return starts, rows


def pack_rows_u8(joined: bytes, starts: np.ndarray, rows: np.ndarray,
                 width: int) -> np.ndarray:
    """(len(rows), width) int8 zero-padded byte matrix: row r holds the
    first ``width`` bytes of ``joined[starts[rows[r]]:starts[rows[r]+1]]``,
    or zeros where ``rows[r]`` is -1 (size-class padding)."""
    starts, rows = _offsets(starts, len(joined), rows, pad_ok=True)
    out = np.empty((len(rows), width), np.int8)
    get_lib().pack_rows_u8(joined, _i64p(starts), _i64p(rows), len(rows),
                           width, _vp(out))
    return out


def pack_rows_u32(joined_u32: np.ndarray, starts: np.ndarray,
                  rows: np.ndarray, width: int) -> np.ndarray:
    """(len(rows), width) int32 zero-padded codepoint matrix, as
    :func:`pack_rows_u8` over a UTF-32 buffer."""
    joined_u32 = np.ascontiguousarray(joined_u32, np.uint32)
    starts, rows = _offsets(starts, len(joined_u32), rows, pad_ok=True)
    out = np.empty((len(rows), width), np.int32)
    get_lib().pack_rows_u32(_vp(joined_u32), _i64p(starts), _i64p(rows),
                            len(rows), width, _vp(out))
    return out


def utf8_lengths(joined_u32: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """(R,) int64 UTF-8 byte length of each row of a UTF-32 buffer."""
    joined_u32 = np.ascontiguousarray(joined_u32, np.uint32)
    starts, _ = _offsets(starts, len(joined_u32))
    n = len(starts) - 1
    out = np.empty(n, np.int64)
    get_lib().utf8_lengths(_vp(joined_u32), _i64p(starts), n, _i64p(out))
    return out


def sw_indices_batch(
    cp: np.ndarray, first: np.ndarray, prev: np.ndarray,
    boff: np.ndarray, blen: np.ndarray,
    su: np.ndarray, eu: np.ndarray, inc_prefix: np.ndarray,
    orig: np.ndarray, flip: np.ndarray,
    scoring9: np.ndarray, max_typos: Optional[int],
):
    """Batched per-row DP fill and traceback walk over (R, W) bucket
    arrays, each row's window [su, eu) in unit columns. Returns (score
    (R,), cnt (R,), idx (R, 4n)) int32: row r's reversed matched byte
    offsets are ``idx[r, :cnt[r]]``. Semantics contract:
    oracle/smith_waterman.sw_indices; NumPy twin: traceback.sw_fill +
    walk_indices."""
    cp, first, prev, boff, blen = map(_c32, (cp, first, prev, boff, blen))
    R, W = cp.shape
    su, eu = _c32(su), _c32(eu)
    inc = np.ascontiguousarray(inc_prefix, np.uint8)
    orig, flip = _c32(orig), _c32(flip)
    sc = _c32(scoring9)
    n = len(orig)
    for a in (first, prev, boff, blen):
        if a.shape != (R, W):
            raise ValueError("native: bucket arrays differ in shape")
    if (su.shape != (R,) or eu.shape != (R,) or inc.shape != (R,)
            or flip.shape != (n,) or sc.shape != (9,)):
        raise ValueError("native: bad window, needle or scoring shape")
    if R and (su.min() < 0 or eu.max() > W or np.any(su > eu)):
        raise ValueError("native: window outside the bucket width")
    cap = max(4 * n, 1)
    score = np.empty(R, np.int32)
    cnt = np.empty(R, np.int32)
    idx = np.empty((R, cap), np.int32)
    get_lib().sw_indices_batch(
        _vp(cp), _vp(first), _vp(prev), _vp(boff), _vp(blen),
        _vp(su), _vp(eu), _vp(inc), R, W,
        _vp(orig), _vp(flip), n,
        _vp(sc), -1 if max_typos is None else int(max_typos),
        _vp(score), _vp(cnt), _vp(idx), cap,
    )
    return score, cnt, idx


def _match_outputs(R: int, indices_cap: int):
    out = [np.empty(R, np.uint8), np.empty(R, np.int32),
           np.empty(R, np.uint8), np.empty(R, np.int32)]
    if indices_cap:
        out += [np.empty((R, indices_cap), np.int32), np.empty(R, np.int32)]
    else:
        out += [None, None]
    return out


def _match_result(outs, indices_cap: int):
    matched, score, exact, end_col, idx, icnt = outs
    res = (matched.astype(bool), score, exact.astype(bool), end_col)
    return res + (idx, icnt) if indices_cap else res


def host_match_batch(
    joined: bytes, starts: np.ndarray,
    orig: np.ndarray, flip: np.ndarray,
    scoring9: np.ndarray, max_typos: Optional[int],
    dp_cap: int, min_len: int, needle_bytes: bytes,
    rows: Optional[np.ndarray] = None,
    indices_cap: int = 0,
):
    """Batched byte-unit host pipeline (length gate -> prefilter window ->
    greedy or full SW with exact bonus) over ragged rows. ``rows`` selects
    a subset (result slot r scores row rows[r]), so a resident encoded
    blob serves per-query candidate sets without re-encoding. Returns
    (matched (R,) bool, score (R,), exact (R,) bool, end_col (R,)), plus
    (idx (R, indices_cap), icnt (R,)) reversed matched byte offsets when
    ``indices_cap`` > 0. Semantics contract: engine._host_pipeline /
    engine.match_one_indices per row."""
    starts, rows = _offsets(starts, len(joined), rows)
    R = len(starts) - 1 if rows is None else len(rows)
    orig, flip, sc = _c32(orig), _c32(flip), _c32(scoring9)
    outs = _match_outputs(R, indices_cap)
    get_lib().host_match_batch(
        joined, _i64p(starts), None if rows is None else _i64p(rows), R,
        _vp(orig), _vp(flip), len(orig), _vp(sc),
        -1 if max_typos is None else int(max_typos),
        dp_cap, min_len, needle_bytes, len(needle_bytes),
        *map(_vp, outs), indices_cap,
    )
    return _match_result(outs, indices_cap)


def host_match_batch_u32(
    joined: bytes, bstarts: np.ndarray,
    joined_u32: np.ndarray, ustarts: np.ndarray,
    orig: np.ndarray, flip: np.ndarray,
    orig_b: np.ndarray, flip_b: np.ndarray,
    scoring9: np.ndarray, max_typos: Optional[int],
    dp_cap: int, min_len: int, needle_bytes: bytes,
    rows: Optional[np.ndarray] = None,
    indices_cap: int = 0,
):
    """Codepoint twin of :func:`host_match_batch`: codepoint units (with
    their UTF-8 byte context derived in the pass) for the prefilter and
    SW, raw bytes and byte-level needle pairs for the greedy matcher —
    the oracle's split."""
    bstarts, rows = _offsets(bstarts, len(joined), rows)
    joined_u32 = np.ascontiguousarray(joined_u32, np.uint32)
    ustarts, _ = _offsets(ustarts, len(joined_u32))
    if ustarts.shape != bstarts.shape:
        raise ValueError("native: byte and codepoint row tables differ")
    R = len(bstarts) - 1 if rows is None else len(rows)
    orig, flip, orig_b, flip_b = map(_c32, (orig, flip, orig_b, flip_b))
    sc = _c32(scoring9)
    outs = _match_outputs(R, indices_cap)
    get_lib().host_match_batch_u32(
        joined, _i64p(bstarts), _vp(joined_u32), _i64p(ustarts),
        None if rows is None else _i64p(rows), R,
        _vp(orig), _vp(flip), len(orig),
        _vp(orig_b), _vp(flip_b), len(orig_b),
        _vp(sc), -1 if max_typos is None else int(max_typos),
        dp_cap, min_len, needle_bytes, len(needle_bytes),
        *map(_vp, outs), indices_cap,
    )
    return _match_result(outs, indices_cap)


LITERAL_MODES = {"exact": 0, "prefix": 1, "suffix": 2, "substring": 3}


def host_literal_batch(
    joined: bytes, starts: np.ndarray,
    unit_pairs,
    mode: str,
    scoring9: np.ndarray, needle_len: int,
    rows: Optional[np.ndarray] = None,
):
    """Batched literal matcher over ragged byte rows: (matched (R,) bool,
    score (R,) int32, pos (R,) int32 byte offsets). ``unit_pairs`` is
    ``oracle.literal._needle_variants``'s per-unit (orig, flip) byte
    strings. Semantics contract: oracle/literal.literal_find per row."""
    starts, rows = _offsets(starts, len(joined), rows)
    R = len(starts) - 1 if rows is None else len(rows)
    obytes = b"".join(o for o, _ in unit_pairs)
    fbytes = b"".join(f for _, f in unit_pairs)
    ostarts = np.zeros(len(unit_pairs) + 1, np.int64)
    np.cumsum([len(o) for o, _ in unit_pairs], out=ostarts[1:])
    fstarts = np.zeros(len(unit_pairs) + 1, np.int64)
    np.cumsum([len(f) for _, f in unit_pairs], out=fstarts[1:])
    sc = _c32(scoring9)
    matched = np.empty(R, np.uint8)
    score = np.empty(R, np.int32)
    pos = np.empty(R, np.int32)
    get_lib().host_literal_batch(
        joined, _i64p(starts), None if rows is None else _i64p(rows), R,
        obytes, _i64p(ostarts), fbytes, _i64p(fstarts), len(unit_pairs),
        LITERAL_MODES[mode], _vp(sc), needle_len,
        _vp(matched), _vp(score), _vp(pos),
    )
    return matched.astype(bool), score, pos
