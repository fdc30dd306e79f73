"""Column-stream fused prefilter + Smith-Waterman (ASCII fuzzy mode) and
the whole-row gather, each as a CUDA kernel beside its plain PyTorch
version.

Counterpart of ``frizbee_tpu/ops/colstream.py``. Rows come in 1024-row
groups laid out unit-major (``corpus.PackedBucket.device_arrays_colstream``):
group g's unit column j holds rows g*1024 .. g*1024+1023 contiguously, so
one thread per row walks its columns and every DP dependency is a
loop-carried value.

The wrappers dispatch on the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (``csrc/colstream_fuzzy.cu``,
``csrc/row_gather.cu``) or raises. ``LAUNCHES`` counts kernel launches,
so a run can show that its path went through the kernels.

Semantics contract (pinned against frizbee_tpu in
tests/test_torch_colstream.py): positional prefilter with typo budget
(greedy embedding at T=0, minimal-position DP for T=1..3, none when
``no_prefilter`` or the budget covers the needle), start-1 window trim,
affine-gap Smith-Waterman with the full bonus schedule, exact-match
bonus with u16 saturation, and the greedy flag.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import MAX_HAYSTACK_LEN
from ..corpus import GROUP_ROWS
from . import _build
from .kernels import MAX_KERNEL_NEEDLE

# Per-needle-unit DP state lives in registers, so long needles and large
# typo budgets take the row-major route instead
MAX_COLSTREAM_NEEDLE = 16
MAX_COLSTREAM_TYPOS = 3

INT64_MAX = (1 << 63) - 1

# Kernel launches per kernel (not counting plain-version calls)
LAUNCHES = {"colstream_fuzzy": 0, "row_gather": 0}

# Prefilter modes of the CUDA kernel
_PF_NONE, _PF_GREEDY, _PF_DP = 0, 1, 2


def colstream_supported(n: int, max_typos, no_prefilter: bool) -> bool:
    """True when (needle length, typo budget) fits the register budget."""
    if n < 1 or n > MAX_COLSTREAM_NEEDLE:
        return False
    if no_prefilter:
        return True
    return int(max_typos) <= MAX_COLSTREAM_TYPOS


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _is_upper(b):
    return (b >= 0x41) & (b <= 0x5A)


def _is_lower(b):
    return (b >= 0x61) & (b <= 0x7A)


def _is_delim(b):
    letter = _is_upper(b) | _is_lower(b)
    digit = (b >= 0x30) & (b <= 0x39)
    return (b >= 0) & (b <= 127) & ~letter & ~digit


def _alive_rows(scalars, flags, nG):
    """(Q, nG*1024) bool: group alive = live-count bound and stage-1 flag."""
    g0 = torch.arange(nG, device=scalars.device) * GROUP_ROWS
    alive = g0[None, :] < scalars[:, :1]
    if flags is not None:
        alive = alive & (flags > 0)
    return alive.repeat_interleave(GROUP_ROWS, dim=1)


def pack_keys(matched, score, exact, end_col, greedy, idx, idx_bits):
    """63-bit sort keys [0xFFFF-score | idx | exact, greedy, end_col];
    unmatched or padding rows carry INT64_MAX."""
    ok = (matched > 0) & (idx >= 0)
    meta16 = (
        (exact.to(torch.int64) << 15) | (greedy.to(torch.int64) << 14)
        | torch.clamp(end_col, max=0x3FFF).to(torch.int64)
    )
    key = (
        ((0xFFFF - score).to(torch.int64) << (16 + idx_bits))
        | (idx.to(torch.int64) << 16) | meta16
    )
    return torch.where(ok, key, torch.full_like(key, INT64_MAX))


def match_units_colstream_plain(
    cpT, nuT, scalars, flags=None, idxT=None, *, W: int, n: int,
    max_typos: int = 0, scoring: Tuple[int, ...], no_prefilter: bool = False,
    idx_bits: int = 0,
):
    """Plain PyTorch version of the colstream kernel: vectorized over
    (query, row), Python loops over unit columns and needle units, line
    for line after ``frizbee_tpu.ops.colstream._match_block``.

    cpT (nG*W, 8, 128) int8, nuT (nG*8, 128) int32, scalars (Q, 130)
    int32 (``kernels.pack_needle_scalars``; [q, 0] is the live row
    count), flags (Q, nG) int32 or None. Returns int64 keys (Q, nG*1024)
    when ``idxT`` (nG*1024,) is given, else the five int32 columns
    (matched, score, exact, end_col, greedy), each (Q, nG*1024)."""
    (match_score, mismatch, gap_open, gap_ext, prefix_b, cap_b, case_b,
     exact_b, delim_b) = (int(s) for s in scoring)
    gop_extra = max(gap_open - gap_ext, 0)
    nG = cpT.shape[0] // W
    T = min(int(max_typos), n)
    Q = scalars.shape[0]
    hay_all = cpT.reshape(nG, W, GROUP_ROWS)
    nu = nuT.reshape(-1)
    shape = (Q, nu.shape[0])
    dev = cpT.device
    z = torch.zeros(shape, dtype=torch.int32, device=dev)
    fz = torch.zeros(shape, dtype=torch.bool, device=dev)
    orig = scalars[:, 2:2 + n]
    flip = scalars[:, 2 + MAX_KERNEL_NEEDLE:2 + MAX_KERNEL_NEEDLE + n]

    def orig_k(k):
        return orig[:, k:k + 1]

    def flip_k(k):
        return flip[:, k:k + 1]

    def column(j):
        hay = (hay_all[:, j, :].reshape(1, -1).to(torch.int32) & 0xFF)
        return hay, (nu > j)[None, :]

    jmaxu = min(int(nu.max()), W) if nu.numel() else 0
    nb = torch.clamp(nu, max=W)[None, :].expand(shape)

    # ---- pass 1: positional prefilter -----------------------------------
    auto = (not no_prefilter) and n <= T
    run_pf = (not no_prefilter) and not auto
    ffound, efound = fz.clone(), fz.clone()
    sbyte, ebyte = z.clone(), z.clone()

    def track(hit_start, hit_end, j):
        nonlocal ffound, efound, sbyte, ebyte
        sbyte = torch.where(~ffound & hit_start, j, sbyte)
        ffound = ffound | hit_start
        ebyte = torch.where(hit_end, j + 1, ebyte)
        efound = efound | hit_end

    if run_pf and T == 0:
        # greedy leftmost embedding: np_ = needle units consumed
        np_ = z.clone()
        for j in range(jmaxu):
            hay, valid = column(j)
            occ_np = fz
            hit0 = occ_last = None
            for k in range(n):
                occ_k = valid & ((hay == orig_k(k)) | (hay == flip_k(k)))
                occ_np = occ_np | ((np_ == k) & occ_k)
                if k == 0:
                    hit0 = occ_k
                if k == n - 1:
                    occ_last = occ_k
            np2 = np_ + occ_np.to(torch.int32)
            track(hit0, occ_last & (np2 >= n), j)
            np_ = np2
        matched = np_ >= n
    elif run_pf:
        # minimal-position DP over T+1 deletion budgets
        g = [torch.full(shape, t, dtype=torch.int32, device=dev)
             for t in range(T + 1)]
        for j in range(jmaxu):
            hay, valid = column(j)
            hits = [fz] * (T + 1)
            hit_low, hit_tail = fz, fz
            for k in range(n):
                occ_k = valid & ((hay == orig_k(k)) | (hay == flip_k(k)))
                for t in range(T + 1):
                    hits[t] = hits[t] | ((g[t] == k) & occ_k)
                if k <= T:
                    hit_low = hit_low | occ_k
                if k >= n - 1 - T:
                    hit_tail = hit_tail | occ_k
            g = [g[t] + hits[t].to(torch.int32) for t in range(T + 1)]
            for t in range(1, T + 1):
                g[t] = torch.maximum(g[t], g[t - 1] + 1)
            track(hit_low, hit_tail, j)
        matched = g[T] >= n
    else:
        matched = torch.ones(shape, dtype=torch.bool, device=dev)
    if run_pf:
        wstart_raw = torch.where(matched & ffound, sbyte, 0)
        wend = torch.where(matched & efound, ebyte, nb)
    else:
        wstart_raw, wend = z, nb

    # ---- pass 2: windowed affine-gap SW (bonus schedule) ----------------
    wstart = torch.clamp(wstart_raw - 1, min=0)
    include_exact = (wstart == 0) & (wend == nb)
    include_prefix = wstart == 0
    sw_bound = min(int(torch.where(matched, wend, 0).max()), jmaxu)
    h = [z] * n
    mm_bits, pctx, seen_first, best, end_b = z, z, z, z, z
    for j in range(sw_bound):
        hay, valid = column(j)
        first = torch.where(valid, hay, 0)
        active = valid & (j >= wstart) & (j + 1 <= wend)
        is_first = active & (seen_first == 0)
        seen_first = seen_first | active.to(torch.int32)
        cap_mask = _is_upper(first) & ((pctx & 1) > 0) & ~is_first
        delim_mask = ((pctx & 2) > 0) & ~_is_delim(first) & ~is_first
        bonus = (
            torch.where(cap_mask, cap_b, 0)
            + torch.where(delim_mask, delim_b, 0)
            + torch.where(is_first & include_prefix, prefix_b, 0)
        )
        pctx = torch.where(
            valid,
            _is_lower(first).to(torch.int32)
            | (_is_delim(first).to(torch.int32) << 1),
            0,
        )
        diag_in, up_src, mm_prev = z, z, fz
        h_new, mm_new = [], z
        for k in range(n):
            occ = active & ((hay == orig_k(k)) | (hay == flip_k(k)))
            hit = (
                match_score + bonus
                + torch.where(active & (hay == orig_k(k)), case_b, 0)
            )
            left = h[k] - gap_ext
            if gop_extra:
                left = left - torch.where(
                    ((mm_bits >> k) & 1) > 0, gop_extra, 0
                )
            if k == 0:
                cur = torch.maximum(torch.where(occ, hit, 0), left)
            else:
                diag = torch.where(
                    occ, diag_in + hit, torch.clamp(diag_in - mismatch, min=0)
                )
                up = up_src - gap_ext
                if gop_extra:
                    up = up - torch.where(mm_prev, gop_extra, 0)
                up = torch.clamp(up, min=0)
                cur = torch.maximum(torch.maximum(diag, up), left)
            diag_in, up_src, mm_prev = h[k], cur, occ
            h_new.append(cur)
            mm_new = mm_new | (occ.to(torch.int32) << k)
            if k == n - 1:
                masked = torch.where(active, cur, 0)
                end_b = torch.where(masked > best, j, end_b)
                best = torch.maximum(best, masked)
        h, mm_bits = h_new, mm_new

    # exact: haystack unit j vs needle unit j, case-sensitive
    neq = fz
    for j in range(min(n, W)):
        hay, _valid = column(j)
        neq = neq | (hay != orig_k(j))
    score = torch.clamp(best, min=0)
    end_col = torch.where(score > 0, end_b, wstart)
    exact = include_exact & (nu == n)[None, :] & ~neq
    score = torch.where(exact, torch.clamp(score + exact_b, max=0xFFFF), score)
    score = torch.where(matched, score, 0)
    exact = exact & matched
    end_col = torch.where(matched, end_col, 0)
    greedy = matched & ((wend - wstart) > MAX_HAYSTACK_LEN)
    cols = (matched.to(torch.int32), score.to(torch.int32),
            exact.to(torch.int32), end_col.to(torch.int32),
            greedy.to(torch.int32))

    alive = _alive_rows(scalars, flags, nG)
    if idxT is not None:
        keys = pack_keys(*cols, idxT.reshape(1, -1), idx_bits)
        return torch.where(alive, keys, torch.full_like(keys, INT64_MAX))
    return tuple(torch.where(alive, c, 0) for c in cols)


def match_units_colstream(
    cpT, nuT, scalars, flags=None, idxT=None, *, W: int, n: int,
    max_typos: int = 0, scoring: Tuple[int, ...], no_prefilter: bool = False,
    idx_bits: int = 0,
):
    """Fused ASCII fuzzy match over nG groups of 1024 rows for Q queries
    in one launch (grid = groups x queries). Arguments and results as
    :func:`match_units_colstream_plain`.

    ``flags`` (Q, nG) carries the per-group stage-1 alive bits: a dead
    group holds no stage-1 survivor, so the kernel writes zeros (or
    INT64_MAX keys) without running the DP. Key-emit mode (``idxT``
    given) writes the serving sort key directly: ascending order is
    (matched first, score desc, index asc)."""
    kw = dict(W=W, n=n, max_typos=max_typos, scoring=scoring,
              no_prefilter=no_prefilter, idx_bits=idx_bits)
    if cpT.device.type == "cpu":
        return match_units_colstream_plain(cpT, nuT, scalars, flags, idxT,
                                           **kw)
    if cpT.device.type != "cuda":
        raise ValueError(f"unsupported device {cpT.device}")
    T = min(int(max_typos), n)
    if not colstream_supported(n, T, no_prefilter):
        raise ValueError(f"needle length {n} / typo budget {T} out of range")
    nG = cpT.shape[0] // W
    Q = scalars.shape[0]
    total = nG * GROUP_ROWS
    for name, t, dt, shp in (
        ("cpT", cpT, torch.int8, (nG * W, 8, 128)),
        ("nuT", nuT, torch.int32, (nG * 8, 128)),
        ("scalars", scalars, torch.int32, (Q, 2 + 2 * MAX_KERNEL_NEEDLE)),
        ("flags", flags, torch.int32, (Q, nG)),
        ("idxT", idxT, torch.int32, (total,)),
    ):
        if t is None:
            continue
        if (t.device != cpT.device or t.dtype != dt
                or tuple(t.shape) != shp or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dt} {shp} on {cpT.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if no_prefilter or n <= T:
        pf_mode = _PF_NONE
    elif T == 0:
        pf_mode = _PF_GREEDY
    else:
        pf_mode = _PF_DP
    keys = cols = None
    if idxT is not None:
        keys = torch.empty((Q, total), dtype=torch.int64, device=cpT.device)
    else:
        cols = torch.empty((5, Q, total), dtype=torch.int32,
                           device=cpT.device)
    sc = (ctypes.c_int * 9)(*(int(s) for s in scoring))
    with torch.cuda.device(cpT.device):
        rc = _build.entry("colstream_fuzzy")(
            _ptr(cpT), _ptr(nuT), _ptr(scalars), _ptr(flags), _ptr(idxT),
            Q, nG, W, n, T, pf_mode, ctypes.cast(sc, ctypes.c_void_p),
            idx_bits, _ptr(keys), _ptr(cols), _stream(cpT),
        )
    if rc != 0:
        raise RuntimeError(f"colstream_fuzzy launch failed: CUDA error {rc}")
    LAUNCHES["colstream_fuzzy"] += 1
    return keys if keys is not None else tuple(cols)


def row_gather_plain(data: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`: advanced indexing."""
    return data[rows.to(torch.int64)]


def row_gather(data: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[i, :] = data[rows[i], :] for a contiguous (R, C) matrix of
    4-byte words, C a multiple of 128, rows (M,) int32 in [0, R).

    Serves the capped finalize (1024-row groups of int64 keys viewed as
    2048 int32 words) and the broad tournament (128-key blocks viewed as
    256 words). The kernel does not check the row ids: an id outside
    [0, R) is the caller's error."""
    if data.device.type == "cpu":
        return row_gather_plain(data, rows)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if (data.dim() != 2 or data.element_size() != 4
            or data.shape[1] % 128 or not data.is_contiguous()
            or data.data_ptr() % 16):
        raise ValueError(
            "row_gather wants a contiguous, 16-byte aligned (R, C) matrix "
            f"of 4-byte words with C % 128 == 0; got {data.dtype} "
            f"{tuple(data.shape)}"
        )
    if (rows.device != data.device or rows.dtype != torch.int32
            or rows.dim() != 1 or not rows.is_contiguous()):
        raise ValueError("row_gather wants contiguous int32 rows (M,) "
                         "on the data's device")
    C = data.shape[1]
    M = rows.shape[0]
    out = torch.empty((M, C), dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        rc = _build.entry("row_gather")(
            _ptr(data), _ptr(rows), _ptr(out), C, M, _stream(data),
        )
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: CUDA error {rc}")
    LAUNCHES["row_gather"] += 1
    return out
