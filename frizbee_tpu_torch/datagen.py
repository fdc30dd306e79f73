"""Synthetic benchmark corpus generator.

Replicates the semantics of the reference's bench generator
(reference: benches/match_list/generate.rs): each haystack is None / Partial
/ Full matching with configured probabilities, lengths drawn from a normal
distribution, filler characters are alphanumerics that never appear in the
needle (case-insensitively), Partial rows splice a random order-preserving
subset of needle characters into the filler, Full rows contain the whole
needle in order. The RNG differs (NumPy PCG64 vs rust StdRng) so outputs are
not byte-identical, but the statistical profile — which is what the
benchmarks measure — is the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

_ALPHANUMERIC = np.array(
    [ord(c) for c in
     "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"],
    dtype=np.uint8,
)


@dataclass
class HaystackGenerationOptions:
    seed: int = 42
    partial_match_percentage: float = 0.0
    match_percentage: float = 0.0
    median_length: int = 16
    std_dev_length: int = 4
    num_samples: int = 100_000


def generate_haystack(needle: str, options: HaystackGenerationOptions) -> List[str]:
    rng = np.random.default_rng(options.seed)
    n = options.num_samples
    needle_l = needle.lower()

    filler_pool = np.array(
        [b for b in _ALPHANUMERIC if chr(b).lower() not in needle_l],
        dtype=np.uint8,
    )
    needle_arr = np.frombuffer(needle.encode("utf-8"), dtype=np.uint8)

    lengths = np.maximum(
        np.abs(np.round(rng.normal(options.median_length,
                                   options.std_dev_length, n))), 1
    ).astype(np.int64)
    r = rng.random(n)
    is_partial = r < options.partial_match_percentage
    is_full = (~is_partial) & (
        r < options.partial_match_percentage + options.match_percentage
    )

    # Bulk filler bytes for everything; rows are carved out of one stream
    total = int(lengths.sum())
    filler_flat = rng.choice(filler_pool, size=total)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offs[1:])

    out: List[str] = []
    nl = len(needle_arr)
    for i in range(n):
        length = int(lengths[i])
        row = filler_flat[offs[i]:offs[i + 1]]
        if is_full[i]:
            # whole needle in order, extra filler joined randomly
            extra = row[: max(length - nl, 0)]
            row = _join_randomly(needle_arr, extra, rng)
        elif is_partial[i]:
            # random order-preserving subset of needle chars, spliced in
            match_count = int(rng.integers(0, min(length, nl))) if min(
                length, nl
            ) > 0 else 0
            idx = np.sort(rng.permutation(nl)[:match_count])
            row = _join_randomly(needle_arr[idx], row[: length - match_count],
                                 rng)
        out.append(row.tobytes().decode("ascii"))
    return out


def _join_randomly(a: np.ndarray, b: np.ndarray, rng) -> np.ndarray:
    """Random interleave preserving the relative order of both inputs
    (reference: benches/match_list/generate.rs join_randomly)."""
    la, lb = len(a), len(b)
    if la == 0:
        return b
    if lb == 0:
        return a
    take_a = np.zeros(la + lb, dtype=bool)
    take_a[rng.permutation(la + lb)[:la]] = True
    out = np.empty(la + lb, dtype=a.dtype)
    out[take_a] = a
    out[~take_a] = b
    return out


def partial_match_corpus(median_length: int = 64,
                         num_samples: int = 100_000,
                         seed: int = 42) -> List[str]:
    """The reference's 'Partial Match' dataset: 5% full, 20% partial
    (reference: BENCHMARKS.md:107-118)."""
    return generate_haystack(
        "deadbeef",
        HaystackGenerationOptions(
            seed=seed,
            partial_match_percentage=0.20,
            match_percentage=0.05,
            median_length=median_length,
            std_dev_length=median_length // 4,
            num_samples=num_samples,
        ),
    )


def all_match_corpus(median_length: int = 64,
                     num_samples: int = 100_000,
                     seed: int = 42) -> List[str]:
    """The reference's 'All Match' dataset (reference: BENCHMARKS.md:127-137)."""
    return generate_haystack(
        "deadbeef",
        HaystackGenerationOptions(
            seed=seed,
            partial_match_percentage=0.0,
            match_percentage=1.0,
            median_length=median_length,
            std_dev_length=median_length // 4,
            num_samples=num_samples,
        ),
    )


def xl_heavy_corpus(median_length: int = 2048,
                    num_samples: int = 100_000,
                    seed: int = 42) -> List[str]:
    """Rows longer than the widest device bucket (1024 units), 5% full +
    20% partial matches: the long-context shape where every row takes the
    batched host pipeline (greedy windows beyond the DP cap, XL rows) —
    no reference dataset covers it (its greedy fallback is unbenchmarked,
    src/smith_waterman/greedy.rs)."""
    return generate_haystack(
        "deadbeef",
        HaystackGenerationOptions(
            seed=seed,
            partial_match_percentage=0.20,
            match_percentage=0.05,
            median_length=median_length,
            std_dev_length=median_length // 4,
            num_samples=num_samples,
        ),
    )


_SCRIPT_RANGES = {
    # (codepoint ranges, space probability) — synthetic analogs of the
    # reference's Arabic/Korean sentence datasets (BENCHMARKS.md:67-105):
    # ~40-45 byte sentences of multi-byte script text with ASCII spaces
    "arabic": ((0x0621, 0x064A),),
    "korean": ((0xAC00, 0xD7A3),),
    "greek": ((0x03B1, 0x03C9),),
}


# Per-script calibration to the reference's published dataset stats
# (reference BENCHMARKS.md:67-104; the real sentence corpora are not
# redistributable): (num_samples, median_units, needle_every,
# partial_rate) chosen so match% / partial% / median byte length land on
# the published values — verified by benchmarks/calibrate_datasets.py.
#   arabic: 285,587 rows, match 7.93%, partial 59.5%, median 37 B
#   korean: 281,471 rows, match 8.42%, partial 40.7%, median 36 B
_SCRIPT_CALIBRATION = {
    "arabic": dict(num_samples=285_587, median_units=20,
                   needle_every=13, partial_rate=0.645),
    "korean": dict(num_samples=281_471, median_units=13,
                   needle_every=12, partial_rate=0.444),
}


def unicode_corpus(script: str = "arabic",
                   num_samples: int = None,
                   median_units: int = None,
                   needle_every: int = None,
                   needle: str = "",
                   partial_rate: float = None,
                   seed: int = 42) -> List[str]:
    """Synthetic unicode sentence corpus calibrated to the reference's
    published dataset statistics (see _SCRIPT_CALIBRATION). The needle's
    codepoints are EXCLUDED from the random draw, so the match and
    partial rates are exact knobs: every ``needle_every``-th row embeds
    the full needle in order (a match); ``partial_rate`` of the others
    get ONE needle codepoint (a partial: trips char-presence prefilters
    without matching)."""
    cal = _SCRIPT_CALIBRATION.get(script, {})
    num_samples = num_samples or cal.get("num_samples", 280_000)
    median_units = median_units or cal.get("median_units", 20)
    needle_every = needle_every or cal.get("needle_every", 50)
    if partial_rate is None:
        partial_rate = cal.get("partial_rate", 0.0)
    rng = np.random.default_rng(seed)
    lo, hi = _SCRIPT_RANGES[script][0]
    lengths = np.maximum(
        np.abs(np.round(rng.normal(median_units, median_units // 4,
                                   num_samples))), 2
    ).astype(np.int64)
    out: List[str] = []
    needle_arr = np.array([ord(c) for c in needle], dtype=np.uint32)
    needle_set = set(int(c) for c in needle_arr)
    partial_mask = rng.random(num_samples) < partial_rate
    for i in range(num_samples):
        n = int(lengths[i])
        cps = rng.integers(lo, hi + 1, size=n, dtype=np.uint32)
        if needle_set:
            # redraw until no needle codepoint appears naturally (rates
            # stay exact knobs; blocks are >=255 wide so this converges
            # immediately)
            bad = np.isin(cps, list(needle_set))
            while bad.any():
                cps[bad] = rng.integers(
                    lo, hi + 1, size=int(bad.sum()), dtype=np.uint32
                )
                bad = np.isin(cps, list(needle_set))
        spaces = rng.random(n) < 0.15
        cps = np.where(spaces, np.uint32(0x20), cps)
        if needle and i % needle_every == 0 and n >= len(needle_arr):
            idx = np.sort(rng.permutation(n)[: len(needle_arr)])
            cps[idx] = needle_arr
        elif needle and partial_mask[i]:
            cps[rng.integers(0, n)] = needle_arr[
                rng.integers(0, len(needle_arr))
            ]
        out.append("".join(map(chr, cps)))
    return out


_PATH_SEGMENTS = [
    "src", "chrome", "browser", "content", "components", "third_party",
    "ui", "gfx", "net", "base", "build", "cc", "media", "gpu", "ipc",
    "mojo", "services", "extensions", "devtools", "renderer", "views",
    "ash", "blink", "v8", "skia", "webrtc", "linux", "win", "mac",
    "android", "test", "tests", "public", "common", "internal", "core",
    "impl", "api", "util", "tools", "sandbox", "policy", "accessibility",
]
_FILE_STEMS = [
    "main", "browser_window", "render_frame_host", "tab_strip_model",
    "navigation_controller", "web_contents", "profile_manager",
    "bookmark_model", "history_service", "download_item", "pref_service",
    "layout_manager", "view_controller", "event_handler", "task_runner",
    "message_loop", "thread_pool", "memory_allocator", "string_util",
    "file_path", "time_ticks", "callback_helpers", "weak_ptr", "observer",
]
_FILE_EXTS = [".cc", ".h", ".mm", ".py", ".js", ".ts", ".html", ".css",
              ".gn", ".json", ".md", ".xml", ".grd", ".mojom"]


def chromium_like_corpus(num_samples: int = 1_406_941,
                         seed: int = 42) -> List[str]:
    """Path-shaped corpus calibrated to the reference's Chromium
    benchmark profile (reference: benches/lib.rs:18-40,
    BENCHMARKS.md:50-58: 1,406,941 paths, median length 67,
    match_percentage 0.08 on needle "linux"). The actual file list isn't
    redistributable (the reference downloads it separately); this
    generator matches the published statistics that drive the
    benchmark's cost profile — measured at default params: median 65
    bytes, 7.9-8.3% of rows matching "linux" (6.1% carry a literal
    /linux/ segment, the rest match as cross-segment subsequences),
    prefilter-dominated like the real list. Calibration is re-checkable
    with benchmarks/calibrate_datasets.py."""
    rng = np.random.default_rng(seed)
    segs_vocab = [s for s in _PATH_SEGMENTS if s != "linux"]
    n_seg = rng.integers(3, 9, num_samples)
    segs = rng.choice(len(segs_vocab), size=int(n_seg.sum()))
    s1 = rng.choice(len(_FILE_STEMS), size=num_samples)
    s2 = rng.choice(len(_FILE_STEMS), size=num_samples)
    exts = rng.choice(len(_FILE_EXTS), size=num_samples)
    inj = rng.random(num_samples) < 0.061
    inj_at = rng.integers(0, 1 << 30, num_samples)
    out: List[str] = []
    pos = 0
    for i in range(num_samples):
        k = int(n_seg[i])
        parts = [segs_vocab[s] for s in segs[pos:pos + k]]
        pos += k
        if inj[i]:
            parts.insert(int(inj_at[i]) % (len(parts) + 1), "linux")
        parts.append(
            _FILE_STEMS[s1[i]] + "_" + _FILE_STEMS[s2[i]] + _FILE_EXTS[exts[i]]
        )
        out.append("/".join(parts))
    return out


def no_match_corpus(median_length: int = 64,
                    num_samples: int = 100_000,
                    seed: int = 42,
                    partial: float = 0.0) -> List[str]:
    """The reference's 'No Match' datasets (reference: BENCHMARKS.md:147-185)."""
    return generate_haystack(
        "deadbeef",
        HaystackGenerationOptions(
            seed=seed,
            partial_match_percentage=partial,
            match_percentage=0.0,
            median_length=median_length,
            std_dev_length=median_length // 4,
            num_samples=num_samples,
        ),
    )
