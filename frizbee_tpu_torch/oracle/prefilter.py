"""Prefilter oracle: typo-tolerant ordered subsequence test + trim window.

Semantics (reference: src/prefilter/mod.rs:1-13): accepts iff the needle,
after deleting at most ``max_typos`` units, is an ordered subsequence of the
haystack (case-insensitive per unit). Equivalently
``LCS(needle, haystack) + max_typos >= needle_len`` — the reference's own
test oracle (src/prefilter/mod.rs:1013-1047).

Instead of the reference's multi-path greedy scan
(src/prefilter/algo/ascii_typos.rs), this computes the exact minimal-position
DP ``f[k][t]`` = minimal haystack units consumed to match the first ``k``
needle units with <= ``t`` deletions, which decides the same predicate and
vectorizes cleanly over a batch.

Window semantics (canonical, lane-independent — see oracle/__init__.py):
 - 0 typos: start = first greedy hit of needle[0]; end = one past the last
   occurrence of the final needle unit at-or-after the greedy completion
   (reference: src/prefilter/algo/ascii.rs:30-46 with LANES -> infinity).
 - T>0 typos: start = min first-occurrence among needle[0..=T]; end = one
   past the last occurrence of any of the last T+1 needle units, or len if
   none (reference: src/prefilter/algo/ascii_typos.rs:363-397 exactly).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .tokenize import HayUnits, NeedleUnits

INF = 1 << 30


def _occ(hay: HayUnits, j: int, needle: NeedleUnits, k: int) -> bool:
    return hay.cp[j] == needle.orig[k] or hay.cp[j] == needle.flip[k]


def prefilter_window(
    needle: NeedleUnits,
    hay: HayUnits,
    total_bytes: int,
    max_typos: int,
) -> Tuple[bool, int, int]:
    """Returns (matched, start_byte, end_byte)."""
    n = len(needle.orig)
    m = len(hay.cp)

    if max_typos == 0:
        if m == 0:
            return (False, 0, 0)
        # Greedy leftmost embedding
        pos = -1
        first_pos = None
        for k in range(n):
            nxt = None
            for j in range(pos + 1, m):
                if _occ(hay, j, needle, k):
                    nxt = j
                    break
            if nxt is None:
                return (False, 0, total_bytes)
            if first_pos is None:
                first_pos = nxt
            pos = nxt
        if n == 0:
            return (True, 0, total_bytes)
        # end: last occurrence of the final needle unit at or after the
        # greedy completion position
        end_unit = pos
        for j in range(m - 1, pos - 1, -1):
            if _occ(hay, j, needle, n - 1):
                end_unit = j
                break
        start_byte = hay.byte_off[first_pos]
        end_byte = hay.byte_off[end_unit] + hay.byte_len[end_unit]
        return (True, start_byte, end_byte)

    # Typo paths: a needle no longer than the budget always matches
    # (reference: ascii_typos.rs:17-21, 118-122, 263-267 — checked before the
    # empty-haystack gate)
    if n <= max_typos:
        return (True, 0, total_bytes)
    if m == 0:
        return (False, 0, 0)

    # Exact minimal-position DP
    t_budget = max_typos
    # f[t] after consuming k needle units; f[t] = minimal hay position (exclusive)
    f = [0] * (t_budget + 1)
    for k in range(n):
        nf = [INF] * (t_budget + 1)
        for t in range(t_budget + 1):
            base = f[t]
            if base < INF:
                nxt = None
                for j in range(base, m):
                    if _occ(hay, j, needle, k):
                        nxt = j + 1
                        break
                if nxt is not None:
                    nf[t] = nxt
            if t > 0:
                nf[t] = min(nf[t], f[t - 1])  # delete needle unit k
        f = nf
    matched = f[t_budget] < INF

    if not matched:
        return (False, 0, total_bytes)

    # start: min first occurrence among needle[0..=T]
    start_byte = 0
    best = None
    for k in range(min(t_budget + 1, n)):
        for j in range(m):
            if _occ(hay, j, needle, k):
                if best is None or j < best:
                    best = j
                break
    if best is not None:
        start_byte = hay.byte_off[best]

    # end: last occurrence of any of the last T+1 needle units
    end_byte = total_bytes
    first_tail = n - 1 - t_budget
    for j in range(m - 1, -1, -1):
        if any(_occ(hay, j, needle, k) for k in range(first_tail, n)):
            end_byte = hay.byte_off[j] + hay.byte_len[j]
            break
    return (True, start_byte, end_byte)


def lcs_accepts(needle: NeedleUnits, hay: HayUnits, max_typos: int) -> bool:
    """LCS-based acceptance oracle (reference: src/prefilter/mod.rs:1013-1047)."""
    n = len(needle.orig)
    m = len(hay.cp)
    if n == 0:
        return True
    prev = [0] * (m + 1)
    for k in range(1, n + 1):
        cur = [0] * (m + 1)
        for j in range(1, m + 1):
            if _occ(hay, j - 1, needle, k - 1):
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[m] + max_typos >= n
