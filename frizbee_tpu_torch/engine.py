"""Per-pattern engine state the batch serving path reads, and the host
pipelines that rescore the rows the device does not finish.

Counterpart of ``frizbee_tpu/engine.FuzzyEngine`` and ``LiteralEngine``:
unit tokenization, case and unicode resolution, the u16 overflow guards,
the host needle arrays the dispatcher stacks per batch, the batched host
pipelines (``match_many``, ``match_xl_rows`` over the corpus's encoded XL
blob, ``match_many_indices``; OpenMP C++ in ``native/packer.cpp``) that
score greedy-flagged rows (trimmed window over the 1024-byte DP cap) and
XL rows (wider than the widest bucket) with the oracle's semantics, the
per-row pipelines (``match_one``, ``match_one_indices``) that are their
differential twins (reached through ``native._FORCE_NUMPY``) and serve
single rows, and ``match_corpus``,
the per-pattern whole-corpus result the matcher combines when a query
does not take the fused device path (atoms of mixed unit modes). Its
device branch runs the generic bucket pipelines (``ops/fuzzy``,
``ops/literal``) over ``PackedBucket.device_arrays()`` on the corpus
device and rescores greedy rows and XL rows on the host; its host
branch (``use_device=False``) is the reference's oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .casefold import case_needle_bytes
from .config import MAX_HAYSTACK_LEN, U16_MAX, Config, sat_add_u16
from .oracle import (
    literal_find,
    make_needle_units,
    match_greedy,
    prefilter_window,
    sw_indices,
    tokenize,
)
from .oracle.literal import _needle_variants
from .oracle.smith_waterman import match_end_col, sw_matrices
from .ops.fuzzy import SCORING_FIELDS, fuzzy_match_bucket
from .ops.literal import literal_match_bucket
from .types import Match, MatchIndices


class MatchResult:
    """Column-oriented per-haystack results for one pattern over a corpus."""

    __slots__ = ("matched", "score", "exact", "end_col")

    def __init__(self, n: int):
        self.matched = np.zeros(n, dtype=bool)
        self.score = np.zeros(n, dtype=np.int64)
        self.exact = np.zeros(n, dtype=bool)
        self.end_col = np.zeros(n, dtype=np.int64)


class _NeedleEngine:
    """Needle units and the cached host arrays both engines share."""

    def __init__(self, needle: str, config: Config, use_device: bool = True):
        self.needle = needle
        self.config = config
        self.use_device = use_device
        self.case_sensitive = config.casing.respects_case_for(needle)
        self.unicode = config.unicode.respects_unicode_for(needle)
        self.needle_bytes = needle.encode("utf-8")
        self._guard_overflow()
        self.units = make_needle_units(needle, self.unicode, self.case_sensitive)
        self._host_args = None
        self._device_args = {}

    def _guard_overflow(self) -> None:
        raise NotImplementedError

    def _host_needle(self):
        """(orig (n,), flip (n,), scoring (9,)) int32 host arrays (cached):
        the batch dispatcher stacks them per group and ships one array."""
        if self._host_args is None:
            self._host_args = (
                np.array(self.units.orig, np.int32),
                np.array(self.units.flip, np.int32),
                np.array(
                    [getattr(self.config.scoring, f)
                     for f in SCORING_FIELDS], np.int32,
                ),
            )
        return self._host_args

    def _device_needle(self, device):
        """(orig (n,), flip (n,), scoring (9,)) int32 tensors on
        ``device`` (cached per device): :meth:`_host_needle` uploaded."""
        device = torch.device(device)
        if device not in self._device_args:
            self._device_args[device] = tuple(
                torch.from_numpy(a).to(device) for a in self._host_needle()
            )
        return self._device_args[device]

    def _scatter_rows(self, out: MatchResult, rows, res) -> None:
        """Write (matched, score, exact, end_col) of corpus rows ``rows``."""
        m, s, e, ec = res
        out.matched[rows] = m
        out.score[rows] = s
        out.exact[rows] = e
        out.end_col[rows] = ec

    def match_one(self, haystack: str, index: int) -> Optional[Match]:
        raise NotImplementedError

    def match_many(self, haystacks) -> tuple:
        """(matched, score, exact, end_col) arrays over a list of rows:
        the engine's native batch (:meth:`_native_many`), or one
        :meth:`match_one` a row for an empty needle or under the test
        hook ``native._FORCE_NUMPY`` (the differential oracle)."""
        if self.units.orig and haystacks and not native._FORCE_NUMPY:
            return self._native_many(haystacks)
        R = len(haystacks)
        matched = np.zeros(R, bool)
        score = np.zeros(R, np.int64)
        exact = np.zeros(R, bool)
        end_col = np.zeros(R, np.int64)
        for r, h in enumerate(haystacks):
            m = self.match_one(h, r)
            if m is not None:
                matched[r] = True
                score[r], exact[r], end_col[r] = m.score, m.exact, m.end_col
        return matched, score, exact, end_col

    def _native_many(self, haystacks) -> tuple:
        raise NotImplementedError


class FuzzyEngine(_NeedleEngine):
    """Fuzzy (Smith-Waterman) matching for one needle + resolved config."""

    def __init__(self, needle: str, config: Config, use_device: bool = True):
        super().__init__(needle, config, use_device)
        self.min_haystack_len = (
            max(len(needle) - config.max_typos, 0)
            if config.max_typos is not None
            else 0
        )

    def _guard_overflow(self) -> None:
        # Overflow guard uses the row count the needle actually uses
        # (reference: src/matcher/algo.rs:300-325)
        rows = len(self.needle) if self.unicode else len(self.needle_bytes)
        scoring = self.config.scoring
        scoring.guard_against_score_overflow(
            rows, scoring.max_per_char_bonus(), scoring.max_one_time_bonus()
        )

    def _window(self, data: bytes) -> Optional[Tuple[int, int]]:
        """(wstart, wend) byte bounds of the trimmed prefilter window of a
        row, or None when the prefilter rejects it."""
        if len(data) < self.min_haystack_len:
            return None
        if self.config.max_typos is None:
            return 0, len(data)
        hay = tokenize(data, self.unicode)
        matched, start, end = prefilter_window(
            self.units, hay, len(data), self.config.max_typos
        )
        return (max(start - 1, 0), end) if matched else None

    def _host_pipeline(
        self, haystack: str
    ) -> Optional[Tuple[int, bool, int, int, int, bool]]:
        """Prefilter window, then Smith-Waterman over it, or the greedy
        matcher past the DP cap. Returns (score, exact, end_col, wstart,
        wend, used_greedy) or None."""
        data = haystack.encode("utf-8")
        window = self._window(data)
        if window is None:
            return None
        wstart, end = window
        include_exact = wstart == 0 and end == len(data)
        include_prefix = wstart == 0
        scoring = self.config.scoring

        if end - wstart > MAX_HAYSTACK_LEN:
            res = match_greedy(
                self.needle_bytes,
                data[wstart:end],
                scoring,
                self.case_sensitive,
                include_prefix,
            )
            if res is None:
                return (0, False, min(wstart, U16_MAX), wstart, end, True)
            score, indices = res
            end_col = min(indices[-1] if indices else 0, U16_MAX)
            end_col = min(end_col + wstart, U16_MAX)
            exact = include_exact and data[wstart:end] == self.needle_bytes
            if exact:
                score = sat_add_u16(score, scoring.exact_match_bonus)
            return (score, exact, end_col, wstart, end, True)

        win = tokenize(data, self.unicode, wstart, end)
        H, _ = sw_matrices(self.units, win, scoring, include_prefix)
        score = max(H[-1]) if H[-1] else 0
        end_col = (
            min(match_end_col(H, win), U16_MAX)
            if score > 0
            else min(wstart, U16_MAX)
        )
        exact = include_exact and data[wstart:end] == self.needle_bytes
        if exact:
            score = min(score + scoring.exact_match_bonus, U16_MAX)
        return (score, exact, end_col, wstart, end, False)

    def match_corpus(self, corpus) -> MatchResult:
        """Every row's result for this pattern, in corpus order. The
        device branch runs the fuzzy pipeline over every bucket on the
        corpus device (:meth:`_match_buckets_device`), then the XL rows
        through the native host batch over the corpus's XL blob
        (:meth:`match_xl_rows`). The host branch runs the
        per-row oracle pipeline over every row, bucketed or XL (the
        reference's differential baseline)."""
        assert corpus.unicode == self.unicode, (
            "corpus packed for wrong unicode mode")
        out = MatchResult(len(corpus))
        if not self.units.orig:
            return out  # empty needles take the Matcher's copy path
        if self.use_device:
            self._match_buckets_device(corpus, out)
            xi = corpus.xl_indices
            if len(xi):
                res = self.match_xl_rows(corpus, np.arange(len(xi)))
                if res is None:
                    res = self.match_many(
                        [corpus.haystacks[int(i)] for i in xi])
                self._scatter_rows(out, xi, res)
            return out
        for i, h in enumerate(corpus.haystacks):
            self._host_row(h, i, out)
        return out

    def _match_buckets_device(self, corpus, out: MatchResult) -> None:
        """Per bucket, :func:`ops.fuzzy.fuzzy_match_bucket` over its
        ``device_arrays()``; rows flagged greedy (trimmed window over the
        DP cap) are rescored on the host with the batched
        :meth:`match_many`."""
        orig, flip, sc = self._device_needle(corpus.device)
        no_prefilter = self.config.max_typos is None
        typos = 0 if no_prefilter else int(self.config.max_typos)
        for bucket in corpus.buckets:
            res = fuzzy_match_bucket(
                *bucket.device_arrays()[:7], orig, flip, sc,
                max_typos=typos, no_prefilter=no_prefilter)
            matched, score, exact, end_col, greedy = (
                x.cpu().numpy() for x in res[:5])
            real = bucket.indices >= 0  # skip size-class padding rows
            idx = bucket.indices[real]
            self._scatter_rows(out, idx, (
                matched[real], score[real], exact[real],
                np.minimum(end_col[real], U16_MAX)))
            gr = np.nonzero(greedy & real)[0]
            if len(gr):
                gi = bucket.indices[gr]
                self._scatter_rows(out, gi, self.match_many(
                    [corpus.haystacks[int(i)] for i in gi]))

    def _host_row(self, haystack: str, index: int, out: MatchResult) -> None:
        res = self._host_pipeline(haystack)
        if res is None:
            out.matched[index] = False
            return
        score, exact, end_col, _, _, _ = res
        out.matched[index] = True
        out.score[index] = score
        out.exact[index] = exact
        out.end_col[index] = end_col

    def match_one(self, haystack: str, index: int) -> Optional[Match]:
        res = self._host_pipeline(haystack)
        if res is None:
            return None
        score, exact, end_col, _, _, _ = res
        return Match(score=score, index=index, exact=exact, end_col=end_col)

    def _native_many(self, haystacks) -> tuple:
        return self._native_batch(
            *native.encode_rows(haystacks, self.unicode), None)

    def match_many_indices(self, haystacks) -> Optional[list]:
        """The native batched score and traceback over rows: per row None
        (no match) or ``(score, exact, reversed matched byte offsets)``,
        the ``MatchIndices`` contract with the typo budget enforced by
        the walk. Returns None for an empty needle or row list, or under
        ``native._FORCE_NUMPY``; callers then keep the per-row
        :meth:`match_one_indices` oracle."""
        if not self.units.orig or not haystacks or native._FORCE_NUMPY:
            return None
        cap = max(4 * len(self.units.orig), len(self.needle_bytes), 1)
        m, s, e, _ec, idx, icnt = self._native_batch(
            *native.encode_rows(haystacks, self.unicode), None,
            indices_cap=cap)
        return [
            (int(s[r]), bool(e[r]), idx[r, : icnt[r]].tolist())
            if m[r] else None
            for r in range(len(haystacks))
        ]

    def match_xl_rows(self, corpus, positions) -> Optional[tuple]:
        """The native batch over the corpus's encoded XL rows
        (``corpus.xl_blob()``) at ``positions`` (indices into
        ``xl_indices``): (matched, score, exact, end_col) arrays. None for
        an empty needle, a unicode engine over a byte corpus's blob, or
        under ``native._FORCE_NUMPY``; callers then run
        :meth:`match_many` on the strings."""
        if not self.units.orig or native._FORCE_NUMPY:
            return None
        blob = corpus.xl_blob()
        if self.unicode and "joined_u32" not in blob:
            return None
        return self._native_batch(
            blob["joined"], blob["bstarts"],
            blob.get("joined_u32"), blob.get("ustarts"),
            np.asarray(positions, np.int64),
        )

    def _native_batch(self, joined, bstarts, joined_u32, ustarts, rows,
                      indices_cap=0):
        """``native.host_match_batch`` (byte units) or
        ``host_match_batch_u32`` (codepoint units) with this engine's
        needle, scoring and budget; score and end_col widened to int64."""
        orig, flip, scoring9 = self._host_needle()
        common = dict(
            scoring9=scoring9, max_typos=self.config.max_typos,
            dp_cap=MAX_HAYSTACK_LEN, min_len=self.min_haystack_len,
            needle_bytes=self.needle_bytes, rows=rows,
            indices_cap=indices_cap,
        )
        if self.unicode:
            pairs = case_needle_bytes(self.needle_bytes, self.case_sensitive)
            res = native.host_match_batch_u32(
                joined, bstarts, joined_u32, ustarts, orig, flip,
                np.array([o for o, _ in pairs], np.int32),
                np.array([f for _, f in pairs], np.int32), **common)
        else:
            res = native.host_match_batch(joined, bstarts, orig, flip,
                                          **common)
        m, s, e, ec = res[:4]
        return (m, s.astype(np.int64), e, ec.astype(np.int64)) + res[4:]

    def match_one_indices(self, haystack: str,
                          index: int) -> Optional[MatchIndices]:
        """Score + traceback indices (reference:
        src/matcher/algo.rs:196-296): the prefilter window, then the
        Smith-Waterman traceback over it, or the greedy matcher past the
        DP cap."""
        data = haystack.encode("utf-8")
        window = self._window(data)
        if window is None:
            return None
        wstart, end = window
        include_exact = wstart == 0 and end == len(data)
        include_prefix = wstart == 0
        scoring = self.config.scoring

        if end - wstart > MAX_HAYSTACK_LEN:
            res = match_greedy(
                self.needle_bytes,
                data[wstart:end],
                scoring,
                self.case_sensitive,
                include_prefix,
            )
            if res is None:
                return MatchIndices(score=0, index=index, exact=False,
                                    indices=[])
            score, fwd = res
            indices = [i + wstart for i in reversed(fwd)]
        else:
            win = tokenize(data, self.unicode, wstart, end)
            score, indices = sw_indices(
                self.units,
                win,
                scoring,
                include_prefix,
                self.config.max_typos,
                haystack_start_pos=0,  # byte_off is already absolute
            )
        exact = include_exact and data[wstart:end] == self.needle_bytes
        if exact:
            score = min(score + scoring.exact_match_bonus, U16_MAX)
        return MatchIndices(score=score, index=index, exact=exact,
                            indices=indices)


class LiteralEngine(_NeedleEngine):
    """Literal matching modes; max_typos is ignored
    (reference: src/literal/mod.rs:1-8)."""

    min_haystack_len = 0

    def _guard_overflow(self) -> None:
        # Literal overflow guard (reference: src/literal/algo.rs:316-325)
        s = self.config.scoring
        max_bonus = min(
            max(s.capitalization_bonus, s.delimiter_bonus)
            + s.matching_case_bonus,
            U16_MAX,
        )
        s.guard_against_score_overflow(len(self.needle_bytes), max_bonus, 0)

    def match_one(self, haystack: str, index: int) -> Optional[Match]:
        data = haystack.encode("utf-8")
        res = literal_find(
            self.needle,
            data,
            self.config.matching,
            self.unicode,
            self.case_sensitive,
            self.config.scoring,
        )
        if res is None:
            return None
        pos, score = res
        exact = pos == 0 and len(self.needle_bytes) == len(data)
        end_col = min(max(pos + len(self.needle_bytes) - 1, 0), U16_MAX)
        return Match(score=score, index=index, exact=exact, end_col=end_col)

    def match_one_indices(self, haystack: str,
                          index: int) -> Optional[MatchIndices]:
        """The match and the needle's byte span at it, in reverse."""
        m = self.match_one(haystack, index)
        if m is None:
            return None
        pos = m.end_col - len(self.needle_bytes) + 1
        indices = list(range(pos + len(self.needle_bytes) - 1, pos - 1, -1))
        return MatchIndices(
            score=m.score, index=index, exact=m.exact, indices=indices
        )

    def _unit_pairs(self):
        """Per-unit (orig, flip) byte strings (cached): the oracle's
        ``_needle_variants``, shared with the native batch."""
        if getattr(self, "_pairs", None) is None:
            self._pairs = _needle_variants(
                self.needle, self.unicode, self.case_sensitive)
        return self._pairs

    def _literal_batch(self, joined, starts, rows=None) -> tuple:
        """``native.host_literal_batch`` over ragged UTF-8 rows (literal
        units are byte sequences, so one blob serves byte and codepoint
        needles alike), decoded to (matched, score, exact, end_col)."""
        matched, score, pos = native.host_literal_batch(
            joined, starts, self._unit_pairs(), self.config.matching.value,
            self._host_needle()[2], len(self.needle_bytes), rows=rows)
        starts = np.asarray(starts, np.int64)
        sel = np.arange(len(starts) - 1) if rows is None else rows
        lens = starts[sel + 1] - starts[sel]
        nb = len(self.needle_bytes)
        exact = matched & (pos == 0) & (lens == nb)
        end_col = np.minimum(
            np.maximum(pos.astype(np.int64) + nb - 1, 0), U16_MAX)
        return (matched, score.astype(np.int64), exact,
                np.where(matched, end_col, 0))

    def _native_many(self, haystacks) -> tuple:
        return self._literal_batch(
            *native.encode_rows(haystacks, unicode=False)[:2])

    def match_xl_rows(self, corpus, positions) -> Optional[tuple]:
        """The native literal batch over the corpus's encoded XL rows
        (``corpus.xl_blob()``) at ``positions`` (indices into
        ``xl_indices``). None for an empty needle or under
        ``native._FORCE_NUMPY``; callers then run :meth:`match_many` on
        the strings."""
        if not self.units.orig or native._FORCE_NUMPY:
            return None
        blob = corpus.xl_blob()
        return self._literal_batch(blob["joined"], blob["bstarts"],
                                   np.asarray(positions, np.int64))

    def match_corpus(self, corpus) -> MatchResult:
        """Every row's result for this pattern, in corpus order. The
        device branch (a corpus packed in this engine's unit mode) runs
        :func:`ops.literal.literal_match_bucket` over every bucket's
        ``device_arrays()`` on the corpus device, then the XL rows on the
        host; the host branch (``use_device=False``, or a corpus packed
        in the other unit mode: literal units are byte sequences either
        way) runs the batched host literal matcher (:meth:`match_many`)
        over every row."""
        out = MatchResult(len(corpus))
        if not self.units.orig:
            return out
        if self.use_device and corpus.unicode == self.unicode:
            orig, flip, sc = self._device_needle(corpus.device)
            scoring = tuple(
                int(getattr(self.config.scoring, f)) for f in SCORING_FIELDS
            )
            for bucket in corpus.buckets:
                res = literal_match_bucket(
                    *bucket.device_arrays()[:7], orig, flip, sc,
                    mode=self.config.matching.value,
                    needle_byte_len=len(self.needle_bytes), scoring=scoring)
                m, s, e, ec = (x.cpu().numpy() for x in res[:4])
                real = bucket.indices >= 0  # skip size-class padding rows
                self._scatter_rows(out, bucket.indices[real], (
                    m[real], s[real], (e & m)[real], ec[real]))
            rows = corpus.xl_indices
        else:
            rows = np.arange(len(corpus.haystacks))
        rows = np.asarray(rows, np.int64)
        if len(rows):
            m, s, e, ec = self.match_many(
                [corpus.haystacks[int(i)] for i in rows])
            self._scatter_rows(out, rows, (
                m, np.where(m, s, 0), e & m, np.where(m, ec, 0)))
        return out


def make_engine(needle: str, config: Config, use_device: bool = True):
    if config.matching.is_fuzzy:
        return FuzzyEngine(needle, config, use_device)
    return LiteralEngine(needle, config, use_device)
