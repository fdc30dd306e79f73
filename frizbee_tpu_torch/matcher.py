"""The Matcher API: single-query matching and batched top-k serving.

Counterpart of ``frizbee_tpu/matcher.py``. A ``Matcher`` compiles one
query (one pattern, or several atoms, some negated) once and matches it
against many corpora:

- ``match_arrays`` / ``match_list`` / ``match_one`` / ``match_iter`` /
  ``match_list_parallel`` and the one-shot ``match_list``,
  ``match_list_parallel`` and ``fuzzy_match``; with matched-character
  indices, ``match_list_indices`` / ``match_one_indices`` /
  ``match_iter_indices`` and the one-shot ``match_list_indices`` and
  ``fuzzy_match_indices``, which take the match set from
  ``match_arrays`` and run the traceback on the host (``traceback.py``,
  or the per-row oracle). A query the fused device
  path serves runs the batched program at Q=1 (``_fused_dispatch``) over
  a tiered result window of ``max(Q1_WINDOW_MIN, N/8)`` rows, ships only
  the count and the first ``fetch_rows`` rows to the host, and
  re-dispatches once with the whole corpus as its window when the count
  overflows the tier. Empty queries take the copy path; a needle whose
  unit mode differs from the corpus is repacked on the corpus device.
- ``match_topk_batch`` / ``match_topk_batch_async`` /
  ``match_arrays_batch``: shape-uniform queries group into one batched
  device pass each (``ops/batch.fused_match_sorted_batch``), and the
  ``(Q, 1+k, 2)`` results decode on the host. Queries a group cannot
  take (empty, of mixed unit modes, or of a unit mode other than the
  corpus's) and greedy-risk overflow go through the per-query path.

The fused device path routes each query as the reference's does
(``ops/batch.fused_match_sorted_batch``). Under a score sort over
corpora of bucket width <= 1024, with needles of up to 64 units and
typo budgets of up to 8 (``use_kernel``): a single fuzzy needle takes
the column-stream kernel (up to 16 units, budgets up to 3) or the
row-major kernel, a single literal needle the column-stream literal
kernel (up to 16 units) or the literal pipeline, and several atoms,
negated ones among them (``foo !^bar``), the column-stream kernels when
every atom fits them. The rest — index sorts, longer atoms in a multi
query, longer needles, larger budgets and custom bucket widths — take
the generic body: fuzzy atoms through ``kernels.fuzzy_match_units``
(the row-major kernel) where ``use_kernel`` holds, else the plain
PyTorch fuzzy and literal pipelines over ``PackedBucket.device_arrays``.
Atoms of mixed unit modes combine the engines' per-pattern device
``match_corpus`` results. Greedy-flagged rows (trimmed window over the
1024-byte DP cap) and XL rows (wider than the widest bucket) are
rescored on the host with the oracle's pipelines, as the reference
does. ``use_device=False`` is the reference's host oracle.
"""

from __future__ import annotations

import itertools
import weakref
from itertools import islice
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import U16_MAX, Config, SortStrategy, sat_add_u16
from .corpus import GROUP_ROWS, Corpus, pack_corpus
from .engine import MatchResult, make_engine
from .ops.batch import (
    _pattern_s1_contributes,
    colstream_eligible_all,
    fused_match_sorted,
    fused_match_sorted_batch,
    uses_colstream,
)
from .ops.colstream import FUZZY_MODE
from .ops.fuzzy import SCORING_FIELDS
from .ops.kernels import MAX_KERNEL_NEEDLE, MAX_KERNEL_TYPOS
from .pattern import Pattern
from .profiling import annotate
from .sort import (
    k_merge_matches_by_index_asc,
    k_merge_matches_by_index_desc,
    k_merge_matches_by_score_then_index_asc,
    k_merge_matches_by_score_then_index_desc,
)
from .types import Match, MatchIndices, MatchList, build_matches

PatternLike = Union[str, Pattern]

# Tiered Q=1 result-window floor (rows): the single-query path serves
# max(this, N/8) result rows and re-dispatches with the full window on
# count overflow (Matcher._fused_dispatch). Module-level so tests can
# take the overflow path on small corpora.
Q1_WINDOW_MIN = 65536

# Mixed-finalize group-count gate: below this many groups the capped +
# full split is not worth its extra work (module constant so tests can
# force the split on small corpora)
MIXED_FINALIZE_MIN_GROUPS = 512

# Batched serving's counts (host integer adds, as ops/batch.py's route
# dicts): batches and their queries, device passes (one a shape group),
# the (group, query) pairs the finalize-cap chooser found alive among all
# it counted (every pair is alive where no pattern's stage 1 narrows the
# groups), and queries the per-query path served instead of a batch
SERVING_COUNTS = {"batches": 0, "queries": 0, "groups": 0,
                  "alive_pairs": 0, "cap_pairs": 0, "fallback_queries": 0}

# serial numbers of match_topk_batch_async's batches, carried by each of
# a batch's spans (profiling.annotate)
_BATCH_SERIALS = itertools.count(1)


class _CompiledPattern:
    __slots__ = ("negated", "needle", "config", "engine")

    def __init__(self, source: Pattern, config: Config, use_device: bool):
        resolved = source.config.resolve(config)
        self.negated = source.negated
        self.needle = source.needle
        self.config = resolved
        self.engine = make_engine(source.needle, resolved, use_device)


def _as_pattern(p: PatternLike) -> Pattern:
    if isinstance(p, Pattern):
        return p
    return Pattern.literal(str(p))


class Matcher:
    """Compile once, match many (reference: src/matcher/mod.rs:80-111).

    ``use_device=False`` selects the host oracle engines (the reference's
    differential baseline; identical semantics). ``device`` is where
    string haystacks are packed: None means the card (and raises where
    there is none); a ``Corpus`` argument keeps its own device. Under
    ``use_device=False`` strings pack on the CPU unless ``device`` names
    another."""

    # Rows copied to the host alongside the match count; larger result
    # sets take one more, blocking copy
    fetch_rows: int = 8192

    def __init__(
        self,
        pattern: Union[PatternLike, Sequence[Pattern]],
        config: Optional[Config] = None,
        use_device: bool = True,
        device=None,
    ):
        self._config = config or Config()
        self._use_device = use_device
        self._device = device
        if isinstance(pattern, (list, tuple)):
            self._raw_patterns = [_as_pattern(p) for p in pattern]
        else:
            self._raw_patterns = [_as_pattern(pattern)]
        self._compiled = self._build()

    @classmethod
    def from_query(cls, query: str, config: Optional[Config] = None,
                   **kw) -> "Matcher":
        return cls(Pattern.parse_query(query), config, **kw)

    @classmethod
    def from_patterns(
        cls, patterns: Sequence[Pattern], config: Optional[Config] = None,
        **kw
    ) -> "Matcher":
        return cls(list(patterns), config, **kw)

    # -- config management ---------------------------------------------------

    @property
    def patterns(self) -> List[Pattern]:
        return list(self._raw_patterns)

    @property
    def config(self) -> Config:
        return self._config

    def set_config(self, config: Config) -> None:
        if config == self._config:
            return
        self._config = config
        self._compiled = self._build()

    def set_pattern(self, pattern: PatternLike) -> None:
        self.set_patterns([_as_pattern(pattern)])

    def set_patterns(self, patterns: Sequence[Pattern]) -> None:
        patterns = [_as_pattern(p) for p in patterns]
        if patterns == self._raw_patterns:
            return
        self._raw_patterns = patterns
        self._compiled = self._build()

    def _build(self) -> List[_CompiledPattern]:
        # compiled needles feed the per-corpus dispatch cache: any
        # pattern or config rebuild invalidates it
        self._dispatch_cache = {}
        return [
            _CompiledPattern(p, self._config, self._use_device)
            for p in self._raw_patterns
            if p.needle
        ]

    # -- host combine ----------------------------------------------------------

    def _pack(self, haystacks: Sequence[str], unicode: bool,
              device=None) -> Corpus:
        if device is None:
            device = self._device
            if device is None and not self._use_device:
                device = "cpu"
        return pack_corpus(haystacks, unicode=unicode, device=device)

    def _match_result(
        self, haystacks: Union[Sequence[str], Corpus]
    ) -> MatchResult:
        """Combined per-haystack result across all patterns, in input order.

        Multi-pattern composition: all non-negated must match (scores sum,
        exact ORs, end_col maxes), no negated may match
        (reference: src/matcher/multi.rs:84-152). A pattern of the other
        unit mode gets the haystacks packed in its mode, on the given
        corpus's device."""
        n = len(haystacks)
        combined: Optional[MatchResult] = None
        corpora = {}
        device = None
        if isinstance(haystacks, Corpus):
            corpora[haystacks.unicode] = haystacks
            device = haystacks.device
            haystacks = haystacks.haystacks

        def corpus_for(unicode: bool) -> Corpus:
            if unicode not in corpora:
                corpora[unicode] = self._pack(haystacks, unicode, device)
            return corpora[unicode]

        for cp in self._compiled:
            res = cp.engine.match_corpus(corpus_for(cp.engine.unicode))
            if combined is None:
                combined = MatchResult(n)
                combined.matched[:] = True
            if cp.negated:
                combined.matched &= ~res.matched
            else:
                combined.matched &= res.matched
                combined.score = np.minimum(
                    combined.score + res.score * res.matched, U16_MAX
                )
                combined.exact |= res.exact & res.matched
                combined.end_col = np.maximum(
                    combined.end_col, res.end_col * res.matched
                )
        if combined is None:
            combined = MatchResult(n)  # no patterns: handled by caller
        return combined

    # -- fused device path -----------------------------------------------------

    def _fused_supported(self) -> bool:
        """Whether the fused device path covers the patterns: the device
        is on, every pattern has units, and all share one unicode packing
        (the reference sends the rest to ``_match_result``)."""
        if not self._use_device or not self._compiled:
            return False
        modes = set()
        for cp in self._compiled:
            if not cp.engine.units.orig:
                return False
            modes.add(cp.engine.unicode)
        return len(modes) == 1

    def _statics(self) -> tuple:
        """Per pattern (typos, no_prefilter, negated, scoring, mode,
        needle bytes): what a batch group shares."""
        return tuple(
            (
                0 if cp.config.max_typos is None else int(cp.config.max_typos),
                cp.config.max_typos is None,
                cp.negated,
                tuple(
                    int(getattr(cp.config.scoring, f)) for f in SCORING_FIELDS
                ),
                cp.config.matching.value,
                len(cp.engine.needle_bytes),
            )
            for cp in self._compiled
        )

    def _fused_device_args(self, corpus: Corpus):
        """(bits8, statics, use_kernel) for the batch: per-bucket presence
        planes, then :meth:`_fused_statics`."""
        statics, use_kernel = self._fused_statics(corpus)
        bits8 = tuple(b.device_presence_bits() for b in corpus.buckets)
        return bits8, statics, use_kernel

    def _fused_statics(self, corpus: Corpus):
        """(statics, use_kernel): the pattern statics (typos,
        no_prefilter, negated, scoring, mode, needle bytes), and whether
        the kernels take the query: every bucket width a divisor or
        multiple of 128 up to 1024, every needle of at most 64 units and
        every clamped typo budget at most 8 (the reference's gate).
        Raises ValueError for a bucket wider than 4095 units: end_col
        travels in a 14-bit meta field, which would clamp it."""
        if any(b.width * 4 > 0x3FFF for b in corpus.buckets):
            raise ValueError(
                "bucket width exceeds the 14-bit end_col meta field (max "
                "4095 units)")
        use_kernel = (
            all(
                (b.width % 128 == 0 or 128 % b.width == 0)
                and b.width <= 1024
                for b in corpus.buckets
            )
            and all(
                len(cp.engine.units.orig) <= MAX_KERNEL_NEEDLE
                for cp in self._compiled
            )
            and all(
                min(cp.config.max_typos or 0, len(cp.engine.units.orig))
                <= MAX_KERNEL_TYPOS
                for cp in self._compiled
            )
        )
        return self._statics(), use_kernel

    def _fused_prepare(self, corpus: Corpus, full_window: bool) -> tuple:
        """Everything a Q=1 launch needs that depends only on (corpus,
        window): presence planes, statics, the stacked needles on the
        corpus device, and, where the batched program serves the query
        (the kernel routes under a score sort, as the reference's
        ``_fused_dispatch`` decides), the host-chosen finalize cap and
        the window; else None in their place, and the generic
        ``fused_match_sorted`` serves the whole corpus. Device layouts
        are uploaded here, on the calling thread's current stream."""
        bits8, statics, use_kernel = self._fused_device_args(corpus)
        hosts = [cp.engine._host_needle() for cp in self._compiled]
        lens = [h[0].shape[0] for h in hosts]
        stacked = tuple(
            tuple(torch.from_numpy(a[None]).to(corpus.device) for a in h)
            for h in hosts
        )
        single = len(statics) == 1 and not statics[0][2]
        if not (use_kernel and self._config.sort.is_by_score
                and (single or colstream_eligible_all(statics, lens))):
            return bits8, statics, stacked, use_kernel, None
        n = len(corpus)
        window = n if full_window else min(n, max(Q1_WINDOW_MIN, n // 8))
        _cs, fin_cap, _perm = _colstream_blocks_and_cap(
            corpus, statics, lens,
            [np.concatenate(h[:2])[None, :] for h in hosts],
            window, single=single,
        )  # perm is the identity at Q=1
        return bits8, statics, stacked, use_kernel, (fin_cap, window)

    def _fused_dispatch(self, corpus: Corpus, full_window: bool = False,
                        prep=None):
        """Launch the Q=1 batched program and start the head copy; returns
        the pending handle ``_fused_collect`` reads. Splitting dispatch
        from collection keeps several corpora in flight (match_iter's
        chunk pipeline).

        The result window is tiered: max(Q1_WINDOW_MIN, N/8) rows unless
        ``full_window``. A full-corpus window forces the full sort of
        every key, while almost every real query's matches fit the tier;
        a count overflow re-dispatches once with the full window
        (``_fused_collect``). ``_fused_prepare``'s result is cached per
        (corpus, window), at most 4 entries, each evicted when its corpus
        is collected: recomputing it runs the host cap chooser every
        call. A caller that prepared elsewhere passes ``prep``."""
        if prep is None:
            cache = self._dispatch_cache
            ck = (id(corpus), bool(full_window))
            entry = cache.get(ck)
            if entry is not None and entry[0]() is corpus:
                prep = entry[1]
            else:
                prep = self._fused_prepare(corpus, full_window)
                if len(cache) >= 4:
                    # entries hold device tensors: bound the cache so
                    # cycling over many corpora cannot pin old ones
                    cache.clear()
                # weakref + eviction callback: a corpus the caller dropped
                # must not stay pinned until a fifth entry arrives
                cache[ck] = (
                    weakref.ref(
                        corpus, lambda _r, c=cache, k=ck: c.pop(k, None)
                    ),
                    prep,
                )
        bits8, statics, stacked, use_kernel, batched = prep
        if batched is None:
            out = fused_match_sorted(
                corpus.buckets, tuple(tuple(a[0] for a in p)
                                      for p in stacked),
                n=len(corpus), pattern_statics=statics,
                sort_by_score=self._config.sort.is_by_score,
                use_kernel=use_kernel, bits8=bits8,
            )
        else:
            fin_cap, window = batched
            out = fused_match_sorted_batch(
                bits8, stacked, n=len(corpus), pattern_statics=statics,
                fetch_rows=window, buckets=corpus.buckets,
                finalize_cap=fin_cap,
            )[0]
        # only the head (count + the first fetch_rows rows) crosses to the
        # host; the rest of the window stays on the device
        host, ready = _copy_back(out[: 1 + min(self.fetch_rows, len(corpus))])
        return corpus, out, host, ready

    def _fused_collect(self, pending) -> tuple:
        corpus, out, host, ready = pending
        # one copy covers the count + the first fetch_rows matches; a
        # second copy only happens for very large result sets
        k = min(self.fetch_rows, len(corpus))
        _wait(ready)
        head = host.numpy()
        count = int(head[0, 0])
        if count > out.shape[0] - 1:
            # the tiered window overflowed: one re-dispatch with the
            # full-corpus window serves everything
            return self._fused_collect(
                self._fused_dispatch(corpus, full_window=True)
            )
        if count > k:
            rows = np.concatenate(
                [head[1:], out[1 + k : 1 + count].cpu().numpy()], axis=0
            )
        else:
            rows = head[1 : 1 + count]
        index, score, exact, end_col, greedy = self._decode_rows(rows)
        return self._host_fixups(
            corpus, index, score, exact, end_col, greedy
        )

    def _fused_match_arrays(self, corpus: Corpus) -> tuple:
        """One device pass for the whole query; usually one copy back."""
        return self._fused_collect(self._fused_dispatch(corpus))

    @staticmethod
    def _decode_rows(rows: np.ndarray) -> tuple:
        """Unpack fetched [index, meta] rows (meta = score<<16 | exact<<15
        | greedy<<14 | end_col)."""
        index = rows[:, 0].astype(np.int64)
        meta = rows[:, 1].astype(np.uint32)
        score = (meta >> np.uint32(16)).astype(np.int64)
        exact = ((meta >> np.uint32(15)) & np.uint32(1)).astype(bool)
        greedy = ((meta >> np.uint32(14)) & np.uint32(1)).astype(bool)
        end_col = (meta & np.uint32(0x3FFF)).astype(np.int64)
        return index, score, exact, end_col, greedy

    def _match_many_host(self, rows, xl=None) -> tuple:
        """(matched, score, exact, end_col) arrays over many rows with the
        multi-pattern combine (reference: src/matcher/multi.rs:84-152):
        every non-negated pattern must match (scores sum saturating at
        0xFFFF, exact ORs, end_col maxes) and no negated one may. Each
        engine runs its native batch (``engine.match_many``).

        With ``xl=(corpus, positions)``, ``rows`` may be a callable that
        returns the row list (called at most once): engines then score
        straight off the corpus's encoded XL blob
        (``engine.match_xl_rows``), and the strings are built only for an
        engine that cannot (a unicode atom over a byte corpus, or the
        ``native._FORCE_NUMPY`` test hook)."""
        mat_rows = None if callable(rows) else rows

        def get_rows():
            nonlocal mat_rows
            if mat_rows is None:
                mat_rows = rows()
            return mat_rows

        R = len(xl[1]) if xl is not None else len(get_rows())
        matched = np.ones(R, bool)
        score = np.zeros(R, np.int64)
        exact = np.zeros(R, bool)
        end_col = np.zeros(R, np.int64)
        for cp in self._compiled:
            res = None
            if xl is not None:
                res = cp.engine.match_xl_rows(*xl)
            if res is None:
                res = cp.engine.match_many(get_rows())
            m, s, e, ec = res
            if cp.negated:
                matched &= ~m
            else:
                matched &= m
                score = np.minimum(score + np.where(m, s, 0), U16_MAX)
                exact |= e & m
                end_col = np.maximum(end_col, np.where(m, ec, 0))
        return matched, score, exact, end_col

    def _host_fixups(
        self, corpus, index, score, exact, end_col, greedy
    ) -> tuple:
        """Greedy and XL host rescoring, then the final strategy ordering.
        Greedy rows (trimmed window over the 1024-byte DP cap) are
        rescored by the native host batch, which can drop them; XL rows
        (wider than the widest bucket) that pass the host presence gate
        run the native batch off the corpus's XL blob and join the
        result."""
        strategy = self._config.sort
        resort = False
        if greedy.any():
            gj = np.nonzero(greedy)[0]
            gm, gs, ge, gec = self._match_many_host(
                [corpus.haystacks[int(index[j])] for j in gj]
            )
            score[gj], exact[gj], end_col[gj] = gs, ge, gec
            keep = np.ones(len(index), dtype=bool)
            keep[gj] = gm
            index, score, exact, end_col = (
                index[keep], score[keep], exact[keep], end_col[keep]
            )
            resort = True
        if len(corpus.xl_indices):
            pos = np.nonzero(self._xl_candidates(corpus))[0]
            cand = corpus.xl_indices[pos]
            if len(cand):
                xm, xs, xe, xec = self._match_many_host(
                    lambda: [corpus.haystacks[int(i)] for i in cand],
                    xl=(corpus, pos),
                )
                if xm.any():
                    index = np.concatenate(
                        [index, cand[xm].astype(np.int64)]
                    )
                    score = np.concatenate([score, xs[xm]])
                    exact = np.concatenate([exact, xe[xm]])
                    end_col = np.concatenate([end_col, xec[xm]])
                    resort = True
        if resort:
            if strategy.is_by_score:
                order = np.lexsort((index, -score))
            else:
                order = np.argsort(index, kind="stable")
            index, score, exact, end_col = (
                index[order], score[order], exact[order], end_col[order]
            )
        if strategy is SortStrategy.SCORE_THEN_INDEX_DESC:
            order = np.lexsort((-index, -score))
            index, score, exact, end_col = (
                index[order], score[order], exact[order], end_col[order]
            )
        elif strategy is SortStrategy.INDEX_DESC:
            index, score, exact, end_col = (
                index[::-1], score[::-1], exact[::-1], end_col[::-1]
            )
        return index, score, exact, end_col

    def _xl_candidates(self, corpus) -> np.ndarray:
        """Boolean mask over ``corpus.xl_indices``: rows that could hold
        every non-negated pattern's fold-bit multiset within its typo
        budget (the host twin of stage 1, a sound superset). Negated
        patterns and patterns without a budget never pre-reject."""
        n_xl = len(corpus.xl_indices)
        keep = np.ones(n_xl, bool)
        counts = None
        for cp in self._compiled:
            if cp.negated or not cp.engine.units.orig:
                continue
            units = cp.engine.units
            t = cp.config.max_typos
            if t is None:
                continue  # unconditional scoring: every row is a candidate
            if counts is None:
                counts = corpus.xl_presence()
            need = np.zeros(128, np.int64)
            for o, f in zip(units.orig, units.flip):
                fo = (o + 0x20 if 0x41 <= o <= 0x5A else o) & 127
                ff = (f + 0x20 if 0x41 <= f <= 0x5A else f) & 127
                if fo == ff:
                    need[fo] += 1
            need = np.minimum(need, 3)
            cols = np.nonzero(need)[0]
            sub = counts[:, cols].astype(np.int16)
            hits = np.minimum(
                sub, need[cols][None, :].astype(np.int16)
            ).sum(axis=1, dtype=np.int32)
            keep &= hits >= int(need.sum()) - int(t)
        return keep

    # -- public APIs -----------------------------------------------------------

    def match_arrays(
        self, haystacks: Union[Sequence[str], Corpus]
    ) -> tuple:
        """Column-oriented matching: (index, score, exact, end_col) numpy
        arrays of all matching haystacks, ordered by the configured sort
        strategy (reference: src/matcher/mod.rs:205-222). Accepts a
        pre-packed, device-resident ``Corpus`` to amortize packing across
        queries; a Corpus packed in the other unit mode than the needle's
        is repacked on its device (the reference's dispatch-by-needle
        rule, src/matcher/mod.rs respects_unicode)."""
        n = len(haystacks)
        if not self._compiled:
            idx = np.arange(n, dtype=np.int64)
            if self._config.sort.is_reversed:
                idx = idx[::-1]
            z = np.zeros(n, dtype=np.int64)
            return idx, z, z.astype(bool), z

        if self._fused_supported():
            unicode = self._compiled[0].engine.unicode
            if isinstance(haystacks, Corpus):
                corpus = (
                    haystacks
                    if haystacks.unicode == unicode
                    else self._pack(haystacks.haystacks, unicode,
                                    haystacks.device)
                )
            else:
                corpus = self._pack(haystacks, unicode)
            return self._fused_match_arrays(corpus)

        res = self._match_result(haystacks)
        idxs = np.nonzero(res.matched)[0]
        score = res.score[idxs]
        strategy = self._config.sort
        if strategy is SortStrategy.SCORE_THEN_INDEX_ASC:
            order = np.lexsort((idxs, -score))
        elif strategy is SortStrategy.SCORE_THEN_INDEX_DESC:
            order = np.lexsort((-idxs, -score))
        elif strategy is SortStrategy.INDEX_ASC:
            order = np.arange(len(idxs))
        else:
            order = np.arange(len(idxs))[::-1]
        idxs = idxs[order]
        return (
            idxs,
            score[order],
            res.exact[idxs],
            res.end_col[idxs],
        )

    def match_list(
        self, haystacks: Union[Sequence[str], Corpus]
    ) -> Sequence[Match]:
        """Batch matching (reference: src/matcher/mod.rs:205-222) as an
        array-backed lazy :class:`MatchList`: ``Match`` objects are built
        on access, so huge result sets and the empty-needle copy path
        cost O(1) Python objects."""
        if not self._compiled:
            # copy path (reference: src/matcher/mod.rs:205-210)
            idx = np.arange(len(haystacks), dtype=np.int64)
            if self._config.sort.is_reversed:
                idx = idx[::-1]
            return MatchList(idx)
        return MatchList(*self.match_arrays(haystacks))

    def match_one(self, haystack: str, index: int = 0) -> Optional[Match]:
        if not self._compiled:
            return Match.from_index(index)
        combined = Match.from_index(index)
        for cp in self._compiled:
            m = cp.engine.match_one(haystack, index)
            if cp.negated:
                if m is not None:
                    return None
            else:
                if m is None:
                    return None
                combined.score = sat_add_u16(combined.score, m.score)
                combined.exact |= m.exact
                combined.end_col = max(combined.end_col, m.end_col)
        return combined

    def match_list_indices(
        self, haystacks: Union[Sequence[str], Corpus]
    ) -> List[MatchIndices]:
        """Matching with matched-character indices (reference:
        src/matcher/mod.rs:229-270). Under ``use_device`` the match set
        comes from ``match_arrays`` (the card's kernels); the traceback
        runs on the host over the matching rows only: the batched NumPy
        walk (``_batched_indices``) where it applies, else the per-row
        oracle (``match_one_indices``)."""
        if not self._compiled:
            matches = [MatchIndices(0, i) for i in range(len(haystacks))]
            if self._config.sort.is_reversed:
                matches.reverse()
            return matches
        hay = (
            haystacks.haystacks
            if isinstance(haystacks, Corpus)
            else haystacks
        )
        if self._use_device:
            index = sorted(int(i) for i in self.match_arrays(haystacks)[0])
        else:
            index = [
                i for i in range(len(hay))
                if self.match_one(hay[i], i) is not None
            ]
        if self._config.sort.is_reversed:
            index = index[::-1]
        out = list(self._traced(hay, index))
        if self._config.sort.is_by_score:
            out.sort(key=lambda m: -m.score)  # stable, score only
        return out

    def _traced(self, hay, index, base: int = 0) -> Iterator[MatchIndices]:
        """The MatchIndices of the matched rows ``index`` of ``hay``, in
        that order, their indices offset by ``base``: the batched walk's
        where it applies, the per-row oracle's for the rest."""
        batched = self._batched_indices(hay, index) or {}
        for i in index:
            m = batched.get(i)
            if m is None:
                m = self.match_one_indices(hay[i], i + base)
            else:
                m.index += base
            if m is not None:
                yield m

    def _batched_indices(self, hay, index) -> Optional[dict]:
        """Batched host traceback of the selected matches (one non-negated
        fuzzy pattern, device mode, at least 32 matches): {index:
        MatchIndices}; rows the batched walk doesn't cover are missing
        and fall back to the per-row oracle (see traceback.py)."""
        if (
            not self._use_device
            or len(self._compiled) != 1
            or self._compiled[0].negated
            or not self._compiled[0].config.matching.is_fuzzy
            or len(index) < 32
        ):
            return None
        from .traceback import batched_match_indices

        cp = self._compiled[0]
        rows = [hay[i] for i in index]
        res = batched_match_indices(cp.engine, rows)
        out = {}
        for i, r in zip(index, res):
            if r is not None:
                score, exact, inds = r
                out[i] = MatchIndices(
                    score=score, index=i, exact=exact, indices=list(inds),
                )
        return out

    def match_one_indices(
        self, haystack: str, index: int = 0
    ) -> Optional[MatchIndices]:
        """One row's match with its indices: no negated atom may match,
        every other must; scores add saturating at 0xFFFF, exact ORs, and
        the indices of all atoms merge, deduplicated, in reverse order
        (reference: src/matcher/multi.rs:74-77)."""
        if not self._compiled:
            return MatchIndices.from_index(index)
        combined = MatchIndices.from_index(index)
        for cp in self._compiled:
            if cp.negated:
                if cp.engine.match_one(haystack, index) is not None:
                    return None
            else:
                m = cp.engine.match_one_indices(haystack, index)
                if m is None:
                    return None
                combined.score = sat_add_u16(combined.score, m.score)
                combined.exact |= m.exact
                combined.indices.extend(m.indices)
        combined.indices = sorted(set(combined.indices), reverse=True)
        return combined

    # Rows per chunk of the string iterator: large enough that a chunk's
    # fixed costs (a pack, a dispatch, one copy back) amortize
    iter_chunk: int = 65536

    def _iter_chunks(self, haystacks: Iterable[str]):
        """(base_index, chunk) blocks with geometrically growing sizes, so
        the first match from a slow or unbounded stream appears after tens
        of items, while steady state runs full-size chunks. Sized inputs
        (lists) skip the small warm-up chunks."""
        it = iter(haystacks)
        base = 0
        try:
            known = len(haystacks)
        except TypeError:
            known = None
        size = self.iter_chunk if known is not None else 32
        while True:
            chunk = list(islice(it, size))
            if not chunk:
                return
            yield base, chunk
            base += len(chunk)
            size = min(size * 4, self.iter_chunk)

    def _pack_staged(self, haystacks: Sequence[str], unicode: bool):
        """Worker half of match_iter's pipeline: pack a chunk, upload its
        device layouts and prepare its Q=1 launch, then record an event on
        this thread's current stream. The dispatching thread makes its
        own stream wait on that event before it launches, so the uploads
        are ordered before the kernels that read them whatever streams
        the two threads run."""
        corpus = self._pack(haystacks, unicode)
        prep = self._fused_prepare(corpus, False)
        staged = None
        if corpus.device.type == "cuda":
            staged = torch.cuda.Event()
            staged.record(torch.cuda.current_stream(corpus.device))
        return corpus, prep, staged

    def match_iter(
        self, haystacks: Union[Iterable[str], Corpus]
    ) -> Iterator[Match]:
        """Lazy matching in input order (reference: src/matcher/iter.rs
        semantics: unsorted, yields as it goes).

        A pre-packed ``Corpus`` runs as one device pass and yields from
        its result. String input streams growing chunks through a
        three-stage pipeline: packing and upload in a 2-worker thread pool,
        up to 3 dispatches in flight on the device, then copy back and
        yield, so a chunk packs while earlier ones run and return."""
        if not self._use_device or not self._compiled:
            rows = (
                haystacks.haystacks
                if isinstance(haystacks, Corpus)
                else haystacks
            )
            for i, h in enumerate(rows):
                m = self.match_one(h, i)
                if m is not None:
                    yield m
            return
        if isinstance(haystacks, Corpus):
            yield from _yield_matches(*self.match_arrays(haystacks))
            return

        unicode = self._compiled[0].engine.unicode
        fused = self._fused_supported()

        def emit(base, res):
            cols = self._fused_collect(res) if fused else res
            yield from _yield_matches(*cols, base=base)

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        if not fused:
            inflight = deque()
            for base, chunk in self._iter_chunks(haystacks):
                inflight.append((base, self.match_arrays(chunk)))
                if len(inflight) >= 2:
                    b, res = inflight.popleft()
                    yield from emit(b, res)
            while inflight:
                b, res = inflight.popleft()
                yield from emit(b, res)
            return

        with ThreadPoolExecutor(max_workers=2) as pool:
            packing = deque()   # (base, Future[(corpus, prep, event)])
            inflight = deque()  # (base, pending device handle)

            def drain_packed(block):
                while packing and (block or packing[0][1].done()):
                    b, fut = packing.popleft()
                    corpus, prep, staged = fut.result()
                    if staged is not None:
                        torch.cuda.current_stream(corpus.device).wait_event(
                            staged)
                    inflight.append(
                        (b, self._fused_dispatch(corpus, prep=prep)))
                    block = False

            for base, chunk in self._iter_chunks(haystacks):
                packing.append(
                    (base, pool.submit(self._pack_staged, chunk, unicode))
                )
                drain_packed(block=len(packing) >= 2)
                while len(inflight) >= 3:
                    b, res = inflight.popleft()
                    yield from emit(b, res)
            while packing:
                drain_packed(block=True)
                while len(inflight) >= 3:
                    b, res = inflight.popleft()
                    yield from emit(b, res)
            while inflight:
                b, res = inflight.popleft()
                yield from emit(b, res)

    def match_iter_indices(
        self, haystacks: Union[Iterable[str], Corpus]
    ) -> Iterator[MatchIndices]:
        """Lazy matching with matched-byte indices, in input order
        (reference: src/matcher/iter.rs). A ``Corpus`` selects its matches
        in one ``match_arrays`` call; string input goes in the chunks of
        ``_iter_chunks``, one ``match_arrays`` call each, with the index
        rebased by the chunk's base; the traceback reuses the batched
        walk."""
        if not self._use_device or not self._compiled:
            rows = (
                haystacks.haystacks
                if isinstance(haystacks, Corpus)
                else haystacks
            )
            for i, h in enumerate(rows):
                m = self.match_one_indices(h, i)
                if m is not None:
                    yield m
            return
        if isinstance(haystacks, Corpus):
            index = sorted(int(i) for i in self.match_arrays(haystacks)[0])
            yield from self._traced(haystacks.haystacks, index)
            return
        for base, chunk in self._iter_chunks(haystacks):
            index = sorted(int(i) for i in self.match_arrays(chunk)[0])
            yield from self._traced(chunk, index, base)

    def match_list_parallel(
        self, haystacks: Sequence[str], shards: int
    ) -> List[Match]:
        """Shard/merge semantics: splits the input, matches each shard
        through the same single-device path one after another, and
        k-merges. Result-identical to ``match_list`` and to the
        reference's rayon-parallel path (src/matcher/parallel.rs:18-89);
        not a parallel execution (one card runs the passes in turn)."""
        if shards <= 0:
            raise ValueError("shards must be positive")
        shards = max(min(shards, -(-len(haystacks) // 2000)), 1)
        if not haystacks or not self._compiled or shards == 1:
            return self.match_list(haystacks)

        chunk = -(-len(haystacks) // shards)
        runs: List[List[Match]] = []
        for s in range(0, len(haystacks), chunk):
            sub = haystacks[s : s + chunk]
            index, score, exact, end_col = self.match_arrays(sub)
            runs.append([
                Match(
                    score=int(score[j]),
                    index=int(index[j]) + s,
                    exact=bool(exact[j]),
                    end_col=int(end_col[j]),
                )
                for j in range(len(index))
            ])
        return k_merge(runs, self._config.sort)


def k_merge(runs: List[List[Match]], strategy: SortStrategy) -> List[Match]:
    """Merge pre-sorted runs under ``strategy``'s order (reference:
    src/k_merge.rs), through ``sort.k_merge_matches_by_*``."""
    return {
        SortStrategy.SCORE_THEN_INDEX_ASC:
            k_merge_matches_by_score_then_index_asc,
        SortStrategy.SCORE_THEN_INDEX_DESC:
            k_merge_matches_by_score_then_index_desc,
        SortStrategy.INDEX_ASC: k_merge_matches_by_index_asc,
        SortStrategy.INDEX_DESC: k_merge_matches_by_index_desc,
    }[strategy](runs)


def match_list(
    needle: str, haystacks: Sequence[str], config: Optional[Config] = None,
    **kw
) -> Sequence[Match]:
    """One-shot convenience API (reference: src/lib.rs:60-68); ``kw``
    (``use_device``, ``device``) goes to the Matcher."""
    return Matcher(needle, config, **kw).match_list(haystacks)


def match_list_indices(
    needle: str, haystacks: Sequence[str], config: Optional[Config] = None,
    **kw
) -> List[MatchIndices]:
    return Matcher(needle, config, **kw).match_list_indices(haystacks)


def match_list_parallel(
    needle: str,
    haystacks: Sequence[str],
    shards: int,
    config: Optional[Config] = None,
    **kw,
) -> List[Match]:
    return Matcher(needle, config, **kw).match_list_parallel(haystacks, shards)


def fuzzy_match(
    haystacks: Iterable[str],
    needle: str,
    config: Optional[Config] = None,
    **kw,
) -> Iterator[Match]:
    """Lazy matching over any string iterable (reference:
    src/matcher/iter.rs FuzzyMatchExt::fuzzy_match). Unsorted; yields in
    input order."""
    return Matcher(needle, config, **kw).match_iter(haystacks)


def fuzzy_match_indices(
    haystacks: Iterable[str],
    needle: str,
    config: Optional[Config] = None,
    **kw,
) -> Iterator[MatchIndices]:
    """Lazy matching with matched-byte indices (reference:
    src/matcher/iter.rs FuzzyMatchExt::fuzzy_match_indices)."""
    return Matcher(needle, config, **kw).match_iter_indices(haystacks)


def _yield_matches(index, score, exact, end_col, base=0):
    """Yield Match objects in input (index-ascending) order from result
    columns, built in one C loop (``types.build_matches``)."""
    order = np.argsort(index, kind="stable")
    idx = index[order]
    if base:
        idx = idx + base
    yield from build_matches(
        np.ascontiguousarray(idx, np.int64),
        np.ascontiguousarray(score[order], np.int64),
        np.ascontiguousarray(exact[order], np.uint8),
        np.ascontiguousarray(end_col[order], np.int64),
    )


def _colstream_blocks_and_cap(corpus, statics, lens, needles_np, fetch_rows,
                              single):
    """(uses_colstream, finalize_cap, perm) for a serving group: whether
    the column-stream kernels serve the pattern set, and the host-chosen
    capped-sort budget from the stage-1-contributing patterns (see
    :func:`_colstream_finalize_cap`). ``needles_np`` holds one (Q, 2n)
    host needle array per pattern; ``single`` marks the one-pattern
    non-negated groups, which may take the row-major flow instead.
    finalize_cap is (cap_blocks, n_sel) or None (no capped tier); perm
    (None = identity) is the selective-first query order the caller
    applies before stacking."""
    if single:
        needs_cs = uses_colstream(statics[0], lens[0])
    else:
        needs_cs = colstream_eligible_all(statics, lens)
    if not needs_cs:
        return False, None, None
    entries = []
    for st, ln, nd in zip(statics, lens, needles_np):
        if _pattern_s1_contributes(st, ln):
            t = 0 if st[4] != FUZZY_MODE else min(st[0], ln)
            entries.append((nd, t))
    if not entries:
        # no stage 1 narrows the groups: every (group, query) pair is alive
        pairs = needles_np[0].shape[0] * sum(
            b.host_blk_bits().shape[0] for b in corpus.buckets)
        SERVING_COUNTS["alive_pairs"] += pairs
        SERVING_COUNTS["cap_pairs"] += pairs
    res = _colstream_finalize_cap(corpus, entries, fetch_rows)
    if res is None:
        return True, None, None
    cap, n_sel, perm = res
    return True, (cap, n_sel), perm


def _colstream_finalize_cap(corpus, pattern_needles, fetch_rows):
    """Static capped-sort group budget, chosen on the host from the
    corpus's group presence planes x each pattern's need matrix (the
    exact math of the device flags, so the cap is sound).
    ``pattern_needles`` is a list of (needles_np (Q, 2n), typos) pairs.
    Returns None (no capped tier) or ``(cap_blocks, n_sel, perm)``: the
    smallest of {1/4, 1/2} of the group count that every query's alive
    groups fit, or a mixed split where the first ``n_sel`` queries of the
    ``perm`` order fit half the groups and the rest take the full sort
    (n_sel quantized to multiples of 8 above 8 queries)."""
    from .ops.presence import needle_need_matrix_np

    if not pattern_needles:
        return None
    Q = pattern_needles[0][0].shape[0]
    n_pat = len(pattern_needles)
    # every pattern's need columns side by side, (PLANES*128, P*Q) float32:
    # one product a bucket
    needs, floors = [], []
    for nd, typos in pattern_needles:
        need, tot = needle_need_matrix_np(nd)
        needs.append(need)
        floors.append(tot - typos)
    need = np.concatenate(needs, axis=1).astype(np.float32)
    floor = np.concatenate(floors)
    alive_tot = np.zeros(Q, np.int64)
    n_gtot = 0
    for b in corpus.buckets:
        planes = b.host_blk_planes()  # (nG, PLANES*128) float32 or None
        n_g = b.host_blk_bits().shape[0]
        n_gtot += n_g
        if planes is None:
            # a wider bucket counts as all alive, as the reference's
            alive_tot += n_g
            continue
        # float32 sums of 0/1 products are integers <= PLANES*128: exact
        alive = (planes @ need >= floor).reshape(n_g, n_pat, Q).all(axis=1)
        alive_tot += alive.sum(axis=0)
    SERVING_COUNTS["alive_pairs"] += int(alive_tot.sum())
    SERVING_COUNTS["cap_pairs"] += n_gtot * Q
    min_blocks = min(-(-fetch_rows // GROUP_ROWS) + 1, n_gtot)
    if min_blocks >= -(-n_gtot // 2):
        return None
    for div in (4, 2):
        cap = max(-(-n_gtot // div), min_blocks)
        if np.all(alive_tot <= cap):
            return int(cap), Q, None
    if n_gtot < MIXED_FINALIZE_MIN_GROUPS:
        return None
    cap = max(-(-n_gtot // 2), min_blocks)
    fit = alive_tot <= cap
    gran = 8 if Q > 8 else 1
    n_sel = (int(fit.sum()) // gran) * gran
    if n_sel == 0:
        return None
    perm = np.argsort(~fit, kind="stable")
    return int(cap), n_sel, perm


def _dispatch_batch_groups(
    matchers: List[Matcher],
    corpus: Corpus,
    config: Config,
    fetch_rows: int,
    serial: Optional[int] = None,
):
    """Group shape-uniform queries (same pattern count, per-pattern
    statics and needle lengths) and enqueue one batched device pass per
    group, with the device->host copy of each result started behind it.
    Returns one (host_rows, ready_event, members) entry per group. Queries
    no group takes (empty, not fused-supported, or of a unit mode other
    than the corpus's) are in no entry: ``_collect_batch_groups`` leaves
    them None for the per-query path. ``serial`` numbers the batch's
    spans."""
    groups = {}
    prepared = {}
    with annotate("frizbee.group", serial):
        for i, m in enumerate(matchers):
            if not m._fused_supported():
                continue
            if m._compiled[0].engine.unicode != corpus.unicode:
                # the needle's unit mode (reference: src/matcher/mod.rs
                # respects_unicode) differs from the corpus packing: the
                # per-query path repacks
                continue
            bits8, statics, use_kernel = m._fused_device_args(corpus)
            hosts = tuple(cp.engine._host_needle() for cp in m._compiled)
            lens = tuple(h[0].shape[0] for h in hosts)
            groups.setdefault((statics, lens, use_kernel), []).append(i)
            prepared[i] = (bits8, hosts)
    SERVING_COUNTS["batches"] += 1
    SERVING_COUNTS["queries"] += len(matchers)
    SERVING_COUNTS["groups"] += len(groups)

    pending = []
    for (statics, lens, use_kernel), members in groups.items():
        bits8 = prepared[members[0]][0]
        n_pat = len(statics)
        fin_cap = None
        if use_kernel and config.sort.is_by_score:
            with annotate("frizbee.cap", serial):
                needles_np = [
                    np.stack([np.concatenate(prepared[i][1][p][:2])
                              for i in members])
                    for p in range(n_pat)
                ]
                _cs, fin_cap, perm = _colstream_blocks_and_cap(
                    corpus, statics, list(lens), needles_np,
                    min(fetch_rows, len(corpus)),
                    single=(n_pat == 1 and not statics[0][2]),
                )
            if perm is not None:
                # mixed finalize: selective queries first; members follow
                members = [members[j] for j in perm]
        with annotate("frizbee.upload", serial):
            stacked = tuple(
                tuple(
                    _upload(
                        np.stack([prepared[i][1][p][a] for i in members]),
                        corpus.device,
                    )
                    for a in range(3)
                )
                for p in range(n_pat)
            )
        with annotate("frizbee.enqueue", serial):
            out = fused_match_sorted_batch(
                bits8,
                stacked,
                n=len(corpus),
                pattern_statics=statics,
                fetch_rows=min(fetch_rows, len(corpus)),
                buckets=corpus.buckets,
                finalize_cap=fin_cap,
                sort_by_score=config.sort.is_by_score,
                use_kernel=use_kernel,
            )
        host_rows, ready = _copy_back(out, serial)
        pending.append((host_rows, ready, members))
    return pending


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; to a card through a pinned copy, non-blocking:
    a copy from pageable memory synchronizes the stream, so the host
    would wait there for every batch already queued on the card."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    # the caching host allocator keeps the pinned block until the copy
    # recorded on it completes
    return t.pin_memory().to(device, non_blocking=True)


def _copy_back(out, serial=None):
    """(host tensor, ready event or None): ``out``'s copy to the host,
    started behind the device work on a card (pinned, non-blocking, an
    event recorded after it), ``out`` itself on the CPU."""
    if not out.is_cuda:
        return out, None
    with annotate("frizbee.copy_back", serial):
        # the caching host allocator keeps the pinned block until the
        # copy recorded on it completes, even if the handle is dropped
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(out.device))
    return host, ready


def _wait(ready, serial=None) -> None:
    """Block until a copy ``_copy_back`` started has landed."""
    if ready is not None:
        with annotate("frizbee.wait", serial):
            ready.synchronize()


def _collect_batch_groups(pending, n_queries,
                          serial=None) -> List[Optional[tuple]]:
    """Wait for each group's copy, then decode per-query (count, index,
    score, exact, end_col, greedy) rows; None for queries no group
    took."""
    results: List[Optional[tuple]] = [None] * n_queries
    for host_rows, ready, members in pending:
        _wait(ready, serial)
        with annotate("frizbee.decode", serial):
            all_rows = host_rows.numpy()
            for qi, i in enumerate(members):
                block = all_rows[qi]
                count = int(block[0, 0])
                rows = block[1 : 1 + min(count, block.shape[0] - 1)]
                results[i] = (count,) + Matcher._decode_rows(rows)
    return results


def _resolve_batch(queries, corpus, config, serial=None, **pack_kw):
    """(matchers, Corpus) of a batch: each query compiled, and a corpus
    given as strings packed (``pack_kw`` to ``pack_corpus``, e.g. the
    device)."""
    with annotate("frizbee.compile", serial):
        matchers = [
            q if isinstance(q, Matcher) else Matcher.from_query(q, config)
            for q in queries
        ]
    if not isinstance(corpus, Corpus):
        # codepoint units when any needle respects unicode
        unicode = any(cp.engine.unicode for m in matchers
                      for cp in m._compiled)
        corpus = pack_corpus(corpus, unicode=unicode, **pack_kw)
    return matchers, corpus


def match_topk_batch(
    queries: Sequence[Union[str, Matcher]],
    corpus: Union[Sequence[str], Corpus],
    config: Optional[Config] = None,
    k: int = 2048,
) -> List[tuple]:
    """Top-k serving: each query returns ``(total_count, index, score,
    exact, end_col)`` with at most the best ``k`` matches materialized on
    the host. A corpus given as strings is packed on the card, in
    codepoint units when any needle respects unicode."""
    return match_topk_batch_async(queries, corpus, config, k).result()


def _run_batch_groups(
    matchers: List[Matcher],
    corpus: Corpus,
    config: Config,
    fetch_rows: int,
) -> List[Optional[tuple]]:
    """Dispatch and collect in one blocking call: per query (count,
    index, score, exact, end_col, greedy) of the top ``fetch_rows``
    device rows, or None for queries the per-query path serves."""
    return _collect_batch_groups(
        _dispatch_batch_groups(matchers, corpus, config, fetch_rows),
        len(matchers),
    )


def match_arrays_batch(
    queries: Sequence[Union[str, Matcher]],
    corpus: Union[Sequence[str], Corpus],
    config: Optional[Config] = None,
    fetch_rows: int = 6144,
) -> List[tuple]:
    """Q independent queries (strings or prebuilt Matchers) against one
    resident corpus in one device pass per shape group and one copy
    back each. Returns per query the (index, score, exact, end_col)
    arrays of all matches, ordered like ``Matcher.match_arrays``.
    Queries whose result set exceeds ``fetch_rows``, and queries no
    group takes, run through the per-query path."""
    config = config or Config()
    matchers, corpus = _resolve_batch(queries, corpus, config)
    raw = _run_batch_groups(
        matchers, corpus, config, min(fetch_rows, len(corpus))
    )
    results: List[Optional[tuple]] = [None] * len(queries)
    for i, r in enumerate(raw):
        if r is None:
            continue
        count, index, score, exact, end_col, greedy = r
        if count > len(index):
            continue  # overflow: the per-query path below fetches all
        results[i] = matchers[i]._host_fixups(
            corpus, index, score, exact, end_col, greedy
        )
    for i in range(len(queries)):
        if results[i] is None:
            SERVING_COUNTS["fallback_queries"] += 1
            results[i] = matchers[i].match_arrays(corpus)
    return results


def _finalize_topk(matchers, corpus, raw, k) -> List[tuple]:
    results: List[Optional[tuple]] = [None] * len(matchers)
    for i, r in enumerate(raw):
        # unfetched rows may be greedy and greedy rescoring can drop
        # rows: past the fetch window on a corpus that can produce
        # greedy rows, the exact total and near-k order need the
        # per-query full fetch (as match_arrays_batch's overflow guard)
        if r is not None and r[0] > len(r[1]) and corpus.greedy_risk():
            r = None
        if r is None:
            SERVING_COUNTS["fallback_queries"] += 1
            index, score, exact, end_col = matchers[i].match_arrays(corpus)
            results[i] = (
                len(index), index[:k], score[:k], exact[:k], end_col[:k]
            )
            continue
        count, index, score, exact, end_col, greedy = r
        fetched = len(index)
        index, score, exact, end_col = matchers[i]._host_fixups(
            corpus, index, score, exact, end_col, greedy
        )
        # greedy rescoring can drop rows and XL rows can add some: the
        # exact total follows the host fixups' delta
        count += len(index) - fetched
        results[i] = (count, index[:k], score[:k], exact[:k], end_col[:k])
    return results


class BatchFuture:
    """An in-flight ``match_topk_batch_async`` result: the device work and
    the device->host copy proceed while the caller does other work,
    typically dispatching the next batch. ``serial`` is the batch's
    number, carried by its spans."""

    def __init__(self, matchers, corpus, k, pending, serial):
        self._matchers = matchers
        self._corpus = corpus
        self._k = k
        self._pending = pending
        self._result = None
        self.serial = serial

    def result(self) -> List[tuple]:
        """Block until ready; same return shape as ``match_topk_batch``."""
        if self._result is None:
            with annotate("frizbee.result", self.serial):
                raw = _collect_batch_groups(
                    self._pending, len(self._matchers), self.serial)
                with annotate("frizbee.fixups", self.serial):
                    self._result = _finalize_topk(
                        self._matchers, self._corpus, raw, self._k
                    )
            self._pending = None
        return self._result


def match_topk_batch_async(
    queries: Sequence[Union[str, Matcher]],
    corpus: Union[Sequence[str], Corpus],
    config: Optional[Config] = None,
    k: int = 2048,
) -> BatchFuture:
    """Dispatch a top-k batch without waiting. Keeping 2-3 batches in
    flight overlaps host work and copies with device execution:

        futures = deque()
        for batch in stream:
            futures.append(match_topk_batch_async(batch, corpus, cfg))
            if len(futures) >= DEPTH:
                consume(futures.popleft().result())
    """
    serial = next(_BATCH_SERIALS)
    with annotate("frizbee.dispatch", serial):
        config = config or Config()
        matchers, corpus = _resolve_batch(queries, corpus, config, serial)
        pending = _dispatch_batch_groups(
            matchers, corpus, config, min(k, len(corpus)), serial
        )
        return BatchFuture(matchers, corpus, k, pending, serial)
