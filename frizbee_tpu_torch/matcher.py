"""Batched top-k serving: ``match_topk_batch`` and its pipelined form.

Counterpart of the serving half of ``frizbee_tpu/matcher.py``: queries
compile to ``Matcher`` objects, shape-uniform queries group into one
batched device pass each (``ops/batch.fused_match_sorted_batch``), and
the ``(Q, 1+k, 2)`` results decode on the host into per-query
``(total_count, index, score, exact, end_col)`` arrays.

This slice serves single-pattern queries with a score sort over corpora
of bucket width <= 1024: ASCII needles over byte-unit corpora and
unicode needles (``UnicodeMatching.SMART`` with a non-ASCII needle, or
any needle under ``ALWAYS``) over codepoint-unit corpora — fuzzy needles
of up to 64 units with typo budgets of up to 8 (the column-stream kernel
for up to 16 units and budgets of up to 3, the row-major kernel beyond),
and literal needles (exact, prefix, suffix, substring) of up to 16
units. Queries and corpora outside that raise NotImplementedError naming
the slice that ports them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config, SortStrategy
from .corpus import GROUP_ROWS, Corpus, pack_corpus
from .engine import make_engine
from .ops.batch import (
    fused_match_sorted_batch,
    unserved_reason,
    uses_colstream,
)
from .ops.colstream import FUZZY_MODE
from .ops.fuzzy import SCORING_FIELDS
from .pattern import Pattern

PatternLike = Union[str, Pattern]

# Mixed-finalize group-count gate: below this many groups the capped +
# full split is not worth its extra work (module constant so tests can
# force the split on small corpora)
MIXED_FINALIZE_MIN_GROUPS = 512


class _CompiledPattern:
    __slots__ = ("negated", "needle", "config", "engine")

    def __init__(self, source: Pattern, config: Config):
        resolved = source.config.resolve(config)
        self.negated = source.negated
        self.needle = source.needle
        self.config = resolved
        self.engine = make_engine(source.needle, resolved)


def _as_pattern(p: PatternLike) -> Pattern:
    if isinstance(p, Pattern):
        return p
    return Pattern.literal(str(p))


class Matcher:
    """One compiled query (reference: src/matcher/mod.rs:80-111)."""

    def __init__(
        self,
        pattern: Union[PatternLike, Sequence[Pattern]],
        config: Optional[Config] = None,
    ):
        self._config = config or Config()
        if isinstance(pattern, (list, tuple)):
            self._raw_patterns = [_as_pattern(p) for p in pattern]
        else:
            self._raw_patterns = [_as_pattern(pattern)]
        needles = [p for p in self._raw_patterns if p.needle]
        if len(needles) > 1 or any(p.negated for p in needles):
            raise NotImplementedError(
                "multi-pattern and negated queries come with the "
                "multi-pattern serving slice"
            )
        self._compiled = [
            _CompiledPattern(p, self._config)
            for p in self._raw_patterns
            if p.needle
        ]
        self._check_served()

    @classmethod
    def from_query(cls, query: str, config: Optional[Config] = None) -> "Matcher":
        return cls(Pattern.parse_query(query), config)

    def _check_served(self) -> None:
        """Raise for queries this slice does not serve."""
        if not self._compiled:
            raise NotImplementedError(
                "empty queries come with the single-query Matcher slice"
            )
        if not self._config.sort.is_by_score:
            raise NotImplementedError(
                "index sort strategies come with the generic pipelines "
                "slice"
            )
        cp = self._compiled[0]
        reason = unserved_reason(self._statics()[0],
                                 len(cp.engine.units.orig))
        if reason is not None:
            raise NotImplementedError(reason)

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
        planes, the pattern statics (typos, no_prefilter, negated,
        scoring, mode, needle bytes), and whether every bucket width
        fits the kernels."""
        use_kernel = all(
            (b.width % 128 == 0 or 128 % b.width == 0) and b.width <= 1024
            for b in corpus.buckets
        )
        bits8 = tuple(b.device_presence_bits() for b in corpus.buckets)
        return bits8, self._statics(), use_kernel

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

    def _host_fixups(
        self, corpus, index, score, exact, end_col, greedy
    ) -> tuple:
        """Final strategy ordering. Greedy-flagged rows (trimmed window
        over the 1024-byte DP cap) need the host rescoring of a later
        slice."""
        if greedy.any():
            raise NotImplementedError(
                "greedy-flagged rows need the host fixups slice"
            )
        if self._config.sort is SortStrategy.SCORE_THEN_INDEX_DESC:
            order = np.lexsort((-index, -score))
            index, score, exact, end_col = (
                index[order], score[order], exact[order], end_col[order]
            )
        return index, score, exact, end_col


def _colstream_cap(corpus, statics, lens, needles_np, fetch_rows):
    """(finalize_cap, perm) for a single-pattern colstream group: the
    host-chosen capped-sort budget (see :func:`_colstream_finalize_cap`).
    perm (None = identity) is the selective-first query order the caller
    applies before stacking."""
    typos, nopre, _neg, _sc, mode, _nbl = statics[0]
    if mode != FUZZY_MODE:
        # literal stage 1 runs at T=0 whatever the budget, so its group
        # flags always narrow (the reference's _pattern_s1_contributes)
        T = 0
    else:
        T = min(typos, lens[0])
        if nopre or lens[0] <= T:  # no stage-1 flags: no capped tier
            return None, None
    res = _colstream_finalize_cap(corpus, [(needles_np[0], T)], fetch_rows)
    if res is None:
        return None, None
    cap, n_sel, perm = res
    return (cap, n_sel), perm


def _colstream_finalize_cap(corpus, pattern_needles, fetch_rows):
    """Static capped-sort group budget, chosen on the host from the
    corpus's NumPy group presence planes x each pattern's need matrix
    (the exact math of the device flags, so the cap is sound).
    ``pattern_needles`` is a list of (needles_np (Q, 2n), typos) pairs.
    Returns None (no capped tier) or ``(cap_blocks, n_sel, perm)``: the
    smallest of {1/4, 1/2} of the group count that every query's alive
    groups fit, or a mixed split where the first ``n_sel`` queries of the
    ``perm`` order fit half the groups and the rest take the full sort
    (n_sel quantized to multiples of 8 above 8 queries)."""
    from .ops.presence import needle_need_matrix_np

    if not pattern_needles:
        return None
    needs = [
        (needle_need_matrix_np(nd), t) for nd, t in pattern_needles
    ]
    Q = pattern_needles[0][0].shape[0]
    alive_tot = np.zeros(Q, np.int64)
    n_gtot = 0
    for b in corpus.buckets:
        blk = b.host_blk_bits().astype(np.int32)  # (nG, PLANES*128)
        n_gtot += blk.shape[0]
        mask = np.ones((blk.shape[0], Q), bool)
        for (need, tot), typos in needs:
            mask &= (blk @ need) >= (tot - typos)[None, :]
        alive_tot += mask.sum(axis=0)
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


def _check_corpus(corpus: Corpus) -> None:
    if len(corpus.xl_indices):
        raise NotImplementedError(
            "corpora with rows wider than the widest bucket need the host "
            "fixups slice"
        )


def _dispatch_batch_groups(
    matchers: List[Matcher],
    corpus: Corpus,
    config: Config,
    fetch_rows: int,
):
    """Group shape-uniform queries (same statics and needle length) and
    enqueue one batched device pass per group, with the device->host copy
    of each result started behind it. Returns one (host_rows,
    ready_event, members) entry per group."""
    _check_corpus(corpus)
    groups = {}
    prepared = {}
    for i, m in enumerate(matchers):
        if m._compiled[0].engine.unicode != corpus.unicode:
            # the needle's unit mode (reference: src/matcher/mod.rs
            # respects_unicode) differs from the corpus packing: the
            # reference repacks per query on its per-query path
            raise NotImplementedError(
                "a needle whose unit mode differs from the corpus packing "
                "comes with the single-query Matcher slice"
            )
        bits8, statics, use_kernel = m._fused_device_args(corpus)
        if not use_kernel or not config.sort.is_by_score:
            raise NotImplementedError(
                "custom bucket widths and index sorts come with the "
                "generic pipelines slice"
            )
        host = m._compiled[0].engine._host_needle()
        groups.setdefault((statics, host[0].shape[0]), []).append(i)
        prepared[i] = (bits8, host)

    pending = []
    for (statics, nlen), members in groups.items():
        bits8 = prepared[members[0]][0]
        needles_np = np.stack([
            np.concatenate(prepared[i][1][:2]) for i in members
        ])
        fin_cap = perm = None
        if uses_colstream(statics[0], nlen):
            # the capped finalize of the column-stream flow
            fin_cap, perm = _colstream_cap(
                corpus, statics, [nlen], [needles_np],
                min(fetch_rows, len(corpus)),
            )
        if perm is not None:
            # mixed finalize: selective queries first; members follow
            members = [members[j] for j in perm]
        stacked = (tuple(
            torch.from_numpy(
                np.stack([prepared[i][1][a] for i in members])
            ).to(corpus.device)
            for a in range(3)
        ),)
        out = fused_match_sorted_batch(
            bits8,
            stacked,
            n=len(corpus),
            pattern_statics=statics,
            fetch_rows=min(fetch_rows, len(corpus)),
            buckets=corpus.buckets,
            finalize_cap=fin_cap,
        )
        if out.is_cuda:
            host_rows = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            host_rows.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(out.device))
        else:
            host_rows, ready = out, None
        pending.append((host_rows, ready, members))
    return pending


def _collect_batch_groups(pending, n_queries) -> List[tuple]:
    """Wait for each group's copy, then decode per-query (count, index,
    score, exact, end_col, greedy) rows."""
    results: List[Optional[tuple]] = [None] * n_queries
    for host_rows, ready, members in pending:
        if ready is not None:
            ready.synchronize()
        all_rows = host_rows.numpy()
        for qi, i in enumerate(members):
            block = all_rows[qi]
            count = int(block[0, 0])
            rows = block[1 : 1 + min(count, block.shape[0] - 1)]
            results[i] = (count,) + Matcher._decode_rows(rows)
    return results


def _resolve_batch(queries, corpus, config):
    matchers = [
        q if isinstance(q, Matcher) else Matcher.from_query(q, config)
        for q in queries
    ]
    if not isinstance(corpus, Corpus):
        # codepoint units when any needle respects unicode
        unicode = any(cp.engine.unicode for m in matchers
                      for cp in m._compiled)
        corpus = pack_corpus(corpus, unicode=unicode)
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


def _finalize_topk(matchers, corpus, raw, k) -> List[tuple]:
    results: List[Optional[tuple]] = [None] * len(matchers)
    for i, r in enumerate(raw):
        if r[0] > len(r[1]) and corpus.greedy_risk():
            # unfetched rows may be greedy and rescoring can drop rows:
            # the exact total needs the full per-query fetch
            raise NotImplementedError(
                "full-fetch fallback comes with the single-query Matcher "
                "slice"
            )
        count, index, score, exact, end_col, greedy = r
        index, score, exact, end_col = matchers[i]._host_fixups(
            corpus, index, score, exact, end_col, greedy
        )
        results[i] = (count, index[:k], score[:k], exact[:k], end_col[:k])
    return results


class BatchFuture:
    """An in-flight ``match_topk_batch_async`` result: the device work and
    the device->host copy proceed while the caller does other work,
    typically dispatching the next batch."""

    def __init__(self, matchers, corpus, k, pending):
        self._matchers = matchers
        self._corpus = corpus
        self._k = k
        self._pending = pending
        self._result = None

    def result(self) -> List[tuple]:
        """Block until ready; same return shape as ``match_topk_batch``."""
        if self._result is None:
            raw = _collect_batch_groups(self._pending, len(self._matchers))
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
    config = config or Config()
    matchers, corpus = _resolve_batch(queries, corpus, config)
    pending = _dispatch_batch_groups(
        matchers, corpus, config, min(k, len(corpus))
    )
    return BatchFuture(matchers, corpus, k, pending)
