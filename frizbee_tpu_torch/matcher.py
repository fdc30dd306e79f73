"""Batched top-k serving: ``match_topk_batch`` and its pipelined form.

Counterpart of the serving half of ``frizbee_tpu/matcher.py``: queries
compile to ``Matcher`` objects, shape-uniform queries group into one
batched device pass each (``ops/batch.fused_match_sorted_batch``), and
the ``(Q, 1+k, 2)`` results decode on the host into per-query
``(total_count, index, score, exact, end_col)`` arrays.

It serves queries with a score sort over corpora of bucket width
<= 1024: ASCII needles over byte-unit corpora and unicode needles
(``UnicodeMatching.SMART`` with a non-ASCII needle, or any needle under
``ALWAYS``) over codepoint-unit corpora. A single pattern is a fuzzy
needle of up to 64 units with a typo budget of up to 8 (the
column-stream kernel for up to 16 units and budgets of up to 3, the
row-major kernel beyond), or a literal needle (exact, prefix, suffix,
substring) of up to 16 units. Several patterns, or a negated one
(``foo !^bar``), are served when every atom fits the column-stream
kernels and all atoms share one unit mode. Greedy-flagged rows (trimmed
window over the 1024-byte DP cap) and XL rows (wider than the widest
bucket) are rescored on the host with the oracle's pipelines, as the
reference does. Queries and corpora outside that raise
NotImplementedError naming the slice that ports them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .config import U16_MAX, Config, SortStrategy
from .corpus import GROUP_ROWS, Corpus, pack_corpus
from .engine import make_engine
from .ops.batch import (
    _pattern_s1_contributes,
    colstream_eligible_all,
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
        statics = self._statics()
        lens = [len(cp.engine.units.orig) for cp in self._compiled]
        for st, ln in zip(statics, lens):
            reason = unserved_reason(st, ln)
            if reason is not None:
                raise NotImplementedError(reason)
        if not self._fused_supported():
            raise NotImplementedError(
                "patterns of mixed unit modes come with the single-query "
                "Matcher slice"
            )
        if ((len(statics) > 1 or statics[0][2])
                and not colstream_eligible_all(statics, lens)):
            raise NotImplementedError(
                "multi-pattern or negated queries with an atom outside the "
                "column-stream kernels' budgets come with the generic "
                "pipelines slice"
            )

    def _fused_supported(self) -> bool:
        """Whether the batch path covers the patterns: every pattern has
        units, and all share one unicode packing (the reference sends the
        rest to its per-query path)."""
        if not self._compiled:
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

    def _match_many_host(self, rows) -> tuple:
        """(matched, score, exact, end_col) arrays over a list of rows with
        the multi-pattern combine (reference: src/matcher/multi.rs:84-152):
        every non-negated pattern must match (scores sum saturating at
        0xFFFF, exact ORs, end_col maxes) and no negated one may. Each
        engine runs its per-row host pipeline (``engine.match_many``)."""
        R = len(rows)
        matched = np.ones(R, bool)
        score = np.zeros(R, np.int64)
        exact = np.zeros(R, bool)
        end_col = np.zeros(R, np.int64)
        for cp in self._compiled:
            m, s, e, ec = cp.engine.match_many(rows)
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
        rescored on the host, which can drop them; XL rows (wider than the
        widest bucket) that pass the host presence gate run the host
        pipeline and join the result."""
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
                    [corpus.haystacks[int(i)] for i in cand]
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
            # batch serving sorts by score (index sorts are refused)
            order = np.lexsort((index, -score))
            index, score, exact, end_col = (
                index[order], score[order], exact[order], end_col[order]
            )
        if strategy is SortStrategy.SCORE_THEN_INDEX_DESC:
            order = np.lexsort((-index, -score))
            index, score, exact, end_col = (
                index[order], score[order], exact[order], end_col[order]
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
    res = _colstream_finalize_cap(corpus, entries, fetch_rows)
    if res is None:
        return True, None, None
    cap, n_sel, perm = res
    return True, (cap, n_sel), perm


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


def _dispatch_batch_groups(
    matchers: List[Matcher],
    corpus: Corpus,
    config: Config,
    fetch_rows: int,
):
    """Group shape-uniform queries (same pattern count, per-pattern
    statics and needle lengths) and enqueue one batched device pass per
    group, with the device->host copy of each result started behind it.
    Returns one (host_rows, ready_event, members) entry per group."""
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
        hosts = tuple(cp.engine._host_needle() for cp in m._compiled)
        lens = tuple(h[0].shape[0] for h in hosts)
        groups.setdefault((statics, lens), []).append(i)
        prepared[i] = (bits8, hosts)

    pending = []
    for (statics, lens), members in groups.items():
        bits8 = prepared[members[0]][0]
        n_pat = len(statics)
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
        stacked = tuple(
            tuple(
                torch.from_numpy(
                    np.stack([prepared[i][1][p][a] for i in members])
                ).to(corpus.device)
                for a in range(3)
            )
            for p in range(n_pat)
        )
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
