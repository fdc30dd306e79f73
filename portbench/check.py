"""What decides ``correct``: the answers the timed window served, for a
sample of its queries drawn from the seed, against the plain reference.

The served answers of a sampled query are reduced to digests when they
arrive: its 1st, 2nd, 4th, 8th, ... answer in the window, so the checks
span the whole window and cost the loop little where a query is in
every batch; once the window has closed and the program's state is
freed, the reference answers each sampled query once, and every digest
is compared with the reference's. An answer is ``(total_count, index,
score, exact, end_col)``: the count and the top k in order, compared
exactly. The numbers compared, each with the limit 0:

- ``wrong_answers``: checked answers that differ from the reference in
  any way;
- ``missing_answers``: checked answers that never came: the batch
  answered, but not this query.

Faults for the benchmark's own tests and the control runs are planted
where the answers are produced (``FAULTS``).
"""

from __future__ import annotations

import hashlib
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from portbench.reference import answer

LIMITS = {"wrong_answers": 0, "missing_answers": 0}


def digest(ans) -> Optional[str]:
    """A served or reference answer reduced to a hash, None if none."""
    if ans is None:
        return None
    count, index, score, exact, end_col = ans
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(count).tobytes())
    for a, dt in ((index, np.int64), (score, np.int64), (exact, np.uint8),
                  (end_col, np.int64)):
        h.update(np.asarray(a).astype(dt).tobytes())
        h.update(b"|")
    return h.hexdigest()


def sample(shapes: Dict[str, str], fixed: Sequence[str], per_shape: int,
           rng: np.random.Generator) -> List[str]:
    """The sampled queries: every fixed query, ``per_shape`` of each
    shape label, and the longest query."""
    by_shape = defaultdict(list)
    for q in sorted(shapes):
        by_shape[shapes[q]].append(q)
    out = list(dict.fromkeys(fixed))
    for label in sorted(by_shape):
        qs = [q for q in by_shape[label] if q not in out]
        pick = rng.choice(len(qs), size=min(per_shape, len(qs)),
                          replace=False)
        out.extend(qs[int(i)] for i in sorted(pick))
    longest = max(shapes, key=lambda q: (len(q.encode()), q))
    if longest not in out:
        out.append(longest)
    return out


class Ledger:
    """The digests of the sampled queries' served answers: the 1st, 2nd,
    4th, 8th, ... of each."""

    def __init__(self, queries: Sequence[str]):
        self.queries = list(queries)
        self._want = set(queries)
        self._seen: Dict[str, int] = defaultdict(int)
        self.served: Dict[str, List[Optional[str]]] = defaultdict(list)
        self.first: Dict[str, object] = {}

    def record(self, batch: Sequence[str], answers) -> None:
        for j, q in enumerate(batch):
            if q not in self._want:
                continue
            self._seen[q] += 1
            n = self._seen[q]
            if n & (n - 1):
                continue  # not a power of two
            ans = answers[j] if answers is not None and j < len(answers) \
                else None
            self.served[q].append(digest(ans))
            self.first.setdefault(q, ans)

    def compare(self, reference: Callable[[str], tuple]) -> Dict[str, int]:
        """The numbers compared, once ``reference(query)`` has answered
        each served query; differences are described on standard
        error."""
        wrong = missing = checked = 0
        for q in self.queries:
            got = self.served.get(q)
            if not got:
                continue
            ref = reference(q)
            want = digest(ref)
            for d in got:
                checked += 1
                if d is None:
                    missing += 1
                elif d != want:
                    wrong += 1
            if any(d is not None and d != want for d in got):
                describe(q, self.first.get(q), ref)
        return {"wrong_answers": wrong, "missing_answers": missing,
                "answers_checked": checked}


def reference_for(ref_corpus, config: dict, k: int, ties: str = "asc"):
    """The reference's answer of a query, each query worked out once."""
    memo = {}

    def ref(q):
        if q not in memo:
            memo[q] = answer(ref_corpus, q, config, k, ties=ties)
        return memo[q]

    return ref


def describe(query: str, got, want) -> None:
    """One line on standard error: where a served answer first differs."""
    msg = f"answer differs: query {query!r}"
    if got is None:
        print(msg + ": none served", file=sys.stderr)
        return
    if int(got[0]) != int(want[0]):
        msg += f": count {int(got[0])} against {int(want[0])}"
    names = ("index", "score", "exact", "end_col")
    for name, g, w in zip(names, got[1:], want[1:]):
        g, w = np.asarray(g).astype(np.int64), np.asarray(w).astype(np.int64)
        if len(g) != len(w):
            msg += f"; {name}: {len(g)} entries against {len(w)}"
            break
        bad = np.nonzero(g != w)[0]
        if len(bad):
            j = int(bad[0])
            msg += (f"; {name}[{j}] = {int(g[j])} against {int(w[j])}"
                    f" ({len(bad)} entries differ)")
            break
    print(msg, file=sys.stderr)


# faults planted in the served answers of the timed path, for the tests
# and the control runs: each takes (answers, previous batch's answers)


def _stale(answers, previous):
    """A step that returns its state unchanged: the previous batch's
    answers served again."""
    return previous if previous is not None else answers


def _half(answers, previous):
    """Half of the batch left out: the second half answers nothing."""
    half = len(answers) // 2
    return list(answers[:half]) + [None] * (len(answers) - half)


def _altered(answers, previous):
    """An answer altered where it is produced: each query's best score
    raised by one."""
    out = []
    for count, index, score, exact, end_col in answers:
        score = np.array(score, copy=True)
        if len(score):
            score[0] += 1
        else:
            count += 1
        out.append((count, index, score, exact, end_col))
    return out


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}
