"""Result types: ``Match``, the array-backed ``MatchList`` and the
``MatchIndices`` record.

Copy of ``frizbee_tpu/types.py`` (reference: src/lib.rs:141-232) with the
same ordering contract, (score desc, index asc). ``Match`` binds to the C
type of ``native/fastmatch.c`` at import; the dataclass stays as
``PY_MATCH``, its behavioral oracle.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import List


@dataclass(slots=True)
class Match:
    """One matched haystack (reference: src/lib.rs:141-152): the
    pure-Python record, kept as ``PY_MATCH`` once ``Match`` binds to the
    C type."""

    score: int = 0
    index: int = 0
    exact: bool = False
    # 0-based haystack byte offset where the best alignment ends
    # (reference feature `match_end_col`, src/lib.rs:149-152). Always populated.
    end_col: int = 0

    @classmethod
    def from_index(cls, index: int) -> "Match":
        return cls(score=0, index=index, exact=False, end_col=0)

    # JSON round-tripping (the analog of the reference's serde derives on
    # Match, src/lib.rs:141-152)
    def to_dict(self) -> dict:
        return {"score": self.score, "index": self.index,
                "exact": self.exact, "end_col": self.end_col}

    @classmethod
    def from_dict(cls, d: dict) -> "Match":
        return cls(int(d["score"]), int(d["index"]),
                   bool(d.get("exact", False)), int(d.get("end_col", 0)))

    def sort_key(self):
        return (-self.score, self.index)

    def __lt__(self, other: "Match") -> bool:
        return self.sort_key() < other.sort_key()


class MatchList(Sequence):
    """Array-backed lazy sequence of :class:`Match`.

    ``match_list`` returns match data as four numpy columns; building a
    Python ``Match`` object per row costs ~4 orders of magnitude more than
    the arrays themselves on large result sets (the reference's
    empty-needle copy path is a 16 us memcpy for 100k rows,
    BENCHMARKS.md:187-205 — eager object construction here was ~61 ms).
    This sequence defers object construction to element access, so holding
    or slicing a huge result list is O(1) per row until a row is touched.

    Equality compares element-wise against any sequence of ``Match``, so
    it interoperates with plain lists in either operand position.
    """

    __slots__ = ("_index", "_score", "_exact", "_end_col")
    __hash__ = None

    def __init__(self, index, score=None, exact=None, end_col=None):
        import numpy as np

        n = len(index)
        self._index = np.asarray(index)
        self._score = (
            np.zeros(n, np.int64) if score is None else np.asarray(score)
        )
        self._exact = (
            np.zeros(n, bool) if exact is None else np.asarray(exact)
        )
        self._end_col = (
            np.zeros(n, np.int64) if end_col is None else np.asarray(end_col)
        )

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return MatchList(
                self._index[i], self._score[i],
                self._exact[i], self._end_col[i],
            )
        return Match(
            score=int(self._score[i]),
            index=int(self._index[i]),
            exact=bool(self._exact[i]),
            end_col=int(self._end_col[i]),
        )

    def __iter__(self):
        import numpy as np

        # one C loop builds every object (native/fastmatch.c)
        return iter(build_matches(
            np.ascontiguousarray(self._index, np.int64),
            np.ascontiguousarray(self._score, np.int64),
            np.ascontiguousarray(self._exact, np.uint8),
            np.ascontiguousarray(self._end_col, np.int64),
        ))

    def arrays(self):
        """The underlying (index, score, exact, end_col) columns."""
        return self._index, self._score, self._exact, self._end_col

    def __eq__(self, other) -> bool:
        if isinstance(other, MatchList):
            import numpy as np

            return (
                len(self) == len(other)
                and bool(np.array_equal(self._index, other._index))
                and bool(np.array_equal(self._score, other._score))
                and bool(np.array_equal(self._exact, other._exact))
                and bool(np.array_equal(self._end_col, other._end_col))
            )
        if isinstance(other, Sequence) and not isinstance(other, str):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self) -> str:
        if len(self) > 8:
            head = ", ".join(repr(m) for m in self[:4])
            return f"MatchList([{head}, ... {len(self)} matches])"
        return f"MatchList({list(self)!r})"


@dataclass(slots=True)
class MatchIndices:
    score: int = 0
    index: int = 0
    exact: bool = False
    # Matched haystack byte offsets in reverse order (reference: src/lib.rs:191-211)
    indices: List[int] = field(default_factory=list)

    @classmethod
    def from_index(cls, index: int) -> "MatchIndices":
        return cls(score=0, index=index, exact=False, indices=[])

    def to_dict(self) -> dict:
        return {"score": self.score, "index": self.index,
                "exact": self.exact, "indices": list(self.indices)}

    @classmethod
    def from_dict(cls, d: dict) -> "MatchIndices":
        return cls(int(d["score"]), int(d["index"]),
                   bool(d.get("exact", False)),
                   [int(i) for i in d.get("indices", [])])

    def sort_key(self):
        return (-self.score, self.index)

    def __lt__(self, other: "MatchIndices") -> bool:
        return self.sort_key() < other.sort_key()


# ---- C extension Match (native/fastmatch.c) --------------------------------
# The dataclass above stays as PY_MATCH: the behavioral oracle the C type is
# held to (construction, mutation, equality, ordering, repr, serde, pickle).
# ``Match`` and ``build_matches`` (the bulk column -> list constructor that
# MatchList.__iter__ and the iterator APIs use) bind to the extension at
# import, so the class identity is stable for the process lifetime; the
# one-time gcc build is the price. A failed build raises here.
PY_MATCH = Match


def _rebuild_match(score, index, exact, end_col):
    """Pickle factory referenced by the C ``Match.__reduce__``, at a stable
    importable path: unpickling builds whatever ``Match`` binds to here."""
    return Match(score, index, exact, end_col)


def _bind_fastmatch():
    from .native import get_fastmatch

    fm = get_fastmatch()
    return fm.Match, fm.build_matches


Match, build_matches = _bind_fastmatch()
