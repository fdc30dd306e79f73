"""Query/pattern parsing.

Port of the reference's atom syntax and per-pattern config overrides
(reference: src/pattern.rs:100-262):

- ``foo``  fuzzy (defers to Config.matching)
- ``^foo`` prefix, ``foo$`` suffix, ``'foo`` substring, ``^foo$`` exact
- ``!foo`` negated; a bare negated atom matches substrings
- backslash escapes any special char, including ``\\ `` for a literal space
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import List, Optional

from .config import CaseMatching, Config, Matching, Scoring, UnicodeMatching

_SPECIAL = {"!", "^", "'", "$"}


@dataclass(frozen=True)
class PatternConfig:
    """Per-pattern overrides of the matcher's Config; ``None`` inherits
    (reference: src/pattern.rs:227-262)."""

    max_typos: Optional[int] = None
    casing: Optional[CaseMatching] = None
    unicode: Optional[UnicodeMatching] = None
    matching: Optional[Matching] = None
    scoring: Optional[Scoring] = None

    def resolve(self, config: Config) -> Config:
        """Merge against the matcher config; ``sort`` is never per-pattern
        (reference: src/pattern.rs:250-262)."""
        return Config(
            max_typos=self.max_typos if self.max_typos is not None else config.max_typos,
            casing=self.casing or config.casing,
            unicode=self.unicode or config.unicode,
            matching=self.matching or config.matching,
            scoring=self.scoring or config.scoring,
            sort=config.sort,
        )

    def with_(self, **kwargs) -> "PatternConfig":
        return replace(self, **kwargs)

    # JSON round-tripping (serde-derive analog; None = inherit survives)
    def to_dict(self) -> dict:
        return {
            "max_typos": self.max_typos,
            "casing": self.casing.value if self.casing else None,
            "unicode": self.unicode.value if self.unicode else None,
            "matching": self.matching.value if self.matching else None,
            "scoring": (
                dataclasses.asdict(self.scoring) if self.scoring else None
            ),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PatternConfig":
        return cls(
            max_typos=d.get("max_typos"),
            casing=CaseMatching(d["casing"]) if d.get("casing") else None,
            unicode=(
                UnicodeMatching(d["unicode"]) if d.get("unicode") else None
            ),
            matching=Matching(d["matching"]) if d.get("matching") else None,
            scoring=Scoring(**d["scoring"]) if d.get("scoring") else None,
        )


@dataclass(frozen=True)
class Pattern:
    """A single parsed query atom (reference: src/pattern.rs:7-19)."""

    pattern: str
    negated: bool = False
    needle: str = ""
    config: PatternConfig = field(default_factory=PatternConfig)

    @classmethod
    def literal(cls, needle: str, config: PatternConfig = PatternConfig()) -> "Pattern":
        """A pattern matching the needle literally, no syntax parsing
        (reference: ``Pattern::new``, src/pattern.rs:43-50)."""
        return cls(pattern=needle, negated=False, needle=needle, config=config)

    def with_(self, **kwargs) -> "Pattern":
        return replace(self, **kwargs)

    def to_dict(self) -> dict:
        return {
            "pattern": self.pattern,
            "negated": self.negated,
            "needle": self.needle,
            "config": self.config.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Pattern":
        return cls(
            pattern=d["pattern"],
            negated=bool(d.get("negated", False)),
            needle=d.get("needle", ""),
            config=PatternConfig.from_dict(d.get("config") or {}),
        )

    @classmethod
    def parse(cls, atom: str) -> "Pattern":
        """Parse one atom (reference: src/pattern.rs:100-165)."""
        # Tokenize, marking escaped chars
        tokens: List[tuple] = []
        it = iter(atom)
        for c in it:
            if c == "\\":
                nxt = next(it, None)
                if nxt is not None:
                    tokens.append((nxt, True))
                else:
                    tokens.append((c, False))
            else:
                tokens.append((c, False))

        rest = tokens

        def strip_first(op: str) -> bool:
            nonlocal rest
            if rest and rest[0] == (op, False):
                rest = rest[1:]
                return True
            return False

        def strip_last(op: str) -> bool:
            nonlocal rest
            if rest and rest[-1] == (op, False):
                rest = rest[:-1]
                return True
            return False

        negated = strip_first("!")
        prefix = strip_first("^")
        substring = (not prefix) and strip_first("'")
        suffix = strip_last("$")

        # Escaped non-special chars keep their backslash
        def is_special(c: str) -> bool:
            return c in _SPECIAL or c.isspace()

        needle_parts: List[str] = []
        for c, escaped in rest:
            if escaped and not is_special(c):
                needle_parts.append("\\")
            needle_parts.append(c)
        needle = "".join(needle_parts)

        if prefix and suffix:
            matching: Optional[Matching] = Matching.EXACT
        elif prefix:
            matching = Matching.PREFIX
        elif suffix:
            matching = Matching.SUFFIX
        elif substring:
            matching = Matching.SUBSTRING
        elif negated:
            # Bare negated atoms match substrings, like fzf and nucleo
            # (reference: src/pattern.rs:153-156)
            matching = Matching.SUBSTRING
        else:
            matching = None

        return cls(
            pattern=atom,
            negated=negated,
            needle=needle,
            config=PatternConfig(matching=matching),
        )

    @classmethod
    def parse_query(cls, query: str) -> List["Pattern"]:
        """Parse a whitespace-separated query; empty needles dropped
        (reference: src/pattern.rs:190-222)."""
        patterns: List[Pattern] = []
        start: Optional[int] = None
        escaped = False

        def push(atom: str) -> None:
            p = cls.parse(atom)
            if p.needle:
                patterns.append(p)

        for i, c in enumerate(query):
            if escaped:
                escaped = False
            elif c == "\\":
                if start is None:
                    start = i
                escaped = True
            elif c.isspace():
                if start is not None:
                    push(query[start:i])
                    start = None
            elif start is None:
                start = i
        if start is not None:
            push(query[start:])
        return patterns
