"""Query parsing and needle units, written from saghen/frizbee's documented
semantics (src/pattern.rs, src/prefilter/mod.rs, src/lib.rs):

- a query is whitespace-separated atoms; ``!`` negates, ``^`` anchors a
  prefix, ``'`` asks for a substring (not after ``^``), a trailing ``$``
  a suffix, ``^...$`` an exact match; an atom with none of them is fuzzy;
  a bare negated atom matches substrings; atoms whose needle is empty are
  dropped;
- smart case: a needle with an uppercase letter is case-sensitive, else
  each unit also matches its opposite case (ASCII bytes on the byte path,
  a 1:1 same-length case flip of a codepoint on the unicode path);
- smart unicode: a non-ASCII needle matches codepoint units, else bytes.

Backslash escapes are not supported: the benchmark's traffic has none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

FUZZY, EXACT, PREFIX, SUFFIX, SUBSTRING = (
    "fuzzy", "exact", "prefix", "suffix", "substring")


@dataclass(frozen=True)
class Atom:
    needle: str
    negated: bool
    mode: str
    # unit values (bytes or codepoints) as written and with the case flip
    orig: Tuple[int, ...]
    flip: Tuple[int, ...]
    # per unit, its UTF-8 bytes as written and flipped (the literal path
    # compares bytes on either unit mode)
    orig_bytes: Tuple[bytes, ...]
    flip_bytes: Tuple[bytes, ...]
    unicode: bool
    case_sensitive: bool

    @property
    def needle_bytes(self) -> bytes:
        return self.needle.encode("utf-8")


def _flip_byte(c: int) -> int:
    if 0x61 <= c <= 0x7A:
        return c - 0x20
    if 0x41 <= c <= 0x5A:
        return c + 0x20
    return c


def _flip_char(c: str) -> str:
    if c.isupper():
        f = c.lower()
    elif c.islower():
        f = c.upper()
    else:
        return c
    if len(f) == 1 and len(f.encode("utf-8")) == len(c.encode("utf-8")):
        return f
    return c


def make_atom(needle: str, negated: bool, mode: str) -> Atom:
    case_sensitive = any(c.isupper() for c in needle)
    unicode = not needle.isascii()
    if unicode:
        chars = list(needle)
        flips = chars if case_sensitive else [_flip_char(c) for c in chars]
        orig = tuple(ord(c) for c in chars)
        flip = tuple(ord(c) for c in flips)
        ob = tuple(c.encode("utf-8") for c in chars)
        fb = tuple(c.encode("utf-8") for c in flips)
    else:
        raw = needle.encode("utf-8")
        orig = tuple(raw)
        flip = orig if case_sensitive else tuple(_flip_byte(c) for c in raw)
        ob = tuple(bytes([c]) for c in orig)
        fb = tuple(bytes([c]) for c in flip)
    return Atom(needle, negated, mode, orig, flip, ob, fb, unicode,
                case_sensitive)


def parse_atom(atom: str, default_mode: str = FUZZY) -> Optional[Atom]:
    if "\\" in atom:
        raise ValueError(f"escapes are not supported: {atom!r}")
    rest = atom
    negated = rest.startswith("!")
    if negated:
        rest = rest[1:]
    prefix = rest.startswith("^")
    if prefix:
        rest = rest[1:]
    substring = not prefix and rest.startswith("'")
    if substring:
        rest = rest[1:]
    suffix = rest.endswith("$")
    if suffix:
        rest = rest[:-1]
    if not rest:
        return None
    if prefix and suffix:
        mode = EXACT
    elif prefix:
        mode = PREFIX
    elif suffix:
        mode = SUFFIX
    elif substring or negated:
        mode = SUBSTRING
    else:
        mode = default_mode
    return make_atom(rest, negated, mode)


def parse_query(query: str, default_mode: str = FUZZY) -> List[Atom]:
    atoms = (parse_atom(a, default_mode) for a in query.split())
    return [a for a in atoms if a is not None]
