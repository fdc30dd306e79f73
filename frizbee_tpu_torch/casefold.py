"""Case folding used for case-insensitive matching.

Mirrors the reference's per-unit "(original, opposite-case)" pairing:
bytes for the ASCII path (reference: src/prefilter/mod.rs:49-65) and whole
codepoints for the unicode path (reference: src/prefilter/mod.rs:71-96).
Multi-char or length-changing case folds (e.g. ``ß`` -> ``SS``) are ignored,
exactly like the reference.
"""

from __future__ import annotations

from typing import List, Tuple


def flip_byte(c: int) -> int:
    """ASCII case flip of a byte; identity for non-letters."""
    if 0x61 <= c <= 0x7A:  # a-z
        return c - 0x20
    if 0x41 <= c <= 0x5A:  # A-Z
        return c + 0x20
    return c


def case_needle_bytes(needle: bytes, case_sensitive: bool) -> List[Tuple[int, int]]:
    """Per-byte (original, flipped) pairs (reference: src/prefilter/mod.rs:49-65)."""
    if case_sensitive:
        return [(c, c) for c in needle]
    return [(c, flip_byte(c)) for c in needle]


def flip_char(c: str) -> str:
    """Opposite-case codepoint, or ``c`` itself when the flip is not a 1:1
    length-preserving mapping (reference: src/prefilter/mod.rs:71-96)."""
    if c.isupper():
        flipped = c.lower()
    elif c.islower():
        flipped = c.upper()
    else:
        return c
    if len(flipped) == 1 and len(flipped.encode("utf-8")) == len(c.encode("utf-8")):
        return flipped
    return c


def case_needle_unicode(needle: str, case_sensitive: bool) -> List[Tuple[str, str]]:
    """Per-codepoint (original, flipped) pairs; flipped == original when
    case-sensitive."""
    if case_sensitive:
        return [(c, c) for c in needle]
    return [(c, flip_char(c)) for c in needle]
