"""Unit tokenization shared by the oracle and the batch engine.

The reference scores the ASCII path one needle row per *byte* and the unicode
path one row per *codepoint*, with UTF-8 continuation bytes acting as free
"transport lanes" in the gap propagation (reference:
src/smith_waterman/algo/unicode_gap.rs:1-104). Collapsing the haystack to its
scalar sequence makes the two paths one algorithm: a DP over *units*, where a
unit is a byte (ASCII path) or a codepoint (unicode path). Per-unit bonus
context is derived from the unit's first byte and the previous unit's last
byte, which reproduces the reference's byte-level mask algebra exactly
(reference: src/smith_waterman/algo/ascii.rs:64-100,
src/smith_waterman/algo/unicode.rs:95-128).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..casefold import case_needle_bytes, case_needle_unicode


@dataclass
class HayUnits:
    """Haystack tokenized into match units."""

    # Unit value: byte (ASCII path) or Unicode codepoint (unicode path)
    cp: List[int]
    # First byte of each unit (== cp on the ASCII path)
    first_byte: List[int]
    # Last byte of the *previous* unit; -1 for the first unit when nothing
    # precedes it in the window
    prev_last_byte: List[int]
    # Byte offset of each unit's start within the full haystack
    byte_off: List[int]
    # Byte length of each unit
    byte_len: List[int]


@dataclass
class NeedleUnits:
    """Needle tokenized into (original, case-flipped) unit values."""

    orig: List[int]
    flip: List[int]
    # Byte length of each needle unit (1 on the ASCII path)
    byte_len: List[int]


def make_needle_units(needle: str, unicode: bool, case_sensitive: bool) -> NeedleUnits:
    if unicode:
        pairs = case_needle_unicode(needle, case_sensitive)
        return NeedleUnits(
            orig=[ord(o) for o, _ in pairs],
            flip=[ord(f) for _, f in pairs],
            byte_len=[len(o.encode("utf-8")) for o, _ in pairs],
        )
    pairs = case_needle_bytes(needle.encode("utf-8"), case_sensitive)
    return NeedleUnits(
        orig=[o for o, _ in pairs],
        flip=[f for _, f in pairs],
        byte_len=[1] * len(pairs),
    )


def _utf8_len(lead: int) -> int:
    if lead < 0x80:
        return 1
    if lead < 0xC0:
        return 1  # dangling continuation byte; treated as transport-only
    if lead < 0xE0:
        return 2
    if lead < 0xF0:
        return 3
    return 4


def tokenize(
    haystack: bytes,
    unicode: bool,
    wstart: int = 0,
    wend: Optional[int] = None,
) -> HayUnits:
    """Tokenize ``haystack[wstart:wend]`` into units.

    On the unicode path, leading dangling continuation bytes (a window that
    starts mid-scalar, possible after the window trim's ``start - 1``) only
    contribute bonus context to the following scalar, and a trailing partial
    scalar is dropped — both matching the byte-level scorer, where such lanes
    can never hold a match (reference: src/matcher/algo.rs:332-338,
    src/smith_waterman/algo/unicode.rs:244-260).
    """
    if wend is None:
        wend = len(haystack)
    window = haystack[wstart:wend]

    if not unicode:
        cps = list(window)
        offs = list(range(wstart, wend))
        prev = [-1] + cps[:-1] if cps else []
        return HayUnits(
            cp=cps,
            first_byte=cps,
            prev_last_byte=prev,
            byte_off=offs,
            byte_len=[1] * len(cps),
        )

    cp: List[int] = []
    first_byte: List[int] = []
    prev_last_byte: List[int] = []
    byte_off: List[int] = []
    byte_len: List[int] = []

    i = 0
    prev_last = -1
    # Skip leading dangling continuation bytes, remembering the last one as
    # the bonus context for the first full scalar
    while i < len(window) and 0x80 <= window[i] < 0xC0:
        prev_last = window[i]
        i += 1

    while i < len(window):
        lead = window[i]
        n = _utf8_len(lead)
        if i + n > len(window):
            break  # trailing partial scalar: can never match
        chunk = window[i : i + n]
        try:
            code = chunk.decode("utf-8")
            val = ord(code) if len(code) == 1 else lead
        except (UnicodeDecodeError, TypeError):
            val = lead  # invalid sequence: unit value is the lead byte
        cp.append(val)
        first_byte.append(lead)
        prev_last_byte.append(prev_last)
        byte_off.append(wstart + i)
        byte_len.append(n)
        prev_last = chunk[-1]
        i += n

    return HayUnits(
        cp=cp,
        first_byte=first_byte,
        prev_last_byte=prev_last_byte,
        byte_off=byte_off,
        byte_len=byte_len,
    )


def is_ascii_upper(b: int) -> bool:
    return 0x41 <= b <= 0x5A


def is_ascii_lower(b: int) -> bool:
    return 0x61 <= b <= 0x7A


def is_ascii_digit(b: int) -> bool:
    return 0x30 <= b <= 0x39


def is_delimiter(b: int) -> bool:
    """Non-alphanumeric ASCII bytes are delimiters (reference:
    src/smith_waterman/algo/ascii.rs:84-93). Negative = no byte = false."""
    return 0 <= b <= 127 and not (
        is_ascii_upper(b) or is_ascii_lower(b) or is_ascii_digit(b)
    )
