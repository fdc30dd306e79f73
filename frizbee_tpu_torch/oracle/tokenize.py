"""Needle tokenization into match units (the subset of
``frizbee_tpu/oracle/tokenize.py`` the batch serving path reads).

A unit is a byte on the ASCII path and a codepoint on the unicode path;
each needle unit carries its original value and its case-flipped twin
(reference: src/prefilter/mod.rs:49-96).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..casefold import case_needle_bytes, case_needle_unicode


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

