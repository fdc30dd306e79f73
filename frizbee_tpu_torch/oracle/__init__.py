"""Host-side tokenization shared by the engines."""

from .tokenize import NeedleUnits, make_needle_units

__all__ = ["NeedleUnits", "make_needle_units"]
