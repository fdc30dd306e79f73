"""Pure-Python match semantics ("the oracle"): copies of
``frizbee_tpu/oracle/`` (tokenize, prefilter, smith_waterman, greedy,
literal), kept line for line so the host pipelines of the port's engines
score greedy-flagged and XL rows exactly as the reference does.
"""

from .tokenize import HayUnits, NeedleUnits, make_needle_units, tokenize
from .smith_waterman import sw_score, sw_indices, match_end_col
from .greedy import match_greedy
from .prefilter import prefilter_window, lcs_accepts
from .literal import literal_find

__all__ = [
    "HayUnits",
    "NeedleUnits",
    "make_needle_units",
    "tokenize",
    "sw_score",
    "sw_indices",
    "match_end_col",
    "match_greedy",
    "prefilter_window",
    "lcs_accepts",
    "literal_find",
]
