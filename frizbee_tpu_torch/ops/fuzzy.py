"""Scoring vector layout shared with ``frizbee_tpu/ops/fuzzy.py``."""

# Scoring vector layout (int32, shape (9,)):
#   0 match, 1 mismatch, 2 gap_open, 3 gap_extend, 4 prefix,
#   5 capitalization, 6 matching_case, 7 exact, 8 delimiter
SCORING_FIELDS = (
    "match_score",
    "mismatch_penalty",
    "gap_open_penalty",
    "gap_extend_penalty",
    "prefix_bonus",
    "capitalization_bonus",
    "matching_case_bonus",
    "exact_match_bonus",
    "delimiter_bonus",
)
