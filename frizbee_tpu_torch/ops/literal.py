"""Literal matching modes (the statics of ``frizbee_tpu/ops/literal.py``).

The column-stream literal kernel (``ops/colstream.py``,
``csrc/colstream_literal.cu``) serves every mode; the generic (B, W)
literal pipelines of the reference come with a later slice.
"""

# mode statics
EXACT, PREFIX, SUFFIX, SUBSTRING = "exact", "prefix", "suffix", "substring"

LITERAL_MODES = (EXACT, PREFIX, SUFFIX, SUBSTRING)
