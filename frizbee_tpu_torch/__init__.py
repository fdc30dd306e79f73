"""frizbee-tpu on PyTorch and CUDA: batched top-k fuzzy serving on an
NVIDIA H100.

The port of ``frizbee_tpu``'s serving main path: a resident packed
corpus (byte units, or codepoint units for unicode needles) answers
batches of single-pattern fuzzy and literal queries through
``match_topk_batch`` / ``match_topk_batch_async``. The device kernels of
that path — the column-stream fuzzy and literal matches, the row-major
match and the whole-row gather — are hand-written CUDA for ``sm_90a``
(``csrc/``); everything else is plain PyTorch. Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.

``config``, ``casefold``, ``pattern`` and ``datagen`` are copies of
``frizbee_tpu``'s modules of the same names: the package imports nothing
of ``frizbee_tpu`` and nothing of JAX.
"""

from .config import (
    CaseMatching,
    Config,
    Matching,
    Scoring,
    SortStrategy,
    UnicodeMatching,
)
from .corpus import Corpus, pack_corpus
from .matcher import (
    BatchFuture,
    Matcher,
    match_topk_batch,
    match_topk_batch_async,
)
from .pattern import Pattern, PatternConfig

__version__ = "0.1.0"

__all__ = [
    "BatchFuture",
    "CaseMatching",
    "Config",
    "Corpus",
    "Matcher",
    "Matching",
    "Pattern",
    "PatternConfig",
    "Scoring",
    "SortStrategy",
    "UnicodeMatching",
    "match_topk_batch",
    "match_topk_batch_async",
    "pack_corpus",
]
