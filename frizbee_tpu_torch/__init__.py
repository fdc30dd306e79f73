"""frizbee-tpu on PyTorch and CUDA: fuzzy matching and batched top-k
serving on an NVIDIA H100.

The port of ``frizbee_tpu``'s Matcher API and serving path: a resident
packed corpus (byte units, or codepoint units for unicode needles)
answers single queries (``Matcher(q).match_arrays`` / ``match_list`` /
``match_iter``, the one-shot ``match_list``, ``match_list_parallel`` and
``fuzzy_match``; with matched-character indices ``match_list_indices`` /
``match_iter_indices`` and the one-shot ``match_list_indices`` and
``fuzzy_match_indices``, whose traceback runs on the host) and batches
of queries (``match_topk_batch`` / ``match_topk_batch_async`` /
``match_arrays_batch``), also over a corpus sharded on a device mesh
(``match_topk_batch_sharded``; ``parallel.py`` on ``torch.distributed``,
``profiling.py`` for traces and timing). The device kernels
of that path — the column-stream fuzzy and literal matches, the row-major
match and the whole-row gather — are hand-written CUDA for ``sm_90a``
(``csrc/``); everything else is plain PyTorch. Entry points run on the
card unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.

``config``, ``casefold``, ``pattern``, ``datagen``, ``types``, ``sort``
and ``traceback`` (its NumPy branch) are copies of ``frizbee_tpu``'s
modules of the same names: the package imports nothing of
``frizbee_tpu`` and nothing of JAX.
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
    fuzzy_match,
    fuzzy_match_indices,
    match_arrays_batch,
    match_list,
    match_list_indices,
    match_list_parallel,
    match_topk_batch,
    match_topk_batch_async,
)
from .parallel import match_topk_batch_sharded
from .pattern import Pattern, PatternConfig
from .sort import sort_matches
from .types import Match, MatchIndices, MatchList

__version__ = "0.1.0"

__all__ = [
    "BatchFuture",
    "CaseMatching",
    "Config",
    "Corpus",
    "Match",
    "MatchIndices",
    "MatchList",
    "Matcher",
    "Matching",
    "Pattern",
    "PatternConfig",
    "Scoring",
    "SortStrategy",
    "UnicodeMatching",
    "fuzzy_match",
    "fuzzy_match_indices",
    "match_arrays_batch",
    "match_list",
    "match_list_indices",
    "match_list_parallel",
    "match_topk_batch",
    "match_topk_batch_async",
    "match_topk_batch_sharded",
    "pack_corpus",
    "sort_matches",
]
