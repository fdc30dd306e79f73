"""The benchmark's plain reference: saghen/frizbee's matching semantics
written again in plain PyTorch (vectorised over rows, run in blocks on
any device) from the corpus strings and the query text alone: the query
syntax, the prefilter and its trimmed window, the Smith-Waterman DP over
windows up to 1,024 bytes and the greedy matcher over longer ones, the
literal modes and the multi-atom combine, on rows of any length. It
imports nothing of the program under test."""

from .serve import Corpus, answer

__all__ = ["Corpus", "answer"]
