"""The benchmark's plain reference: saghen/frizbee's matching semantics
written again in plain PyTorch (vectorised over rows, run in blocks on
any device) from the corpus strings and the query text alone. It imports
nothing of the program under test."""

from .serve import Corpus, answer

__all__ = ["Corpus", "answer"]
