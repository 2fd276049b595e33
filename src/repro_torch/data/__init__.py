"""Training data (port of ``repro/data``): the token pipeline and the
KronDPP batch selector."""

from .pipeline import TokenPipeline, synthetic_corpus
from .dpp_selection import DPPBatchSelector

__all__ = ["TokenPipeline", "synthetic_corpus", "DPPBatchSelector"]
