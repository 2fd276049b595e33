"""Core types and Kronecker algebra of the port (``repro/core``)."""

from .dpp import SubsetBatch, marginal_kernel
from .kron import split_indices_multi
from .krondpp import KronDPP, random_krondpp

__all__ = ["SubsetBatch", "marginal_kernel", "split_indices_multi",
           "KronDPP", "random_krondpp"]
