"""Core types, Kronecker algebra and the KrK-Picard step of the port
(``repro/core``)."""

from .dpp import SubsetBatch, log_likelihood, marginal_kernel
from .kron import split_indices_multi
from .krk_picard import (AC_from_dense_theta, accumulate_AC, compute_AC,
                         krk_picard_step, krk_picard_stochastic_step)
from .krondpp import KronDPP, random_krondpp

__all__ = ["SubsetBatch", "log_likelihood", "marginal_kernel",
           "split_indices_multi", "KronDPP", "random_krondpp",
           "krk_picard_step", "krk_picard_stochastic_step", "accumulate_AC",
           "AC_from_dense_theta", "compute_AC"]
