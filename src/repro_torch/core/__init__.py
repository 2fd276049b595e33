"""Core types, Kronecker algebra, the KrK-Picard step, the host samplers,
the kernel-free greedy MAP and the subset clustering of the port
(``repro/core``)."""

from . import clustering, dpp, kron, sampling
from .clustering import greedy_subset_clustering
from .dpp import SubsetBatch, log_likelihood, marginal_kernel, picard_delta
from .kron import split_indices_multi
from .krk_picard import (AC_from_dense_theta, accumulate_AC, compute_AC,
                         krk_picard_step, krk_picard_stochastic_step)
from .krondpp import KronDPP, random_krondpp
from .sampling import greedy_map_kdpp, sample_full_dpp, sample_krondpp

__all__ = ["SubsetBatch", "log_likelihood", "marginal_kernel",
           "picard_delta", "split_indices_multi", "KronDPP",
           "random_krondpp", "krk_picard_step", "krk_picard_stochastic_step",
           "accumulate_AC", "AC_from_dense_theta", "compute_AC",
           "sample_full_dpp", "sample_krondpp", "greedy_map_kdpp",
           "greedy_subset_clustering", "kron", "dpp", "sampling",
           "clustering"]
