"""Core types, Kronecker algebra, the KrK-Picard step and its sharded
sweep over a ``Mesh``, the full-Picard, joint-Picard and EM baselines, the
host samplers, the kernel-free greedy MAP and the subset clustering of the
port (``repro/core``)."""

from . import clustering, distributed, dpp, em, kron, sampling
from .clustering import greedy_subset_clustering
from .distributed import (make_distributed_krk_step,
                          make_distributed_krk_sweep, shard_select_no_replace,
                          shard_subsets)
from .dpp import SubsetBatch, log_likelihood, marginal_kernel, picard_delta
from .kron import split_indices_multi
from .joint_picard import joint_picard_step
from .krk_picard import (AC_from_dense_theta, accumulate_AC, compute_AC,
                         krk_picard_step, krk_picard_stochastic_step)
from .krondpp import KronDPP, random_krondpp
from .picard import PicardResult, fit_picard, picard_step
from .sampling import greedy_map_kdpp, sample_full_dpp, sample_krondpp

__all__ = ["SubsetBatch", "log_likelihood", "marginal_kernel",
           "picard_delta", "split_indices_multi", "KronDPP",
           "random_krondpp", "krk_picard_step", "krk_picard_stochastic_step",
           "accumulate_AC", "AC_from_dense_theta", "compute_AC",
           "picard_step", "fit_picard", "PicardResult", "joint_picard_step",
           "sample_full_dpp", "sample_krondpp", "greedy_map_kdpp",
           "greedy_subset_clustering", "make_distributed_krk_step",
           "make_distributed_krk_sweep", "shard_select_no_replace",
           "shard_subsets", "kron", "dpp", "sampling", "clustering", "em",
           "distributed"]
