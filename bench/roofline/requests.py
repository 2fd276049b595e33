"""Algorithmic FLOPs of whole requests and sweeps, for the ``mfu``
metrics: the arithmetic that the request's mathematics needs, counted
from shapes, whatever runs it.
"""

from . import greedy_map


def ffn_prune(positions: int, d_model: int, d_ff: int, keep: int,
              live: int) -> float:
    """One pruning request: RMSNorm (4 a value), the gate and up products
    (2 · 2·P·d·f), SwiGLU (5 a unit value), the column norms and scaling
    (3 a unit value), the unit kernel ÂᵀÂ as a full product (2·P·f²), and
    the greedy MAP of ``keep`` units."""
    P, d, f = float(positions), float(d_model), float(d_ff)
    return (4 * P * d + 4 * P * d * f + 5 * P * f + 3 * P * f
            + 2 * P * f * f + greedy_map.work(d_ff, keep, live)[0])


def krk_sweep(N1: int, N2: int, sizes) -> float:
    """One KrK-Picard sweep (Mariet & Sra 2016, Alg. 1 and Appendix B):
    two Θ builds, at L and at the updated L1 (each subset of s items a
    block product s² and an inverse s³, and Θ's scaling N²), A once and C
    once (2N² each), and the factor updates (three N_f³ products and an
    eigendecomposition, ~9 N_f³, for each half)."""
    N = float(N1) * N2
    theta = 2 * (sum(float(s) ** 2 + float(s) ** 3 for s in sizes) + N * N)
    return theta + 2 * 2 * N * N + 2 * 9.0 * (N1 ** 3 + N2 ** 3)


def krk_log_likelihood(N1: int, N2: int, sizes) -> float:
    """One log-likelihood: each subset's log-determinant (s³/3) and the two
    factor spectra (~9 N_f³)."""
    return sum(float(s) ** 3 / 3 for s in sizes) + 9.0 * (N1 ** 3 + N2 ** 3)
