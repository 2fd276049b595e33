"""The partial traces of a dense Θ (N x N, N = N1·N2) against a factor:
A (N1 x N1) = Σ_uv Θ[(k,u),(l,v)] L2[v,u] and C (N2 x N2) =
Σ_ij L1[i,j] Θ[(i,u),(j,v)]. Each takes one multiply and one add an entry
of Θ (2N²); bytes: Θ, the factor and the output once each, 4-byte words.
A KrK-Picard sweep (Alg. 1) needs A once, at the sweep's L, and C once, at
the updated L1.
"""

from typing import List, Tuple


def work(N1: int, N2: int) -> Tuple[float, float]:
    """(flops, bytes) of one partial trace, A or C."""
    N = float(N1) * N2
    return 2.0 * N * N, 4.0 * (N * N + N1 * N1 + N2 * N2)


def of_record(rec: dict) -> List[Tuple[float, float]]:
    """A record's ``sweeps`` of a Kronecker kernel of ``factor_sizes``: one
    A and one C each."""
    if "sweeps" not in rec:
        return []
    N1, N2 = rec["factor_sizes"]
    return [work(N1, N2)] * (2 * int(rec["sweeps"]))
