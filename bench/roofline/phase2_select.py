"""Phase 2 of a batch of DPP draws (``phase2_select``): the projection
chain rule over N = N1·Nr items for each row of the batch.

A row that picks s items from its s kept eigenvectors needs: the norms of
its N rows of s columns (2Ns); at each step t < s, the running sum and its
search (2N) and two Gram-Schmidt passes of the picked row against the t
basis columns (8st); after every step but the last, the downdate of the N
norms (2Ns + 3N). Bytes: the uniforms (k_max a row), the row's size, the
two factor column blocks (N1 + Nr rows of k_max) read once, the picks
(k_max a row) written once, in 4-byte words.
"""

from typing import List, Sequence, Tuple

import numpy as np


def work(N1: int, Nr: int, k_max: int, sizes: Sequence[int]
         ) -> Tuple[float, float]:
    """(flops, bytes) of one launch over rows of ``sizes`` picks."""
    N = float(N1) * Nr
    s = np.asarray(sizes, np.float64)
    # Σ_t<s (2N + 8st) = 2Ns + 4s²(s - 1)
    flops = float((2.0 * N * s + 2.0 * N * s + 4.0 * s * s * (s - 1.0)
                   + np.maximum(s - 1.0, 0.0) * (2.0 * N * s + 3.0 * N))
                  .sum())
    B = len(s)
    nbytes = 4.0 * B * (k_max + 1 + (N1 + Nr) * k_max + k_max)
    return flops, nbytes


def of_record(rec: dict) -> List[Tuple[float, float]]:
    """A record's batch of draws from a Kronecker kernel of
    ``factor_sizes``: ``picks`` (B, k_max), -1 past each row's size."""
    if "factor_sizes" not in rec or "picks" not in rec:
        return []
    sizes = rec["factor_sizes"]
    picks = rec["picks"]
    return [work(int(sizes[0]), int(np.prod(sizes[1:])), picks.shape[1],
                 (picks >= 0).sum(1))]
