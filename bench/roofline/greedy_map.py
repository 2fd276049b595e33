"""Greedy MAP of k items of an N x N kernel (``greedy_map_kdpp``; Chen et
al. 2018): step t scores the N items (2N) and, while the pick is live,
takes the dot of each item's t-column prefix (2Nt) and updates its score
and column (4N). Bytes: the diagonal, and one column of L a live step,
read once; the k picks written once; 4-byte words.
"""

from typing import List, Tuple


def work(N: int, k: int, live: int) -> Tuple[float, float]:
    """(flops, bytes) of one selection whose first ``live`` steps are
    live."""
    flops = 2.0 * N * k + sum(2.0 * N * t + 4.0 * N for t in range(live))
    nbytes = 4.0 * (N + live * N) + 4.0 * k
    return flops, nbytes


def of_record(rec: dict) -> List[Tuple[float, float]]:
    """A record's greedy-MAP selection: ``map_size`` items, every pick of
    ``picks`` (-1 pads past the live steps) one live step."""
    if "map_size" not in rec:
        return []
    picks = rec["picks"]
    k = int(picks.shape[-1])
    return [work(int(rec["map_size"]), k, int((picks >= 0).sum()))]
