"""Subset clustering (paper Sec. 3.3; port of ``repro/core/clustering.py``)
— greedy approximation to the Subset-Union Knapsack partition.

Partition training subsets {Y_1..Y_n} into clusters S_1..S_m with
|union(S_k)| <= z, so Θ decomposes into m sparse blocks of at most z²
nonzeros: O(mz² + N) memory instead of O(N²).

Exact minimization of m is NP-hard (SUKP); the paper suggests a greedy
construction, implemented here: place each subset in the cluster whose
union grows least, opening a new cluster when the budget would be
exceeded. Pure Python, so the port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Set


@dataclasses.dataclass
class Clustering:
    assignments: List[int]          # cluster id per subset
    unions: List[Set[int]]          # ground-set union per cluster

    @property
    def m(self) -> int:
        return len(self.unions)

    def memory_nonzeros(self) -> int:
        return sum(len(u) ** 2 for u in self.unions)


def greedy_subset_clustering(subsets: Sequence[Sequence[int]], z: int,
                             order: str = "size_desc") -> Clustering:
    """Greedy SUKP-style partition with union budget z per cluster;
    ``order="size_desc"`` places the largest subsets first. Raises
    ``ValueError`` for a subset larger than z."""
    idx = list(range(len(subsets)))
    if order == "size_desc":
        idx.sort(key=lambda i: -len(subsets[i]))
    unions: List[Set[int]] = []
    assign = [0] * len(subsets)
    for i in idx:
        Y = set(subsets[i])
        if len(Y) > z:
            raise ValueError(f"subset {i} has {len(Y)} > budget z={z}")
        best, best_growth = -1, None
        for c, u in enumerate(unions):
            new = len(u | Y)
            if new <= z:
                growth = new - len(u)
                if best_growth is None or growth < best_growth:
                    best, best_growth = c, growth
                    if growth == 0:
                        break
        if best < 0:
            unions.append(set(Y))
            assign[i] = len(unions) - 1
        else:
            unions[best] |= Y
            assign[i] = best
    return Clustering(assign, unions)
