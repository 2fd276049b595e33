"""Pruning a mixture-of-experts layer's units: the work of one request
(for ``mfu.moe``) and of its greedy-MAP selections (for
``expert_map_roofline``), counted from shapes and the records' picks.

A record of such a request holds ``expert_size`` (f) with
``expert_picks`` (E, k), one selection of k units of f an expert, and
``shared_size`` (fs) with ``shared_picks`` (ks,), the shared experts'
selection; -1 pads past a selection's live steps.
"""

from typing import List, Tuple

from . import greedy_map


def of_record(rec: dict) -> List[Tuple[float, float]]:
    """The record's greedy-MAP selections, one ``greedy_map.work`` a
    matrix: each row of ``expert_picks`` and the shared picks."""
    if "expert_picks" not in rec:
        return []
    out = []
    for picks in rec["expert_picks"]:
        out.append(greedy_map.work(int(rec["expert_size"]),
                                   int(picks.shape[-1]),
                                   int((picks >= 0).sum())))
    if "shared_picks" in rec:
        picks = rec["shared_picks"]
        out.append(greedy_map.work(int(rec["shared_size"]),
                                   int(picks.shape[-1]),
                                   int((picks >= 0).sum())))
    return out


def request(positions: int, d_model: int, experts: int, routed_rows: int,
            d_expert: int, d_shared: int) -> float:
    """One request's FLOPs but its selections: RMSNorm (4 a value), the
    router (2·P·d·E), each routed row's gate and up products (2 · 2·d·f),
    SwiGLU and its routing weight (6 a unit value), the column norms and
    scaling (3 a unit value), each expert's unit kernel ÂᵀÂ as a full
    product (2·n·f² over its n rows); the shared experts the same over
    every position, with no weight (5 a unit value)."""
    P, d, R = float(positions), float(d_model), float(routed_rows)
    f, fs = float(d_expert), float(d_shared)
    routed = 4 * R * d * f + 6 * R * f + 3 * R * f + 2 * R * f * f
    shared = 4 * P * d * fs + 5 * P * fs + 3 * P * fs + 2 * P * fs * fs
    return 4 * P * d + 2 * P * d * experts + routed + shared


def flops(rec: dict, positions: int, d_model: int, experts: int) -> float:
    """A record's whole request: ``request`` and its selections."""
    return request(positions, d_model, experts, int(rec["routed_rows"]),
                   int(rec["expert_size"]), int(rec["shared_size"])) \
        + sum(w[0] for w in of_record(rec))
