"""Faults of the mixture-of-experts pruning cells (kind ``moe_prune``),
entered in ``faults.FAULTS`` when this module is imported (the kind's
module imports it): each turns one call of the timed path into a wrong
one of the kind a broken change would make. The benchmark's runs never
plant one.
"""

import dataclasses

from . import faults


def _swapped_pick(fn):
    def broken(L, k):
        picks = fn(L, k).clone()
        if L.dim() == 3:
            # the matrix with the most off-diagonal mass: one whose expert
            # has rows, so the pick is judged
            off = L.abs().sum((-2, -1)) - L.diagonal(dim1=-2, dim2=-1) \
                .abs().sum(-1)
            h = int(off.argmax())
            row = picks[h]
        else:
            row = picks
        taken = set(row.tolist())
        row[1] = next(j for j in range(L.shape[-1]) if j not in taken)
        return picks
    return broken


def _dropped_token(fn):
    def broken(top_e, n_experts):
        order, counts = fn(top_e, n_experts)
        e = int(top_e.reshape(-1)[order[0]])
        counts = counts.clone()
        counts[e] -= 1
        return order[1:], counts
    return broken


def _softmax_routing(fn):
    def broken(p, h, cfg):
        return fn(p, h, dataclasses.replace(cfg, router_scoring="softmax"))
    return broken


faults.FAULTS["moe_prune"] = {
    "swapped_pick": ("repro_torch.dpp.functional", "greedy_map_kdpp",
                     _swapped_pick),
    "dropped_token": ("repro_torch.models.moe", "dispatch_dropless",
                      _dropped_token),
    "softmax_routing": ("repro_torch.models.moe", "route",
                        _softmax_routing),
}
