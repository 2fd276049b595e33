"""The fused greedy-MAP kernel's share (%) of its roofline in a
mixture-of-experts pruning cell: the least time that the window's
selections need, one ``greedy_map.work`` a matrix of each batched launch
(``roofline.moe_prune``), over the device time of
``greedy_map_kdpp_kernel``."""

from bench.roofline import moe_prune


def read(t):
    return t.roofline("greedy_map_kdpp_kernel",
                      [w for r in t.records for w in moe_prune.of_record(r)])
