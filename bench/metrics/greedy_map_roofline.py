"""The fused greedy-MAP kernel's share (%) of its roofline: the least time
that the window's selections need (``roofline.greedy_map``, from each
record's matrix size and picks) over the device time of
``greedy_map_kdpp_kernel``."""

from bench.roofline import greedy_map


def read(t):
    return t.roofline("greedy_map_kdpp_kernel",
                      [w for r in t.records for w in greedy_map.of_record(r)])
