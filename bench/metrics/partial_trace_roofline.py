"""The partial-trace kernels' share (%) of their roofline: the least time
that the window's sweeps need (``roofline.partial_trace``: A once and C once
a sweep, as Alg. 1 needs them) over the device time of every
``partial_trace_`` kernel the port launched."""

from bench.roofline import partial_trace


def read(t):
    return t.roofline("partial_trace_",
                      [w for r in t.records
                       for w in partial_trace.of_record(r)])
