"""Device time a sweep of the Θ scatter: the kernels the profiler records
under ``aten::index_put_`` (``scatter_theta``'s accumulating scatter and
what it launches), over the sweeps of the traced window."""


def read(t):
    s = t.op_device_seconds("aten::index_put_")
    return 1e3 * s / t.units if s > 0 and t.units else None
