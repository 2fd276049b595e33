"""The share (%) of the traced window in which no operation ran on the
device: 1 minus the union of its kernels', copies' and fills' intervals,
over the window."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
