"""Kernel launches the device ran a request (traced window; copies and
fills not counted)."""


def read(t):
    n = len(t.kernels())
    return n / t.units if n and t.units else None
