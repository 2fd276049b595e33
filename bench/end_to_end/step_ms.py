"""The whole window over the sweeps completed in it (host clock)."""


def read(w):
    return 1e3 * w.seconds / w.units if w.units else None
