"""Requests completed in the window, over the window (host clock)."""


def read(w):
    return w.requests / w.seconds if w.requests else None
