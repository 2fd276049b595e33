"""The device's idle time that the host spent inside the program: the
idle gaps of the traced window whose middle lies inside a ``repro_torch.*``
span (``bench.program``), over the window's requests (``.draw``) or sweeps
(``.learn``), in ms."""

from bench import program


def read(t):
    s = program.idle_in_spans_s(t)
    return None if s is None or not t.units else 1e3 * s / t.units
