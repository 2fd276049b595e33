"""Host time a request inside the program's draw: the summed durations of
the ``repro_torch.dpp.sample`` spans (``Kron.sample``, the whole call) in
the traced window, over its requests, in ms."""

from bench import program


def read(t):
    s = program.spans(t, "dpp.sample")
    if not s or not t.units:
        return None
    return sum(t1 - t0 for t0, t1, _ in s) / 1e3 / t.units
