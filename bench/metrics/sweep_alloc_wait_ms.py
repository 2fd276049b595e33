"""Host time a sweep in device allocations outside the caching allocator's
pool: the ``cudaMalloc`` and ``cudaFree`` calls that start inside a
``repro_torch.learning.sweep`` span in the traced window, over its sweeps,
in ms."""

from bench import program


def read(t):
    s = program.seconds_inside(t, program.ALLOCS, "learning.sweep")
    return None if s is None or not t.units else 1e3 * s / t.units
