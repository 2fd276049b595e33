"""Blocking host syncs the program makes: the ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` and ``cudaEventSynchronize`` calls that start
inside a ``repro_torch.*`` span in the traced window, over its requests
(``.draw``) or sweeps (``.learn``)."""

from bench import program


def read(t):
    n = program.count_inside(t, program.SYNCS)
    return None if n is None or not t.units else n / t.units
