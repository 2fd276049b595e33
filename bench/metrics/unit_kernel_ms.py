"""Device time a request of the unit kernels: the kernels launched under
the ``repro_torch.prune.unit_kernels`` spans (each expert's ÂᵀÂ + 1e-4 I
and the shared experts') in the traced window, over its requests, in
ms."""


def read(t):
    s = t.op_device_seconds("repro_torch.prune.unit_kernels")
    return 1e3 * s / t.units if s > 0 and t.units else None
