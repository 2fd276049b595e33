"""Device time a sweep of the Θ build: the kernels launched under the
``repro_torch.learning.theta_build`` spans (``theta_matrix_kron``: the
subset blocks, their inverses and the scatter into Θ), over the window's
sweeps, in ms."""


def read(t):
    s = t.op_device_seconds("repro_torch.learning.theta_build")
    return 1e3 * s / t.units if s > 0 and t.units else None
