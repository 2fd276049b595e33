"""Device time a request of the MoE layer's routing: the kernels launched
under the ``repro_torch.moe.route`` spans (RMSNorm, the router's product,
the choice of experts and the drop-free dispatch) in the traced window,
over its requests, in ms."""


def read(t):
    s = t.op_device_seconds("repro_torch.moe.route")
    return 1e3 * s / t.units if s > 0 and t.units else None
