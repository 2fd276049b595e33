"""The inputs of the mixture-of-experts cells, made from ``--seed`` on the
run's device with ``inputs.generator``: every MoE layer's weights that
choosing units needs, and one probe batch a layer.

Both sides get the same tensors, as for ``inputs``: the port takes them as
its inputs and the plain reference reads the same values in float64.
"""

from __future__ import annotations

import torch

from .inputs import generator

#: Tags that keep the streams of one seed apart (and apart from
#: ``inputs``'s).
TAG_MOE_WEIGHTS = 0x4D4F4557      # MoE layers' weights
TAG_MOE_PROBE = 0x4D4F4550        # MoE probe activations


def moe_weights(seed: int, layers: int, d_model: int, experts: int,
                d_expert: int, d_shared: int, device: torch.device) -> dict:
    """Every layer's weights, stacked on a leading layer axis, float32:
    ``ln`` (layers, d) = 1 + 0.1·N(0, 1), so the norm's scale matters;
    ``router`` (layers, d, E) N(0, 1/d); ``router_bias`` (layers, E)
    N(0, 0.01²), the correction bias; ``w_gate``, ``w_up`` (layers, E, d,
    f) and ``shared_gate``, ``shared_up`` (layers, d, fs) N(0, 1/d)."""
    gen = generator(seed, TAG_MOE_WEIGHTS, device)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(std)

    s = d_model ** -0.5
    out = {"ln": normal((layers, d_model), 0.1).add_(1.0),
           "router": normal((layers, d_model, experts), s),
           "router_bias": normal((layers, experts), 0.01)}
    for name in ("w_gate", "w_up"):
        out[name] = normal((layers, experts, d_model, d_expert), s)
    for name in ("shared_gate", "shared_up"):
        out[name] = normal((layers, d_model, d_shared), s)
    return out


def moe_probes(seed: int, layers: int, documents: int, positions: int,
               topics: int, d_model: int, device: torch.device
               ) -> torch.Tensor:
    """One probe batch a layer, (layers, documents, positions, d) float32.
    A document's positions are its topic's centre plus noise, both
    N(0, I); its topic is one of ``topics``, drawn with Zipf weights
    ∝ 1/rank, as calibration text is skewed by topic, so the experts'
    loads are uneven. Each layer has its own centres and draws."""
    gen = generator(seed, TAG_MOE_PROBE, device)
    zipf = 1.0 / torch.arange(1, topics + 1, dtype=torch.float64,
                              device=device)
    topic = torch.multinomial(zipf.expand(layers, topics), documents,
                              replacement=True, generator=gen)
    centres = torch.randn((layers, topics, d_model), generator=gen,
                          dtype=torch.float32, device=device)
    x = torch.randn((layers, documents, positions, d_model), generator=gen,
                    dtype=torch.float32, device=device)
    x += torch.gather(centres, 1, topic[..., None].expand(
        -1, -1, d_model))[:, :, None, :]
    return x
