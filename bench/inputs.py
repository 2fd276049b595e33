"""The benchmark's inputs, made from ``--seed`` on the run's device.

Both sides get the same tensors: the program under test takes them as its
inputs, and the plain reference reads the same values (in float64) to work
out its own answer. Each input is drawn in a few large calls by a
``torch.Generator`` on the device, seeded from the run's seed and a tag of
its own, so two inputs of one run never share a stream and one seed gives
the same inputs in every run on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

#: Tags that keep the streams of one seed apart.
TAG_FACTORS = 0x4B524F4E          # the true kernel's factors
TAG_INIT = 0x494E4954             # a learner's starting factors
TAG_WEIGHTS = 0x57454947          # FFN weights
TAG_PROBE = 0x50524F42            # FFN probe activations


def generator(seed: int, tag: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + tag) % (2 ** 63))
    return gen


def kron_factors(seed: int, sizes: Sequence[int], device: torch.device,
                 tag: int = TAG_FACTORS) -> Tuple[torch.Tensor, ...]:
    """The paper's random factors (Mariet & Sra 2016, §5.1):
    L_f = XᵀX + 1e-3 I with X ~ U[0, sqrt(2)] (N_f x N_f), formed in
    float64 and rounded once to float32, so each factor is exactly
    symmetric."""
    gen = generator(seed, tag, device)
    out = []
    for n in sizes:
        X = torch.rand((n, n), generator=gen, dtype=torch.float64,
                       device=device) * math.sqrt(2.0)
        L = X.T @ X + 1e-3 * torch.eye(n, dtype=torch.float64, device=device)
        out.append(L.to(torch.float32))
    return tuple(out)


def ffn_weights(seed: int, layers: int, d_model: int, d_ff: int,
                device: torch.device):
    """Every layer's RMSNorm scale (layers, d_model) and the gate and up
    projections (layers, 2, d_model, d_ff), float32, N(0, 1/d_model)
    entries; the norm's scale is 1 + N(0, 0.1²), so it matters."""
    gen = generator(seed, TAG_WEIGHTS, device)
    w = torch.randn((layers, 2, d_model, d_ff), generator=gen,
                    dtype=torch.float32, device=device)
    w.mul_(d_model ** -0.5)
    ln = 1.0 + 0.1 * torch.randn((layers, d_model), generator=gen,
                                 dtype=torch.float32, device=device)
    return ln, w


def ffn_probes(seed: int, count: int, shape: Sequence[int], d_model: int,
               device: torch.device) -> torch.Tensor:
    """``count`` probe batches (count, *shape, d_model) of N(0, 1) float32
    activations."""
    gen = generator(seed, TAG_PROBE, device)
    return torch.randn((count, *shape, d_model), generator=gen,
                       dtype=torch.float32, device=device)
