"""repro_torch.dpp — the model-centric DPP API of the port (port of
``repro/dpp``)::

    import torch
    from repro_torch import dpp

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = dpp.random_kron(gen, (100, 100)).rescale(20.0)   # N = 10^4
    batch = model.sample(gen, 64)           # SubsetBatch, one batched call
    svc = model.service(seed=0)             # micro-batching front-end
    rows = svc.sample(16)
    init = dpp.random_kron(gen, (100, 100))
    rep = init.fit(batch, algorithm="krk", use_dense_theta=True)  # KrK-Picard

Every entry point defaults to ``device="cuda"`` and raises without a card
unless ``device="cpu"`` is passed.
"""

from ..sampling.service import SampleTicket, SamplingService
from ..sampling.spectral import FactorSpectrum, SpectralCache, default_cache
from .model import (MAX_DENSE_N, Dense, DPPModel, Kron, from_factors,
                    from_kernel, random_kron)

__all__ = [
    "DPPModel", "Dense", "Kron", "MAX_DENSE_N",
    "from_kernel", "from_factors", "random_kron",
    "FactorSpectrum", "SpectralCache", "default_cache",
    "SamplingService", "SampleTicket",
]
