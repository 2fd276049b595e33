"""repro_torch.dpp — the model-centric DPP API of the port (port of
``repro/dpp``)::

    from repro_torch import dpp, random

    key = random.PRNGKey(0)                 # the JAX package's key
    key, k1, k2, k3 = random.split(key, 4)
    model = dpp.random_kron(k1, (100, 100)).rescale(20.0)   # N = 10^4
    batch = model.sample(k2, 64)            # SubsetBatch, one batched call
    exact = model.sample(k3, 64, k=20)      # k-DPP: exactly 20 per row
    best = model.map(20, max_dense=10_000)  # greedy MAP on the dense L
    svc = model.service(seed=0)             # micro-batching front-end
    rows = svc.sample(16)
    init = dpp.random_kron(key, (100, 100))
    rep = init.fit(batch, algorithm="krk", use_dense_theta=True)  # KrK-Picard

The same key gives the JAX package's factors (up to float32 roundoff of
XᵀX) and rows; a ``torch.Generator`` may stand in for any key.

Every entry point defaults to ``device="cuda"`` and raises without a card
unless ``device="cpu"`` is passed.
"""

from ..sampling.service import SampleTicket, SamplingService
from ..sampling.spectral import FactorSpectrum, SpectralCache, default_cache
from . import functional
from .model import (MAX_DENSE_N, Dense, DPPModel, Kron, from_factors,
                    from_kernel, random_kron)

__all__ = [
    "DPPModel", "Dense", "Kron", "MAX_DENSE_N",
    "from_kernel", "from_factors", "random_kron",
    "FactorSpectrum", "SpectralCache", "default_cache",
    "SamplingService", "SampleTicket", "functional",
]
