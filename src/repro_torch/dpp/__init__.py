"""repro_torch.dpp — the model-centric DPP API of the port (port of
``repro/dpp``)::

    import torch
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
    rep = init.fit(batch, algorithm="krk", use_dense_theta=True,
                   schedule=dpp.schedules.armijo())      # KrK-Picard
    g = torch.Generator(device="cuda").manual_seed(0)   # a low-rank family
    V = torch.randn(65536, 32, generator=g, device="cuda") * 0.7
    q = torch.rand(65536, generator=g, device="cuda") + 0.3
    low = dpp.LowRank(V, q).rescale(8.0)    # L = V diag(q) Vᵀ, r = 32
    rows = low.sample(k2, 16)               # through the r x r dual
    best = low.map(8)
    rep = low.fit(rows, algorithm="lowrank")

The same key gives the JAX package's factors (up to float32 roundoff of
XᵀX) and rows; a ``torch.Generator`` may stand in for any key on one
device.

WHERE the work runs is ``runtime=`` (``repro_torch.dpp.runtime``), taken
by ``sample``, ``spectrum``, ``service``, ``serving`` and ``fit``:
``Local()`` (the default), ``Mesh(axes={"data": n}, devices=[...])`` (key
batches and training subsets cut into shards, one a device of the list;
draws equal ``Local``'s bit for bit on shared keys) and ``Host()`` (the
numpy oracle)::

    rt = dpp.Mesh(axes={"data": 4}, devices=["cuda:0"] * 4)
    batch = model.sample(k2, 4096, runtime=rt)
    rep = init.fit(batch, schedule=dpp.schedules.armijo(), runtime=rt)

Every entry point defaults to ``device="cuda"`` and raises without a card
unless ``device="cpu"`` is passed.
"""

from ..learning import schedules
from ..sampling.service import SampleTicket, SamplingService
from ..sampling.spectral import FactorSpectrum, SpectralCache, default_cache
from . import functional, runtime
from .model import (MAX_DENSE_N, Dense, DPPModel, Kron, from_factors,
                    from_kernel, random_kron)
from .runtime import Host, Local, Mesh, Runtime

# LowRank and friends resolve lazily (PEP 562): repro_torch.lowrank
# subclasses .model's DPPModel, so an eager import here would be circular
# when the lowrank package is imported first.
_LOWRANK_EXPORTS = ("LowRank", "DualSpectrum", "nystrom_features",
                    "random_fourier_features")


def __getattr__(name):
    if name in _LOWRANK_EXPORTS:
        from .. import lowrank
        value = getattr(lowrank, name)
        globals()[name] = value      # cache: later lookups skip this hook
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DPPModel", "Dense", "Kron", "LowRank", "MAX_DENSE_N",
    "from_kernel", "from_factors", "random_kron",
    "functional", "schedules",
    "runtime", "Runtime", "Local", "Mesh", "Host",
    "FactorSpectrum", "DualSpectrum", "SpectralCache", "default_cache",
    "SamplingService", "SampleTicket",
    "nystrom_features", "random_fourier_features",
]
