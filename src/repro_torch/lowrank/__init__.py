"""repro_torch.lowrank — learned feature-based kernels in the rank-r dual
space (port of ``repro/lowrank``).

The third kernel family behind the ``repro_torch.dpp`` facade:
``L = V diag(q) Vᵀ`` with a shared (N, r) diversity basis ``V`` and
per-item quality scores ``q``. Spectrum, sampling, log_prob, marginals,
conditioning, MAP and learning all run through the rank-r dual Gram
``C = Vᵀ diag(q) V`` (Kulesza & Taskar §3.3): one r×r eigh plus O(Nr)
products, never an N×N factorization. The dense kernel is materialized
only under the facade's ``MAX_DENSE_N`` guard.

dual.py      ``DualSpectrum`` and ``dual_spectrum`` (through
             ``SpectralCache.spectrum_lowrank``), with the ``sample_rows``
             hooks the batched samplers dispatch through.
sample.py    the dual DPP and k-DPP draws (plain PyTorch; no kernel).
model.py     ``LowRank(V, q, device=)``.
learn.py     ``fit_lowrank``: q Picard step + projected-gradient V step.
features.py  ``nystrom_features``, ``random_fourier_features`` (numpy).

Consumers import ``repro_torch.dpp`` (which re-exports ``LowRank``).
"""

from .dual import DualSpectrum, dual_spectrum
from .features import nystrom_features, random_fourier_features
from .model import LowRank

__all__ = [
    "DualSpectrum",
    "LowRank",
    "dual_spectrum",
    "nystrom_features",
    "random_fourier_features",
]
