"""repro_torch.sampling — batched exact DPP sampling (port of
``repro/sampling``). The public API is the ``repro_torch.dpp`` facade;
this package is the engine behind it.

spectral.py  ``FactorSpectrum`` and ``SpectralCache`` (one eigh per factor
             identity).
batched.py   phase 1 (spectrum draw, compaction, factored column gather)
             and ``sample_krondpp_batched`` / ``_from_uniforms``; phase 2
             goes through ``kernels.ops.phase2_select``.
service.py   ``SamplingService`` — submit → coalesce → one batched call
             per chunk → scatter.

Not ported yet: ``kdpp.py`` (exactly-k draws) and ``sample_krondpp_keyed``.
"""

from .batched import (compact_selection, gather_factor_columns,
                      picks_to_lists, sample_krondpp_batched,
                      sample_krondpp_from_uniforms)
from .service import SampleTicket, SamplingService, ServiceStats
from .spectral import (FactorSpectrum, SpectralCache, default_cache,
                       gain_for_expected_size, log_product_spectrum,
                       rescale_expected_size)

__all__ = [
    "FactorSpectrum", "SpectralCache", "default_cache",
    "gain_for_expected_size", "log_product_spectrum",
    "rescale_expected_size", "compact_selection", "gather_factor_columns",
    "picks_to_lists", "sample_krondpp_batched",
    "sample_krondpp_from_uniforms", "SamplingService", "SampleTicket",
    "ServiceStats",
]
