"""repro_torch.sampling — batched exact DPP sampling (port of
``repro/sampling``). The public API is the ``repro_torch.dpp`` facade;
this package is the engine behind it.

spectral.py  ``FactorSpectrum`` and ``SpectralCache`` (one eigh per factor
             identity).
batched.py   phase 1 (spectrum draw, compaction, factored column gather)
             and ``sample_krondpp_batched`` / ``_keyed`` /
             ``_from_uniforms``; phase 2 goes through
             ``kernels.ops.phase2_select``; ``assemble_eigvecs``
             materializes selected eigenvectors.
kdpp.py      ``sample_kdpp_batched`` / ``_from_uniforms`` /
             ``sample_kdpp_dense`` — exactly-k draws (ESP phase 1, the
             same phase 2).
service.py   ``SamplingService`` — submit → coalesce → one batched call
             per chunk → scatter; ``draw_keyed`` for per-row keys.
"""

from .batched import (assemble_eigvecs, compact_selection,
                      gather_factor_columns, picks_to_lists,
                      sample_krondpp_batched, sample_krondpp_from_uniforms,
                      sample_krondpp_keyed, split_mixed_radix)
from .kdpp import (log_esp_table, sample_kdpp_batched, sample_kdpp_dense,
                   sample_kdpp_from_uniforms)
from .service import SampleTicket, SamplingService, ServiceStats
from .spectral import (FactorSpectrum, SpectralCache, default_cache,
                       gain_for_expected_size, log_product_spectrum,
                       rescale_expected_size)

__all__ = [
    "FactorSpectrum", "SpectralCache", "default_cache",
    "gain_for_expected_size", "log_product_spectrum",
    "rescale_expected_size", "compact_selection", "gather_factor_columns",
    "picks_to_lists", "sample_krondpp_batched", "sample_krondpp_keyed",
    "sample_krondpp_from_uniforms", "split_mixed_radix", "assemble_eigvecs",
    "log_esp_table", "sample_kdpp_batched", "sample_kdpp_from_uniforms",
    "sample_kdpp_dense", "SamplingService", "SampleTicket", "ServiceStats",
]
