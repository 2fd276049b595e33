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

The bare ``sample_krondpp_batched``, ``sample_kdpp_batched`` and
``sample_kdpp_dense`` re-exported here are the JAX package's deprecated
shims: they warn and call the engine entry point; new code goes through
``repro_torch.dpp``, and the port's own modules import the engine entry
points from the submodules.
"""

import functools as _functools
import warnings as _warnings

from .batched import (assemble_eigvecs, compact_selection,
                      compile_cache_size, gather_factor_columns,
                      picks_to_lists, sample_krondpp_from_uniforms,
                      sample_krondpp_keyed, split_mixed_radix)
from .batched import sample_krondpp_batched as _sample_krondpp_batched
from .kdpp import log_esp_table, sample_kdpp_from_uniforms
from .kdpp import (sample_kdpp_batched as _sample_kdpp_batched,
                   sample_kdpp_dense as _sample_kdpp_dense)
from .service import SampleTicket, SamplingService, ServiceStats
from .spectral import (FactorSpectrum, SpectralCache, default_cache,
                       gain_for_expected_size, log_product_spectrum,
                       rescale_expected_size)


def _deprecated_shim(fn, facade_hint):
    @_functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _warnings.warn(
            f"repro_torch.sampling.{fn.__name__} (top-level re-export) is "
            f"deprecated; use {facade_hint}, or import it from "
            f"repro_torch.sampling.{fn.__module__.rsplit('.', 1)[-1]} if "
            f"you really want the raw engine entry point",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapper


sample_krondpp_batched = _deprecated_shim(
    _sample_krondpp_batched, "repro_torch.dpp: model.sample(key, n)")
sample_kdpp_batched = _deprecated_shim(
    _sample_kdpp_batched, "repro_torch.dpp: model.sample(key, n, k=k)")
sample_kdpp_dense = _deprecated_shim(
    _sample_kdpp_dense,
    "repro_torch.dpp: Dense(L).sample(key, k=k) — or "
    "repro_torch.dpp.functional.sample_kdpp_dense")

__all__ = [
    "FactorSpectrum", "SpectralCache", "default_cache",
    "gain_for_expected_size", "log_product_spectrum",
    "rescale_expected_size", "compact_selection", "gather_factor_columns",
    "picks_to_lists", "compile_cache_size", "sample_krondpp_batched",
    "sample_krondpp_keyed",
    "sample_krondpp_from_uniforms", "split_mixed_radix", "assemble_eigvecs",
    "log_esp_table", "sample_kdpp_batched", "sample_kdpp_from_uniforms",
    "sample_kdpp_dense", "SamplingService", "SampleTicket", "ServiceStats",
]
