"""Building blocks behind the ``repro_torch.dpp`` facade (port of
``repro/dpp/functional.py``).

The facade models in ``dpp.model`` make host-level decisions (phase-2
budgets, batch rounding) off concrete spectra. Consumers that want the
primitives themselves — greedy MAP and exactly-k draws for KV-cache
compaction, for example — use these functions, the exact ones the facade
dispatches to, re-exported so every layer routes through ``dpp``.
"""

from ..kernels.ops import greedy_map_kdpp
from ..sampling.batched import sample_krondpp_batched
from ..sampling.kdpp import sample_kdpp_batched, sample_kdpp_dense

__all__ = [
    "greedy_map_kdpp",
    "sample_kdpp_dense", "sample_kdpp_batched", "sample_krondpp_batched",
]
