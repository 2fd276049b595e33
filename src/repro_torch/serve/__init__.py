"""repro_torch.serve — the LM serving engine and the DPP KV-cache
compaction it runs between prefill and decode (port of ``repro/serve``).

engine.py         ``ServeEngine``: prefill, optional KV compaction (inline
                  or through ``serving.KVCompactionClient``), decode loop.
kv_compaction.py  ``dpp_select_tokens``: a diverse subset of cached token
                  positions per attention head (greedy MAP or an exact
                  k-DPP draw); ``compact_kv_cache``: one layer's cache cut
                  to the budget.
"""

from .engine import ServeEngine
from .kv_compaction import compact_kv_cache, dpp_select_tokens

__all__ = ["ServeEngine", "compact_kv_cache", "dpp_select_tokens"]
