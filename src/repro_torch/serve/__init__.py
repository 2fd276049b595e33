"""repro_torch.serve — consumers of the DPP primitives on the serving side
(port of ``repro/serve``).

kv_compaction.py  ``dpp_select_tokens``: a diverse subset of cached
                  token positions per attention head (greedy MAP or an
                  exact k-DPP draw).

Not ported yet (ROADMAP.md, queue 1: #8 consumers): ``compact_kv_cache``
and ``ServeEngine``, which need the LM stack's ``models.attention.KVCache``.
"""

from .kv_compaction import dpp_select_tokens

__all__ = ["dpp_select_tokens"]
