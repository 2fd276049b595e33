"""repro_torch.models — the LM stack's decoder-only attention models (port
of ``repro/models``; the MoE and SSM layers, ``SSMCache`` and whisper's
encoder are not ported yet: ROADMAP.md, queue 1)."""

from .transformer import LM, DecodeState
from .attention import KVCache

__all__ = ["LM", "DecodeState", "KVCache"]
