"""repro_torch.models — the LM stack (port of ``repro/models``): dense,
MoE, SSM and hybrid decoders and whisper's encoder-decoder."""

from .transformer import LM, DecodeState
from .attention import KVCache
from .ssm import SSMCache

__all__ = ["LM", "DecodeState", "KVCache", "SSMCache"]
