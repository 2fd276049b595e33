"""whisper-tiny [arXiv:2212.04356] — enc-dec backbone; conv frontend is a
STUB: `input_specs` provides precomputed audio-frame embeddings (B, 1500, d).

Deviation (DESIGN.md §7): decoder uses RoPE instead of learned positions —
this is a backbone stand-in; param/FLOP structure is unchanged.
"""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    encoder_layers=4, encoder_seq=1500,
    tie_embeddings=True, mlp_gelu=True,
)
