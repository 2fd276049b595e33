"""starcoder2-15b [arXiv:2402.19173] — GQA kv=4, RoPE, full attention."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    rope_theta=100000.0, qkv_bias=True, mlp_gelu=True,
)
