"""mixtral-8x7b [arXiv:2401.04088] — 8 experts top-2, SWA."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, experts_per_token=2, moe_every=1,
    sliding_window=4096, rope_theta=1000000.0,
)
