"""h2o-danube-3-4b [arXiv:2401.16818] — llama+mistral mix with SWA."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    sliding_window=4096, rope_theta=10000.0,
)
