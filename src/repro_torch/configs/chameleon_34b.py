"""chameleon-34b [arXiv:2405.09818] — early-fusion VLM. Image VQ tokens live
in the unified vocab (65536), so the backbone is a dense LM; the VQ tokenizer
frontend is a STUB (input_specs provides token ids directly)."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
    rope_theta=10000.0,
)
