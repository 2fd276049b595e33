"""jamba-1.5-large-398b [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave (attention at position 4 of each 8-layer period), MoE 16e top-2
every other layer. SSM blocks use the Mamba2/SSD formulation (TPU-native;
DESIGN.md §7 notes this deviation from Jamba's Mamba-1 layers)."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    n_experts=16, experts_per_token=2, moe_every=2,
    # attention phase-shifted to position 0 of the 8-layer period (Jamba
    # places it at 4; same 1:7 ratio and MoE-every-2 — DESIGN.md §7) so the
    # period nests as head [attn, ssm+moe] + scan of 3x [ssm, ssm+moe].
    hybrid_period=8, hybrid_attn_pos=(0,),
    unit_head=2, unit_tail_period=2,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    sliding_window=None, rope_theta=1000000.0,
)
