"""Architecture registry: --arch <id> resolution, smoke reductions, shapes
(a copy of ``repro/configs/__init__.py`` and its ten arch files)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

from ..config import LM_SHAPES, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "starcoder2-15b": "starcoder2_15b",
    "mamba2-2.7b": "mamba2_2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-tiny": "whisper_tiny",
    "chameleon-34b": "chameleon_34b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

# long_500k requires sub-quadratic attention. Pure full-attention archs skip
# it (DESIGN.md §5); SWA / SSM / hybrid archs run it.
LONG_CONTEXT_OK = {
    "h2o-danube-3-4b",       # SWA 4k window
    "mamba2-2.7b",           # SSM, O(1) state
    "mixtral-8x7b",          # SWA 4k window
    "jamba-1.5-large-398b",  # hybrid
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, 1 forward/train step on CPU."""
    cfg = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, d_ff=0 if cfg.d_ff == 0 else 128, vocab=256,
        attn_chunk=16, remat=False, dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                  head_dim=16)
    else:
        kw.update(n_heads=0, n_kv_heads=0)
    if cfg.n_experts:
        kw.update(n_experts=4, experts_per_token=2)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.hybrid_period:
        kw.update(hybrid_period=2, hybrid_attn_pos=(0,), n_layers=4,
                  moe_every=2, unit_head=0, unit_tail_period=0)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=24)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    return dataclasses.replace(cfg, **kw)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule."""
    out = []
    for arch in list_archs():
        for shape in LM_SHAPES:
            skipped = shape.name == "long_500k" and arch not in LONG_CONTEXT_OK
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out
