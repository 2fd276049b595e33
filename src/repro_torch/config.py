"""Framework configuration: model architecture + parallelism + run settings
(a copy of ``repro/config.py``, which imports nothing of JAX; the port
keeps its own so that it imports nothing of the JAX package).

One `ModelConfig` instance per assigned architecture lives in
`repro_torch/configs/<id>.py`; shapes (train_4k / prefill_32k / decode_32k /
long_500k) are defined per-arch there too.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class LayerKind(str, enum.Enum):
    ATTN = "attn"            # attention + dense MLP
    ATTN_MOE = "attn_moe"    # attention + MoE FFN
    SSM = "ssm"              # Mamba2 block + dense MLP (none for pure mamba)
    SSM_MOE = "ssm_moe"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # SWA width; None = full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_gelu: bool = False           # 2-matrix GELU MLP (starcoder2, whisper)
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1               # MoE FFN every k-th layer (1 = all)
    capacity_factor: float = 1.25
    # DeepSeek-V3 routing (the defaults are the softmax top-k above)
    n_shared_experts: int = 0        # shared experts, one MLP of n × d_ff
    router_scoring: str = "softmax"  # softmax | sigmoid
    norm_topk_prob: bool = True      # the K weights normalised to sum 1
    routed_scaling: float = 1.0      # the routed weights' factor
    n_group: int = 1                 # sigmoid: expert groups ...
    topk_group: int = 1              # ... of which the best are kept
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Jamba): period layout, attention positions in period ---
    hybrid_period: int = 0           # 0 = not hybrid
    hybrid_attn_pos: Tuple[int, ...] = ()
    # multi-layer units: first `unit_head` layers are applied directly; the
    # remaining layers must repeat with period `unit_tail_period` and are run
    # under a nested lax.scan (bounds activation liveness per pair, not per
    # whole period — see transformer.apply_unit).
    unit_head: int = 0               # 0 = whole unit is "head" (no tail scan)
    unit_tail_period: int = 0
    # --- encoder-decoder (Whisper): encoder stack of same width ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed frame count from the stub frontend
    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 512            # query-chunk size for memory-bound attn
    # dry-run cost-accounting mode: unroll inner scans (attn/ssd/loss chunks,
    # unit stack) so HLO cost analysis sees every iteration. Used only for
    # the small depth-1/depth-2 FLOP-measurement compiles.
    unroll_scans: bool = False
    # --- paper feature toggles ---
    dpp_batch_selection: bool = False
    dpp_kv_budget: Optional[int] = None   # KV-compaction budget (serving)

    @property
    def hd(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a multiple of 256 so the LM head TP-shards."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, i: int) -> LayerKind:
        """Layer kind at global layer index i."""
        moe = self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)
        if self.family == "ssm":
            return LayerKind.SSM
        if self.hybrid_period:
            attn = (i % self.hybrid_period) in self.hybrid_attn_pos
            if attn:
                return LayerKind.ATTN_MOE if moe else LayerKind.ATTN
            return LayerKind.SSM_MOE if moe else LayerKind.SSM
        return LayerKind.ATTN_MOE if moe else LayerKind.ATTN

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in (LayerKind.ATTN, LayerKind.ATTN_MOE):
                total += d * hd * (H + 2 * KV) + H * hd * d  # qkv + o
                if self.qkv_bias:
                    total += hd * (H + 2 * KV)
            if kind in (LayerKind.SSM, LayerKind.SSM_MOE):
                di = self.ssm_expand * d
                nh = di // self.ssm_head_dim
                total += d * (2 * di + 2 * self.ssm_state * 2 + nh)  # in_proj approx
                total += di * d                                       # out_proj
            if kind in (LayerKind.ATTN_MOE, LayerKind.SSM_MOE):
                total += self.n_experts * 3 * d * f + d * self.n_experts
                total += self.n_shared_experts * 3 * d * f
            elif f > 0:
                total += (2 if self.mlp_gelu else 3) * d * f
            total += 2 * d  # norms
        if self.encoder_layers:
            total += self.encoder_layers * (4 * d * H * hd // H * H + 3 * d * f)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count()
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.layer_kind(i) in (LayerKind.ATTN_MOE, LayerKind.SSM_MOE))
        all_experts = n_moe_layers * self.n_experts * 3 * d * f
        active = n_moe_layers * self.experts_per_token * 3 * d * f
        return dense - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Sharding policy knobs (consumed by distributed/sharding.py)."""
    fsdp: bool = True                # shard params/opt over data (+pod) axes
    tp: bool = True                  # tensor-parallel over "model"
    seq_shard_decode: bool = True    # shard KV sequence for decode shapes
    remat_policy: str = "block"      # none | block | dots
    grad_compression: Optional[str] = None  # None | "int8"
