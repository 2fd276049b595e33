"""DeepSeek-V3 routing, shared experts and DPP pruning of a mixture-of-experts
layer in the PyTorch port (``models.moe``, ``models.prune``) against the
benchmark's plain reference (``bench/reference/moe.py``, float64), on
seeded random weights at a small size on the CPU.

The port computes in float32, the reference in float64: expert choices are
compared at every token whose reference margin between the K-th and the
(K+1)-th biased score exceeds 1e-4 (float32 scores are good to about 1e-6
here), outputs and kernels to 1e-5. The softmax routing of the registered
MoE families is held bit for bit against the routing the port had before
the sigmoid scoring came (its lines copied here) and against the JAX
package's choice. One ``cuda``-marked test holds a batched greedy-MAP
launch at the cell's shape against its single launches on the card.
"""

import dataclasses
import os
import sys
from pathlib import Path

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
import repro_torch.random as prng
from repro_torch.config import ModelConfig
from repro_torch.configs import smoke_config
from repro_torch.dpp import functional as dpp_functional
from repro_torch.kernels import ops
from repro_torch.models import moe, prune
from repro_torch.models.common import rms_norm

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import moe as ref  # noqa: E402

TAU = 1e-4
TOL = 1e-5


def small_config(**kw) -> ModelConfig:
    base = dict(name="moe-small", family="moe", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=24, vocab=64, norm_eps=1e-5,
                n_experts=16, experts_per_token=4, n_shared_experts=2,
                router_scoring="sigmoid",
                norm_topk_prob=True, routed_scaling=2.446, dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


def routing_of(cfg: ModelConfig) -> ref.Routing:
    return ref.Routing(cfg.n_experts, cfg.experts_per_token,
                       cfg.router_scoring, cfg.n_group, cfg.topk_group,
                       cfg.norm_topk_prob, cfg.routed_scaling)


def params(cfg: ModelConfig, seed: int) -> dict:
    """Seeded float32 weights: ``init_moe_params`` with a random norm
    scale and correction bias (it starts both at their constants)."""
    p = moe.init_moe_params(prng.PRNGKey(seed, "cpu"), cfg, torch.float32)
    g = torch.Generator().manual_seed(seed)
    p["ln"] = 1.0 + 0.1 * torch.randn(cfg.d_model, generator=g)
    if "router_bias" in p:
        p["router_bias"] = 0.05 * torch.randn(cfg.n_experts, generator=g)
    return p


def probe(cfg: ModelConfig, seed: int, shape=(2, 48)) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn((*shape, cfg.d_model), generator=g)


def assert_same_choice(top_e, want_e, margin):
    """The same set of experts at every token clear of a tie, and most
    tokens clear."""
    clear = margin > TAU
    assert clear.float().mean() > 0.8
    got = torch.sort(top_e.reshape(want_e.shape), -1).values
    want = torch.sort(want_e, -1).values
    assert torch.equal(got[clear], want[clear])


@pytest.mark.parametrize("groups", [(1, 1), (4, 2)], ids=["one-group",
                                                          "4-groups-keep-2"])
@pytest.mark.parametrize("norm", [True, False], ids=["normed", "unnormed"])
def test_sigmoid_routing_matches_the_reference(groups, norm):
    """Sigmoid scores, the bias used for the choice only, the group step,
    the weights from the unbiased scores (normalised or not) times the
    routed scaling."""
    cfg = small_config(n_group=groups[0], topk_group=groups[1],
                       norm_topk_prob=norm)
    p = params(cfg, 11)
    x = probe(cfg, 11)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    probs, top_w, top_e = moe.route(p, h, cfg)
    s, want_w, want_e, margin = ref.route(
        ref.rms_norm(x.reshape(-1, cfg.d_model), p["ln"], cfg.norm_eps),
        p["router"], p["router_bias"], routing_of(cfg))
    torch.testing.assert_close(probs.reshape(s.shape).double(), s,
                               rtol=0, atol=TOL)
    assert_same_choice(top_e, want_e, margin)
    clear = margin > TAU
    torch.testing.assert_close(top_w.reshape(want_w.shape)[clear].double(),
                               want_w[clear], rtol=TOL, atol=TOL)
    if groups[1] < groups[0]:
        # every choice lies in the topk_group best groups
        E_g = cfg.n_experts // cfg.n_group
        per_token = (top_e // E_g).reshape(-1, cfg.experts_per_token)
        assert max(len(set(r.tolist())) for r in per_token) <= cfg.topk_group


def test_sigmoid_routing_ties_take_the_lower_expert_first():
    """Two router columns and biases equal: their biased scores tie
    exactly, and the port, like the reference, takes the lower index."""
    cfg = small_config(n_experts=6, experts_per_token=3)
    p = params(cfg, 5)
    for c in (4, 5):
        p["router"][:, c] = p["router"][:, 1]
        p["router_bias"][c] = p["router_bias"][1]
    x = probe(cfg, 5)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    _, _, top_e = moe.route(p, h, cfg)
    _, _, want_e, _ = ref.route(h.reshape(-1, cfg.d_model).double(),
                                p["router"], p["router_bias"],
                                routing_of(cfg))
    assert torch.equal(top_e.reshape(want_e.shape), want_e)
    assert ((want_e == 1) & ~(want_e == 4).any(-1, keepdim=True)).any()


def test_moe_ffn_with_shared_experts_matches_the_reference():
    """``moe_ffn`` of a DeepSeek-V3 block: the routed experts at a capacity
    that drops nothing, plus the shared experts' MLP, plus the residual."""
    cfg = small_config(capacity_factor=4.0)      # E / K: capacity S
    p = params(cfg, 7)
    x = probe(cfg, 7)
    y = moe.moe_ffn(p, x, cfg)
    want = ref.moe_block(x.reshape(-1, cfg.d_model), p, routing_of(cfg),
                         cfg.norm_eps)
    torch.testing.assert_close(y.reshape(want.shape).double(), want,
                               rtol=TOL, atol=TOL)
    # and without the shared experts the difference is their MLP's
    p_routed = {k: v for k, v in p.items() if not k.startswith("shared")}
    y0 = moe.moe_ffn(p_routed, x, dataclasses.replace(cfg,
                                                      n_shared_experts=0))
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    torch.testing.assert_close(y - y0, moe.shared_mlp(p, h), rtol=1e-4,
                               atol=1e-5)


def test_dropless_dispatch_gives_every_pair_once():
    """Every (token, slot) pair once, grouped by expert in (token, slot)
    order, with the experts' counts; an expert nobody chose counts 0."""
    g = torch.Generator().manual_seed(3)
    T, K, E = 200, 3, 10
    # uneven loads; expert 9 never chosen
    w = torch.tensor([30.0, 10, 5, 5, 2, 1, 1, 0.5, 0.5, 0.0])
    top_e = torch.stack([torch.multinomial(w, K, generator=g)
                         for _ in range(T)])
    order, counts = moe.dispatch_dropless(top_e, E)
    assert sorted(order.tolist()) == list(range(T * K))
    assert torch.equal(counts, torch.bincount(top_e.reshape(-1),
                                              minlength=E))
    assert counts[9] == 0 and counts.max() > 3 * counts[1:9].min()
    experts = top_e.reshape(-1)[order]
    assert torch.equal(experts, torch.sort(experts).values)
    start = 0
    for n in counts.tolist():
        run = order[start:start + n]
        assert torch.equal(run, torch.sort(run).values)
        start += n


def _captured_prune(cfg, p, x, keep=0.5):
    """``prune_moe_layer`` with the kernels it passes to greedy MAP kept."""
    seen = []
    real = dpp_functional.greedy_map_kdpp

    def spy(L, k, backend=None):
        seen.append(L.clone())
        return real(L, k, backend=backend)

    dpp_functional.greedy_map_kdpp = spy
    try:
        out = prune.prune_moe_layer(p, x, cfg, keep)
    finally:
        dpp_functional.greedy_map_kdpp = real
    return out, seen


def _one_idle_expert(cfg, seed):
    """Weights under which expert 0 is never chosen."""
    p = params(cfg, seed)
    p["router"][:, 0] = 0.0
    p["router_bias"][0] = -2.0                 # sigmoid 0.5 - 2 < any other
    return p


def test_prune_moe_layer_matches_the_reference():
    """The routing, the experts' loads, every unit kernel (an expert with
    no tokens keeps only the ridge) and the picks of both selections,
    judged in float64 along their order."""
    cfg = small_config(d_ff=24, n_experts=8, experts_per_token=2)
    p = _one_idle_expert(cfg, 13)
    x = probe(cfg, 13, shape=(2, 64))
    out, (L, Ls) = _captured_prune(cfg, p, x)
    r = routing_of(cfg)
    x2 = x.reshape(-1, cfg.d_model)
    _, _, want_e, margin = ref.route(ref.rms_norm(x2, p["ln"], cfg.norm_eps),
                                     p["router"], p["router_bias"], r)
    assert_same_choice(out["top_e"], want_e, margin)
    loads = torch.bincount(out["top_e"].reshape(-1),
                           minlength=cfg.n_experts)
    assert torch.equal(out["tokens_per_expert"], loads)
    assert loads[0] == 0 and loads.sum() == x2.shape[0] * 2
    assert out["rows_computed"] == x2.shape[0] * 2
    assert L.shape == (8, 24, 24) and Ls.shape == (48, 48)
    assert torch.equal(L[0], 1e-4 * torch.eye(24))
    for e, want in ref.expert_unit_kernels(x2, p, r, cfg.norm_eps,
                                           out["top_e"]):
        torch.testing.assert_close(L[e].double(), want, rtol=0, atol=TOL)
    want_s = ref.shared_unit_kernel(x2, p, cfg.norm_eps)
    torch.testing.assert_close(Ls.double(), want_s, rtol=0, atol=TOL)
    assert out["routed"].shape == (8, 12) and out["shared"].shape == (24,)
    assert out["routed"].dtype == torch.int32
    for e, want in ref.expert_unit_kernels(x2, p, r, cfg.norm_eps,
                                           out["top_e"]):
        got = ref.judge(want, out["routed"][e], int(loads[e]))
        assert got["gap"] <= 1e-4, (e, got)
    assert ref.judge(want_s, out["shared"], x2.shape[0])["gap"] <= 1e-4


def test_batched_picks_equal_each_matrix_picks():
    """One greedy-MAP call on the (E, f, f) batch gives each matrix's picks
    of a call on that matrix alone, the idle expert's included."""
    cfg = small_config(d_ff=24, n_experts=8, experts_per_token=2)
    p = _one_idle_expert(cfg, 17)
    out, (L, _) = _captured_prune(cfg, p, probe(cfg, 17, shape=(2, 64)))
    one = torch.stack([dpp_functional.greedy_map_kdpp(L[e], 12)
                       for e in range(8)])
    assert torch.equal(out["routed"], one)
    assert out["routed"][0].tolist() == list(range(12))   # ridge: in order


def test_judge_counts_steps_past_the_rank_as_ties():
    """On a kernel of 3 rows' units, the steps from 3 on are not counted;
    a repeated pick still reads inf."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn(3, 8, generator=g, dtype=torch.float64)
    L = ref._gram_kernel(iter([A]), 8, torch.float64, "cpu", "exact")
    picks = ops.greedy_map_kdpp(L.float(), 6)
    got = ref.judge(L, picks, 3)
    assert got["ties"] == 3 and got["gap"] < 1e-5
    assert ref.judge(L, torch.tensor([0, 0, 1]), 3)["gap"] == float("inf")


def _route_before_sigmoid(p, h, cfg):
    """``moe.route`` as the port had it before sigmoid scoring."""
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
def test_softmax_routing_is_bitwise_as_before(arch):
    """The registered MoE families keep the defaults, and their routing,
    weights and ``moe_ffn`` output are bit for bit what they were; the
    choice is the JAX package's ``lax.top_k``."""
    cfg = smoke_config(arch)
    assert (cfg.router_scoring, cfg.n_shared_experts,
            cfg.norm_topk_prob, cfg.routed_scaling, cfg.n_group,
            cfg.topk_group) == ("softmax", 0, True, 1.0, 1, 1)
    p = moe.init_moe_params(prng.PRNGKey(4, "cpu"), cfg, torch.float32)
    assert "router_bias" not in p and "shared_gate" not in p
    x = probe(cfg, 4)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    got = moe.route(p, h, cfg)
    want = _route_before_sigmoid(p, h, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    jcfg = jax_smoke_config(arch)
    jtop = jax.lax.top_k(jnp.asarray(want[0].numpy()),
                         jcfg.experts_per_token)[1]
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jtop))


@pytest.mark.cuda
def test_batched_launch_equals_single_launches_on_the_card():
    """At the cell's shape, (64, 1408, 1408) with k = 704: each matrix's
    picks of the one batched launch equal its single launch, an idle
    expert's ridge-only kernel among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused greedy-MAP kernel has "
                    "no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(9)
    H, N, k = 64, 1408, 704
    L = torch.empty((H, N, N), device=dev)
    for h in range(H):
        n = 0 if h == 0 else int(200 + 97 * h)
        A = torch.randn((n, N), generator=g, device=dev)
        prune.unit_kernel(A, L[h])
    batched = ops.greedy_map_kdpp(L, k)
    for h in range(H):
        assert torch.equal(batched[h], ops.greedy_map_kdpp(L[h], k)), h
    assert batched[0].tolist() == list(range(k))
