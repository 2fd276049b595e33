"""The port's LM stack (``repro_torch.config``, ``configs``, ``models``,
``convert.lm_params_*``) against the JAX package's ``repro.config``,
``repro.configs`` and ``repro.models`` on the CPU, at smoke size (2 layers,
d_model 64, 4 heads of 16, vocab 256).

The JAX params go to the port through ``lm_params_from_numpy``, so both
packages compute on the same float32 weights. Tolerances:

* float32 logits and caches: max |Δ| ≤ 2e-5 · max(1, max |JAX|) — float32
  roundoff of a 2-layer stack whose products and sums run in another
  order (measured: under 5e-6);
* decode against forward (one package): max |Δ| ≤ 2e-2 of max |forward|,
  as ``tests/test_models.py``;
* bfloat16 compute: logits within 0.05 · max |JAX| and the caches within
  4 bfloat16 units at their scale — both packages round each product and
  elementwise result to bfloat16, but not at the same places (XLA may keep
  a fused chain in float32);
* ``init_params(key)``: the leaves equal JAX's to 6e-6 relative of the
  leaf's max — ``random.normal`` takes XLA's uniforms bit for bit but
  ``torch.erfinv``, not XLA's polynomial (at most 91 units in the last
  place, in the tails);
* the config registry, parameter counts and the converter: exact."""

import dataclasses
import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch import random as tr
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import LM, DecodeState, KVCache
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import tree_map
from repro_torch.models import common as tcommon

DENSE = ["qwen2-0.5b", "qwen1.5-32b", "h2o-danube-3-4b", "starcoder2-15b",
         "chameleon-34b"]
FAMILIES = ["mixtral-8x7b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-tiny"]
F32_TOL = 2e-5
INIT_RTOL = 6e-6


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_close(got, want, tol=F32_TOL, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: max |Δ| {err} > {tol} · {scale}"


def jax_setup(arch, **overrides):
    """(JAX LM, JAX params, port LM, the JAX params in the port)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **overrides)
    jlm = JaxLM(jcfg)
    jp = jlm.init_params(jax.random.PRNGKey(0))
    return jlm, jp, LM(tcfg, device="cpu"), lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def tokens_for(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# the config registry
# ---------------------------------------------------------------------------

#: ``ModelConfig`` fields the reference's lacks: DeepSeek-V3 routing and
#: shared experts, which no registered architecture uses.
PORT_ONLY_FIELDS = {"n_shared_experts", "router_scoring",
                    "norm_topk_prob", "routed_scaling", "n_group",
                    "topk_group"}


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_registry_equals_the_reference(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for get in ("get_config", "smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        # the port's own fields (DeepSeek-V3 routing) keep their defaults,
        # under which it routes as the reference does
        own = {f.name: f.default for f in dataclasses.fields(got)
               if f.name not in dataclasses.asdict(want)}
        assert set(own) == PORT_ONLY_FIELDS
        assert {k: getattr(got, k) for k in own} == own
        assert {k: v for k, v in dataclasses.asdict(got).items()
                if k not in own} == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.hd, got.vocab_padded, got.is_ssm_only) == \
            (want.hd, want.vocab_padded, want.is_ssm_only)
        assert [got.layer_kind(i).value for i in range(got.n_layers)] == \
            [want.layer_kind(i).value for i in range(want.n_layers)]
    for include in (False, True):
        assert tconfigs.cells(include) == jconfigs.cells(include)
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert [dataclasses.asdict(s) for s in tconfig.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.LM_SHAPES]
    assert dataclasses.asdict(tconfigs.get_shape("decode_32k")) == \
        dataclasses.asdict(jconfigs.get_shape("decode_32k"))
    assert dataclasses.asdict(tconfig.ParallelConfig()) == \
        dataclasses.asdict(jconfig.ParallelConfig())
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# common.py and attention.py
# ---------------------------------------------------------------------------

def test_rms_norm_rope_and_stable_softmax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    xt, st = tensors(x, scale)
    assert_close(tcommon.rms_norm(xt, st, 1e-5),
                 jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
                 label="rms_norm")
    pos = np.array([[0, 1, 7, 100, 4095]], np.int32)
    assert_close(tcommon.rope(xt, torch.from_numpy(pos), 1e6),
                 jcommon.rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                 label="rope")
    scores = rng.normal(size=(3, 6)).astype(np.float32) * 10
    mask = rng.random((3, 6)) < 0.5
    mask[1] = False                                  # a fully-masked row
    got = tcommon.stable_softmax(*tensors(scores, mask))
    want = jcommon.stable_softmax(jnp.asarray(scores), jnp.asarray(mask))
    assert_close(got, want, label="stable_softmax")
    assert (got[1] == 0).all() and torch.isfinite(got).all()


def attn_inputs(arch, S, seed=0, **overrides):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch), **overrides)
    jp = jattn.init_attn_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("arch, S, route", [
    ("qwen2-0.5b", 48, "full, three query chunks"),
    ("qwen2-0.5b", 20, "full, one chunk (S % C != 0)"),
    ("h2o-danube-3-4b", 24, "SWA on the full keys (S <= W + C)"),
    ("h2o-danube-3-4b", 64, "SWA banded (S > W + C)"),
])
def test_attention_forward_matches_jax(arch, S, route):
    jcfg, tcfg, jp, tp, x = attn_inputs(arch, S)
    jy, (jk, jv) = jattn.attention_forward(jp, jnp.asarray(x), jcfg,
                                           return_kv=True)
    ty, (tk, tv) = tattn.attention_forward(tp, torch.from_numpy(x), tcfg,
                                           return_kv=True)
    for got, want, name in ((ty, jy, "y"), (tk, jk, "k"), (tv, jv, "v")):
        assert_close(got, want, label=f"{route}: {name}")


@pytest.mark.parametrize("S", [10, 16, 37, 48])
def test_fill_kv_cache_ring_matches_jax(S):
    """SWA window 16: S ≤ W keeps every slot; S > W rolls the last W keys
    so that slot s holds position p ≡ s (mod W)."""
    cfg = tconfigs.smoke_config("h2o-danube-3-4b")
    k = np.random.default_rng(S).normal(size=(2, S, 2, 16)).astype(
        np.float32)
    v = k[::-1].copy()
    want = jattn.fill_kv_cache(jconfigs.smoke_config("h2o-danube-3-4b"),
                               jnp.asarray(k), jnp.asarray(v))
    got = tattn.fill_kv_cache(cfg, *tensors(k, v))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    assert int(got.pos) == int(want.pos) == S and got.pos.dtype == \
        torch.int32


@pytest.mark.parametrize("arch, size, pos", [
    ("qwen2-0.5b", 32, 0), ("qwen2-0.5b", 32, 19),       # linear slots
    ("h2o-danube-3-4b", 16, 9), ("h2o-danube-3-4b", 16, 41),   # the ring
])
def test_attention_decode_matches_jax(arch, size, pos):
    jcfg, tcfg, jp, tp, x = attn_inputs(arch, 1)
    rng = np.random.default_rng(pos)
    k, v = (rng.normal(size=(2, size, jcfg.n_kv_heads, jcfg.hd)).astype(
        np.float32) for _ in range(2))
    jy, jc = jattn.attention_decode(jp, jnp.asarray(x), jattn.KVCache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32)), jcfg)
    cache = KVCache(*tensors(k, v), torch.tensor(pos, dtype=torch.int32))
    ty, tc = tattn.attention_decode(tp, torch.from_numpy(x), cache, tcfg)
    assert_close(ty, jy, label="y")
    assert_close(tc.k, jc.k, label="k")
    assert_close(tc.v, jc.v, label="v")
    assert int(tc.pos) == pos + 1
    np.testing.assert_array_equal(cache.k.numpy(), k)    # left as it was


# ---------------------------------------------------------------------------
# the LM against the JAX package, on the JAX params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_prefill_decode_match_jax(arch):
    jlm, jp, lm, params = jax_setup(arch)
    cfg = lm.cfg
    S = 40 if cfg.sliding_window else 24       # SWA: banded (40 > 16 + 16)
    toks = tokens_for(cfg, 2, S)
    assert_close(lm.forward(params, toks),
                 jlm.forward(jp, jnp.asarray(toks)), label="forward")
    jl, js = jlm.prefill(jp, jnp.asarray(toks))
    tl, ts = lm.prefill(params, toks)
    assert tl.shape == (2, 1, cfg.vocab_padded)
    assert_close(tl, jl, label="prefill logits")
    jc = js.caches["head"]["layer0"]
    tc = ts.caches["head"]["layer0"]
    assert_close(tc.k, jc.k, label="cache k")
    assert_close(tc.v, jc.v, label="cache v")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    nxt = np.array([[3], [250]], np.int32)
    for _ in range(3):
        jl, js = jlm.decode_step(jp, jnp.asarray(nxt), js)
        tl, ts = lm.decode_step(params, nxt, ts)
        assert_close(tl, jl, label="decode logits")
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jc, tc = js.caches["head"]["layer0"], ts.caches["head"]["layer0"]
    assert_close(tc.k, jc.k, label="decoded cache k")
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    # the padded vocab is masked in prefill and decode logits
    if cfg.vocab_padded != cfg.vocab:
        assert (tl[..., cfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """As ``tests/test_models.py``: token-by-token decode from an empty
    cache reproduces the forward logits (SWA: past the window)."""
    _, _, lm, params = jax_setup(arch)
    cfg = lm.cfg
    B, S = 2, 24
    toks = tokens_for(cfg, B, S)
    full = lm.forward(params, toks)[..., :cfg.vocab]
    state = lm.init_decode_state(B, 40)
    outs = []
    for t in range(S):
        lg, state = lm.decode_step(params, toks[:, t:t + 1], state)
        outs.append(lg[:, 0, :cfg.vocab])
    dec = torch.stack(outs, 1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-2, rel


def test_prefill_then_decode_continuity_and_the_swa_ring():
    """``tests/test_models.py``'s two continuity checks: prefill equals
    pure decode, for full attention and for an SWA prompt past the window;
    for SWA the ring from ``fill_kv_cache`` then continues as the decode
    cache does. (A full-attention prefill cache holds exactly S slots, so
    the next step writes slot S % S = 0, over position 0, in both
    packages: ``tests/test_torch_serve_engine.py`` pins that.)"""
    for arch, S in (("qwen2-0.5b", 12), ("h2o-danube-3-4b", 28)):
        _, _, lm, params = jax_setup(arch)
        cfg = lm.cfg
        toks = tokens_for(cfg, 2, S)
        lp, state_p = lm.prefill(params, toks)
        state_d = lm.init_decode_state(2, 64)
        for t in range(S):
            ld, state_d = lm.decode_step(params, toks[:, t:t + 1], state_d)
        assert_close(lp, ld, tol=2e-5, label=f"{arch} prefill vs decode")
        if not cfg.sliding_window:
            continue
        nxt = np.array([[7], [9]], np.int32)
        l1, _ = lm.decode_step(params, nxt, state_p)
        l2, _ = lm.decode_step(params, nxt, state_d)
        assert_close(l1, l2, tol=2e-5, label=f"{arch} continued")


def test_bfloat16_compute_matches_jax_at_bf16_tolerance():
    """dtype="bfloat16": every stacked block leaf (norm scales and QKV
    biases too) is cast, only ``ln_f`` stays float32; prefill returns
    bfloat16 logits and caches, as in the JAX package."""
    jlm, jp, lm, params = jax_setup("qwen2-0.5b", dtype="bfloat16")
    cast = lm._cast(params)
    assert cast["ln_f"].dtype == torch.float32
    assert all(a.dtype == torch.bfloat16 for a in jax.tree_util.tree_leaves(
        cast["blocks"])) and cast["embed"].dtype == torch.bfloat16
    toks = tokens_for(lm.cfg, 2, 24)
    jl, js = jlm.prefill(jp, jnp.asarray(toks))
    tl, ts = lm.prefill(params, toks)
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    tc, jc = ts.caches["head"]["layer0"], js.caches["head"]["layer0"]
    assert tc.k.dtype == torch.bfloat16
    live = slice(0, lm.cfg.vocab)
    assert_close(tl[..., live], jl[..., live].astype(jnp.float32), tol=0.05,
                 label="bf16 prefill logits")
    kscale = float(np.abs(np.asarray(jc.k, np.float32)).max())
    err = float(np.abs(tc.k.float().numpy() - np.asarray(jc.k, np.float32))
                .max())
    assert err <= 4 * 2 ** -8 * kscale, err
    jf = jlm.forward(jp, jnp.asarray(toks)).astype(jnp.float32)
    assert_close(lm.forward(params, toks)[..., live], jf[..., live],
                 tol=0.05, label="bf16 forward")


@pytest.mark.parametrize("arch", DENSE + ["mamba2-2.7b", "whisper-tiny"])
def test_init_params_match_jax_from_the_same_key(arch):
    jcfg = jconfigs.smoke_config(arch)
    want = jax.tree_util.tree_map(
        np.asarray, JaxLM(jcfg).init_params(jax.random.PRNGKey(7)))
    got = lm_params_to_numpy(
        LM(tconfigs.smoke_config(arch), device="cpu").init_params(
            tr.PRNGKey(7, "cpu")))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, got_leaves)) == sorted(str(p) for p, _ in
                                                  want_leaves)
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= INIT_RTOL * scale, path


def test_converter_round_trip_leaf_by_leaf():
    jlm, jp, lm, params = jax_setup("qwen1.5-32b")
    carried = jax.tree_util.tree_map(np.asarray, jp)
    back = lm_params_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(carried)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(carried),
                              jax.tree_util.tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b)
    _, js = jlm.prefill(jp, jnp.asarray(tokens_for(lm.cfg, 2, 8)))
    state = decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                    "cpu")
    assert isinstance(state, DecodeState)
    cache = state.caches["head"]["layer0"]
    assert isinstance(cache, KVCache) and cache.pos.dtype == torch.int32
    again = decode_state_to_numpy(state).caches["head"]["layer0"]
    want = js.caches["head"]["layer0"]
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(getattr(again, name),
                                      np.asarray(getattr(want, name)))
    # bfloat16 leaves cross exactly, through float32
    bf = {"w": jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)}
    t = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, bf), "cpu")
    assert t["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lm_params_to_numpy(t)["w"],
                                  np.asarray(bf["w"], np.float32))


def _shapes(tree, prefix=""):
    """{leaf path: (shape, dtype name)} of a nested dict of arrays or
    tensors."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _shapes(tree[key], f"{prefix}/{key}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                 ""))}


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_arch_builds_with_the_references_param_shapes(arch):
    """The MoE, SSM, hybrid and encoder-decoder configs build (the port
    once refused them): ``init_params``' leaf paths, shapes and dtypes are
    ``jax.eval_shape`` of the JAX ``LM.init_params``, at smoke size on the
    CPU and at the full config (on the meta device: shapes only)."""
    for get, device in ((tconfigs.smoke_config, "cpu"),
                        (tconfigs.get_config, "meta")):
        cfg = get(arch)
        want = jax.eval_shape(JaxLM(getattr(jconfigs, get.__name__)(arch))
                              .init_params, jax.random.PRNGKey(0))
        got = LM(cfg, device=device).init_params(tr.PRNGKey(0, device))
        assert _shapes(got) == _shapes(want), (arch, device)


@pytest.mark.cuda
def test_lm_on_card_matches_cpu_copy():
    """qwen2-0.5b at smoke size: the card's prefill and decode logits
    against a CPU copy of the same params, float32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tconfigs.smoke_config("qwen2-0.5b")
    cpu, card = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    params = cpu.init_params(tr.PRNGKey(0, "cpu"))
    on_card = card.init_params(tr.PRNGKey(0, "cuda"))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(on_card)):
        # the same uniforms; CUDA's erfinv and the CPU's may differ in ulps
        assert_close(b.cpu(), a.numpy(), tol=INIT_RTOL, label="init")
    params = tree_map(lambda a: a.cuda(), params)
    on_card = params
    params = tree_map(lambda a: a.cpu(), params)
    toks = tokens_for(cfg, 2, 24)
    lc, sc = cpu.prefill(params, toks)
    lg, sg = card.prefill(on_card, toks)
    assert_close(lg.cpu(), lc.numpy(), label="prefill")
    nxt = np.array([[1], [2]], np.int32)
    lc, _ = cpu.decode_step(params, nxt, sc)
    lg, _ = card.decode_step(on_card, nxt, sg)
    assert_close(lg.cpu(), lc.numpy(), label="decode")
