"""The port's MoE, SSM, hybrid and encoder-decoder families
(``repro_torch.models.{moe,ssm,transformer,attention}``, the engine and the
converter on their states) against the JAX package's ``repro.models`` and
``repro.serve`` on the CPU, at smoke size: mixtral-8x7b and
qwen3-moe-235b-a22b (4 experts, top 2), mamba2-2.7b (2 SSD layers of 8
heads of 16, state 16, chunk 8), jamba-1.5-large-398b (2 units of [attn,
ssm+moe]; its smoke config has no unit tail, so ``TAIL`` gives one unit of
8 layers, a head of 2 and 3 repeats of [ssm, ssm+moe]) and whisper-tiny (2
encoder and 2 decoder layers, 24 frames).

The JAX params go to the port through ``lm_params_from_numpy``, so both
packages compute on the same float32 weights. Tolerances:

* float32 logits, caches and losses: max |Δ| ≤ 1e-4 · max(1, max |JAX|)
  (measured: under 4e-6); MoE outputs 1e-5 of max |JAX|; routing (the
  chosen experts, then the slot map) exact, compared first so that a
  failure names its cause;
* bfloat16 compute (mixtral, mamba2): logits within 0.05 · max |JAX|, the
  bf16 tolerance of ``test_torch_models``'s bfloat16 test; the caches
  within 4 bfloat16 units at their scale (KV, conv window) or 0.05 of
  max |JAX| (the float32 SSM state, summed from bfloat16 inputs);
* decode against forward (one package): 2e-2 of max |forward|, as
  ``tests/test_models.py`` (MoE at capacity_factor 8, no token dropped);
* ``init_params(key)``: ``INIT_RTOL`` of ``test_torch_models``;
* kept positions of a compaction: equal or a proven tie
  (``test_torch_serve_engine.assert_heads_match``).

The init-from-a-key and bfloat16 cases live in
``tests/test_torch_model_families_numerics.py``, which imports the
helpers and tolerances of this file, so that ``--dist loadfile`` runs
the two halves on two workers."""

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

from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch import random as tr
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, lm_params_from_numpy,
                                 lm_params_to_numpy)
from repro_torch.models import LM, KVCache, SSMCache
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import tree_map
from repro_torch.serve import ServeEngine
from test_torch_serve_engine import (assert_heads_match, capture,
                                     kept_positions)

TOL = 1e-4
MOE_TOL = 1e-5
BF16_TOL = 0.05
DVF_TOL = 2e-2
TAIL = dict(hybrid_period=8, unit_head=2, unit_tail_period=2, n_layers=8)
ARCHS = [("mixtral-8x7b", {}), ("qwen3-moe-235b-a22b", {}),
         ("mamba2-2.7b", {}), ("jamba-1.5-large-398b", {}),
         ("jamba-1.5-large-398b", TAIL), ("whisper-tiny", {})]
IDS = ["mixtral", "qwen3-moe", "mamba2", "jamba", "jamba-tail", "whisper"]


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=TOL, label=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: max |Δ| {err} > {tol} · {scale}"


def configs(arch, overrides=None, **kw):
    overrides = dict(overrides or {}, **kw)
    return (dataclasses.replace(jconfigs.smoke_config(arch), **overrides),
            dataclasses.replace(tconfigs.smoke_config(arch), **overrides))


def setup(arch, overrides=None, **kw):
    """(JAX LM, JAX params, port LM, the JAX params in the port)."""
    jcfg, tcfg = configs(arch, overrides, **kw)
    jlm = JaxLM(jcfg)
    jp = jlm.init_params(jax.random.PRNGKey(0))
    return jlm, jp, LM(tcfg, device="cpu"), lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def seq_len(cfg) -> int:
    """A prompt length: a multiple of the SSD chunk (8) for SSM layers, past
    the window plus a chunk (16 + 16) for SWA."""
    return 40 if cfg.sliding_window else 24


def inputs(cfg, B=2, S=None, seed=1):
    """Seeded tokens (B, S) and, for whisper, frame embeddings."""
    S = seq_len(cfg) if S is None else S
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    enc = None
    if cfg.encoder_layers:
        enc = np.random.default_rng(seed + 1).standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, enc


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def assert_caches_close(got, want, tol=TOL, label=""):
    """Two cache trees (port, JAX) leaf for leaf: ``KVCache`` k/v,
    ``SSMCache`` conv/state within ``tol``, ``pos`` equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for k in want:
            assert_caches_close(got[k], want[k], tol, f"{label}/{k}")
        return
    assert type(got).__name__ == type(want).__name__, label
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), label)
            assert g.dtype == torch.int32, label
        else:
            assert_close(g, w, tol, f"{label}.{name}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def test_converter_carries_tail_encoder_and_cross_leaves_bitwise():
    for arch, overrides in (("jamba-1.5-large-398b", TAIL),
                            ("whisper-tiny", {})):
        _, jp, _, params = setup(arch, overrides)
        carried = jax.tree_util.tree_map(np.asarray, jp)
        back = lm_params_to_numpy(params)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(carried)
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(carried),
                jax.tree_util.tree_leaves_with_path(back)):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b)
    assert {"encoder", "cross"} <= set(params)


# ---------------------------------------------------------------------------
# moe.py
# ---------------------------------------------------------------------------

def jax_routing(jp, x, cfg, C):
    """The reference's routing and slot map (``moe_ffn``'s own lines; the
    JAX module returns only the output): (top_e (B, S, K), dest (B, S·K))."""
    E, K = cfg.n_experts, cfg.experts_per_token
    S = x.shape[1]
    h = jcommon.rms_norm(x, jp["ln"], cfg.norm_eps)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ jp["router"], axis=-1)
    top_e = jax.lax.top_k(probs, K)[1]

    def slot_one(e_ids):
        order = jnp.argsort(e_ids)
        sorted_e = e_ids[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(E))
        rank = jnp.arange(S * K) - starts[sorted_e]
        dest = jnp.where(rank < C, sorted_e * C + rank, E * C)
        return dest[jnp.argsort(order)]

    return np.asarray(top_e), np.asarray(
        jax.vmap(slot_one)(top_e.reshape(x.shape[0], S * K)))


MOE_CASES = [("mixtral-8x7b", {}, 1.25), ("mixtral-8x7b", {}, 8.0),
             ("qwen3-moe-235b-a22b", {}, 1.25),
             ("qwen3-moe-235b-a22b", dict(n_experts=16, experts_per_token=8),
              1.25),
             ("qwen3-moe-235b-a22b", dict(n_experts=16, experts_per_token=8),
              8.0)]


@pytest.mark.parametrize("arch, overrides, cf", MOE_CASES,
                         ids=["mixtral-drop", "mixtral-nodrop", "qwen3-drop",
                              "k8-drop", "k8-nodrop"])
def test_moe_ffn_matches_jax_with_and_without_drops(arch, overrides, cf):
    """``moe_ffn`` on the same x and weights: the chosen experts, then the
    slot map (drops into the sentinel at capacity 1.25, none at 8), then
    the output; ``moe_aux_loss`` too. The K = 8 cases (qwen3-moe's top-8)
    sum eight pairs a token."""
    jcfg, tcfg = configs(arch, overrides, capacity_factor=cf)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    B, S = 2, 48
    # a component shared by every token skews the routing toward a few
    # experts, so that capacity 1.25 drops pairs
    x = (np.random.default_rng(4).standard_normal((B, S, jcfg.d_model))
         + 1.5).astype(np.float32)
    C = tmoe.group_capacity(S, tcfg)
    assert C == jmoe.group_capacity(S, jcfg)
    want_e, want_dest = jax_routing(jp, jnp.asarray(x), jcfg, C)
    h = tmoe.rms_norm(torch.from_numpy(x), tp["ln"], tcfg.norm_eps)
    _, _, top_e = tmoe.route(tp, h, tcfg)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    dest = tmoe.slot_map(top_e, tcfg.n_experts, C)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    dropped = int((want_dest == jcfg.n_experts * C).sum())
    assert (dropped > 0) == (cf < 2), dropped
    assert_close(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg),
                 jmoe.moe_ffn(jp, jnp.asarray(x), jcfg), MOE_TOL, "moe_ffn")
    assert_close(tmoe.moe_aux_loss(tp, torch.from_numpy(x), tcfg),
                 jmoe.moe_aux_loss(jp, jnp.asarray(x), jcfg), MOE_TOL, "aux")


def test_routing_ties_take_the_lower_expert_first():
    """Two router columns equal: their probabilities tie exactly, and both
    packages take the lower expert index first (``lax.top_k``'s rule)."""
    jcfg, tcfg = configs("mixtral-8x7b", n_experts=6, experts_per_token=3)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    r = np.asarray(jp["router"]).copy()
    r[:, 4] = r[:, 1]
    r[:, 5] = r[:, 1]
    jp = dict(jp, router=jnp.asarray(r))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    want_e, _ = jax_routing(jp, jnp.asarray(x), jcfg, 1)
    h = tmoe.rms_norm(torch.from_numpy(x), tp["ln"], tcfg.norm_eps)
    probs, _, top_e = tmoe.route(tp, h, tcfg)
    assert (probs[..., 1] == probs[..., 4]).all()
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    assert ((want_e == 1) | (want_e == 4)).any()      # a tie was decided


# ---------------------------------------------------------------------------
# ssm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 4], ids=["three-chunks", "one-short-chunk"])
def test_ssm_forward_and_decode_match_jax(S):
    """``ssm_forward(return_state=True)`` and three ``ssm_decode`` steps from
    its cache: outputs, ``conv``, ``state`` and ``pos``."""
    jcfg, tcfg = configs("mamba2-2.7b")
    jp = jssm.init_ssm_params(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jy, jc = jssm.ssm_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tc = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg,
                              return_state=True)
    assert isinstance(tc, SSMCache)
    assert_close(ty, jy, label="y")
    assert_close(tssm.ssm_forward(tp, torch.from_numpy(x), tcfg), jy,
                 label="y without the state")
    assert_caches_close(tc, jc, label="prefill cache")
    for t in range(3):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jssm.ssm_decode(jp, jnp.asarray(x1), jc, jcfg)
        conv_before = tc.conv.clone()
        ty, tc2 = tssm.ssm_decode(tp, torch.from_numpy(x1), tc, tcfg)
        assert torch.equal(tc.conv, conv_before)         # left as it was
        tc = tc2
        assert_close(ty, jy, label=f"decode {t}")
        assert_caches_close(tc, jc, label=f"decode cache {t}")


def test_ssm_prompt_must_fill_whole_chunks():
    """The reference's assertion: S ≤ ssm_chunk or a multiple of it."""
    _, tcfg = configs("mamba2-2.7b")
    tp = tssm.init_ssm_params(tr.PRNGKey(0, "cpu"), tcfg, torch.float32)
    with pytest.raises(AssertionError):
        tssm.ssm_forward(tp, torch.zeros((1, 12, tcfg.d_model)), tcfg)


# ---------------------------------------------------------------------------
# the LM against the JAX package, on the JAX params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, overrides", ARCHS, ids=IDS)
def test_forward_prefill_decode_and_loss_match_jax(arch, overrides):
    jlm, jp, lm, params = setup(arch, overrides)
    cfg = lm.cfg
    toks, enc = inputs(cfg)
    assert_close(lm.forward(params, toks, enc_embeds=enc),
                 jlm.forward(jp, jnp.asarray(toks),
                             enc_embeds=jnp_or_none(enc)), label="forward")
    jl, js = jlm.prefill(jp, jnp.asarray(toks), enc_embeds=jnp_or_none(enc))
    tl, ts = lm.prefill(params, toks, enc_embeds=enc)
    assert tl.shape == (2, 1, cfg.vocab_padded)
    assert_close(tl, jl, label="prefill logits")
    assert_caches_close(ts.caches, js.caches, label="prefill caches")
    assert (ts.enc_out is None) == (js.enc_out is None)
    if enc is not None:
        assert_close(ts.enc_out, js.enc_out, label="enc_out")
    nxt = np.array([[3], [250]], np.int32)
    for t in range(4):
        jl, js = jlm.decode_step(jp, jnp.asarray(nxt), js)
        tl, ts = lm.decode_step(params, nxt, ts)
        assert_close(tl, jl, label=f"decode logits {t}")
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    assert_caches_close(ts.caches, js.caches, label="decoded caches")
    batch = {"tokens": np.concatenate([toks, nxt], 1)}
    if enc is not None:
        batch["enc_embeds"] = enc
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    assert_close(lm.loss_fn(params, batch), jlm.loss_fn(jp, jb),
                 label="loss")


@pytest.mark.parametrize("arch, overrides", ARCHS, ids=IDS)
def test_decode_matches_forward(arch, overrides):
    """As ``tests/test_models.py``: token-by-token decode from an empty
    state reproduces the forward logits (MoE at capacity_factor 8, so that
    no token is dropped; whisper from its encoder states)."""
    _, _, lm, params = setup(arch, overrides, capacity_factor=8.0)
    cfg = lm.cfg
    toks, enc = inputs(cfg, S=16)
    full = lm.forward(params, toks, enc_embeds=enc)[..., :cfg.vocab]
    state = lm.init_decode_state(2, 32, enc_embeds=enc, params=params)
    outs = []
    for t in range(toks.shape[1]):
        lg, state = lm.decode_step(params, toks[:, t:t + 1], state)
        outs.append(lg[:, 0, :cfg.vocab])
    rel = float((torch.stack(outs, 1) - full).abs().max()) / \
        (float(full.abs().max()) + 1e-9)
    assert rel < DVF_TOL, rel


def test_remat_under_grad_gives_the_same_loss_and_grads():
    """``cfg.remat`` checkpoints a unit, and each layer of a multi-layer
    unit, while grad is on: the loss and every grad equal the run without
    it (jamba's tail unit)."""
    _, jp, lm, params = setup("jamba-1.5-large-398b", TAIL)
    lm_r = LM(dataclasses.replace(lm.cfg, remat=True), device="cpu")
    toks, _ = inputs(lm.cfg, S=17)
    out = []
    for model in (lm, lm_r):
        leaves = [a.clone().requires_grad_(True)
                  for a in jax.tree_util.tree_leaves(params)]
        p = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), leaves)
        loss = model.loss_fn(p, {"tokens": toks})
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_every_entry_point_wants_enc_embeds_for_whisper():
    _, _, lm, params = setup("whisper-tiny")
    toks, _ = inputs(lm.cfg)
    for call in (lambda: lm.forward(params, toks),
                 lambda: lm.prefill(params, toks),
                 lambda: lm.init_decode_state(2, 8, params=params)):
        with pytest.raises(ValueError, match="enc_embeds"):
            call()


# ---------------------------------------------------------------------------
# the engine, compaction and the converter on the new states
# ---------------------------------------------------------------------------

BUDGET, RECENCY = 16, 4


@pytest.mark.parametrize("method", ["sample", "map"])
def test_jamba_compaction_keeps_the_jax_positions_and_the_ssm_caches(method):
    """Inline compaction of jamba's prefill state under one seed: keys are
    split for the ``KVCache`` leaves only (the attention layer of each
    unit), so every head keeps the JAX engine's positions (or differs on a
    proven tie); every ``SSMCache`` comes back as the same object, bit for
    bit; the engine key after it is the JAX engine's."""
    jlm, jp, lm, params = setup("jamba-1.5-large-398b")
    S, seed = 48, 5
    toks, _ = inputs(lm.cfg, S=S, seed=9)
    eng = ServeEngine(lm, params, seed=seed, device="cpu")
    jeng = JaxEngine(jlm, jp, seed=seed)
    _, ts = lm.prefill(eng.params, toks)
    _, js = jlm.prefill(jp, jnp.asarray(toks))
    tc = eng.compact_kv(ts, BUDGET, RECENCY, method)
    jc = jeng.compact_kv(js, BUDGET, RECENCY, method)
    np.testing.assert_array_equal(tr.key_data(eng._key),
                                  np.asarray(jeng._key))
    for name in ("layer1",):
        assert tc.caches["head"][name] is ts.caches["head"][name]
        assert isinstance(tc.caches["head"][name], SSMCache)
    head_keys = None
    if method == "sample":
        ckey = jax.random.split(jax.random.PRNGKey(seed))[1]
        head_keys = []
        for _ in range(2):                       # one split a unit
            ckey, sub = jax.random.split(ckey)
            head_keys.append(np.asarray(jax.random.split(sub, (2, 2))))
        head_keys = np.stack(head_keys)
    keys = ts.caches["head"]["layer0"].k.numpy()
    jkeys = np.asarray(js.caches["head"]["layer0"].k)
    assert_heads_match(
        keys, jkeys, kept_positions(keys, tc.caches["head"]["layer0"].k
                                    .numpy()),
        kept_positions(jkeys, np.asarray(jc.caches["head"]["layer0"].k)),
        S, method, head_keys)


def test_whisper_engine_with_inline_compaction_matches_jax():
    """whisper through both engines with ``enc_embeds`` and inline
    ``"map"`` compaction of its decoder self-attention: the first tokens
    equal, and the port's tokens equal the JAX engine's wherever no head's
    kept positions differ (else they follow from a proven tie)."""
    jlm, jp, lm, params = setup("whisper-tiny")
    toks, enc = inputs(lm.cfg, S=32, seed=3)
    kw = dict(kv_budget=BUDGET, kv_recency=RECENCY, kv_method="map")
    eng, jeng = (ServeEngine(lm, params, seed=1, device="cpu"),
                 JaxEngine(jlm, jp, seed=1))
    seen, jseen = capture(eng), capture(jeng)
    got = eng.generate(toks, 6, enc_embeds=enc, **kw)
    want = jeng.generate(toks, 6, enc_embeds=enc, **kw)
    assert got["tokens"].shape == (2, 6) and got["compact_s"] > 0
    (_, b, a), (_, jb, ja) = seen[0], jseen[0]
    assert a.enc_out is b.enc_out and a.cross is None
    keys, jkeys = (s.caches["head"]["layer0"].k for s in (b, jb))
    keys, jkeys = as_np(keys), as_np(jkeys)
    differ = assert_heads_match(
        keys, jkeys, kept_positions(keys, as_np(a.caches["head"]["layer0"]
                                                .k)),
        kept_positions(jkeys, as_np(ja.caches["head"]["layer0"].k)), 32,
        "map")
    np.testing.assert_array_equal(got["tokens"][:, 0], want["tokens"][:, 0])
    if differ == 0:
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_mamba2_engine_compaction_is_a_no_op_on_its_caches():
    """mamba2 has no attention cache: compaction splits the engine key once
    (``"sample"``, as the JAX engine), selects nothing and returns every
    ``SSMCache`` as it was; the tokens equal the run without it and the
    JAX engine's."""
    jlm, jp, lm, params = setup("mamba2-2.7b")
    toks, _ = inputs(lm.cfg, S=16, seed=2)
    eng = ServeEngine(lm, params, seed=4, device="cpu")
    seen = capture(eng)
    got = eng.generate(toks, 5, kv_budget=8, kv_recency=2)
    plain = ServeEngine(lm, params, seed=4, device="cpu").generate(toks, 5)
    want = JaxEngine(jlm, jp, seed=4).generate(toks, 5, kv_budget=8,
                                                kv_recency=2)
    np.testing.assert_array_equal(got["tokens"], plain["tokens"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    (_, before, after), = seen
    for u in ("layer0",):
        assert after.caches["head"][u] is before.caches["head"][u]


def test_decode_state_round_trips_ssm_caches_and_encoder_states():
    """A JAX prefill state of mamba2 (``SSMCache`` leaves) and of whisper
    (``enc_out``) carried to the port and back, bit for bit; the port
    decodes from the carried state as from its own."""
    for arch in ("mamba2-2.7b", "whisper-tiny"):
        jlm, jp, lm, params = setup(arch)
        toks, enc = inputs(lm.cfg, S=8)
        _, js = jlm.prefill(jp, jnp.asarray(toks),
                            enc_embeds=jnp_or_none(enc))
        state = decode_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js), "cpu")
        back = decode_state_to_numpy(state)
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(
                    jax.tree_util.tree_map(np.asarray, js)),
                jax.tree_util.tree_leaves_with_path(back)):
            np.testing.assert_array_equal(a, b, str(p))
        leaf = state.caches["head"]["layer0"]
        assert isinstance(leaf, SSMCache if arch.startswith("mamba")
                          else KVCache)
        assert (state.enc_out is not None) == (enc is not None)
        nxt = np.array([[1], [2]], np.int32)
        _, own = lm.prefill(params, toks, enc_embeds=enc)
        l1, _ = lm.decode_step(params, nxt, state)
        l2, _ = lm.decode_step(params, nxt, own)
        assert_close(l1, l2, label=f"{arch}: decode from the carried state")


# ---------------------------------------------------------------------------
# the card against a CPU copy
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch, overrides", ARCHS, ids=IDS)
def test_family_on_card_matches_cpu_copy(arch, overrides):
    """Each family at smoke size: prefill and two decode steps on the card
    against a CPU copy of the same params, float32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, lm, params = setup(arch, overrides)
    card = LM(lm.cfg, device="cuda")
    on_card = tree_map(lambda a: a.cuda(), params)
    toks, enc = inputs(lm.cfg)
    lc, sc = lm.prefill(params, toks, enc_embeds=enc)
    lg, sg = card.prefill(on_card, toks, enc_embeds=enc)
    assert_close(lg.cpu(), lc, label="prefill")
    nxt = np.array([[1], [2]], np.int32)
    for t in range(2):
        lc, sc = lm.decode_step(params, nxt, sc)
        lg, sg = card.decode_step(on_card, nxt, sg)
        assert_close(lg.cpu(), lc, label=f"decode {t}")


def test_ssd_grads_stay_finite_where_a_masked_decay_overflows():
    """A chunk of 64 tokens with dt near 5 (``dt_bias`` 5): the decays above
    the SSD tile's diagonal, exp of a positive sum of -dA over up to 63
    tokens, overflow float32. The port masks before the exp, so its
    forward equals the JAX package's within ``TOL`` and every grad of the
    layer's params is finite; the JAX package masks after the exp, and
    its backward meets inf · 0 (its grads hold NaN: a fault of the
    reference, ROADMAP queue 3)."""
    jcfg, tcfg = configs("mamba2-2.7b", ssm_chunk=64)
    jp = jssm.init_ssm_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 5.0))
    x = np.random.default_rng(0).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jssm.ssm_forward(p, jnp.asarray(x), jcfg) ** 2)

    jgrads = jax.grad(jloss)(jp)
    assert any(not np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(jgrads))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    y = tssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    assert_close(y, jssm.ssm_forward(jp, jnp.asarray(x), jcfg), TOL, "y")
    torch.sum(y ** 2).backward()
    for k, v in tp.items():
        assert torch.isfinite(v.grad).all(), k
