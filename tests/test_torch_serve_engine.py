"""The port's serving engine and KV compaction (``repro_torch.serve``:
``ServeEngine``, ``compact_kv_cache``; ``repro_torch.launch.serve``)
against the JAX package's ``repro.serve`` and ``repro.launch.serve`` on the
CPU, at qwen2-0.5b's smoke size (2 layers, 2 KV heads of 16), float32, on
the JAX params carried by ``lm_params_from_numpy``.

Tolerances and tie rules:

* tokens: equal to the JAX engine's for the same params and seed; where a
  step's token differs, the JAX logits' top-two scores (after the Gumbel
  draw at temperature > 0) lie within ``TOKEN_TIE`` = 1e-4 — float32
  roundoff of the logits (under 5e-6 here, ``test_torch_models.py``) plus
  the Gumbel twin's 5e-7 — and the test proves each such tie;
* greedy-MAP picks (``method="map"``): equal, or each package's greedy
  order (recomputed on its own float32 kernel and shown to give its kept
  positions) picks at every step a float64 argmax of the conditional
  variances within ``MAP_TIE`` = 1e-4 of max diag L: the kernel's
  diagonal is 1 + 1e-4 - O(1e-6/|k|) for every key, so the very first
  pick is decided by float32 roundoff whenever the normalised norms tie,
  and the two orders then follow other prefixes; a generation after such
  a compaction is compared with the JAX model decoding from the port's
  compacted cache;
* k-DPP picks (``method="sample"``): the raw draw equal, or a proven
  roundoff tie on the CDF (``test_torch_kv_client.assert_same_kdpp``,
  phase 3's rule);
* caches and logits after compaction: float32, as ``test_torch_models``.

Compaction keeps at most hd = 16 diverse tokens a head (budget − recency ≤
the keys' rank), except where a test says otherwise."""

import json
import os
import subprocess
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

from repro.configs import smoke_config as jax_smoke
from repro.models import LM as JaxLM
from repro.models.attention import KVCache as JaxKVCache
from repro.serve import ServeEngine as JaxEngine
from repro.serve import compact_kv_cache as jax_compact
from repro.serving import KVCompactionClient as JaxClient
from repro.serving import ServingConfig as JaxConfig
import repro_torch.obs as obs
from repro_torch import random as tr
from repro_torch.configs import smoke_config
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy, lm_params_from_numpy)
from repro_torch.kernels.ops import greedy_map_kdpp
from repro_torch.models import LM, KVCache
from repro_torch.serve import ServeEngine, compact_kv_cache, \
    dpp_select_tokens
from repro_torch.serve.kv_compaction import token_kernel
from repro_torch.serving import KVCompactionClient, ServingConfig
from test_torch_kv_client import (MAP_TIE, assert_same_kdpp,
                                  conditional_variances)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-0.5b"
TOKEN_TIE = 1e-4
F32_TOL = 2e-5
BUDGET, RECENCY = 16, 4


@pytest.fixture(scope="module")
def model():
    """(JAX LM, JAX params, port LM, the JAX params in the port)."""
    jlm = JaxLM(jax_smoke(ARCH))
    jp = jlm.init_params(jax.random.PRNGKey(0))
    return jlm, jp, LM(smoke_config(ARCH), device="cpu"), \
        lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def prompts_for(B=2, S=48, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def assert_close(got, want, tol=F32_TOL, label=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, label


def jax_trace(jlm, jp, n, temperature, key, prompts=None, state=None,
              first=None):
    """The JAX engine's steps replayed with its own model and key chain
    from ``key`` (uint32 words): (tokens (B, n), the scores each computed
    step's argmax took — logits, plus the Gumbel draw at temperature > 0).
    From ``prompts`` it prefills; from ``state`` (a JAX decode state) and
    ``first`` (the first tokens) it decodes only."""
    key = jnp.asarray(key, jnp.uint32)
    if state is None:
        logits, state = jlm.prefill(jp, jnp.asarray(prompts))
        logits = logits[:, -1]
        tok = None
    else:
        tok = jnp.asarray(first, jnp.int32)
    toks, scores = [], []
    for t in range(n):
        if tok is None:
            s = logits
            if temperature > 0:
                key, sub = jax.random.split(key)
                s = jax.random.gumbel(sub, logits.shape, logits.dtype) + \
                    logits / temperature
            tok = jnp.argmax(s, -1).astype(jnp.int32)
            scores.append(np.asarray(s, np.float32))
        toks.append(np.asarray(tok))
        if t + 1 < n:
            logits, state = jlm.decode_step(jp, tok[:, None], state)
            logits, tok = logits[:, -1], None
    return np.stack(toks, 1), scores


def assert_tokens_or_ties(got, want, scores, label):
    """Tokens equal; at the first differing step (``scores[t]`` the JAX
    scores of step t) the scores of the two tokens lie within TOKEN_TIE
    (a proven tie; later steps follow other histories and are not
    compared)."""
    diff = np.argwhere(got != want)
    if diff.size == 0:
        return
    t = int(diff[:, 1].min())
    for b in diff[diff[:, 1] == t, 0]:
        s = scores[t][b]
        gap = abs(float(s[want[b, t]]) - float(s[got[b, t]]))
        assert gap <= TOKEN_TIE, f"{label}: row {b} step {t}: " \
            f"{got[b, t]} vs {want[b, t]}, score gap {gap}"


def kept_positions(keys, kept):
    """The positions (U, B, KV, budget) whose rows of ``keys`` (U, B, S,
    KV, hd) a compacted cache ``kept`` (U, B, budget, KV, hd) holds, found
    by matching rows (every row of a head is distinct: rope differs by
    position)."""
    U, B, _, KV, _ = keys.shape
    out = np.zeros((U, B, KV, kept.shape[2]), np.int64)
    for u, b, h in np.ndindex(U, B, KV):
        rows = {r.tobytes(): i for i, r in enumerate(keys[u, b, :, h])}
        assert len(rows) == keys.shape[2]
        out[u, b, h] = [rows[r.tobytes()] for r in kept[u, b, :, h]]
    return out


def jax_kernel(keys, vl, method):
    """The float32 L the JAX package builds for one head's keys (S, d),
    as ``repro.serve.kv_compaction.dpp_select_tokens`` does."""
    S = keys.shape[0]
    kf = jnp.asarray(keys, jnp.float32)
    kf = kf / (jnp.linalg.norm(kf, axis=-1, keepdims=True) + 1e-6)
    L = kf @ kf.T + 1e-4 * jnp.eye(S)
    ok = jnp.arange(S) < (vl - RECENCY)
    both = ok[:, None] & ok[None, :]
    if method == "sample":
        return jnp.where(both, L, 0.0)
    return jnp.where(both, L, jnp.where(jnp.eye(S, dtype=bool), 1e-6, 0.0))


def assert_head_tie(tkeys, jkeys, got, want, vl, method, hkey, label):
    """One head whose kept positions differ between the packages (``got``
    from the port's keys ``tkeys``, ``want`` from JAX's ``jkeys``, (S, d)
    each): each package's own selection on its own float32 kernel is
    recomputed, shown to give its kept positions, and the two held to the
    method's tie rule (``assert_same_map`` on the float64 kernel, or
    ``assert_same_kdpp`` on the port's)."""
    k = BUDGET - RECENCY
    recent = set(range(vl - RECENCY, vl))
    Lt = token_kernel(torch.from_numpy(tkeys), RECENCY, vl, method)[0]
    Lj = jax_kernel(jkeys, vl, method)
    if method == "map":
        from repro.kernels.ops import greedy_map_kdpp as jax_map
        go = greedy_map_kdpp(Lt, k).numpy()
        wo = np.asarray(jax_map(Lj, k))
        assert sorted(set(go.tolist()) | recent) == got.tolist(), label
        assert sorted(set(wo.tolist()) | recent) == want.tolist(), label
        L = kernel_for(tkeys, vl, RECENCY, "map")
        for order in (go, wo):
            assert_greedy(L, order, label)
        return
    from repro.sampling.kdpp import sample_kdpp_dense as jax_kdpp
    from repro_torch.sampling.kdpp import sample_kdpp_dense
    go = sample_kdpp_dense(hkey, Lt, k).numpy()
    wo = np.asarray(jax_kdpp(jnp.asarray(hkey), Lj, k))
    assert set(go[go >= 0].tolist()) <= set(got.tolist()), label
    assert set(wo[wo >= 0].tolist()) <= set(want.tolist()), label
    assert_same_kdpp(wo, go, hkey, Lt.numpy(), k, label)


def assert_greedy(L, order, label):
    """Every step of a greedy-MAP order picks a float64 argmax of the
    conditional variances given its prefix, up to ``MAP_TIE`` of max diag
    L: a float32 greedy run on the float64 kernel. Two such orders can
    part only on a tie (the first pick is one when the keys' normalised
    norms tie, and the orders then follow other prefixes)."""
    scale = np.diag(L).max()
    for t, j in enumerate(order):
        d = conditional_variances(L, order[:t].tolist())
        d[order[:t]] = -np.inf
        gap = (d.max() - d[j]) / scale
        assert gap <= MAP_TIE, f"{label}: step {t} picks {j}, {gap} " \
            f"below the best"


def assert_heads_match(tkeys, jkeys, got, want, vl, method,
                       head_keys=None):
    """Kept positions (U, B, KV, budget) of the port (``got``, from its
    prefill keys ``tkeys`` (U, B, S, KV, hd)) and of the JAX package
    (``want``, from ``jkeys``): each head sorted, distinct, below ``vl``
    with the recency window, and equal to JAX's or, where not, a proven tie
    (``assert_head_tie``; ``head_keys`` (U, B, KV, 2) the k-DPP keys).
    Returns the number of heads that differ."""
    differ = 0
    for u, b, h in np.ndindex(got.shape[:3]):
        row = got[u, b, h]
        assert (np.diff(row) > 0).all() and row[-1] < vl
        assert set(range(vl - RECENCY, vl)) <= set(row.tolist())
        if np.array_equal(row, want[u, b, h]):
            continue
        differ += 1
        assert_head_tie(tkeys[u, b, :, h], jkeys[u, b, :, h], row,
                        want[u, b, h], vl, method,
                        None if head_keys is None else head_keys[u, b, h],
                        f"unit {u} b {b} h {h}")
    return differ


def capture(engine):
    """Record each ``engine.compact_kv`` call of a run (either package's
    engine) as (tenant, state before, state after)."""
    seen, inner = [], engine.compact_kv

    def compact_kv(state, *args, **kw):
        out = inner(state, *args, **kw)
        seen.append((kw.get("tenant", "default"), state, out))
        return out
    engine.compact_kv = compact_kv
    return seen


def cache_k(state):
    """The stacked keys (U, B, S, KV, hd) of a decode state of either
    package, as numpy."""
    c = state.caches["head"]["layer0"]
    return c.k.numpy() if isinstance(c.k, torch.Tensor) else \
        np.asarray(c.k)


# ---------------------------------------------------------------------------
# compact_kv_cache
# ---------------------------------------------------------------------------

def cache_inputs(seed, B=2, S=48, KV=2, hd=16, pos=None):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    return k, v, S if pos is None else pos


def kernel_for(keys, vl, recency, method):
    """The float64 L of one head as ``token_kernel`` builds it."""
    L = token_kernel(torch.from_numpy(keys).double(), recency, vl,
                     method)[0]
    return L.numpy()


@pytest.mark.parametrize("pos", [48, 31])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_kv_cache_map_matches_jax(seed, pos):
    k, v, vl = cache_inputs(seed, pos=pos)
    want_c, want = jax_compact(JaxKVCache(jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(vl, jnp.int32)),
                               BUDGET, RECENCY, "map")
    cache = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.tensor(vl, dtype=torch.int32))
    got_c, got = compact_kv_cache(cache, BUDGET, RECENCY, "map")
    assert got.dtype == torch.int32 and got.shape == (2, 2, BUDGET)
    assert_heads_match(k[None], k[None], got.numpy()[None],
                       np.asarray(want)[None], vl, "map")
    # the gather: kept rows are the cache's rows at the picks
    for b in range(2):
        for h in range(2):
            idx = got[b, h].long().numpy()
            np.testing.assert_array_equal(got_c.k[b, :, h].numpy(),
                                          k[b, idx, h])
            np.testing.assert_array_equal(got_c.v[b, :, h].numpy(),
                                          v[b, idx, h])
    assert int(got_c.pos) == vl == int(want_c.pos)


@pytest.mark.parametrize("pos", [48, 31])
def test_compact_kv_cache_map_is_one_batched_selection(model, pos):
    """``"map"`` compaction of a unit runs one ``greedy_map_kdpp`` over the
    stack of its (batch, KV head) kernels, the counterpart of the
    reference's vmap: one dispatch a unit (counted once per call), each
    head's kept positions those of ``dpp_select_tokens`` on that head alone,
    bit for bit. Inline compaction of the smoke model's prefill cache makes
    one dispatch a unit."""
    k, v, vl = cache_inputs(2, pos=pos)
    cache = KVCache(torch.from_numpy(k), torch.from_numpy(v),
                    torch.tensor(vl, dtype=torch.int32))
    with obs.use(obs.InMemoryTracker()) as t:
        _, got = compact_kv_cache(cache, BUDGET, RECENCY, "map")
    assert t.counter_value("kernels.greedy_map_update.reference") == 1
    assert t.counter_value("kernels.greedy_map_update.cuda") == 0
    for b in range(2):
        for h in range(2):
            assert torch.equal(got[b, h], dpp_select_tokens(
                cache.k[b, :, h], BUDGET, RECENCY, valid_len=vl))
    _, _, lm, params = model
    _, state = lm.prefill(params, prompts_for(S=40, seed=4))
    units = state.caches["head"]["layer0"].k.shape[0]
    with obs.use(obs.InMemoryTracker()) as t:
        ServeEngine(lm, params, device="cpu").compact_kv(
            state, BUDGET, RECENCY, "map")
    assert units == lm.cfg.n_layers
    assert t.counter_value("kernels.greedy_map_update.reference") == units


@pytest.mark.parametrize("seed", [0, 3])
def test_compact_kv_cache_sample_matches_jax(seed):
    """Head (b, h) draws with ``split(key, (B, KV))[b, h]``, as the JAX
    function's vmapped heads."""
    k, v, vl = cache_inputs(seed, pos=37)
    key = jax.random.PRNGKey(100 + seed)
    want_c, want = jax_compact(JaxKVCache(jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(vl, jnp.int32)),
                               BUDGET, RECENCY, "sample", key=key)
    got_c, got = compact_kv_cache(
        KVCache(torch.from_numpy(k), torch.from_numpy(v),
                torch.tensor(vl, dtype=torch.int32)), BUDGET, RECENCY,
        "sample", key=np.asarray(key))
    hkeys = np.asarray(jax.random.split(key, (2, 2)))
    np.testing.assert_array_equal(
        tr.key_data(tr.split(tr.as_key(np.asarray(key)), (2, 2))), hkeys)
    assert got.shape == (2, 2, BUDGET)
    assert_heads_match(k[None], k[None], got.numpy()[None],
                       np.asarray(want)[None], vl, "sample", hkeys[None])
    with pytest.raises(ValueError, match="PRNG key"):
        compact_kv_cache(KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                 torch.tensor(vl)), 12, RECENCY, "sample")


# ---------------------------------------------------------------------------
# ServeEngine.generate against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_generate_matches_jax(model, temperature):
    jlm, jp, lm, params = model
    prompts = prompts_for()
    got = ServeEngine(lm, params, temperature=temperature, seed=3,
                      device="cpu").generate(prompts, 12)
    want = JaxEngine(jlm, jp, temperature=temperature, seed=3).generate(
        prompts, 12)
    assert got["tokens"].shape == (2, 12)
    assert got["tokens"].dtype == want["tokens"].dtype
    assert set(got) == set(want)
    trace, scores = jax_trace(jlm, jp, 12, temperature,
                              jax.random.PRNGKey(3), prompts=prompts)
    np.testing.assert_array_equal(trace, want["tokens"])   # the replay
    assert_tokens_or_ties(got["tokens"], want["tokens"], scores,
                          f"T = {temperature}")


@pytest.mark.parametrize("method, temperature", [("sample", 0.7),
                                                 ("map", 0.0)])
def test_generate_with_inline_compaction_matches_jax(model, method,
                                                     temperature):
    """Inline compaction between prefill and decode. The engine key is
    split once, then once a unit, then into (B, KV) head keys, as the JAX
    engine splits; every head keeps the JAX engine's tokens or differs on
    a proven tie; the tokens then equal the JAX model's decoding from the
    port's compacted cache on the port engine's key (and the JAX engine's
    own tokens where no head differs)."""
    jlm, jp, lm, params = model
    seed, S = 5, 48
    prompts = prompts_for(S=S, seed=4)
    kw = dict(kv_budget=BUDGET, kv_recency=RECENCY, kv_method=method)
    eng = ServeEngine(lm, params, temperature=temperature, seed=seed,
                      device="cpu")
    jeng = JaxEngine(jlm, jp, temperature=temperature, seed=seed)
    seen, jseen = capture(eng), capture(jeng)
    got = eng.generate(prompts, 10, **kw)
    want = jeng.generate(prompts, 10, **kw)
    assert got["compact_s"] > 0 and len(seen) == len(jseen) == 1
    np.testing.assert_array_equal(tr.key_data(eng._key),
                                  np.asarray(jeng._key))
    ckey = jax.random.PRNGKey(seed)       # the engine's key chain
    if temperature > 0:
        ckey = jax.random.split(ckey)[0]  # the first token's draw
    ckey = jax.random.split(ckey)[1]
    head_keys = []
    for _ in range(lm.cfg.n_layers):
        ckey, sub = jax.random.split(ckey)
        head_keys.append(np.asarray(jax.random.split(sub, (2, 2))))
    (_, ts, tc), (_, js, jc) = seen[0], jseen[0]
    keys, jkeys = cache_k(ts), cache_k(js)
    differ = assert_heads_match(
        keys, jkeys, kept_positions(keys, cache_k(tc)),
        kept_positions(jkeys, cache_k(jc)), S, method, np.stack(head_keys))
    # the key after the compaction: the first token's draw and one split
    key = jax.random.PRNGKey(seed)
    if temperature > 0:
        key = jax.random.split(key)[0]
    key = jax.random.split(key)[0]
    jstate = jax.tree_util.tree_map(jnp.asarray, decode_state_to_numpy(tc))
    trace, scores = jax_trace(jlm, jp, 10, temperature, key, state=jstate,
                              first=got["tokens"][:, 0])
    assert_tokens_or_ties(got["tokens"][:, 1:], trace[:, 1:], scores,
                          "after the port's compaction")
    np.testing.assert_array_equal(got["tokens"][:, 0], want["tokens"][:, 0])
    if differ == 0:
        assert_tokens_or_ties(got["tokens"][:, 1:], want["tokens"][:, 1:],
                              scores, "against the JAX engine")


def test_generate_through_the_client_matches_the_jax_client(model):
    """Two tenants' streams through both packages' KV clients: the heads
    in (U·B·KV, S, hd) order with valid = pos repeated B·KV times, keyed
    (tenant, seq, head); the kept positions equal the JAX client's (or
    differ on a proven tie), and so do the tokens."""
    from repro.serving.keys import TenantKeyring as JaxKeyring
    from test_torch_kv_client import Ticket
    jlm, jp, lm, params = model
    S = 40
    streams = {"a": prompts_for(S=S, seed=8), "b": prompts_for(S=S, seed=9)}
    cfg = dict(max_batch=4096, deadline_ms=20.0)
    engines = {
        "jax": (JaxEngine(jlm, jp), JaxClient(
            BUDGET, RECENCY, JaxConfig(**cfg), seed=1)),
        "port": (ServeEngine(lm, params, device="cpu"),
                 KVCompactionClient(BUDGET, RECENCY, ServingConfig(**cfg),
                                    seed=1, device="cpu"))}
    out = {}
    for name, (eng, client) in engines.items():
        seen = capture(eng)
        try:
            out[name] = {t: eng.generate(p, 6, kv_client=client,
                                         kv_tenant=t)["tokens"]
                         for t, p in streams.items()}
        finally:
            client.close()
        out[name]["keys"] = {t: cache_k(b) for t, b, _ in seen}
        out[name]["pos"] = {t: kept_positions(cache_k(b), cache_k(a))
                            for t, b, a in seen}
    H = lm.cfg.n_layers * 2 * 2
    for t in streams:
        rkeys = np.asarray(JaxKeyring(1).row_keys([Ticket(t, 0, H)], H))
        differ = assert_heads_match(
            out["port"]["keys"][t], out["jax"]["keys"][t],
            out["port"]["pos"][t], out["jax"]["pos"][t], S, "sample",
            rkeys.reshape(2, 2, 2, 2))
        if differ == 0:
            np.testing.assert_array_equal(out["port"][t], out["jax"][t])
    with pytest.raises(ValueError, match="conflicts"):
        ServeEngine(lm, params, device="cpu").compact_kv(
            lm.prefill(params, streams["a"])[1], 8, client=KVCompactionClient(
                BUDGET, RECENCY, device="cpu"))


def test_decode_after_compaction_overwrites_slot_pos_mod_budget(model):
    """A reference quirk, mirrored: after compaction a full-attention
    cache holds ``budget`` slots with pos = S, and the next step writes its
    key at slot S % budget, over a kept token, in both packages."""
    jlm, jp, lm, params = model
    S = 40
    prompts = prompts_for(S=S, seed=11)
    _, js = jlm.prefill(jp, jnp.asarray(prompts))
    jc = JaxEngine(jlm, jp).compact_kv(js, BUDGET, RECENCY, "map")
    state = decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                                    "cpu")
    nxt = np.array([[5], [6]], np.int32)
    tl, ts = lm.decode_step(params, nxt, state)
    jl, js2 = jlm.decode_step(jp, jnp.asarray(nxt), jc)
    assert_close(tl, jl, label="logits")
    before = state.caches["head"]["layer0"].k.numpy()
    after = ts.caches["head"]["layer0"].k.numpy()
    want = np.asarray(js2.caches["head"]["layer0"].k)
    assert_close(after, want, label="cache")
    slot = S % BUDGET
    assert slot != 0
    changed = np.nonzero((after != before).any(axis=(0, 1, 3, 4)))[0]
    assert changed.tolist() == [slot]
    assert ts.caches["head"]["layer0"].pos.tolist() == [S + 1, S + 1]
    # a prefill cache is full too: its next step writes slot S % S = 0
    _, tp = lm.prefill(params, prompts)
    _, tp2 = lm.decode_step(params, nxt, tp)
    a, b = (x.caches["head"]["layer0"].k.numpy() for x in (tp, tp2))
    assert np.nonzero((a != b).any(axis=(0, 1, 3, 4)))[0].tolist() == [0]


# ---------------------------------------------------------------------------
# tests/test_serve.py, mirrored
# ---------------------------------------------------------------------------

def test_engine_generates(model):
    _, _, lm, params = model
    prompts = np.random.default_rng(0).integers(0, lm.cfg.vocab, (3, 16),
                                                dtype=np.int32)
    out = ServeEngine(lm, params, device="cpu").generate(prompts, 8)
    assert out["tokens"].shape == (3, 8)
    assert (out["tokens"] >= 0).all() and (out["tokens"] < lm.cfg.vocab
                                           ).all()
    stop = int(out["tokens"][0, 2])
    short = ServeEngine(lm, params, device="cpu").generate(
        prompts[:1], 8, stop_token=stop)
    np.testing.assert_array_equal(short["tokens"][0],
                                  out["tokens"][0, :short["tokens"].shape[1]])
    assert short["tokens"][0, -1] == stop


def test_dpp_select_unique_and_recent(rng):
    keys = torch.from_numpy(rng.standard_normal((64, 16)).astype(
        np.float32))
    picks = dpp_select_tokens(keys, budget=16, recency=4,
                              valid_len=60).numpy()
    assert len(set(picks.tolist())) == 16
    for p in (56, 57, 58, 59):
        assert p in picks


def test_compaction_gathers_correctly(rng):
    B, S, KV, hd = 2, 32, 2, 8
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    new, picks = compact_kv_cache(KVCache(
        torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(S, dtype=torch.int32)), budget=12, recency=4)
    assert new.k.shape == (B, 12, KV, hd)
    for b in range(B):
        for h in range(KV):
            np.testing.assert_allclose(new.k[b, :, h].numpy(),
                                       k[b][picks[b, h].numpy(), h],
                                       rtol=1e-6)


def test_compaction_diversity_beats_recency(rng):
    """DPP keeps early anchor tokens a recency-only policy would evict."""
    S, hd = 48, 8
    base = rng.standard_normal((S, hd)).astype(np.float32)
    base[5] *= 8.0
    k = torch.from_numpy(base[None, :, None, :])
    _, picks = compact_kv_cache(KVCache(k, k, torch.tensor(S)), budget=12,
                                recency=4)
    assert 5 in picks.numpy().ravel()


def test_encoder_decoder_engine_is_not_ported():
    """``tests/test_serve.py``'s whisper engine: the port refuses the
    config (its encoder is ROADMAP queue 1)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(smoke_config("whisper-tiny"), device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "24",
          "--max-new", "4"]
TENANTS = ["--kv-budget", "12", "--kv-recency", "4", "--tenants", "a:2,b",
           "--deadline-ms", "50"]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.mark.parametrize("extra", [[], TENANTS], ids=["plain", "tenants"])
def test_launcher_prints_the_references_json(extra, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve ... --device cpu`` prints the
    reference launcher's JSON keys (its values are timings and counts)."""
    from repro.launch import serve as jax_serve
    monkeypatch.setattr(sys, "argv", ["serve"] + LAUNCH + extra)
    jax_serve.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *LAUNCH, *extra, "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert _keys(got) == _keys(want)
    if extra == TENANTS:
        assert got["coalescing"]["heads_selected"] == 2 * 2 * 2 * 2
        assert got["per_tenant"] == want["per_tenant"]
    else:
        assert got["generated_shape"] == want["generated_shape"] == [2, 4]


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_copy(model):
    """qwen2-0.5b at smoke size on the card: greedy tokens with and without
    inline k-DPP compaction equal a CPU copy's (the same keys, phase 2 on
    its kernel), or differ first on a tie."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jlm, jp, lm, params = model
    card = LM(lm.cfg, device="cuda")
    gparams = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   "cuda")
    prompts = prompts_for()
    for kw in ({}, dict(kv_budget=BUDGET, kv_recency=RECENCY)):
        got = ServeEngine(card, gparams, seed=2).generate(prompts, 8, **kw)
        want = ServeEngine(lm, params, seed=2, device="cpu").generate(
            prompts, 8, **kw)
        if not kw:
            trace, scores = jax_trace(jlm, jp, 8, 0.0,
                                      jax.random.PRNGKey(2), prompts=prompts)
            assert_tokens_or_ties(got["tokens"], trace, scores, "card")
        np.testing.assert_array_equal(got["tokens"][:, 0],
                                      want["tokens"][:, 0])
