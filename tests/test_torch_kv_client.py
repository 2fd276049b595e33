"""The port's KV-compaction selection (``repro_torch.serve.kv_compaction``)
and its coalescing client (``repro_torch.serving.KVCompactionClient``)
against the JAX package's ``repro.serve.kv_compaction`` and
``repro.serving.kv``.

The same numpy key vectors (H, S, d) = (4, 16, 4), budget 6, recency 2,
go through both packages on the CPU; the port takes its own eigh and
products of each head's kernel. Tolerances:

* ``method="map"``: picks equal; where the greedy orders first differ,
  the float64 conditional variances of the two candidates given the
  common prefix within 1e-4 of max diag L (a float32 roundoff tie), and
  the two sets' log det L_Y then within 1e-3 relative;
* ``method="sample"``: the k-DPP draw before the recency fill equal, or
  its first difference a proven float32 roundoff tie on the exact chain
  (``kernels.phase2_select.first_difference`` on the port's eigenvectors),
  or a phase-1 uniform within 1e-6 of its inclusion probability (a
  different draw, not compared);
* the client: the same per-head picks as the JAX client for the same seed
  and tenants under the rule above, and its own picks bit for bit under
  any coalescing.

Timing: deadlines of 2 s where one fire is under test, ``result()`` waits
up to 120 s."""

import collections
import os
import warnings

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.kv_compaction import dpp_select_tokens as jax_select
from repro.serving import KVCompactionClient as JaxClient
from repro.serving import ServingConfig as JaxConfig
from repro.serving.keys import TenantKeyring as JaxKeyring
from repro_torch import random as tr
from repro_torch.kernels.phase2_select import (first_difference,
                                               is_roundoff_tie)
from repro_torch.sampling.batched import compact_selection, keyed_uniforms
from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms
from repro_torch.serve import dpp_select_tokens
from repro_torch.serving import KVCompactionClient, ServingConfig

threaded = pytest.mark.threaded
H, S, D, BUDGET, RECENCY = 4, 16, 4, 6, 2
WAIT = 120.0
DEADLINE_MS = 2_000.0
TIE = 1e-6              # a uniform this close to its threshold may flip
MAP_TIE = 1e-4          # of max diag L, on the float64 greedy chain
Ticket = collections.namedtuple("Ticket", "tenant seq num_samples")


def heads(seed, h=H, s=S, d=D):
    return np.random.default_rng(seed).normal(size=(h, s, d)).astype(
        np.float32)


def kernel(keys, valid_len, recency, exclude):
    """The selection's L for one head (S, d), float64, as both packages
    build it; ``exclude`` zeroes the recency window and the invalid tail
    (the "sample" method's hard exclusion)."""
    kf = keys.astype(np.float64)
    kf = kf / (np.linalg.norm(kf, axis=-1, keepdims=True) + 1e-6)
    L = kf @ kf.T + 1e-4 * np.eye(len(kf))
    if exclude:
        ok = np.arange(len(kf)) < valid_len - recency
        L = np.where(ok[:, None] & ok[None, :], L, 0.0)
    return L


def conditional_variances(L, prefix):
    """d_i = L_ii - L_{i,P} L_{P,P}^{-1} L_{P,i} in float64."""
    d = np.diag(L).copy()
    if len(prefix):
        P = np.asarray(prefix)
        A = L[np.ix_(P, P)]
        B = L[P]
        d -= np.einsum("pi,pi->i", B, np.linalg.solve(A, B))
    return d


def assert_same_map(want, got, L, k, label):
    """Greedy MAP orders ``want`` (JAX) and ``got`` (port), before the
    sort: equal, or a first difference on a float64 tie."""
    want, got = np.asarray(want), np.asarray(got)
    diff = np.nonzero(want != got)[0]
    if diff.size == 0:
        return
    t = int(diff[0])
    d = conditional_variances(L, want[:t].tolist())
    gap = abs(d[want[t]] - d[got[t]]) / np.diag(L).max()
    assert gap <= MAP_TIE, f"{label}: step {t} {want[t]} vs {got[t]}, " \
        f"gap {gap}"
    ld = [np.linalg.slogdet(L[np.ix_(p, p)])[1] for p in (want, got)]
    assert abs(ld[0] - ld[1]) <= 1e-3 * abs(ld[0]), label
    warnings.warn(f"{label}: greedy orders differ at step {t} on a tie")


def assert_same_kdpp(want, got, key, Ls, k, label):
    """Raw k-DPP draws ``want`` (JAX) and ``got`` (port) of the same key on
    the same kernel, in chain order: equal, or a proven roundoff tie on
    the port's spectrum, or a phase-1 uniform on its threshold."""
    want, got = np.asarray(want), np.asarray(got)
    if (want == got).all():
        return
    lam, vec = torch.linalg.eigh(torch.from_numpy(Ls.astype(np.float32)))
    lam = torch.clamp_min(lam, 0.0)
    u, us = keyed_uniforms(tr.as_key(key, "cpu")[None], len(Ls), k)
    mask = _phase1_kdpp_from_uniforms(u, torch.log(lam), k)
    jlam = np.clip(np.linalg.eigvalsh(Ls), 0.0, None)
    jmask = _phase1_kdpp_from_uniforms(
        u, torch.log(torch.from_numpy(jlam).float()), k)
    if not torch.equal(mask, jmask):
        warnings.warn(f"{label}: the ESP draws differ (a uniform on a "
                      f"threshold); not compared")
        return
    sel, valid, _ = compact_selection(mask, k)
    G = (vec[:, sel[0].long()] * valid[0].float()).double()
    step, kind, value = first_difference(us[0], G, torch.ones(
        (1, k), dtype=torch.float64), want, got)
    assert is_roundoff_tie(kind, value), (
        f"{label}: draws differ at step {step}: {want} vs {got} ({kind} "
        f"{value}) — not a roundoff tie")
    warnings.warn(f"{label}: draws differ at step {step} on a tie")


# ---------------------------------------------------------------------------
# dpp_select_tokens against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("valid_len", [None, 12, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_tokens_map_matches_jax(seed, valid_len):
    keys = heads(seed)
    for h in range(H):
        want = np.asarray(jax_select(jnp.asarray(keys[h]), BUDGET, RECENCY,
                                     valid_len=valid_len, method="map"))
        got = dpp_select_tokens(torch.from_numpy(keys[h]), BUDGET, RECENCY,
                                valid_len=valid_len, method="map")
        assert got.dtype == torch.int32 and tuple(got.shape) == (BUDGET,)
        if not np.array_equal(got.numpy(), want):
            from repro.kernels.ops import greedy_map_kdpp as jax_map
            from repro_torch.kernels.ops import greedy_map_kdpp
            vl = S if valid_len is None else valid_len
            L = kernel(keys[h], vl, RECENCY, False)
            ok = np.arange(S) < vl - RECENCY
            Lm = np.where(ok[:, None] & ok[None, :], L,
                          np.where(np.eye(S, dtype=bool), 1e-6, 0.0))
            k = BUDGET - RECENCY
            assert_same_map(np.asarray(jax_map(jnp.asarray(Lm, jnp.float32),
                                               k)),
                            greedy_map_kdpp(torch.from_numpy(
                                Lm.astype(np.float32)), k).numpy(),
                            Lm, k, f"seed {seed} head {h}")
        vl = S if valid_len is None else valid_len
        row = got.numpy()
        assert len(set(row.tolist())) == BUDGET
        assert (np.sort(row) == row).all() and (row < vl).all()
        assert set(range(vl - RECENCY, vl)) <= set(row.tolist())


@pytest.mark.parametrize("valid_len", [None, 12, 7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_tokens_sample_matches_jax(seed, valid_len):
    keys = heads(seed)
    rkeys = np.asarray(jax.random.split(jax.random.PRNGKey(50 + seed), H))
    k = BUDGET - RECENCY
    vl = S if valid_len is None else valid_len
    for h in range(H):
        want = np.asarray(jax_select(jnp.asarray(keys[h]), BUDGET, RECENCY,
                                     valid_len=valid_len, method="sample",
                                     key=jnp.asarray(rkeys[h])))
        got = dpp_select_tokens(torch.from_numpy(keys[h]), BUDGET, RECENCY,
                                valid_len=valid_len, method="sample",
                                key=rkeys[h])
        assert got.dtype == torch.int32 and tuple(got.shape) == (BUDGET,)
        row = got.numpy()
        assert len(set(row.tolist())) == BUDGET
        assert (np.sort(row) == row).all() and (row < vl).all()
        assert set(range(vl - RECENCY, vl)) <= set(row.tolist())
        if not np.array_equal(row, want):
            from repro.sampling.kdpp import sample_kdpp_dense as jax_kdpp
            from repro_torch.sampling.kdpp import sample_kdpp_dense
            Ls = kernel(keys[h], vl, RECENCY, True).astype(np.float32)
            assert_same_kdpp(
                np.asarray(jax_kdpp(jnp.asarray(rkeys[h]), jnp.asarray(Ls),
                                    k)),
                sample_kdpp_dense(rkeys[h], torch.from_numpy(Ls), k).numpy(),
                rkeys[h], Ls, k, f"seed {seed} head {h}")


def test_select_tokens_fills_below_rank_like_jax():
    """More picks than the valid keys' rank: the sampled positions, then
    the most recent unsampled selectable ones, as the reference fills."""
    keys = np.zeros((S, D), np.float32)
    keys[:, 0] = 1.0                      # rank 1 (+ the 1e-4 ridge)
    key = np.asarray(jax.random.PRNGKey(3))
    want = np.asarray(jax_select(jnp.asarray(keys), 10, 2, valid_len=6,
                                 method="sample", key=jnp.asarray(key)))
    got = dpp_select_tokens(torch.from_numpy(keys), 10, 2, valid_len=6,
                            method="sample", key=key)
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_tokens_needs_a_key_for_sample():
    with pytest.raises(ValueError, match="PRNG key"):
        dpp_select_tokens(torch.zeros((S, D)), BUDGET, RECENCY,
                          method="sample")


# ---------------------------------------------------------------------------
# the coalescing client
# ---------------------------------------------------------------------------

def _run(client_cls, config_cls, submits, seed=0, deadline_ms=DEADLINE_MS,
         **kw):
    client = client_cls(BUDGET, RECENCY, config_cls(
        max_batch=4096, deadline_ms=deadline_ms), seed=seed, **kw)
    try:
        tickets = [client.submit(k, valid_len=v, tenant=t)
                   for t, k, v in submits]
        return [t.result(timeout=WAIT) for t in tickets], client
    finally:
        client.close()


@threaded
@pytest.mark.parametrize("seed", [0, 5])
def test_kv_client_matches_the_jax_client(seed):
    """Two streams through both packages' clients (one flush each): the
    same picks per head, on the same (tenant, seq, head) keys."""
    k0, k1 = heads(10 + seed), heads(20 + seed, h=3)
    submits = [("s0", k0, None), ("s1", k1, np.array([16, 12, 9]))]
    jpicks, jclient = _run(JaxClient, JaxConfig, submits, seed=seed)
    tpicks, tclient = _run(KVCompactionClient, ServingConfig, submits,
                           seed=seed, device="cpu")
    tickets = [Ticket("s0", 0, 4), Ticket("s1", 0, 3)]
    keys = np.asarray(JaxKeyring(seed).row_keys(tickets, 8))
    np.testing.assert_array_equal(
        tr.key_data(tclient._keyring.row_keys(tickets, 8)), keys)
    k = BUDGET - RECENCY
    head = 0
    for (_, kk, vv), want, got in zip(submits, jpicks, tpicks):
        assert got.dtype == torch.int32 and tuple(got.shape) == (len(kk),
                                                                 BUDGET)
        vls = np.broadcast_to(S if vv is None else vv, (len(kk),))
        for h in range(len(kk)):
            if not np.array_equal(got[h].numpy(), np.asarray(want[h])):
                from repro.sampling.kdpp import sample_kdpp_dense as jk
                from repro_torch.sampling.kdpp import sample_kdpp_dense
                Ls = kernel(kk[h], int(vls[h]), RECENCY, True).astype(
                    np.float32)
                assert_same_kdpp(np.asarray(jk(jnp.asarray(keys[head]),
                                               jnp.asarray(Ls), k)),
                                 sample_kdpp_dense(keys[head],
                                                   torch.from_numpy(Ls),
                                                   k).numpy(),
                                 keys[head], Ls, k, f"head {head}")
            head += 1
    for name in ("serving.device_calls", "serving.heads_selected"):
        assert tclient._metrics.counter_value(name) == \
            jclient._metrics.counter_value(name)
    # the JAX client pads 7 heads to 8; the port draws the 7 alone
    assert jclient._metrics.gauges["serving.batch_occupancy"] == 7 / 8
    assert tclient._metrics.gauges["serving.batch_occupancy"] == 1.0


@threaded
def test_kv_client_coalesces_streams_into_one_device_call():
    client = KVCompactionClient(
        BUDGET, RECENCY, ServingConfig(max_batch=4096,
                                       deadline_ms=DEADLINE_MS),
        tenants={"s0": 1, "s1": 1}, seed=0, device="cpu")
    try:
        k0, k1 = heads(30), heads(31)
        t0 = client.submit(k0, valid_len=S, tenant="s0")
        t1 = client.submit(torch.from_numpy(k1), valid_len=12, tenant="s1")
        p0 = t0.result(timeout=WAIT).numpy()
        p1 = t1.result(timeout=WAIT).numpy()
        # both streams' heads rode one selection call
        assert client._metrics.counter_value("serving.device_calls") == 1
        assert client._metrics.counter_value("serving.heads_selected") == \
            2 * H
        assert client._metrics.counter_value("serving.deadline_fires") == 1
        for picks, valid in ((p0, S), (p1, 12)):
            assert picks.shape == (H, BUDGET) and picks.dtype == np.int32
            for row in picks:
                assert len(set(row.tolist())) == BUDGET
                assert (np.sort(row) == row).all()
                assert (row >= 0).all() and (row < valid).all()
                # the recency tail of the valid window is always kept
                assert set(range(valid - RECENCY, valid)) <= \
                    set(row.tolist())
    finally:
        client.close()


@threaded
def test_kv_client_picks_are_batching_invariant():
    k0, k1 = heads(40, h=2), heads(41, h=2)

    def run(submits):
        return _run(KVCompactionClient, ServingConfig,
                    [(t, k, None) for t, k in submits], seed=3,
                    device="cpu")[0]

    together = run([("a", k0), ("b", k1)])
    apart = []
    for sub in (("a", k0), ("b", k1)):       # one flush per submit
        apart.extend(run([sub]))
    assert torch.equal(together[0], apart[0])
    assert torch.equal(together[1], apart[1])
    # and a head drawn alone, through the selection itself
    rk = tr.key_data(KVCompactionClient(BUDGET, RECENCY, seed=3,
                                        device="cpu")._keyring.row_keys(
        [Ticket("b", 0, 2)], 2))
    alone = dpp_select_tokens(torch.from_numpy(k1[1]), BUDGET, RECENCY,
                              method="sample", key=rk[1])
    assert torch.equal(alone, together[1][1])


def test_kv_client_validation_matches_jax():
    for cls in (JaxClient, KVCompactionClient):
        kw = {} if cls is JaxClient else {"device": "cpu"}
        with pytest.raises(ValueError, match="budget must exceed recency"):
            cls(4, 4, **kw)
        client = cls(4, 1, **kw)
        with pytest.raises(ValueError, match="stacked heads"):
            client.submit(np.zeros((S, D), np.float32))
        client.close()


@threaded
def test_kv_client_groups_by_head_shape():
    """Streams of two cache shapes in one flush: one selection call a
    shape, each stream's picks within its own valid window."""
    client = KVCompactionClient(
        BUDGET, RECENCY, ServingConfig(max_batch=4096,
                                       deadline_ms=DEADLINE_MS),
        seed=1, device="cpu")
    try:
        a = client.submit(heads(50), tenant="a")
        b = client.submit(heads(51, h=2, s=24), tenant="b")
        pa, pb = a.result(timeout=WAIT), b.result(timeout=WAIT)
    finally:
        client.close()
    assert tuple(pa.shape) == (H, BUDGET) and tuple(pb.shape) == (2, BUDGET)
    assert (pb >= 0).all() and (pb < 24).all()
    assert client._metrics.counter_value("serving.device_calls") == 2
    assert client._metrics.gauges["serving.shape_groups"] == 2


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kv_client_on_the_card_matches_the_cpu():
    """On a card: two streams' heads through the client (one ``eigh`` and
    one phase-2 launch a head) against the same client on the CPU, head
    for head under the sample rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    from repro_torch.kernels import phase2_select as p2
    submits = [("s0", heads(60, s=64, d=8), None),
               ("s1", heads(61, s=64, d=8), 40)]
    p2.launches = 0
    card, _ = _run(KVCompactionClient, ServingConfig, submits, seed=2,
                   device="cuda")
    assert p2.launches == 2 * H
    cpu, client = _run(KVCompactionClient, ServingConfig, submits, seed=2,
                       device="cpu")
    keys = tr.key_data(client._keyring.row_keys(
        [Ticket("s0", 0, H), Ticket("s1", 0, H)], 2 * H))
    head = 0
    for (_, kk, vv), got, want in zip(submits, card, cpu):
        assert got.is_cuda
        for h in range(H):
            if not torch.equal(got[h].cpu(), want[h]):
                from repro_torch.sampling.kdpp import sample_kdpp_dense
                vl = 64 if vv is None else vv
                Ls = kernel(kk[h], vl, RECENCY, True).astype(np.float32)
                Lt = torch.from_numpy(Ls)
                assert_same_kdpp(
                    sample_kdpp_dense(keys[head], Lt, BUDGET - RECENCY),
                    sample_kdpp_dense(keys[head], Lt.cuda(),
                                      BUDGET - RECENCY).cpu(),
                    keys[head], Ls, BUDGET - RECENCY, f"head {head}")
            head += 1
