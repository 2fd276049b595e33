"""The data pipeline, the KronDPP batch selector and the learner CLI of the
PyTorch port (``repro_torch.data``, ``repro_torch.launch.learn``) against
the JAX package's ``repro.data`` and ``repro.launch.learn`` on the CPU.

Both packages get the same numpy features and the same numpy rng. The
selector's keys (the service seed, the Host draw's key) come from that rng
through the PRNG twin, so the port draws the JAX package's documents.
Tolerances:

* the corpus, the pipeline's batches and the selected indices: exact (the
  same numpy code; keyed draws from the same keys, on inputs where no
  draw meets a float32 roundoff tie — the tie rule of
  ``tests/test_torch_lowrank.py`` would name one, and none occurs here);
* the selector's kernels: L1 and L2 and the low-rank basis equal the
  reference's (the same float64 numpy code, cast to float32 once);
* ``fit_from_subsets``: factors within 1e-4 of max |L_i| (KrK, as
  ``tests/test_torch_learning.py``), V and q within 1e-3 of their max
  (the low-rank learner, as ``tests/test_torch_lowrank.py``);
* ``launch.learn``'s JSON lines: the same sweeps, backtracks and keys, the
  LLs within rtol 1e-4 (float32 sums in other orders).
"""

import json
import os
import sys

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro import dpp as jdpp
from repro import obs as jax_obs
from repro.data import DPPBatchSelector as JaxSelector
from repro.data import TokenPipeline as JaxPipeline
from repro.data import synthetic_corpus as jax_corpus
from repro.launch import learn as jax_learn
from repro_torch import dpp
from repro_torch.data import DPPBatchSelector, TokenPipeline, synthetic_corpus
from repro_torch.data import dpp_selection
from repro_torch.launch import learn

KRK_REL = 1e-4
LOWRANK_REL = 1e-3
LL_RTOL = 1e-4


def features(n_docs=144, seq=24, vocab=256, d=8, seed=1, n_topics=12):
    """The corpus and doc features of ``tests/test_system.py``."""
    corpus = synthetic_corpus(n_docs, seq, vocab, seed=seed,
                              n_topics=n_topics)
    proj = np.random.default_rng(0).standard_normal((vocab, d)).astype(
        np.float32) / d
    return corpus, np.stack([proj[c].mean(0) for c in corpus])


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel(got, want) -> float:
    got, want = np_(got).astype(np.float64), np_(want).astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(32, 16, 100, 0, 16), (144, 24, 256, 1, 12),
                                  (10, 4, 7, 3, 16)])
def test_synthetic_corpus_equals_the_reference(args):
    n, s, v, seed, topics = args
    got = synthetic_corpus(n, s, v, seed=seed, n_topics=topics)
    want = jax_corpus(n, s, v, seed=seed, n_topics=topics)
    assert got.dtype == np.int32 and got.shape == (n, s + 1)
    np.testing.assert_array_equal(got, want)


def test_pipeline_state_replay():
    """``tests/test_checkpoint.py::test_pipeline_state_replay`` on the
    port, and its batches are the reference pipeline's."""
    corpus = synthetic_corpus(32, 16, 100)
    p1 = TokenPipeline(corpus, 4, seed=3)
    it = iter(p1)
    seen = [next(it)["tokens"] for _ in range(5)]
    state = p1.state()
    want = next(iter(p1))["tokens"]
    p2 = TokenPipeline(corpus, 4, seed=3)
    p2.restore(state)
    got = next(iter(p2))["tokens"]
    np.testing.assert_array_equal(got, want)
    jit = iter(JaxPipeline(corpus, 4, seed=3))
    for b in seen + [want]:
        np.testing.assert_array_equal(b, next(jit)["tokens"])


def test_pipeline_with_selector_replays_and_matches_the_reference():
    """A selector-driven pipeline: ``restore`` drops the prefetch buffer
    and replays the rng stream, so the next batch is the one the first
    run drew; every batch is the reference pipeline's."""
    corpus, feats = features()
    mk = lambda: DPPBatchSelector.from_features(feats, 12, 12, device="cpu")
    p1 = TokenPipeline(corpus, 8, seed=0, selector=mk())
    it = iter(p1)
    seen = [next(it)["tokens"] for _ in range(20)]   # past one prefetch
    state = p1.state()
    want = next(it)["tokens"]
    p2 = TokenPipeline(corpus, 8, seed=0, selector=mk())
    next(iter(p2))                                   # a buffered draw
    p2.restore(state)
    np.testing.assert_array_equal(next(iter(p2))["tokens"], want)
    jit = iter(JaxPipeline(corpus, 8, seed=0,
                           selector=JaxSelector.from_features(feats, 12, 12)))
    for b in seen + [want]:
        np.testing.assert_array_equal(b, next(jit)["tokens"])


# ---------------------------------------------------------------------------
# from_features
# ---------------------------------------------------------------------------

def test_selector_routes_by_size_and_method():
    """``tests/test_lowrank.py::test_selector_routes_by_size_and_method``
    on the port, with the kernels equal to the reference's."""
    X = np.random.default_rng(2).normal(size=(24, 6))
    kw = dict(device="cpu")
    dense = DPPBatchSelector.from_features(X, 4, 6, method="dense", **kw)
    low = DPPBatchSelector.from_features(X, 4, 6, method="lowrank", rank=8,
                                         **kw)
    auto_small = DPPBatchSelector.from_features(X, 4, 6, method="auto", **kw)
    auto_big = DPPBatchSelector.from_features(X, 4, 6, method="auto",
                                              threshold=10, **kw)
    assert type(dense.dpp) is dpp.Kron
    assert type(low.dpp) is dpp.LowRank and low.dpp.rank == 8
    assert type(auto_small.dpp) is dpp.Kron        # 24 <= default threshold
    assert type(auto_big.dpp) is dpp.LowRank       # 24 > 10
    assert dpp_selection.LOWRANK_THRESHOLD == 2048
    with pytest.raises(ValueError, match="method"):
        DPPBatchSelector.from_features(X, 4, 6, method="nope", **kw)
    with pytest.raises(ValueError, match="features"):
        DPPBatchSelector.from_features(X, 4, 6, method="lowrank",
                                       features="nope", **kw)
    jd = JaxSelector.from_features(X, 4, 6, method="dense")
    for got, want in zip(dense.dpp.factors, jd.dpp.factors):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    for feats in ("nystrom", "rff"):
        got = DPPBatchSelector.from_features(X, 4, 6, method="lowrank",
                                             rank=8, features=feats,
                                             scale=2.0, **kw)
        want = JaxSelector.from_features(X, 4, 6, method="lowrank", rank=8,
                                         features=feats, scale=2.0)
        np.testing.assert_array_equal(np_(got.dpp.V), np.asarray(want.dpp.V))
        np.testing.assert_array_equal(np_(got.dpp.q), np.asarray(want.dpp.q))


def test_backend_shim_warns_and_resolves():
    """``tests/test_runtime.py::test_selector_backend_shim_warns_and_
    resolves`` on the port."""
    feats = np.random.default_rng(0).standard_normal((12, 3))
    with pytest.warns(DeprecationWarning, match="backend= placement"):
        sel = DPPBatchSelector.from_features(feats, 3, 4, backend="host",
                                             device="cpu")
    assert sel.runtime.kind == "host"
    assert sel.backend is None          # consumed: replace() must not re-warn
    quiet = DPPBatchSelector.from_features(feats, 3, 4, device="cpu")
    assert quiet.runtime.kind == "local"
    with pytest.raises(ValueError, match="conflicting"):
        DPPBatchSelector.from_features(feats, 3, 4, backend="host",
                                       runtime=dpp.Host(), device="cpu")


# ---------------------------------------------------------------------------
# select: draw for draw against the reference
# ---------------------------------------------------------------------------

ROUTES = {
    "kron_local": (dict(), dict()),
    "kron_host": (dict(runtime=dpp.Host()), dict(runtime=jdpp.Host())),
    "lowrank": (dict(method="lowrank", rank=24),
                dict(method="lowrank", rank=24)),
    "lowrank_rff_scaled": (dict(method="lowrank", rank=16, features="rff",
                                scale=3.0),
                           dict(method="lowrank", rank=16, features="rff",
                                scale=3.0)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_select_equals_the_reference_selector(route):
    """The same features and the same numpy rng give the reference's
    indices, batch for batch, across two prefetch flushes (Local and
    low-rank: the service's seed from the rng) or one key a draw (Host)."""
    tkw, jkw = ROUTES[route]
    corpus, feats = features()
    n = 20 if route == "kron_host" else 40
    sel = DPPBatchSelector.from_features(feats, 12, 12, device="cpu", **tkw)
    ref = JaxSelector.from_features(feats, 12, 12, **jkw)
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(n):
        got, want = sel.select(r1, 8), ref.select(r2, 8)
        assert got.dtype == np.int64 and len(set(got.tolist())) == 8
        np.testing.assert_array_equal(got, want, err_msg=f"batch {i}")
    assert r1.integers(2 ** 31) == r2.integers(2 ** 31)   # same stream


def test_select_under_a_mesh_equals_local():
    """A ``Mesh`` selector (each flush's keys cut into shards) draws the
    ``Local`` selector's indices."""
    _, feats = features()
    local = DPPBatchSelector.from_features(feats, 12, 12, device="cpu")
    mesh = DPPBatchSelector.from_features(
        feats, 12, 12, device="cpu",
        runtime=dpp.Mesh(axes={"data": 4}, devices=["cpu"] * 4))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        np.testing.assert_array_equal(mesh.select(r1, 10),
                                      local.select(r2, 10))


def test_dpp_batches_are_more_diverse_than_random():
    """``tests/test_system.py::test_dpp_batches_are_more_diverse_than_
    random`` on the port: KronDPP selection yields at least comparable
    topic coverage vs uniform sampling, and always fills the batch."""
    rng = np.random.default_rng(0)
    n_topics = 12
    corpus = synthetic_corpus(144, 24, 256, seed=1, n_topics=n_topics)
    proj = rng.standard_normal((256, 8)).astype(np.float32) / 8
    feats = np.stack([proj[c].mean(0) for c in corpus])
    sel = DPPBatchSelector.from_features(feats, 12, 12, scale=4.0,
                                         device="cpu")
    topics = np.random.default_rng(1).integers(0, n_topics, 144)
    cov_dpp, cov_rand = [], []
    for _ in range(20):
        idx = sel.select(rng, 12)
        assert len(idx) == 12
        cov_dpp.append(len(set(topics[idx])))
        cov_rand.append(len(set(topics[rng.choice(144, 12, replace=False)])))
    assert np.mean(cov_dpp) >= np.mean(cov_rand) - 0.5


# ---------------------------------------------------------------------------
# fit_from_subsets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["krk", "krk-stochastic", "lowrank"])
def test_fit_from_subsets_matches_the_reference(mode):
    """``tests/test_system.py::test_selector_learns_from_subsets`` (and
    ``tests/test_lowrank.py::test_selector_lowrank_selects_and_learns``)
    on both packages: the learned kernel, and the fitted selector still
    fills a batch."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((36, 4)).astype(np.float32)
    subs = [list(rng.choice(36, 6, replace=False)) for _ in range(10)]
    kw = dict(method="lowrank", rank=12) if mode == "lowrank" else {}
    fit_kw = dict(iters=3)
    if mode == "krk-stochastic":
        fit_kw["minibatch_size"] = 4
    sel = DPPBatchSelector.from_features(feats, 6, 6, device="cpu", **kw)
    ref = JaxSelector.from_features(feats, 6, 6, **kw)
    sel2 = sel.fit_from_subsets(subs, **fit_kw)
    ref2 = ref.fit_from_subsets(subs, **fit_kw)
    assert type(sel2.dpp) is type(sel.dpp) and sel2.device == sel.device
    if mode == "lowrank":
        assert rel(sel2.dpp.V, ref2.dpp.V) <= LOWRANK_REL
        assert rel(sel2.dpp.q, ref2.dpp.q) <= LOWRANK_REL
    else:
        for got, want in zip(sel2.dpp.factors, ref2.dpp.factors):
            assert got.shape == tuple(want.shape)
            assert rel(got, want) <= KRK_REL
    assert sel2.select(rng, 8).shape == (8,)


# ---------------------------------------------------------------------------
# launch.learn
# ---------------------------------------------------------------------------

def run_main(main, argv, capsys, monkeypatch=None):
    if monkeypatch is not None:          # the reference reads sys.argv
        monkeypatch.setattr(sys, "argv", ["learn", *argv])
        main()
    else:
        main(argv)
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


LEARN_ARGS = {
    "krk_dense_armijo": ["--n1", "8", "--n2", "8", "--subsets", "64",
                         "--iters", "6", "--log-every", "3", "--schedule",
                         "armijo", "--a", "1.5", "--dense-theta"],
    "krk_stochastic": ["--n1", "6", "--n2", "7", "--subsets", "50",
                       "--algorithm", "krk-stochastic", "--minibatch", "16",
                       "--iters", "4", "--log-every", "2"],
    "em": ["--n1", "5", "--n2", "5", "--subsets", "40", "--algorithm", "em",
           "--iters", "3", "--log-every", "3"],
    "joint": ["--n1", "5", "--n2", "5", "--subsets", "40", "--algorithm",
              "joint", "--iters", "3", "--log-every", "3"],
    "mesh_sweep_ll": ["--n1", "6", "--n2", "6", "--subsets", "40", "--iters",
                      "4", "--runtime", "mesh", "--log-every", "2",
                      "--ll-mode", "sweep", "--seed", "3"],
}


@pytest.mark.parametrize("case", sorted(LEARN_ARGS))
def test_learn_cli_equals_the_reference(case, capsys, monkeypatch):
    """``main([... "--device", "cpu"])`` prints the reference launcher's
    lines: the same data (keys through the PRNG twin), the same sweeps,
    the LLs within rtol 1e-4."""
    argv = LEARN_ARGS[case]
    want = run_main(jax_learn.main, argv, capsys, monkeypatch)
    got = run_main(learn.main, argv + ["--device", "cpu"], capsys)
    assert len(got) == len(want) >= 2
    for g, w in zip(got[:-1], want[:-1]):
        assert g["sweep"] == w["sweep"]
        np.testing.assert_allclose(g["ll"], w["ll"], rtol=LL_RTOL)
    g, w = got[-1], want[-1]
    for k in ("algorithm", "sweeps", "armijo_backtracks", "health",
              "health_triggered"):
        assert g[k] == w[k], k
    np.testing.assert_allclose(g["ll_final"], w["ll_final"], rtol=LL_RTOL)
    assert g["sweeps_per_sec"] > 0


def test_learn_cli_run_log_and_trace(tmp_path, capsys, monkeypatch):
    """``--jsonl`` and ``--trace``: the run log holds the reference's
    metric and span names (and the port's ``kernels.*`` dispatch
    counters), the trace file its events, and the process-wide tracker is
    the one it was before the run."""
    from repro_torch import obs
    argv = ["--n1", "6", "--n2", "6", "--subsets", "40", "--iters", "4",
            "--log-every", "2", "--schedule", "armijo"]
    paths = {p: (str(tmp_path / f"{p}.jsonl"), str(tmp_path / f"{p}.json"))
             for p in ("jax", "torch")}
    before = obs.current_tracker()
    jax_before = jax_obs.current_tracker()
    try:        # the reference launcher installs its run log process-wide
        run_main(jax_learn.main, argv + ["--jsonl", paths["jax"][0],
                                         "--trace", paths["jax"][1]],
                 capsys, monkeypatch)
    finally:
        installed = jax_obs.configure(jax_before)
        if installed is not jax_before and hasattr(installed, "close"):
            installed.close()
    got = run_main(learn.main, argv + ["--device", "cpu", "--jsonl",
                                       paths["torch"][0], "--trace",
                                       paths["torch"][1]], capsys)
    assert obs.current_tracker() is before
    assert got[-1]["health"] is not None
    names = {}
    for p, (log, trace) in paths.items():
        recs = [json.loads(line) for line in open(log)]
        names[p] = {(r["kind"], r["name"]) for r in recs}
        assert json.load(open(trace))["traceEvents"]
    # the port also counts the dispatch of its keyed-draw ops, which the
    # JAX package fuses into one traced call
    extra = names["torch"] - names["jax"]
    assert names["jax"] <= names["torch"]
    assert all(k == "counter" and n.startswith("kernels.") for k, n in extra)
    with pytest.raises(SystemExit):
        learn.main(["--trace", "x.json", "--device", "cpu"])


@pytest.mark.cuda
def test_selector_on_card_equals_the_cpu_copy():
    """On a card: the selector's draws (the service's phase-2 kernel, one
    launch a prefetch of 16) equal a CPU copy's for the same rng, on the
    Kron route and on the low-rank route, for two flushes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import phase2_select as p2
    _, feats = features()
    for kw in (dict(), dict(method="lowrank", rank=24)):
        card = DPPBatchSelector.from_features(feats, 12, 12, device="cuda",
                                              **kw)
        cpu = DPPBatchSelector.from_features(feats, 12, 12, device="cpu",
                                             **kw)
        r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
        n0 = p2.launches
        for i in range(32):
            np.testing.assert_array_equal(card.select(r1, 8),
                                          cpu.select(r2, 8),
                                          err_msg=f"{kw} batch {i}")
        if not kw:
            assert p2.launches == n0 + 2
