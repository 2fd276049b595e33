"""Greedy MAP of the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX Pallas
step kernel (interpret mode, ``force_pallas=True``), the JAX oracles
(``ref.greedy_map_update_ref``, ``core.sampling.greedy_map_kdpp``) and the
port (``kernels.ops`` on CPU tensors, so the plain update; batches of
matrices against the reference's ``vmap``). One step is
compared at float32 tolerance: rtol 1e-5 and an atol of 1e-5 · max |lcol|
(for e) and 1e-5 · max |lcol|² (for d_new), since the two packages sum
C · cj in different orders. Whole selections are compared in order and
exactly: a tie between two items' conditional variances is the only
admissible difference. Only the rank-deficient case meets ties (every
pick past the rank is one) and says so where it compares.
"""

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

from repro import dpp as jax_dpp
from repro.core.sampling import greedy_map_kdpp as jax_core_greedy
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
import repro_torch.obs as obs
from repro_torch import dpp
from repro_torch.core.sampling import greedy_map_kdpp as core_greedy
from repro_torch.kernels import ops
from repro_torch.kernels.greedy_map import (degeneracy_eps,
                                            greedy_map_kdpp_cuda,
                                            greedy_map_kdpp_plain,
                                            greedy_map_update_cuda,
                                            greedy_map_update_plain)


def step_inputs(n, k, seed=0):
    """One step's (lcol, C, cj, dj, d) with C's rows a Cholesky-like
    buffer, d positive, as in a MAP run."""
    rng = np.random.default_rng(seed)
    lcol = rng.standard_normal(n).astype(np.float32)
    C = (0.3 * rng.standard_normal((n, k))).astype(np.float32)
    cj = C[rng.integers(n)].copy()
    dj = np.asarray([1.0 + rng.random()], np.float32)
    d = (1.0 + 4.0 * rng.random(n)).astype(np.float32)
    return lcol, C, cj, dj, d


def psd(n, r, seed, ridge):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, r)).astype(np.float32)
    return (X @ X.T + ridge * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n,k", [(16, 1), (100, 5), (700, 16), (1030, 33)])
def test_update_plain_matches_jax_pallas_and_ref(n, k):
    """N = 100, 700, 1030 are no multiple of 512 (the Pallas block)."""
    args = step_inputs(n, k, seed=n + k)
    jargs = [jnp.asarray(a) for a in args]
    e_pl, d_pl = jax_ops.greedy_map_update(*jargs, force_pallas=True)
    e_rf, d_rf = jax_ref.greedy_map_update_ref(*jargs)
    e, d_new = ops.greedy_map_update(*(torch.from_numpy(a) for a in args))
    assert e.dtype == d_new.dtype == torch.float32
    scale = float(np.abs(args[0]).max())
    for want_e, want_d in ((e_pl, d_pl), (e_rf, d_rf)):
        np.testing.assert_allclose(e.numpy(), np.asarray(want_e), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(d_new.numpy(), np.asarray(want_d),
                                   rtol=1e-5, atol=1e-5 * scale ** 2)


def test_update_reads_c_through_its_strides():
    """The greedy loop passes the (N, k) view of a (k, N) buffer."""
    lcol, C, cj, dj, d = (torch.from_numpy(a) for a in step_inputs(50, 7))
    CT = C.t().contiguous()
    for a, b in zip(ops.greedy_map_update(lcol, C, cj, dj, d),
                    ops.greedy_map_update(lcol, CT.t(), cj, dj, d)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_degeneracy_eps_matches_jax():
    L = psd(12, 3, 0, 0.0) * 1e-3
    np.testing.assert_allclose(float(degeneracy_eps(torch.from_numpy(L))),
                               float(jax_ref.degeneracy_eps(jnp.asarray(L))),
                               rtol=1e-6)


@pytest.mark.parametrize("n,k", [(16, 4), (32, 8), (64, 5), (128, 16)])
def test_greedy_map_kdpp_matches_jax_in_order(n, k):
    """The shapes of tests/test_kernels.py::test_greedy_map_kernel_vs_core,
    but the picks in order, not sorted."""
    rng = np.random.default_rng(n + k)
    X = rng.standard_normal((n, max(k, 8))).astype(np.float32)
    L = (X @ X.T + 0.1 * np.eye(n)).astype(np.float32)
    want_pl = np.asarray(jax_ops.greedy_map_kdpp(jnp.asarray(L), k,
                                                 force_pallas=True))
    want_core = np.asarray(jax_core_greedy(jnp.asarray(L), k))
    got = ops.greedy_map_kdpp(torch.from_numpy(L), k)
    got_core = core_greedy(torch.from_numpy(L), k)
    assert got.dtype == got_core.dtype == torch.int32
    assert got.shape == (k,)
    np.testing.assert_array_equal(got.numpy(), want_pl)
    np.testing.assert_array_equal(got.numpy(), want_core)
    np.testing.assert_array_equal(got_core.numpy(), want_core)


@pytest.mark.parametrize("impl", ["core", "ops"])
def test_greedy_map_rank_deficient_no_nan(impl):
    """Mirror of tests/test_sampling_batched.py: k beyond numerical rank
    must neither divide by a collapsed variance nor repeat a pick."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8, 2)).astype(np.float32)   # rank 2, N = 8
    L = torch.from_numpy(X @ X.T)
    fn = core_greedy if impl == "core" else ops.greedy_map_kdpp
    picks = fn(L, 6).numpy()
    assert picks.shape == (6,)
    assert (picks >= 0).all() and (picks < 8).all()
    assert len(set(picks.tolist())) == 6
    ref = core_greedy(L + 1e-5 * torch.eye(8), 6).numpy()
    assert (picks[:2] == ref[:2]).all()
    # beyond the rank every conditional variance is float32 roundoff of
    # zero — a tie among the remaining items, broken by noise differently
    # in the two packages — so only the first rank picks are compared
    want = np.asarray(jax_core_greedy(jnp.asarray(X @ X.T), 6))
    np.testing.assert_array_equal(picks[:2], want[:2])


@pytest.mark.parametrize("impl", ["core", "ops"])
def test_greedy_map_scale_equivariant(impl):
    """The degeneracy gate is relative to the kernel's scale."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 8)).astype(np.float32)
    L = torch.from_numpy(X @ X.T)
    fn = core_greedy if impl == "core" else ops.greedy_map_kdpp
    base = fn(L, 5).numpy()
    for scale in (1e-10, 1e8):
        assert (fn(L * scale, 5).numpy() == base).all(), scale


def test_greedy_map_maximizes_logdet():
    """Greedy MAP beats random subsets on det(L_Y) (sanity), as in
    tests/test_kernels.py."""
    rng = np.random.default_rng(1)
    L = psd(48, 12, 1, 0.05)
    picks = ops.greedy_map_kdpp(torch.from_numpy(L), 6).numpy()
    det_g = np.linalg.det(L[np.ix_(picks, picks)])
    rnd = [np.linalg.det(L[np.ix_(s, s)])
           for s in (rng.choice(48, 6, replace=False) for _ in range(50))]
    assert det_g >= np.max(rnd) * 0.5


def test_dispatch_counter_fires_once_per_step():
    """The step op counts once a step; a whole selection, single or
    batched, counts once (the JAX package counts once per traced scan)."""
    L = torch.from_numpy(psd(20, 6, 2, 0.1))
    args = [torch.from_numpy(a) for a in step_inputs(20, 3)]
    with obs.use(obs.InMemoryTracker()) as t:
        ops.greedy_map_update(*args)
    assert t.counter_value("kernels.greedy_map_update.reference") == 1
    with obs.use(obs.InMemoryTracker()) as t:
        ops.greedy_map_kdpp(L, 7)
        ops.greedy_map_kdpp(torch.stack([L, L, L]), 7)
    assert t.counter_value("kernels.greedy_map_update.reference") == 2
    assert t.counter_value("kernels.greedy_map_update.cuda") == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.greedy_map_kdpp(L, 2, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.greedy_map_kdpp(L, 2, backend="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in step_inputs(10, 3)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        greedy_map_update_cuda(*args)
    assert greedy_map_update_cuda.launches == 0


def rank_deficient(n, r, seed):
    """A PSD L of rank r whose other n - r items have exactly zero rows and
    columns: past the rank every conditional variance is exactly 0 in both
    packages, so every later pick is a tie broken by the first index."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)[:r]
    X = rng.standard_normal((r, r)).astype(np.float32)
    L = np.zeros((n, n), np.float32)
    L[np.ix_(idx, idx)] = X @ X.T + 0.5 * np.eye(r, dtype=np.float32)
    return L


def equal_diagonal(n, seed):
    """Unit-norm features plus a ridge, the diagonal set to 1.1 exactly: the
    first pick is a tie of all n items."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L = (X @ X.T + 0.1 * np.eye(n)).astype(np.float32)
    np.fill_diagonal(L, 1.1)
    return L


BATCHES = {
    "psd": (lambda: np.stack([psd(24, 8, s, 0.1) for s in range(3)]), 10),
    "k_equals_n": (lambda: np.stack([psd(12, 12, s, 0.1)
                                     for s in range(3)]), 12),
    "rank_deficient": (lambda: np.stack([rank_deficient(16, 5, s)
                                         for s in range(4)]), 12),
    "rank_deficient_k_equals_n": (lambda: np.stack(
        [rank_deficient(10, 3, s) for s in range(2)]), 10),
    "equal_diagonal": (lambda: np.stack([equal_diagonal(20, s)
                                         for s in range(3)]), 14),
    "scaled_identity": (lambda: np.stack([2.0 * np.eye(9, dtype=np.float32)]
                                         * 2), 9),
    "one_matrix": (lambda: psd(30, 6, 7, 0.1)[None], 5),
}


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_kdpp_plain_batch_equals_each_matrix(case):
    """The plain selection of an (H, N, N) batch is each matrix's own
    selection, bit for bit."""
    make, k = BATCHES[case]
    Ls = torch.from_numpy(make())
    got = greedy_map_kdpp_plain(Ls, k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (Ls.shape[0], k)
    for h in range(Ls.shape[0]):
        assert torch.equal(got[h], greedy_map_kdpp_plain(Ls[h], k)), h
    assert tuple(greedy_map_kdpp_plain(Ls[:0], k).shape) == (0, k)


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_kdpp_batch_matches_jax_vmap(case):
    """``ops.greedy_map_kdpp`` on a CPU batch against the reference's vmap
    of ``ops.greedy_map_kdpp``, in order and exactly: random PSD, k = N,
    rank-deficient past the rank (exact zero variances, ties broken by the
    first index), an all-equal diagonal and a scaled identity (ties)."""
    make, k = BATCHES[case]
    Ls = make()
    want = np.asarray(jax.vmap(lambda L: jax_ops.greedy_map_kdpp(L, k))(
        jnp.asarray(Ls)))
    got = ops.greedy_map_kdpp(torch.from_numpy(Ls), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for h in range(Ls.shape[0]):
        assert len(set(got[h].tolist())) == k


def test_kdpp_cuda_wrapper_refuses_bad_inputs():
    """The fused wrapper refuses a CPU tensor, float64, a non-contiguous or
    badly shaped L and a k outside 1..N, and counts no launch."""
    L = torch.from_numpy(psd(12, 4, 0, 0.1))
    cases = [
        (L, 3, "CUDA tensor"),
        (L[None].expand(2, 12, 12).contiguous(), 3, "CUDA tensor"),
        (L.double(), 3, "float32"),
        (L.t(), 3, "contiguous"),
        (L[:, :11].contiguous(), 3, r"\(N, N\)"),
        (L[None, None], 3, r"\(N, N\)"),
        (L[0], 1, r"\(N, N\)"),
        (L, 0, "outside"),
        (L, 13, "outside"),
        ("not a tensor", 3, "tensor"),
    ]
    for x, k, msg in cases:
        with pytest.raises(ValueError, match=msg):
            greedy_map_kdpp_cuda(x, k)
    assert greedy_map_kdpp_cuda.launches == 0


@pytest.mark.parametrize("sizes", [(4, 6), (8, 8)])
@pytest.mark.parametrize("kind", ["kron", "dense"])
def test_facade_map_matches_jax(sizes, kind):
    """``Kron.map`` and ``Dense.map`` on the JAX model's numpy factors give
    the JAX facade's picks, in order."""
    jm = jax_dpp.random_kron(jax.random.PRNGKey(sum(sizes)), sizes)
    factors = [np.asarray(f) for f in jm.factors]
    if kind == "dense":
        jm = jax_dpp.from_kernel(jm.dense_kernel())
        m = dpp.from_kernel(np.asarray(jm.dense_kernel()), device="cpu")
    else:
        m = dpp.Kron(factors, device="cpu")
    for k in (3, 10):
        got = m.map(k)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm.map(k)))


@pytest.mark.parametrize("kind", ["kron", "dense"])
def test_map_is_valid_and_greedy(kind):
    """Mirror of tests/test_dpp_facade.py on the (2, 3) kernel."""
    m = dpp.random_kron(torch.Generator().manual_seed(5), (2, 3),
                        device="cpu")
    if kind == "dense":
        m = dpp.from_kernel(m.dense_kernel(), device="cpu")
    picks = m.map(3).numpy()
    assert picks.shape == (3,)
    assert len(set(picks.tolist())) == 3
    assert (picks >= 0).all() and (picks < 6).all()
    L = m.dense_kernel().numpy()
    assert picks[0] == int(np.argmax(np.diag(L)))


def test_kron_map_max_dense_guard():
    """Mirror of tests/test_dpp_facade.py::test_kron_dense_fallback_guard
    for ``map``: N = 6400 > MAX_DENSE_N."""
    big = dpp.random_kron(torch.Generator().manual_seed(0), (80, 80),
                          device="cpu")
    with pytest.raises(ValueError, match="max_dense"):
        big.map(4)
    with pytest.raises(ValueError, match="max_dense"):
        big.dense_kernel()
    assert dpp.functional.greedy_map_kdpp is ops.greedy_map_kdpp


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: the step kernel against the plain version, row-major and
    transposed C, ragged N; then a whole MAP run through the kernel
    (k launches) against the plain run, picks equal in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    for n, k in ((1, 1), (33, 20), (4097, 200), (1030, 0)):
        args = [torch.from_numpy(a).cuda()
                for a in step_inputs(n, max(k, 1), seed=n)]
        if k == 0:
            args[1], args[2] = args[1][:, :0], args[2][:0]
        scale = float(args[0].abs().max())
        for C in (args[1], args[1].t().contiguous().t()):
            n0 = greedy_map_update_cuda.launches
            e, d_new = greedy_map_update_cuda(args[0], C, *args[2:])
            torch.cuda.synchronize()
            assert greedy_map_update_cuda.launches == n0 + 1
            e_p, d_p = greedy_map_update_plain(args[0], C, *args[2:])
            torch.testing.assert_close(e, e_p, rtol=1e-5,
                                       atol=1e-5 * scale)
            torch.testing.assert_close(d_new, d_p, rtol=1e-5,
                                       atol=1e-5 * scale ** 2)
    L = torch.from_numpy(psd(300, 40, 3, 0.1)).cuda()
    n0 = greedy_map_update_cuda.launches
    f0 = greedy_map_kdpp_cuda.launches
    got = ops.greedy_map_kdpp(L, 25)
    assert greedy_map_update_cuda.launches == n0
    assert greedy_map_kdpp_cuda.launches == f0 + 1
    want = ops.greedy_map_kdpp(L, 25, backend="reference")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_fused_kernel_matches_plain_on_card():
    """On a card: the fused selection against the plain loop on the same
    matrices, at N on both sides of the cluster sizes and of C in shared
    memory, k = 1 and k = N, the tie-heavy batches above; every matrix of
    a batched launch equals its own single launch bit for bit. The picks
    equal the plain version's, or first differ at a tie: the float64
    conditional variances of the two candidates, given the common prefix,
    within ``GREEDY_TIE_TOL`` of max diag L (the two sum each dot in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    batches = [(torch.from_numpy(make()), k)
               for make, k in BATCHES.values()]
    for n, k, H in ((1, 1, 1), (33, 20, 3), (129, 33, 2), (512, 120, 4),
                    (700, 700, 1), (2500, 60, 2)):
        batches.append((torch.from_numpy(np.stack(
            [psd(n, max(k, 8), n + h, 0.1) for h in range(H)])), k))
    for Ls, k in batches:
        Ls = Ls.cuda()
        f0 = greedy_map_kdpp_cuda.launches
        got = ops.greedy_map_kdpp(Ls, k)
        torch.cuda.synchronize()
        assert greedy_map_kdpp_cuda.launches == f0 + 1
        want = greedy_map_kdpp_plain(Ls, k)
        for h in range(Ls.shape[0]):
            assert_same_or_tie(Ls[h].cpu().double().numpy(),
                               got[h].cpu().numpy(), want[h].cpu().numpy())
            assert torch.equal(greedy_map_kdpp_cuda(Ls[h], k), got[h])


GREEDY_TIE_TOL = 1e-4


def assert_same_or_tie(L, a, b):
    """Two greedy orders of the float64 L: equal, or the first difference a
    tie of the exact conditional variances given the common prefix."""
    diff = np.nonzero(a != b)[0]
    if not diff.size:
        return
    t = int(diff[0])
    P = a[:t]
    d = np.diag(L).copy()
    if t:
        d -= np.einsum("ij,ij->j", L[P],
                       np.linalg.lstsq(L[np.ix_(P, P)], L[P], rcond=None)[0])
    gap = abs(d[a[t]] - d[b[t]]) / np.diag(L).max()
    assert gap <= GREEDY_TIE_TOL, (t, a[t], b[t], gap)


@pytest.mark.parametrize("shape", [(6,), (3, 6)])
def test_kdpp_past_n_matches_jax_on_both_routes(shape, monkeypatch):
    """k > N gives the reference's N picks and then k - N zeros on the
    plain route, and on the card's route too: there ``ops`` launches the
    fused selection with k = N (here a counted stand-in that refuses k
    outside 1..N, as the wrapper does) and pads with int32 zeros."""
    n, k = shape[-1], 8
    Ls = np.stack([psd(n, 3, s, 0.1) for s in range(3)]) if len(shape) == 2 \
        else psd(n, 3, 0, 0.1)
    want = np.asarray(jax.vmap(lambda L: jax_ops.greedy_map_kdpp(L, k))(
        jnp.asarray(Ls)) if Ls.ndim == 3
        else jax_ops.greedy_map_kdpp(jnp.asarray(Ls), k))
    L = torch.from_numpy(Ls)
    np.testing.assert_array_equal(ops.greedy_map_kdpp(L, k).numpy(), want)
    assert (want[..., n:] == 0).all()
    asked = []

    def fused(L, k):
        assert 1 <= k <= L.shape[-1]
        asked.append(k)
        return greedy_map_kdpp_plain(L, k)
    monkeypatch.setattr(ops, "greedy_map_kdpp_cuda", fused)
    monkeypatch.setattr(ops, "_resolve_backend", lambda *a: "cuda")
    got = ops.greedy_map_kdpp(L, k)
    assert asked == [n] and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.greedy_map_kdpp(L, n), got[..., :n])


@pytest.mark.cuda
def test_fused_kernel_past_n_pads_zeros_on_card():
    """On a card: ``ops.greedy_map_kdpp`` and ``Kron.map`` with k > N, for
    (N, N) and (H, N, N), return the plain loop's answer, the N picks and
    then zeros, from one launch and without raising."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    cases = [(torch.from_numpy(psd(6, 3, 0, 0.1)), 8),
             (torch.from_numpy(np.stack([psd(6, 3, s, 0.1)
                                         for s in range(4)])), 8),
             (torch.from_numpy(psd(33, 8, 1, 0.1)), 40)]
    for L, k in cases:
        f0 = greedy_map_kdpp_cuda.launches
        got = ops.greedy_map_kdpp(L.cuda(), k)
        torch.cuda.synchronize()
        assert greedy_map_kdpp_cuda.launches == f0 + 1
        assert got.is_cuda and got.dtype == torch.int32
        want = greedy_map_kdpp_plain(L, k)
        n = L.shape[-1]
        for a, b, Lh in zip(got.cpu().reshape(-1, k), want.reshape(-1, k),
                            L.reshape(-1, n, n)):
            assert_same_or_tie(Lh.double().numpy(), a[:n].numpy(),
                               b[:n].numpy())
            assert (a[n:] == 0).all() and (b[n:] == 0).all()
    model = dpp.Kron((psd(2, 2, 0, 0.1), psd(3, 3, 1, 0.1)), device="cuda")
    cpu = dpp.Kron(tuple(f.cpu() for f in model.factors), device="cpu")
    got, want = model.map(8), cpu.map(8)
    assert got.is_cuda
    assert_same_or_tie(cpu.dense_kernel().double().numpy(),
                       got.cpu()[:6].numpy(), want[:6].numpy())
    assert (got.cpu()[6:] == 0).all() and (want[6:] == 0).all()
