"""The PyTorch port's Kronecker algebra (``repro_torch.core.kron``) against
``repro.core.kron`` on the same seeded numpy inputs, at float32 tolerance,
plus the property tests of ``tests/test_kron.py`` run on the port."""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

from _hypothesis_compat import hypothesis, st
import jax  # noqa: F401  (imported beside torch, as in every port test)

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kron as JK
from repro_torch.core import kron as K


def _pd(rng, n):
    X = rng.standard_normal((n, n)).astype(np.float32)
    return (X @ X.T + n * np.eye(n)).astype(np.float32)


def _both(*arrays):
    """The same float32 arrays as tensors (port) and jax arrays (JAX)."""
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _close(got, want, rtol=2e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_products_match_jax(rng):
    A, B = _pd(rng, 3), _pd(rng, 5)
    X = rng.standard_normal((15, 4)).astype(np.float32)
    Q = rng.standard_normal((15, 15)).astype(np.float32)
    y = rng.standard_normal(15).astype(np.float32)
    (tA, tB, tX, tQ, ty), (jA, jB, jX, jQ, jy) = _both(A, B, X, Q, y)
    _close(K.kron_matmat(tA, tB, tX), JK.kron_matmat(jA, jB, jX))
    _close(K.kron_matmat(tA, tB, tX), np.kron(A, B) @ X)
    _close(K.kron_quad(tA, tB, tQ), JK.kron_quad(jA, jB, jQ), atol=2e-2)
    L = np.kron(A, B).astype(np.float64)
    _close(K.kron_quad(tA, tB, tQ), L @ Q @ L.T, atol=2e-2)
    cA, cB = np.linalg.cholesky(A), np.linalg.cholesky(B)
    (tcA, tcB), (jcA, jcB) = _both(cA, cB)
    x = K.kron_solve(tcA, tcB, ty)
    _close(x, JK.kron_solve(jcA, jcB, jy), rtol=1e-3, atol=1e-5)
    _close(K.kron_matvec(tA, tB, x), y, rtol=1e-3, atol=1e-3)


def test_partial_traces_match_jax(rng):
    M = rng.standard_normal((12, 12)).astype(np.float32)
    (tM,), (jM,) = _both(M)
    for fn in ("partial_trace_1", "partial_trace_2"):
        _close(getattr(K, fn)(tM, 3, 4), getattr(JK, fn)(jM, 3, 4),
               rtol=1e-5, atol=1e-5)
    A, B = _pd(rng, 3), _pd(rng, 4)
    L = torch.from_numpy(np.kron(A, B))
    _close(K.partial_trace_1(L, 3, 4), np.trace(B) * A, rtol=1e-4)
    _close(K.partial_trace_2(L, 3, 4), np.trace(A) * B, rtol=1e-4)


def test_spectra_match_jax(rng):
    A, B = _pd(rng, 4), _pd(rng, 5)
    (tA, tB), (jA, jB) = _both(A, B)
    (d1, P1), (d2, P2) = K.kron_eigh(tA, tB)
    (e1, Q1), (e2, Q2) = JK.kron_eigh(jA, jB)
    _close(d1, e1, rtol=1e-5)
    _close(d2, e2, rtol=1e-5)
    # eigenvectors up to sign: compare the projectors v vᵀ
    for P, Q in ((P1, Q1), (P2, Q2)):
        P, Q = P.numpy(), np.asarray(Q)
        _close(np.einsum("ic,jc->cij", P, P), np.einsum("ic,jc->cij", Q, Q),
               atol=1e-4)
    _close(K.kron_eigvals(d1, d2), JK.kron_eigvals(e1, e2), rtol=1e-5)
    lam = np.sort(K.kron_eigvals(d1, d2).numpy())
    _close(lam, np.linalg.eigvalsh(np.kron(A, B).astype(np.float64)),
           rtol=1e-3, atol=1e-3)
    _close(K.logdet_I_plus_kron(d1, d2), JK.logdet_I_plus_kron(e1, e2),
           rtol=1e-5)
    _close(K.logdet_I_plus_kron(d1, d2),
           np.linalg.slogdet(np.kron(A, B).astype(np.float64)
                             + np.eye(20))[1], rtol=1e-4)
    # an eigenvector of the product, up to sign, for (i, j) = (1, 3)
    v = K.kron_eigvec(P1, P2, 1, 3).numpy()
    w = np.asarray(JK.kron_eigvec(Q1, Q2, 1, 3))
    _close(np.outer(v, v), np.outer(w, w), atol=1e-4)
    _close(np.kron(A, B) @ v, (d1[1] * d2[3]).item() * v, rtol=1e-3,
           atol=1e-3)


def test_index_helpers_match_jax(rng):
    A, B = _pd(rng, 4), _pd(rng, 6)
    idx = np.asarray([0, 3, 7, 11, 23, 17], np.int64)
    (tA, tB), (jA, jB) = _both(A, B)
    r, u = K.split_indices(torch.from_numpy(idx), 6)
    jr, ju = JK.split_indices(jnp.asarray(idx), 6)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    got = K.kron_submatrix(tA, tB, torch.from_numpy(idx))
    _close(got, JK.kron_submatrix(jA, jB, jnp.asarray(idx)), rtol=1e-6)
    _close(got, np.kron(A, B)[np.ix_(idx, idx)], rtol=1e-5)


def test_nearest_kron_factors_match_jax(rng):
    A, B = _pd(rng, 3), _pd(rng, 4)
    (tL,), (jL,) = _both(np.kron(A, B))
    U, s, V = K.nearest_kron_factors(tL, 3, 4, iters=100)
    jU, js, jV = JK.nearest_kron_factors(jL, 3, 4, iters=100)
    _close(s, js, rtol=1e-5)
    _close(U, jU, atol=1e-5)
    _close(V, jV, atol=1e-5)
    _close(s * torch.kron(U, V), np.kron(A, B), rtol=1e-3, atol=1e-3)
    # the power iteration itself, on a non-symmetric R, fixed 7 steps
    R = rng.standard_normal((9, 16)).astype(np.float32)
    (tR,), (jR,) = _both(R)
    for got, want in zip(K.dominant_singular(tR, 7),
                         JK.dominant_singular(jR, 7)):
        _close(got, want, rtol=1e-4, atol=1e-5)


@hypothesis.given(n1=st.integers(2, 5), n2=st.integers(2, 5),
                  seed=st.integers(0, 2 ** 16))
@hypothesis.settings(max_examples=15, deadline=None)
def test_property_kron_structure(n1, n2, seed):
    """Mixed-product + inverse + partial-trace identities hold on the port
    for random PD factors of any compatible size, as in JAX."""
    rng = np.random.default_rng(seed)
    A, B = _pd(rng, n1), _pd(rng, n2)
    L = np.kron(A, B)
    Linv = np.kron(np.linalg.inv(A), np.linalg.inv(B))
    np.testing.assert_allclose(L @ Linv, np.eye(n1 * n2), atol=1e-2)
    tL = torch.from_numpy(L)
    np.testing.assert_allclose(K.partial_trace_1(tL, n1, n2).numpy(),
                               np.trace(B) * A, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(K.partial_trace_2(tL, n1, n2).numpy(),
                               np.asarray(JK.partial_trace_2(jnp.asarray(L),
                                                             n1, n2)),
                               rtol=1e-5, atol=1e-4)


@hypothesis.given(n1=st.integers(2, 4), n2=st.integers(2, 4),
                  seed=st.integers(0, 2 ** 16))
@hypothesis.settings(max_examples=10, deadline=None)
def test_property_vlp_roundtrip(n1, n2, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n1 * n2, n1 * n2)).astype(np.float32)
    R = K.vlp_rearrange(torch.from_numpy(M), n1, n2)
    np.testing.assert_array_equal(
        R.numpy(), np.asarray(JK.vlp_rearrange(jnp.asarray(M), n1, n2)))
    np.testing.assert_array_equal(K.vlp_unrearrange(R, n1, n2).numpy(), M)


@pytest.mark.parametrize("sizes", [(3, 4), (2, 3, 5), (7,)])
def test_split_indices_multi_matches_jax(sizes):
    n = int(np.prod(sizes))
    idx = np.arange(n, dtype=np.int64)
    got = K.split_indices_multi(torch.from_numpy(idx), sizes)
    want = JK.split_indices_multi(jnp.asarray(idx), sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
