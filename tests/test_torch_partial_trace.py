"""The partial traces of the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernels (interpret mode, ``force_pallas=True``), the JAX einsum oracles of
``repro/kernels/ref.py``, and the port's plain versions (through
``kernels.ops``). Inputs are non-symmetric, as in
``tests/test_kernels.py``. Tolerance rtol = atol = 2e-4, that file's: the
contractions sum N2² or N1² float32 terms in different orders.
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

from repro.core import SubsetBatch as JaxSubsetBatch
from repro.core import random_krondpp as jax_random_krondpp
from repro.core.krk_picard import AC_from_dense_theta as jax_AC_dense
from repro.core.krk_picard import theta_matrix_kron as jax_theta_kron
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
import repro_torch.obs as obs
from repro_torch.convert import subset_batch_from_numpy
from repro_torch.core.krk_picard import AC_from_dense_theta, theta_matrix_kron
from repro_torch.kernels import ops
from repro_torch.kernels.partial_trace import (partial_trace_A_cuda,
                                               partial_trace_A_plain,
                                               partial_trace_C_cuda,
                                               partial_trace_C_plain)

TOL = dict(rtol=2e-4, atol=2e-4)


def inputs(n1, n2, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((n1 * n2, n1 * n2)).astype(np.float32)
    L1 = rng.standard_normal((n1, n1)).astype(np.float32)
    L2 = rng.standard_normal((n2, n2)).astype(np.float32)
    return theta, L1, L2


@pytest.mark.parametrize("n1,n2", [(4, 4), (4, 8), (8, 4), (3, 5)])
def test_plain_matches_jax_pallas_and_oracle(n1, n2):
    theta, L1, L2 = inputs(n1, n2)
    t4 = jnp.asarray(theta).reshape(n1, n2, n1, n2)
    A_pl = np.asarray(jax_ops.partial_trace_A(jnp.asarray(theta),
                                              jnp.asarray(L2), n1, n2,
                                              force_pallas=True))
    C_pl = np.asarray(jax_ops.partial_trace_C(jnp.asarray(theta),
                                              jnp.asarray(L1), n1, n2,
                                              force_pallas=True))
    A_ref = np.asarray(jax_ref.partial_trace_A_ref(t4, jnp.asarray(L2)))
    C_ref = np.asarray(jax_ref.partial_trace_C_ref(t4, jnp.asarray(L1)))
    A = ops.partial_trace_A(torch.from_numpy(theta), torch.from_numpy(L2),
                            n1, n2)
    C = ops.partial_trace_C(torch.from_numpy(theta), torch.from_numpy(L1),
                            n1, n2)
    assert A.shape == (n1, n1) and C.shape == (n2, n2)
    np.testing.assert_allclose(A.numpy(), A_pl, **TOL)
    np.testing.assert_allclose(A.numpy(), A_ref, **TOL)
    np.testing.assert_allclose(C.numpy(), C_pl, **TOL)
    np.testing.assert_allclose(C.numpy(), C_ref, **TOL)


def test_plain_versions_match_the_formulas_in_float64():
    """The einsum index strings against explicit loops, non-symmetric
    L1 and L2 (a transposed index would show)."""
    n1, n2 = 3, 4
    theta, L1, L2 = inputs(n1, n2, seed=1)
    t4 = theta.astype(np.float64).reshape(n1, n2, n1, n2)
    A = np.zeros((n1, n1))
    C = np.zeros((n2, n2))
    for k in range(n1):
        for l in range(n1):
            A[k, l] = sum(t4[k, u, l, v] * L2[v, u]
                          for u in range(n2) for v in range(n2))
    for u in range(n2):
        for v in range(n2):
            C[u, v] = sum(L1[i, j] * t4[i, u, j, v]
                          for i in range(n1) for j in range(n1))
    T4 = torch.from_numpy(t4)
    np.testing.assert_allclose(
        partial_trace_A_plain(T4, torch.from_numpy(L2).double()).numpy(), A,
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        partial_trace_C_plain(T4, torch.from_numpy(L1).double()).numpy(), C,
        rtol=1e-12, atol=1e-12)


def test_dispatch_counters_and_backend_choices():
    theta, L1, L2 = (torch.from_numpy(x) for x in inputs(3, 5))
    with obs.use(obs.InMemoryTracker()) as t:
        ops.partial_trace_A(theta, L2, 3, 5)
        ops.partial_trace_C(theta, L1, 3, 5, backend="reference")
        ops.partial_trace_C(theta, L1, 3, 5)
    assert t.counter_value("kernels.partial_trace_A.reference") == 1
    assert t.counter_value("kernels.partial_trace_C.reference") == 2
    assert t.counter_value("kernels.partial_trace_A.cuda") == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.partial_trace_A(theta, L2, 3, 5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.partial_trace_C(theta, L1, 3, 5, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.partial_trace_A(theta, L2, 3, 5, backend="pallas")


def test_cuda_wrappers_refuse_cpu_tensors():
    theta, L1, L2 = (torch.from_numpy(x) for x in inputs(3, 5))
    t4 = theta.reshape(3, 5, 3, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        partial_trace_A_cuda(t4, L2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        partial_trace_C_cuda(t4, L1)
    assert partial_trace_A_cuda.launches == 0
    assert partial_trace_C_cuda.launches == 0


@pytest.fixture(scope="module")
def small_kron():
    """Mirror of tests/test_kernels.py::test_krk_with_pallas_partial_trace:
    a (4, 4) KronDPP and three subsets, k_max 4."""
    m = jax_random_krondpp(jax.random.PRNGKey(0), (4, 4))
    jb = JaxSubsetBatch.from_lists([[0, 3, 7], [2, 9], [5, 11, 14]],
                                   k_max=4)
    L1, L2 = (np.array(f) for f in m.factors)
    tb = subset_batch_from_numpy(np.asarray(jb.indices), np.asarray(jb.mask),
                                 device="cpu")
    return m, jb, L1, L2, tb


def test_theta_matrix_kron_matches_jax(small_kron):
    """The single-buffer scatter gives the JAX per-subset dense mean."""
    m, jb, L1, L2, tb = small_kron
    want = np.asarray(jax_theta_kron(*m.factors, jb))
    got = theta_matrix_kron(torch.from_numpy(L1), torch.from_numpy(L2), tb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_krk_with_partial_trace_matches_jax_pallas(small_kron):
    """End to end: the port's dense-route A/C (its Θ, its plain partial
    traces) equal the JAX package's Θ through its Pallas kernels."""
    m, jb, L1, L2, tb = small_kron
    theta_j = jax_theta_kron(*m.factors, jb)
    A_pl = jax_ops.partial_trace_A(theta_j, m.factors[1], 4, 4,
                                   force_pallas=True)
    C_pl = jax_ops.partial_trace_C(theta_j, m.factors[0], 4, 4,
                                   force_pallas=True)
    A_ein, C_ein = jax_AC_dense(theta_j, *m.factors)
    t1, t2 = torch.from_numpy(L1), torch.from_numpy(L2)
    A, C = AC_from_dense_theta(theta_matrix_kron(t1, t2, tb), t1, t2)
    for got, want in ((A, A_pl), (A, A_ein), (C, C_pl), (C, C_ein)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On a card: both kernels against the plain versions, at even and
    odd shapes, on non-symmetric inputs. Tolerance elementwise:
    1e-4 · (the same contraction over |Θ| and |L|) + 1e-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    for n1, n2 in ((4, 4), (7, 13), (64, 30), (33, 65)):
        theta, L1, L2 = (torch.from_numpy(x).cuda()
                         for x in inputs(n1, n2, seed=n1 + n2))
        t4 = theta.reshape(n1, n2, n1, n2)
        a0 = partial_trace_A_cuda.launches
        c0 = partial_trace_C_cuda.launches
        A = partial_trace_A_cuda(t4, L2)
        C = partial_trace_C_cuda(t4, L1)
        torch.cuda.synchronize()
        assert partial_trace_A_cuda.launches == a0 + 1
        assert partial_trace_C_cuda.launches == c0 + 1
        tol_A = 1e-4 * partial_trace_A_plain(t4.abs(), L2.abs()) + 1e-7
        tol_C = 1e-4 * partial_trace_C_plain(t4.abs(), L1.abs()) + 1e-7
        assert ((A - partial_trace_A_plain(t4, L2)).abs() <= tol_A).all()
        assert ((C - partial_trace_C_plain(t4, L1)).abs() <= tol_C).all()
