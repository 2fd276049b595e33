"""The Kronecker matvec and the explicit eigenvector assembly of the
PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel (interpret mode, ``force_pallas=True``), the JAX einsum oracle
``ref.kron_matvec_ref`` and the port's plain version (through
``kernels.ops``), at the shapes and tolerances of
``tests/test_kernels.py::test_kron_matvec_kernel``: rtol = atol = 2e-4 in
float32 (sums of N1 or N2 terms in other orders) and 3e-2 in bfloat16
(one bfloat16 rounding of the output, 2^-8 relative). bfloat16 inputs are
the JAX arrays' values, carried across through float32.

Eigenvectors come from one JAX spectrum carried across with
``convert.spectrum_from_numpy``, so both packages assemble the same
columns (eigh sign choices differ between libraries).
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

from repro.core import random_krondpp
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.sampling import SpectralCache
from repro.sampling.batched import assemble_eigvecs as jax_assemble
import repro_torch.obs as obs
from repro_torch.convert import spectrum_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.kron_matvec import (kron_matvec_cuda,
                                             kron_matvec_plain)
from repro_torch.kernels.phase2_select import canonical_pair
from repro_torch.sampling.batched import (assemble_eigvecs,
                                          gather_factor_columns,
                                          split_mixed_radix)

SHAPES = [(3, 4, 2), (8, 8, 5), (16, 12, 3), (128, 128, 4), (64, 96, 7)]
# Inputs with all-zero rows of mat(X[b]), whose rows the kernel skips: a
# one-hot batch (the eigenvector path's), some zero rows, an all-zero X[b];
# and the degenerate factor sizes N1 = 1 and N2 = 1.
SPARSE = [(8, 8, 5, "onehot"), (16, 12, 3, "onehot"), (16, 12, 3, "zero_rows"),
          (64, 96, 7, "zero_rows"), (8, 8, 5, "zero_entry"),
          (1, 7, 3, "dense"), (6, 1, 4, "dense"), (1, 1, 2, "dense"),
          (1, 7, 3, "onehot")]
CASES = ([pytest.param(*s, "dense", id="-".join(map(str, s))) for s in SHAPES]
         + [pytest.param(*s, id="-".join(map(str, s))) for s in SPARSE])
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def np_inputs(n1, n2, batch, pattern, seed):
    """A (n1, n1), B (n2, n2) and X (batch, n1·n2) in float64, from a seed.
    ``pattern``: "dense"; "onehot" (one 1 per X[b]); "zero_rows" (about
    half the rows of each mat(X[b]) zero); "zero_entry" (X[1] all zero)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n1, n1))
    B = rng.standard_normal((n2, n2))
    X = rng.standard_normal((batch, n1, n2))
    if pattern == "onehot":
        X = np.zeros_like(X).reshape(batch, n1 * n2)
        X[np.arange(batch), rng.integers(0, n1 * n2, batch)] = 1.0
    elif pattern == "zero_rows":
        X[rng.random((batch, n1)) < 0.5] = 0.0
    elif pattern == "zero_entry":
        X[1] = 0.0
    else:
        assert pattern == "dense", pattern
    return A, B, X.reshape(batch, n1 * n2)


def jax_inputs(n1, n2, batch, dtype, seed, pattern="dense"):
    return tuple(jnp.asarray(x, dtype)
                 for x in np_inputs(n1, n2, batch, pattern, seed))


def to_torch(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(TORCH[x.dtype.type])


@pytest.mark.parametrize("n1,n2,batch,pattern", CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_pallas_and_oracle(n1, n2, batch, pattern, dtype):
    A, B, X = jax_inputs(n1, n2, batch, dtype, seed=n1 * n2 + batch,
                         pattern=pattern)
    want_pl = jax_ops.kron_matvec(A, B, X, force_pallas=True)
    want_rf = jax_ref.kron_matvec_ref(A, B, X)
    got = ops.kron_matvec(to_torch(A), to_torch(B), to_torch(X))
    assert got.dtype == TORCH[dtype] and got.shape == (batch, n1 * n2)
    tol = 2e-4 if dtype == jnp.float32 else 3e-2
    for want in (want_pl, want_rf):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    if pattern == "zero_entry":
        assert (got[1] == 0).all()


def nonfinite_inputs(n1, n2, batch, pattern, kind, seed):
    """``np_inputs`` with a NaN in A (``kind`` "nan_A") or an Inf in B
    ("inf_B"); the patterns give mat(X[b]) zero rows, which the kernel
    skips unless A or B holds such a value."""
    A, B, X = np_inputs(n1, n2, batch, pattern, seed)
    if kind == "nan_A":
        A[n1 // 2, (n1 - 1) // 3] = np.nan
    else:
        assert kind == "inf_B", kind
        B[n2 // 3, n2 // 2] = np.inf
    return A, B, X


def assert_same_nonfinite(got, want, tol):
    """NaN exactly where ``want`` has NaN, the same infinities, and the
    finite entries within rtol = atol = ``tol``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


NONFINITE = [(8, 8, 5), (16, 12, 3), (64, 96, 7)]


@pytest.mark.parametrize("n1,n2,batch", NONFINITE)
@pytest.mark.parametrize("pattern", ["onehot", "zero_rows"])
@pytest.mark.parametrize("kind", ["nan_A", "inf_B"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_spreads_nonfinite_as_jax_pallas(n1, n2, batch, pattern, kind,
                                               dtype):
    """A NaN in A or an Inf in B, with zero rows in mat(X[b]): the plain
    version's NaN, its infinities and its finite entries are the JAX
    Pallas kernel's (both take T = mat(X[b])·Bᵀ first; the oracle's
    einsum may contract in the other order and put the NaN elsewhere)."""
    A, B, X = (jnp.asarray(x, dtype) for x in
               nonfinite_inputs(n1, n2, batch, pattern, kind, seed=n1 + n2))
    want = jax_ops.kron_matvec(A, B, X, force_pallas=True)
    got = ops.kron_matvec(to_torch(A), to_torch(B), to_torch(X))
    assert np.isnan(np.asarray(want, np.float32)).any()
    assert_same_nonfinite(got.float().numpy(), want,
                          2e-4 if dtype == jnp.float32 else 3e-2)


def test_plain_is_the_kronecker_product():
    """The two products against an explicit Kronecker product in
    float64 (a transposed index would show). The plain version computes
    in float32, hence rtol = atol = 1e-5."""
    rng = np.random.default_rng(3)
    A, B = rng.standard_normal((3, 3)), rng.standard_normal((5, 5))
    X = rng.standard_normal((4, 15))
    got = kron_matvec_plain(*(torch.from_numpy(a) for a in (A, B, X)))
    assert got.dtype == torch.float64      # output in X's dtype
    np.testing.assert_allclose(got.numpy(), X @ np.kron(A, B).T, rtol=1e-5,
                               atol=1e-5)


def test_dispatch_counters_and_backend_choices():
    """Mirror of tests/test_obs.py::test_kernels_ops_dispatch_counters."""
    A = torch.eye(3)
    B = torch.eye(2)
    X = torch.ones((1, 6))
    with obs.use(obs.InMemoryTracker()) as t:
        ops.kron_matvec(A, B, X)
    assert t.counter_value("kernels.kron_matvec.reference") == 1
    assert t.counter_value("kernels.kron_matvec.cuda") == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.kron_matvec(A, B, X, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.kron_matvec(A, B, X, backend="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kron_matvec_cuda(torch.eye(3), torch.eye(2), torch.ones((1, 6)))
    assert kron_matvec_cuda.launches == 0


@pytest.fixture(scope="module")
def spec34():
    """The JAX spectrum of a (3, 4) KronDPP and its carried copy."""
    spec = SpectralCache().spectrum(random_krondpp(jax.random.PRNGKey(8),
                                                   (3, 4)))
    tspec = spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                                [np.asarray(x) for x in spec.vecs],
                                device="cpu")
    return spec, tspec


@pytest.mark.parametrize("route", ["gather", "matvec"])
def test_kron_eigvec_batch_matches_jax(spec34, route):
    """The CPU gather route (no ``backend``) and the one-hot matvec route
    (``backend="reference"``, the kernel's plain version) against the JAX
    package's two routes."""
    spec, tspec = spec34
    i = np.asarray([0, 2, 1, 2], np.int32)
    j = np.asarray([3, 0, 1, 1], np.int32)
    want = np.asarray(jax_ops.kron_eigvec_batch(
        *spec.vecs, jnp.asarray(i), jnp.asarray(j),
        force_pallas=route == "matvec"))
    backend = "reference" if route == "matvec" else None
    with obs.use(obs.InMemoryTracker()) as t:
        got = ops.kron_eigvec_batch(*tspec.vecs, torch.from_numpy(i),
                                    torch.from_numpy(j), backend=backend)
    assert got.shape == (12, 4)
    assert t.counter_value("kernels.kron_matvec.reference") == \
        (1 if route == "matvec" else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sizes,seed", [((3, 4), 8), ((2, 3, 2), 9),
                                        ((7,), 10)])
def test_assemble_eigvecs_matches_jax(sizes, seed):
    """m = 2 (through kron_eigvec_batch), m = 3 and m = 1 (outer-product
    fold); an invalid slot is a zero column."""
    spec = SpectralCache().spectrum(random_krondpp(jax.random.PRNGKey(seed),
                                                   sizes))
    tspec = spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                                [np.asarray(x) for x in spec.vecs],
                                device="cpu")
    N = spec.N
    sel = np.asarray([0, N - 1, 5 % N, 3 % N], np.int32)
    valid = np.asarray([True, True, True, False])
    want = np.asarray(jax_assemble(spec.vecs, sizes, jnp.asarray(sel),
                                   jnp.asarray(valid)))
    got = assemble_eigvecs(tspec.vecs, sizes, torch.from_numpy(sel),
                           torch.from_numpy(valid))
    assert got.shape == (N, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert (got[:, 3] == 0).all()
    V = got[:, :3].double()
    np.testing.assert_allclose((V.T @ V).numpy(), np.eye(3), atol=1e-5)
    for part, want_p in zip(split_mixed_radix(torch.from_numpy(sel), sizes),
                            np.unravel_index(sel, sizes)):
        np.testing.assert_array_equal(part.numpy(), want_p)


def test_factored_columns_match_materialized_eigvecs(spec34):
    """Mirror of tests/test_sampling_batched.py: phase 2 runs on factored
    columns, which must reproduce the materialized eigenvectors — the
    colspace product V q is G1 diag(q) Grᵀ flattened and a row of V is the
    product of the factor rows."""
    _, tspec = spec34
    sizes = (3, 4)
    sel = torch.tensor([0, 5, 11, 7], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False])
    V = assemble_eigvecs(tspec.vecs, sizes, sel, valid)
    G1, Gr = canonical_pair(gather_factor_columns(tspec.vecs, sizes, sel,
                                                  valid))
    q = torch.tensor([0.3, -1.2, 0.5, 2.0])
    torch.testing.assert_close(((G1 * q) @ Gr.T).reshape(-1), V @ q,
                               rtol=1e-5, atol=1e-6)
    for i in (0, 7, 11):
        torch.testing.assert_close(G1[i // 4] * Gr[i % 4], V[i], rtol=1e-5,
                                   atol=1e-6)


# Cases on the card past SPARSE: a ragged tile, and shapes near and past
# the one-launch route's shared-memory limit (N1 = N2 up to 153 in float32,
# 200 in bfloat16, on the H100), with the dtypes whose route is two passes.
ON_CARD = [(1, 1, 1, "dense"), (3, 4, 2, "dense"), (64, 96, 7, "dense"),
           (130, 70, 3, "dense"), (300, 8, 3, "dense"),
           (150, 150, 4, "dense"), (160, 160, 4, "dense"),
           (256, 256, 4, "dense"), (256, 256, 4, "zero_rows"), *SPARSE]
TWO_PASS = {(300, 8): (torch.float32, torch.bfloat16),
            (160, 160): (torch.float32,),
            (256, 256): (torch.float32, torch.bfloat16)}
# Past 10^4 products per output the float32 comparison's atol is 2e-4 of
# max |Y|: two association orders of an N1·N2-term float32 sum differ by
# roundoff that grows with the sum (at 256 x 256, outputs of std 256 differ
# by up to 4e-4), which a fixed atol of 2e-4 does not hold near Y = 0.
LONG_SUM = 10_000


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(spec34):
    """On a card: the kernel against the plain version at ragged shapes,
    at the sparse inputs above and on both routes, in float32 (rtol = atol
    = 2e-4, the atol scaled by max |Y| past LONG_SUM) and bfloat16 (3e-2),
    one counted launch a call and each case's route asserted. The
    eigenvector assembly through the kernel against the gather route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from repro_torch.kernels.kron_matvec import kron_matvec_route
    for n1, n2, batch, pattern in ON_CARD:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            A, B, X = (torch.from_numpy(x).float().to("cuda", dtype)
                       for x in np_inputs(n1, n2, batch, pattern,
                                          seed=n1 + n2))
            route = kron_matvec_route(A, B, X)
            assert route == ("two_pass" if dtype in TWO_PASS.get((n1, n2), ())
                             else "one_launch"), (n1, n2, dtype, route)
            n0 = kron_matvec_cuda.launches
            got = kron_matvec_cuda(A, B, X)
            torch.cuda.synchronize()
            assert kron_matvec_cuda.launches == n0 + 1
            want = kron_matvec_plain(A, B, X).float()
            atol = tol
            if dtype == torch.float32 and n1 * n2 > LONG_SUM:
                atol = tol * float(want.abs().max())
            torch.testing.assert_close(got.float(), want, rtol=tol,
                                       atol=atol)
    _, tspec = spec34
    vecs = [v.cuda() for v in tspec.vecs]
    i = torch.tensor([0, 2, 1, 2], device="cuda")
    j = torch.tensor([3, 0, 1, 1], device="cuda")
    got = ops.kron_eigvec_batch(*vecs, i, j)
    want = (vecs[0][:, i][:, None, :] * vecs[1][:, j][None, :, :]).reshape(
        12, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)


# A NaN in A or an Inf in B with zero rows of mat(X[b]), on both routes:
# 100 x 100 (one launch; the eigenvector path's one-hot batch) and 256 x 256
# (two passes).
NONFINITE_ON_CARD = [(100, 100, 46, "onehot"), (100, 100, 8, "zero_rows"),
                     (256, 256, 4, "onehot"), (256, 256, 4, "zero_rows")]


@pytest.mark.cuda
def test_kernel_spreads_nonfinite_on_card():
    """On a card: where A holds a NaN or B an Inf and mat(X[b]) has zero
    rows, the kernel's NaN are the plain version's exactly, on both routes
    and in both dtypes; the finite entries within the tolerances of
    ``test_kernel_matches_plain_on_card``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from repro_torch.kernels.kron_matvec import kron_matvec_route
    routes = set()
    for n1, n2, batch, pattern in NONFINITE_ON_CARD:
        for kind in ("nan_A", "inf_B"):
            for dtype, tol in ((torch.float32, 2e-4),
                               (torch.bfloat16, 3e-2)):
                A, B, X = (torch.from_numpy(x).float().to("cuda", dtype)
                           for x in nonfinite_inputs(n1, n2, batch, pattern,
                                                     kind, seed=n1 + n2))
                routes.add(kron_matvec_route(A, B, X))
                got = kron_matvec_cuda(A, B, X).float()
                want = kron_matvec_plain(A, B, X).float()
                torch.cuda.synchronize()
                assert bool(torch.isnan(want).any())
                atol = tol
                if dtype == torch.float32 and n1 * n2 > LONG_SUM:
                    atol = tol * float(want[torch.isfinite(want)].abs().max())
                assert torch.equal(torch.isnan(got), torch.isnan(want))
                fin = torch.isfinite(want)
                assert torch.equal(got[~fin & ~torch.isnan(want)],
                                   want[~fin & ~torch.isnan(want)])
                torch.testing.assert_close(got[fin], want[fin], rtol=tol,
                                           atol=atol)
    assert routes == {"one_launch", "two_pass"}
