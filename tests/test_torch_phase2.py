"""Phase-2 selection of the PyTorch port against the JAX package.

The same phase-1 output — uniforms, factored eigenvector columns and live
step counts, made by the JAX package's own ``_phase1_one`` — goes through
the JAX Pallas kernel (interpret mode), the JAX while_loop reference and
the port's ``phase2_select_plain`` (via ``kernels.ops``). The contract is
identical picks. The only admissible difference is a float32 roundoff tie
on the exact chain: a row whose first differing step drew
``r = us·total`` within 1e-5·total of the boundary between the two picks
(cumsums in different orders), or stopped where the exact residual mass
is already at or below MASS_EPS. Such a row is named in a warning, never
silently accepted.
"""

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

from repro.core import KronDPP, random_krondpp
from repro.kernels import ops as jax_ops
from repro.sampling import SpectralCache
from repro.sampling.batched import (_phase1_one, gather_factor_columns,
                                    phase2_select, sample_krondpp_batched)
from repro_torch.convert import spectrum_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.phase2_select import (THREADS, canonical_pair,
                                               first_difference,
                                               global_smem_bytes,
                                               is_roundoff_tie,
                                               onchip_geometry,
                                               phase2_select_cuda,
                                               phase2_select_plain,
                                               phase2_select_route)
from repro_torch.sampling import batched as tb

def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def assert_same_picks(want, got, us, G1, Gr, label):
    """Rows equal, or each differing row a proven float32 roundoff tie on
    the exact chain (``first_difference``), named in a warning."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    for b in np.nonzero((want != got).any(axis=1))[0]:
        step, kind, value = first_difference(us[b], G1[b], Gr[b], want[b],
                                             got[b])
        assert is_roundoff_tie(kind, value), (
            f"{label}: row {b} differs at step {step}: {want[b]} vs "
            f"{got[b]} ({kind} {value}) — not a roundoff tie")
        warnings.warn(f"{label}: row {b} differs at step {step} on a "
                      f"roundoff tie ({kind} {value})")


def assert_rows_distinct(picks):
    for row in np.asarray(picks):
        real = row[row >= 0].tolist()
        assert len(set(real)) == len(real), row


@pytest.mark.parametrize("sizes", [(12,), (3, 4), (6, 5), (2, 3, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_pallas_and_reference(sizes, seed):
    """m = 1, 2, 3, batch 16: the port's plain version gives the JAX
    package's picks, both its interpret-mode Pallas kernel and its
    while_loop reference."""
    m = random_krondpp(jax.random.PRNGKey(seed), sizes)
    spec = SpectralCache().spectrum(m)
    k_max = spec.suggested_k_max()
    lams, vecs = tuple(spec.lams), tuple(spec.vecs)
    keys = jax.random.split(jax.random.PRNGKey(100 + seed), 16)
    us, Gs, k_eff, _ = jax.jit(jax.vmap(
        lambda k: _phase1_one(k, lams, vecs, k_max)))(keys)
    p_pal = jax_ops.phase2_select(us, Gs, sizes, k_eff, backend="pallas")
    p_ref = jax_ops.phase2_select(us, Gs, sizes, k_eff, backend="reference")
    us_t, ke_t = t(us), t(k_eff, torch.int32)
    Gs_t = tuple(t(G) for G in Gs)
    got = ops.phase2_select(us_t, Gs_t, sizes, ke_t)      # CPU: plain
    assert got.dtype == torch.int32 and got.shape == (16, k_max)
    G1, Gr = canonical_pair(Gs_t)
    assert torch.equal(got, phase2_select_plain(us_t, ke_t, G1, Gr))
    label = f"sizes={sizes} seed={seed}"
    assert_same_picks(p_ref, got.numpy(), us_t, G1, Gr, label + " ref")
    assert_same_picks(p_pal, got.numpy(), us_t, G1, Gr, label + " pallas")
    assert_rows_distinct(got)


def test_degenerate_columns_early_exit_no_duplicates():
    """A duplicated eigen-index makes the span one short of k_eff: the
    chain must stop at the span with a -1 tail, as the JAX reference
    does (``test_phase2_fused.py`` degenerate-columns regression)."""
    m = random_krondpp(jax.random.PRNGKey(8), (3, 4))
    spec = SpectralCache().spectrum(m)
    sel = jnp.asarray([2, 5, 5, 7], jnp.int32)          # span is 3, not 4
    valid = jnp.asarray([True, True, True, True])
    Gs = gather_factor_columns(spec.vecs, (3, 4), sel, valid)
    tspec = spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                                [np.asarray(x) for x in spec.vecs],
                                device="cpu")
    Gs_t = tb.gather_factor_columns(tspec.vecs, (3, 4), t(sel, torch.int32),
                                    t(valid, torch.bool))
    for G, G_t in zip(Gs, Gs_t):
        np.testing.assert_array_equal(np.asarray(G), G_t.numpy())
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(phase2_select(key, Gs, (3, 4),
                                        jnp.asarray(4, jnp.int32),
                                        backend="reference"))
        us = t(jax.random.uniform(key, (4,)))
        picks = ops.phase2_select(us, Gs_t, (3, 4), 4).numpy()
        assert picks.shape == (4,)
        real = picks[picks >= 0]
        assert len(real) <= 3, picks                     # span exhausted
        assert len(set(real.tolist())) == len(real), picks
        assert (picks[len(real):] == -1).all(), picks    # -1 tail
        G1, Gr = canonical_pair(Gs_t)
        assert_same_picks(want[None], picks[None], us[None], G1[None],
                          Gr[None], f"degenerate seed={seed}")


def test_rank_deficient_kron_factor_no_duplicates():
    """Rank-2 L1 ⊗ 5·I4: no subset repeats an item or exceeds rank 8, and
    the port's draws equal the JAX reference's on JAX's uniforms."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 2)).astype(np.float32)
    L1 = jnp.asarray(X @ X.T) * 10.0                    # rank 2 of 6
    L2 = 5.0 * jnp.eye(4, dtype=jnp.float32)
    spec = SpectralCache().spectrum(KronDPP((L1, L2)))
    tspec = spectrum_from_numpy([np.asarray(x) for x in spec.lams],
                                [np.asarray(x) for x in spec.vecs],
                                device="cpu")
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want, _, _ = sample_krondpp_batched(key, spec, 12, 32,
                                            backend="reference")
        k1, k2 = jax.vmap(jax.random.split, out_axes=1)(
            jax.random.split(key, 32))
        u = jax.vmap(lambda k: jax.random.uniform(k, (24,)))(k1)
        us = jax.vmap(lambda k: jax.random.uniform(k, (12,)))(k2)
        picks, counts, _ = tb.sample_krondpp_from_uniforms(
            t(u), t(us), tspec, 12)
        assert_rows_distinct(picks)
        assert int(counts.max()) <= 8                  # rank(L1 ⊗ L2)
        assert int((picks >= 0).sum(1).max()) <= 8
        _, Gs, k_eff, _ = tb._phase1_from_uniforms(t(u), t(us), tspec.lams,
                                                   tspec.vecs, 12)
        G1, Gr = canonical_pair(Gs)
        assert_same_picks(want, picks.numpy(), t(us), G1, Gr,
                          f"rank-deficient seed={seed}")


def test_cuda_backend_refuses_cpu_tensors():
    us = torch.rand((2, 3))
    Gs = (torch.rand((2, 4, 3)), torch.rand((2, 5, 3)))
    k_eff = torch.tensor([3, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.phase2_select(us, Gs, (4, 5), k_eff, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        phase2_select_cuda(us, k_eff, *Gs)
    with pytest.raises(ValueError, match="backend"):
        ops.phase2_select(us, Gs, (4, 5), k_eff, backend="pallas")
    with pytest.raises(ValueError, match="inconsistent"):
        ops.phase2_select(us, Gs, (5, 4), k_eff)


# The opt-in shared memory a block may use on the H100 (227 KB), the limit
# the route tests hand to phase2_select_route.
H100_SMEM_OPTIN = 232_448


@pytest.mark.parametrize("N1,Nr,k,want", [
    (100, 100, 46, (12, 100, 108, 90_872)),    # the main path's shape
    (400, 1, 46, (4, 400, 4, 90_136)),         # m = 1: Gr is a ones column
    (20, 500, 46, (12, 20, 504, 146_136)),     # the m = 3 fold 20 x (20·25)
    (30, 40, 20, (4, 32, 40, 13_104)),
    (1, 1, 1, (4, 4, 4, 496)),
])
def test_onchip_geometry(N1, Nr, k, want):
    """The on-chip layout by hand: tiles of 4 rows of G1 by TN of Gr, TN
    the least of 4, 8, 12, 16 that gives every tile one of the 256
    threads; G1ᵀ, Grᵀ, the padded norms grid, the basis, three k-vectors
    and 32 partials in floats, then 64 ints."""
    tn, n1p, pr, nbytes = onchip_geometry(N1, Nr, k)
    assert (tn, n1p, pr, nbytes) == want
    assert n1p % 4 == 0 and pr % tn == 0
    assert nbytes == 4 * (k * (n1p + pr) + n1p * pr + k * k + 3 * k + 32) \
        + 256
    assert (n1p // 4) * (pr // tn) <= THREADS


@pytest.mark.parametrize("N1,Nr,k,want", [
    (100, 100, 46, "on_chip"), (400, 1, 46, "on_chip"),
    (20, 500, 46, "on_chip"), (300, 300, 46, "global"),
    (100, 100, 224, "global"), (400, 1, 224, "global"),
    (100, 100, 238, "global"), (100, 100, 239, "global_basis"),
    (32, 32, 333, "global_basis"), (1024, 1, 333, "global_basis"),
])
def test_route_at_the_h100_limit(N1, Nr, k, want):
    """The main path's 100 x 100 at k_max 46 and the m = 1 and m = 3 edges
    fit a block; 300 x 300 (its norms alone 360 KB) and k = 224 do not;
    past k = 238 neither does the global route's basis (the KronDPP batch
    selector's 1024 documents draw k_max 333)."""
    assert phase2_select_route(N1, Nr, k, limit=H100_SMEM_OPTIN) == want
    if want != "on_chip":
        basis_fits = global_smem_bytes(k) <= H100_SMEM_OPTIN
        assert basis_fits == (want == "global")
        assert global_smem_bytes(k, basis_in_smem=False) < 8 * 1024


@pytest.mark.parametrize("N1,Nr,k", [(100, 100, 46), (400, 1, 46),
                                     (20, 500, 46), (100, 100, 224)])
def test_route_switches_at_the_limit(N1, Nr, k):
    """On-chip up to exactly its byte count, global one byte below it; and
    along N1 at Nr = 1 the route turns global once and stays so."""
    nbytes = onchip_geometry(N1, Nr, k)[3]
    assert phase2_select_route(N1, Nr, k, limit=nbytes) == "on_chip"
    assert phase2_select_route(N1, Nr, k, limit=nbytes - 1) == "global"
    routes = [phase2_select_route(n, 1, k, limit=H100_SMEM_OPTIN)
              for n in range(1, 4000, 37)]
    assert routes == sorted(routes, reverse=True)     # on_chip..., global...


# one shape of each route: the on-chip route's small shape, 300 x 300
# (N = 9·10^4), whose norms alone pass the H100's 227 KB a block, and the
# batch selector's 32 x 32 at E|Y| = 250, whose k x k basis passes it
ON_CARD = {"on_chip": ((30, 40), 64, 10.0), "global": ((300, 300), 8, 10.0),
           "global_basis": ((32, 32), 16, 250.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ON_CARD))
def test_kernel_matches_plain_on_card(route):
    """On a card: the Hopper kernel against the plain version on the same
    inputs (rows equal or proven boundary ties), on each route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from repro_torch import dpp
    sizes, B, size = ON_CARD[route]
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = dpp.random_kron(gen, sizes).rescale(size)
    spec = model.spectrum()
    k_max = spec.suggested_k_max()
    assert phase2_select_route(*sizes, k_max) == route
    u = torch.rand((B, spec.N), generator=gen, device="cuda")
    us = torch.rand((B, k_max), generator=gen, device="cuda")
    us, Gs, k_eff, _ = tb._phase1_from_uniforms(u, us, spec.lams, spec.vecs,
                                                k_max)
    G1, Gr = (G.contiguous() for G in canonical_pair(Gs))
    got = phase2_select_cuda(us, k_eff, G1, Gr)
    want = phase2_select_plain(us, k_eff, G1, Gr)
    assert_rows_distinct(got.cpu())
    assert_same_picks(want.cpu().numpy(), got.cpu().numpy(), us, G1, Gr,
                      "cuda kernel")
