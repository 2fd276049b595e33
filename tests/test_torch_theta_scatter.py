"""The dense Θ of the PyTorch port (``kernels.ops.theta_scatter``) against
the JAX package and against the accumulating ``index_put_`` it replaced.

Batches are made with numpy from a seed, with heavy padding (k_max well
above |Y|) and padded slots holding 0, N - 1 or a real item's index. On the
CPU ``ops.theta_scatter`` is ``theta_scatter_plain``; its Θ is held bit for
bit against the scatter that ``core.dpp.scatter_theta`` ran before the
kernel, and to rtol 1e-4 / atol 1e-5 against the JAX package's
``theta_matrix_kron`` (a mean of n dense matrices, float32 sums in another
order). Bitwise comparisons stay below n·k² = 32768 pairs: past PyTorch's
grain the CPU's float32 ``index_put_`` adds with atomics in a varying
order. The card's kernel is held bit for bit against the plain version on
a CPU copy in one thread (``index_put_`` in (s, a, b) order) in the one
``cuda``-marked test.
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
from repro.core.krk_picard import theta_matrix_kron as jax_theta_kron
import repro_torch.obs as obs
from repro_torch.convert import subset_batch_from_numpy
from repro_torch.core.dpp import (identity_padded, masked_inv_and_logdet,
                                  scatter_theta)
from repro_torch.core.krk_picard import _subset_blocks, theta_matrix_kron
from repro_torch.kernels import ops
from repro_torch.kernels.theta_scatter import (theta_scatter_cuda,
                                               theta_scatter_plain)


def index_put_theta(N, idx, mask, inv):
    """``core.dpp.scatter_theta`` before the kernel: every slot pair into
    one buffer with ``index_put_(accumulate=True)``, divided by n."""
    n = idx.shape[0]
    idx = idx.long()
    vals = inv * (mask[:, :, None] & mask[:, None, :])
    theta = torch.zeros((N, N), dtype=inv.dtype, device=inv.device)
    theta.index_put_((idx[:, :, None], idx[:, None, :]), vals,
                     accumulate=True)
    return theta / n


def padded_batch(N, n, k_max, max_size, pad, seed, shared=None):
    """n subsets of 1..max_size distinct items of range(N), padded to k_max;
    padded slots hold ``pad``: an int, "last" (N - 1) or "real" (an item
    of the same subset). With ``shared``, every subset's first item."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((n, k_max), np.int32)
    mask = np.zeros((n, k_max), bool)
    pool = np.array([i for i in range(N) if i != shared])
    for s in range(n):
        size = int(rng.integers(1, max_size + 1))
        items = rng.choice(pool, size, replace=False)
        if shared is not None:
            items[0] = shared
        idx[s, :size] = items
        mask[s, :size] = True
        if pad == "last":
            idx[s, size:] = N - 1
        elif pad == "real":
            idx[s, size:] = rng.choice(items, k_max - size)
        else:
            idx[s, size:] = pad
    return idx, mask


def kron_inputs(sizes, idx, mask, seed=0):
    """JAX factors (paper init) and the port's subset inverses of them."""
    m = jax_random_krondpp(jax.random.PRNGKey(seed), sizes)
    L1, L2 = (torch.from_numpy(np.array(f)) for f in m.factors)
    tb = subset_batch_from_numpy(idx, mask, device="cpu")
    _, _, B1, B2 = _subset_blocks(L1, L2, tb)
    inv, _ = masked_inv_and_logdet(identity_padded(B1 * B2, tb.mask))
    return m, L1, L2, tb, inv


def serial_plain(N, idx, mask, inv):
    """``theta_scatter_plain`` on CPU copies in one thread, where
    ``index_put_`` adds in (s, a, b) order at any size."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return theta_scatter_plain(N, idx.cpu(), mask.cpu(), inv.cpu())
    finally:
        torch.set_num_threads(threads)


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32 if a.dtype == torch.float32 else torch.int64),
        b.view(torch.int32 if b.dtype == torch.float32 else torch.int64))


CASES = [  # (N1, N2), n, k_max, max |Y|, padded index
    ((3, 4), 6, 8, 3, 0),
    ((3, 4), 6, 8, 3, "last"),
    ((3, 4), 6, 8, 3, "real"),
    ((5, 5), 9, 12, 4, 0),
    ((5, 5), 9, 12, 4, "real"),
    ((2, 3), 5, 10, 2, "last"),
    ((4, 6), 4, 40, 5, 0),
]


@pytest.mark.parametrize("sizes,n,k_max,max_size,pad", CASES)
def test_plain_matches_index_put_and_jax(sizes, n, k_max, max_size, pad):
    N = sizes[0] * sizes[1]
    idx, mask = padded_batch(N, n, k_max, max_size, pad, seed=n + k_max)
    m, L1, L2, tb, inv = kron_inputs(sizes, idx, mask)
    got = ops.theta_scatter(N, tb.indices, tb.mask, inv)
    assert same_bits(got, theta_scatter_plain(N, tb.indices, tb.mask, inv))
    assert same_bits(got, index_put_theta(N, tb.indices, tb.mask, inv))
    assert same_bits(got, scatter_theta(N, tb.indices, tb.mask, inv))
    assert same_bits(got, theta_matrix_kron(L1, L2, tb))
    want = np.asarray(jax_theta_kron(*m.factors, JaxSubsetBatch(
        jnp.asarray(idx), jnp.asarray(mask))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pad", [0, "last", "real", 7])
def test_a_masked_slot_changes_nothing(pad):
    """Items shared across subsets, padded slots pointing anywhere: Θ is
    the one of the same batch with every padded slot at index 0."""
    N, n, k_max = 12, 8, 9
    idx, mask = padded_batch(N, n, k_max, 4, pad, seed=3, shared=5)
    idx0 = np.where(mask, idx, 0)
    rng = np.random.default_rng(4)
    inv = torch.from_numpy(rng.standard_normal((n, k_max, k_max))
                           .astype(np.float32))
    want = theta_scatter_plain(N, torch.from_numpy(idx0),
                               torch.from_numpy(mask), inv)
    got = ops.theta_scatter(N, torch.from_numpy(idx), torch.from_numpy(mask),
                            inv)
    assert same_bits(got, want)
    assert (got[5, 5] != 0) and got[5].count_nonzero() > 1


def test_sum_matches_an_explicit_loop_in_float64():
    """Θ[i, j] = (1/n) Σ inv[s, a, b] over real (s, a, b) with idx[s, a]
    = i and idx[s, b] = j: the explicit loop, in the same order."""
    N, n, k_max = 10, 7, 6
    idx, mask = padded_batch(N, n, k_max, 4, "real", seed=5)
    inv = np.random.default_rng(6).standard_normal((n, k_max, k_max))
    want = np.zeros((N, N))
    for s in range(n):
        for a in range(k_max):
            for b in range(k_max):
                if mask[s, a] and mask[s, b]:
                    want[idx[s, a], idx[s, b]] += inv[s, a, b]
    got = ops.theta_scatter(N, torch.from_numpy(idx), torch.from_numpy(mask),
                            torch.from_numpy(inv))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want / n)


def test_all_padded_batch_gives_zeros():
    N, n, k_max = 9, 4, 5
    idx = torch.from_numpy(np.random.default_rng(7).integers(
        0, N, (n, k_max)).astype(np.int32))
    mask = torch.zeros((n, k_max), dtype=torch.bool)
    inv = torch.randn((n, k_max, k_max), generator=torch.Generator()
                      .manual_seed(8))
    got = ops.theta_scatter(N, idx, mask, inv)
    assert got.shape == (N, N) and got.dtype == torch.float32
    assert not got.count_nonzero() and not torch.signbit(got).any()


def test_dispatch_counter_and_backend_choices():
    """One ``kernels.theta_scatter.<engine>`` count a Θ build; "cuda" on
    CPU tensors and an unknown backend raise; nothing launches here."""
    idx, mask = padded_batch(12, 5, 6, 3, 0, seed=9)
    _, L1, L2, tb, inv = kron_inputs((3, 4), idx, mask)
    launches = theta_scatter_cuda.launches
    with obs.use(obs.InMemoryTracker()) as t:
        theta_matrix_kron(L1, L2, tb)
        ops.theta_scatter(12, tb.indices, tb.mask, inv, backend="reference")
    assert t.counter_value("kernels.theta_scatter.reference") == 2
    assert t.counter_value("kernels.theta_scatter.cuda") == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.theta_scatter(12, tb.indices, tb.mask, inv, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.theta_scatter(12, tb.indices, tb.mask, inv, backend="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        theta_scatter_cuda(12, tb.indices, tb.mask, inv)
    assert theta_scatter_cuda.launches == launches


@pytest.mark.parametrize("kind", ["meta", "fake"])
def test_cuda_wrapper_raises_on_tensors_without_storage(kind):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()

    def make(shape, dt):
        if kind == "meta":
            return torch.empty(shape, dtype=dt, device="meta")
        with fake:
            return torch.empty(shape, dtype=dt)
    with pytest.raises(ValueError, match=f"{kind} tensor"):
        theta_scatter_cuda(6, make((2, 3), torch.int32),
                           make((2, 3), torch.bool),
                           make((2, 3, 3), torch.float32))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On a card: the kernel against the plain version in one CPU thread on
    the same inputs, bit for bit (finite inverses), at shapes past a warp's
    32 columns and a row slice's 1024 entries, with repeated items, an
    all-padded batch, an empty one and float64; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(10)
    for N, n, k_max, max_size, pad, dtype in (
            (12, 6, 8, 3, "real", np.float32),
            (1, 3, 2, 1, 0, np.float32),
            (1500, 40, 70, 50, "last", np.float32),
            (2100, 30, 33, 20, 0, np.float64)):
        idx, mask = padded_batch(N, n, k_max, max_size, pad, seed=N)
        inv = rng.standard_normal((n, k_max, k_max)).astype(dtype)
        args = [torch.from_numpy(x).cuda() for x in (idx, mask, inv)]
        before = theta_scatter_cuda.launches
        got = theta_scatter_cuda(N, *args)
        torch.cuda.synchronize()
        assert theta_scatter_cuda.launches == before + 1
        assert same_bits(got.cpu(), serial_plain(N, *args))
        # no DPP sample: each subset's second slot repeats its first item
        rep = torch.from_numpy(np.where(np.arange(k_max) == 1, idx[:, :1],
                                        idx)).cuda()
        assert same_bits(theta_scatter_cuda(N, rep, args[1], args[2]).cpu(),
                         serial_plain(N, rep, args[1], args[2]))
        none = torch.zeros_like(args[1])
        assert not theta_scatter_cuda(N, args[0], none, args[2]) \
            .count_nonzero()
    empty = theta_scatter_cuda(5, torch.zeros((0, 4), dtype=torch.int32,
                                              device="cuda"),
                               torch.zeros((0, 4), dtype=torch.bool,
                                           device="cuda"),
                               torch.zeros((0, 4, 4), device="cuda"))
    assert empty.isnan().all()
