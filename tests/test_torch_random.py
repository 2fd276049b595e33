"""The port's PRNG twin (``repro_torch.random``) against ``jax.random``, bit
for bit, on the CPU (the plain int64 version of the ``threefry2x32``
kernel): keys, ``split``, ``fold_in``, ``bits``, ``uniform`` (with and
without bounds), batches of keys against ``jax.vmap``, ``permutation`` and
``choice`` (one and two shuffle rounds), ``randint``; the literal values
``chip_smoke.py`` holds the kernel to on the card; and the JAX config the
twin follows. Tolerance: none — every word and every float's bits equal —
except for ``normal``, ``gumbel`` and ``categorical`` in float32 (below):
their uniforms are bit for bit, but ``torch.erfinv`` and ``torch.log`` are
not XLA's polynomials. Measured over 2·10⁵ draws: ``normal`` within 91
units in the last place (6e-6 relative, in the tails), ``gumbel`` within
a few units in the last place (5e-7 + 4e-7·|g|); so float32
``categorical`` may differ only where the top-two scores lie within 2e-6,
and each such row is proven a tie. In bfloat16 all three equal XLA's bit
for bit."""

import os
import sys
from pathlib import Path

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro_torch import random as tr
from repro_torch.convert import key_from_numpy, key_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.threefry import (threefry2x32_cuda,
                                          threefry2x32_plain)

ROOT = Path(__file__).resolve().parents[1]


def K(seed):
    return tr.PRNGKey(seed, device="cpu")


def J(seed):
    return jax.random.PRNGKey(seed)


def assert_bits_equal(got, want):
    """Integer words equal, or float32 values equal bit for bit."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))


def test_jax_config_is_the_one_the_twin_follows():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", [-2 ** 31 - 1, -1, 0, 1, 2 ** 31 - 1,
                                  2 ** 31 + 5, 2 ** 32 - 1, 2 ** 32])
def test_prng_key(seed):
    key = K(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert_bits_equal(key, J(seed))
    assert_bits_equal(tr.key_data(key), J(seed))
    assert tr.key_data(key).dtype == np.uint32


@pytest.mark.parametrize("num", [0, 1, 2, 5, (2, 3)])
def test_split(num):
    assert_bits_equal(tr.split(K(0), num), jax.random.split(J(0), num))
    assert_bits_equal(tr.split(K(11), num), jax.random.split(J(11), num))


def test_split_default_unpacks_into_two_keys():
    a, b = tr.split(K(4))
    ja, jb = jax.random.split(J(4))
    assert_bits_equal(a, ja)
    assert_bits_equal(b, jb)


@pytest.mark.parametrize("data", [0, 5, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in(data):
    assert_bits_equal(tr.fold_in(K(3), data), jax.random.fold_in(J(3), data))
    # a tensor of data folds each into its own key of a batch
    keys = tr.split(K(8), 3)
    got = tr.fold_in(keys, torch.tensor([data, 1, 0]))
    jkeys = jax.random.split(J(8), 3)
    want = [jax.random.fold_in(jkeys[i], d) for i, d in
            enumerate((data, 1, 0))]
    assert_bits_equal(got, np.stack(want))


def test_fold_in_refuses_data_out_of_range():
    for bad in (-1, 2 ** 32):
        with pytest.raises(ValueError, match="2\\^32"):
            tr.fold_in(K(0), bad)


SHAPES = [(), (0,), (1,), (3, 5, 7), (1000,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits(shape):
    assert_bits_equal(tr.bits(K(7), shape), jax.random.bits(J(7), shape))


@pytest.mark.parametrize("bounds", [None, (-3.0, 2.5), (0.0, np.sqrt(2.0)),
                                    (1e6, 1e6 + 3.0)], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform(shape, bounds):
    """Default [0, 1) and explicit bounds; XLA fuses the scale and the
    shift into one multiply-add, which the twin rounds the same way."""
    if bounds is None:
        got, want = tr.uniform(K(7), shape), jax.random.uniform(J(7), shape)
    else:
        lo, hi = bounds
        got = tr.uniform(K(7), shape, lo, hi)
        want = jax.random.uniform(J(7), shape, minval=lo, maxval=hi)
    assert got.dtype == torch.float32
    assert_bits_equal(got, want)


BF16_BOUNDS = [(0.0, 1.0), (-3.0, 2.5), (float(np.finfo(np.float32).tiny),
                                       1.0)]
NORMAL_RTOL, GUMBEL_RTOL, GUMBEL_ATOL, CATEGORICAL_TIE = 6e-6, 4e-7, 5e-7, 2e-6


@pytest.mark.parametrize("bounds", BF16_BOUNDS, ids=str)
def test_uniform_bfloat16(bounds):
    """bfloat16 draws: 7 mantissa bits from the low byte of ``bits`` (JAX
    draws 8 bits for fewer than 8 mantissa bits), then minus 1, the scale,
    the shift and the clamp each rounded to bfloat16."""
    lo, hi = bounds
    got = tr.uniform(K(7), (3, 1000), lo, hi, dtype=torch.bfloat16)
    want = jax.random.uniform(J(7), (3, 1000), jax.numpy.bfloat16, lo, hi)
    assert got.dtype == torch.bfloat16
    assert_bits_equal(got.float(), np.asarray(want, np.float32))
    keys = tr.split(K(3), 4)
    assert_bits_equal(
        tr.uniform(keys, (9,), lo, hi, dtype=torch.bfloat16).float(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (9,), jax.numpy.bfloat16, lo, hi))(
                jax.random.split(J(3), 4)), np.float32))
    with pytest.raises(ValueError, match="bfloat16"):
        tr.uniform(K(7), (3,), dtype=torch.float16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 11])
def test_normal_and_gumbel(seed, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jax.numpy, dtype)
    shape = (200, 1000)
    pairs = ((tr.normal(K(seed), shape, tdt),
              jax.random.normal(J(seed), shape, jdt)),
             (tr.gumbel(K(seed), shape, tdt),
              jax.random.gumbel(J(seed), shape, jdt)))
    for got, want in pairs:
        assert got.dtype == tdt and got.shape == shape
        want = np.asarray(want, np.float32)
        if dtype == "bfloat16":
            assert_bits_equal(got.float(), want)
    if dtype == "float32":
        (n, jn), (g, jg) = ((a.numpy(), np.asarray(b)) for a, b in pairs)
        np.testing.assert_allclose(n, jn, rtol=NORMAL_RTOL, atol=0)
        np.testing.assert_allclose(g, jg, rtol=GUMBEL_RTOL, atol=GUMBEL_ATOL)
    keys = tr.split(K(seed), 3)                  # a batch of keys: vmap
    want = jax.vmap(lambda k: jax.random.normal(k, (5,), jdt))(
        jax.random.split(J(seed), 3))
    np.testing.assert_allclose(tr.normal(keys, (5,), tdt).float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_categorical(dtype, temperature):
    """The engine's draw: logits of a padded vocab (the pad at -1e30)
    over the temperature, one key a step."""
    tdt, jdt = getattr(torch, dtype), getattr(jax.numpy, dtype)
    logits = np.random.default_rng(1).normal(size=(64, 512)).astype(
        np.float32) * 3
    logits[:, 500:] = -1e30
    jl = jax.numpy.asarray(logits).astype(jdt) / temperature
    tl = torch.from_numpy(np.asarray(jl, np.float32)).to(tdt)    # exact
    for seed in range(4):
        want = np.asarray(jax.random.categorical(J(seed), jl, axis=-1))
        got = tr.categorical(K(seed), tl, axis=-1)
        assert got.shape == (64,) and (got < 500).all()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        scores = (np.asarray(jax.random.gumbel(J(seed), jl.shape)) +
                  np.asarray(jl))
        for row in np.nonzero(got.numpy() != want)[0]:
            gap = abs(scores[row, want[row]] - scores[row, got[row]])
            assert gap <= CATEGORICAL_TIE, (row, gap)
    with pytest.raises(ValueError, match="one key"):
        tr.categorical(tr.split(K(0), 2), tl)


def test_batched_keys_match_vmap():
    """(R, 2) keys -> (R, *shape): each row from its own counters, as
    ``jax.vmap`` over the keys gives."""
    keys, jkeys = tr.split(K(1), 4), jax.random.split(J(1), 4)
    assert_bits_equal(tr.uniform(keys, (6,)), jax.vmap(
        lambda k: jax.random.uniform(k, (6,)))(jkeys))
    assert_bits_equal(tr.bits(keys, (2, 3)), jax.vmap(
        lambda k: jax.random.bits(k, (2, 3)))(jkeys))
    assert_bits_equal(tr.split(keys), jax.vmap(jax.random.split)(jkeys))
    assert_bits_equal(tr.split(keys, 3), jax.vmap(
        lambda k: jax.random.split(k, 3))(jkeys))
    assert_bits_equal(tr.uniform(keys, ()), jax.vmap(
        lambda k: jax.random.uniform(k))(jkeys))
    grid = tr.split(K(2), (2, 3))                 # a (2, 3) batch of keys
    assert tr.uniform(grid, (5,)).shape == (2, 3, 5)
    assert_bits_equal(tr.uniform(grid, (5,)), jax.vmap(jax.vmap(
        lambda k: jax.random.uniform(k, (5,))))(jax.random.split(J(2),
                                                                 (2, 3))))


@pytest.mark.parametrize("n,n2", [(0, 0), (1, 46), (1000, 7), (10, 0)])
def test_split_uniform_is_uniform_of_both_halves_of_split(n, n2):
    """The fused mode of a phase-1 row: ``a, b = split(key)``, then
    uniform(a, (n,)) and uniform(b, (n2,)), for one key and a batch."""
    def want(k):
        a, b = jax.random.split(k)
        return jax.random.uniform(a, (n,)), jax.random.uniform(b, (n2,))
    u, us = tr.split_uniform(K(13), n, n2)
    wu, wus = want(J(13))
    assert_bits_equal(u, wu)
    assert_bits_equal(us, wus)
    keys, jkeys = tr.split(K(14), 5), jax.random.split(J(14), 5)
    u, us = tr.split_uniform(keys, n, n2)
    wu, wus = jax.vmap(want)(jkeys)
    assert_bits_equal(u, wu)
    assert_bits_equal(us, wus)


@pytest.mark.parametrize("n", [1, 32, 1000, 2000])
def test_permutation_and_choice(n):
    """``_shuffle``'s rounds: 0 at n = 1, 1 up to n = 1000, 2 at 2000."""
    assert_bits_equal(tr.permutation(K(2), n),
                      jax.random.permutation(J(2), n))
    size = min(n, 32)
    assert_bits_equal(tr.choice(K(2), n, (size,), replace=False),
                      jax.random.choice(J(2), n, (size,), replace=False))
    assert_bits_equal(tr.choice(K(5), n, (4, 3)),
                      jax.random.choice(J(5), n, (4, 3)))
    keys, jkeys = tr.split(K(6), 3), jax.random.split(J(6), 3)
    assert_bits_equal(tr.choice(keys, n, (size,), replace=False), jax.vmap(
        lambda k: jax.random.choice(k, n, (size,), replace=False))(jkeys))


def test_choice_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="larger sample"):
        tr.choice(K(0), 3, (4,), replace=False)
    with pytest.raises(ValueError):
        tr.choice(K(0), 0, (1,))
    assert tr.choice(K(0), 0, (0,)).shape == (0,)


@pytest.mark.parametrize("lo,hi", [(0, 10), (-5, 7), (0, 1000),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                                   (3, 3), (5, 1)])
def test_randint(lo, hi):
    assert_bits_equal(tr.randint(K(9), (50,), lo, hi),
                      jax.random.randint(J(9), (50,), lo, hi))
    assert_bits_equal(tr.randint(K(9), (), lo, hi),
                      jax.random.randint(J(9), (), lo, hi))


def test_keys_cross_between_packages():
    """A JAX key's uint32 words drive the twin as the JAX key drives
    jax.random, and a twin key crosses back."""
    jkey = jax.random.split(J(12))[1]
    key = key_from_numpy(np.asarray(jkey), device="cpu")
    assert_bits_equal(tr.uniform(key, (9,)), jax.random.uniform(jkey, (9,)))
    assert_bits_equal(tr.uniform(np.asarray(jkey), (9,)),
                      jax.random.uniform(jkey, (9,)))
    back = key_to_numpy(tr.split(key)[0])
    assert back.dtype == np.uint32
    assert_bits_equal(jax.random.uniform(back, (3,)),
                      tr.uniform(tr.split(key)[0], (3,)))


def test_golden_literals_of_chip_smoke_equal_jax():
    """``chip_smoke.py`` may not import jax, so it holds the kernel to
    literal values; these must be jax.random's own."""
    sys.path.insert(0, str(ROOT))
    try:
        from chip_smoke import GOLDEN
    finally:
        sys.path.remove(str(ROOT))
    for seed, words in GOLDEN["prng_key"].items():
        assert_bits_equal(np.array(words), J(seed))
    assert_bits_equal(np.array(GOLDEN["split_0_4"]),
                      jax.random.split(J(0), 4))
    assert_bits_equal(np.array(GOLDEN["fold_in_3_5"]),
                      jax.random.fold_in(J(3), 5))
    assert_bits_equal(np.array(GOLDEN["uniform_7_8_bits"], np.uint32),
                      np.asarray(jax.random.uniform(J(7), (8,))).view(
                          np.uint32))
    assert_bits_equal(np.array(GOLDEN["choice_2_1000_32"]),
                      jax.random.choice(J(2), 1000, (32,), replace=False))


def test_plain_threefry_modes_and_dispatch():
    """The plain version's modes agree with one another, and CPU keys take
    it through ``ops.threefry2x32``: counted as the reference engine, no
    kernel launch; the kernel refuses CPU tensors and 2^32 counters."""
    import repro_torch.obs as obs
    keys = tr.split(K(5), 3)
    pair = threefry2x32_plain(keys, 7, "pair")
    assert pair.shape == (3, 7, 2)
    assert torch.equal(threefry2x32_plain(keys, 7, "bits"),
                       pair[..., 0] ^ pair[..., 1])
    fold = threefry2x32_plain(keys, 0, "fold",
                              data=torch.zeros(3, dtype=torch.int64))
    assert torch.equal(fold, pair[:, 0])         # counter 0 is the pair (0, 0)
    with obs.use(obs.InMemoryTracker()) as t:
        out = ops.threefry2x32(keys, 7, "uniform")
    assert out.dtype == torch.float32 and out.shape == (3, 7)
    assert t.counter_value("kernels.threefry2x32.reference") == 1
    assert t.counter_value("kernels.threefry2x32.cuda") == 0
    assert threefry2x32_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        threefry2x32_cuda(keys, 7, "bits")
    with pytest.raises(ValueError, match="CUDA"):
        ops.threefry2x32(keys, 7, "bits", backend="cuda")
    with pytest.raises(ValueError, match="2\\^32"):
        threefry2x32_plain(keys, 2 ** 32, "bits")
    with pytest.raises(ValueError, match="mode"):
        threefry2x32_plain(keys, 3, "normal")


@pytest.mark.cuda
def test_kernel_matches_plain_and_jax_on_card():
    """On a card: every mode of the kernel against the plain twin on the
    card, bit for bit, for 1 and 512 keys and 0, 1, 7 and 64 x 10^4
    counters; and the kernel's draws against jax.random's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    for R in (1, 512):
        keys = tr.split(tr.PRNGKey(R, device="cuda"), R)
        data = torch.arange(R, dtype=torch.int64, device="cuda") * 7919
        assert torch.equal(ops.threefry2x32(keys, 0, "fold", data=data),
                           threefry2x32_plain(keys, 0, "fold", data=data))
        for n in (0, 1, 7, 64 * 10_000):
            for mode, kw in (("pair", {}), ("bits", {}), ("uniform", {}),
                             ("uniform", dict(minval=-3.0, maxval=2.5)),
                             ("split_uniform", dict(n2=46))):
                got = ops.threefry2x32(keys, n, mode, **kw)
                want = threefry2x32_plain(keys, n, mode, **kw)
                for g, w in zip(*((got, want) if mode == "split_uniform"
                                  else ((got,), (want,)))):
                    assert g.dtype == w.dtype and torch.equal(
                        g.view(torch.int32) if g.is_floating_point()
                        else g, w.view(torch.int32)
                        if w.is_floating_point() else w), (R, n, mode)
    with jax.default_device(jax.devices("cpu")[0]):
        jkeys = jax.random.split(J(3), 16)
        want = jax.vmap(lambda k: jax.random.uniform(k, (1000,)))(jkeys)
        want_choice = jax.random.choice(J(2), 1000, (32,), replace=False)
    got = tr.uniform(key_from_numpy(np.asarray(jkeys)), (1000,))
    assert_bits_equal(got.cpu(), want)
    assert_bits_equal(tr.choice(tr.PRNGKey(2), 1000, (32,),
                                replace=False).cpu(), want_choice)
