"""Keyed randomness: the twin of the part of ``jax.random`` the package uses.

The JAX package draws every random number from ``jax.random`` keys under
threefry2x32 with ``jax_threefry_partitionable`` on. This module gives the
same numbers, bit for bit, from the same keys, on the card and on the CPU,
so that a key drives the same rows through both packages.

A key is an int64 tensor (..., 2) holding two unsigned 32-bit words (the
JAX package's uint32 key data; ``key_data`` and ``as_key`` convert). Every
function takes one key (2,) or a batch of keys (..., 2) and returns the
batch's shape followed by its own: each key draws from its own counters
0..prod(shape)-1, as ``jax.vmap`` over the keys does.

Every bit comes from one call of ``kernels.ops.threefry2x32``: the
hand-written kernel for keys on the card, its plain int64 version for keys
on the CPU (``backend`` forces one, as for the other kernels).

    PRNGKey(seed)           [0, seed mod 2^32] (the JAX package runs with
                            x64 off)
    split(key, num)         the fold-like split (counters of ``num``)
    fold_in(key, data)      the hash of the pair (0, data)
    bits(key, shape)        x0 ^ x1 of the counters, 32-bit values
    uniform(key, shape, minval, maxval)   float32 in [minval, maxval)
                            (``dtype=torch.bfloat16``: from 8 of the bits,
                            as ``jax.random.uniform`` makes bfloat16)
    split_uniform(key, n, n2)  uniform of both halves of split(key), fused
    randint(key, shape, minval, maxval)   two draws of 32 bits, modulus
    permutation(key, n), choice(key, n, shape, replace)
    normal(key, shape, dtype)   sqrt(2)·erfinv of a uniform in (-1, 1)
    gumbel(key, shape, dtype)   -log(-log(u)), u uniform in [tiny, 1)
    categorical(key, logits, axis)   argmax of gumbel + logits

``normal`` and ``gumbel`` take the JAX package's uniforms bit for bit but
PyTorch's ``erfinv`` (in float64) and ``log``, not XLA's polynomials: in
float32 ``normal`` agrees to about 6e-6 relative (at most 91 units in the
last place over 2·10⁵ draws, the largest in the tails), ``gumbel`` to a few
units in the last place, so ``categorical`` can differ only where two
categories' scores lie that close. In bfloat16 each operation rounds to bfloat16 as XLA's does,
and ``gumbel`` and ``categorical`` give the JAX package's values
(``tests/test_torch_random.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .kernels import ops as kernel_ops

MASK = 0xFFFFFFFF
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """The key of an integer seed: [0, seed mod 2^32] as (2,) int64 on
    ``device`` (``jax.random.PRNGKey`` with x64 off, which keeps the low 32
    bits of the seed)."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=dev)


def as_key(key, device: Optional[DeviceLike] = None) -> torch.Tensor:
    """``key`` (..., 2) — a twin key, a numpy uint32 key carried from the
    JAX package, or a sequence — as an int64 tensor, on ``device`` when
    given."""
    if isinstance(key, torch.Tensor):
        out = key.to(torch.int64)
    else:
        arr = np.asarray(key)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"a PRNG key holds integer words, got "
                            f"{arr.dtype}")
        out = torch.from_numpy(arr.astype(np.int64))
    if out.dim() < 1 or out.shape[-1] != 2:
        raise ValueError(f"a PRNG key is (..., 2), got {tuple(out.shape)}")
    return out if device is None else out.to(resolve_device(device))


def key_data(key) -> np.ndarray:
    """The key's words as numpy uint32 (..., 2), as ``jax.random.key_data``
    gives them for the JAX package's keys."""
    return as_key(key).cpu().numpy().astype(np.uint32)


def _rows(key) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    key = as_key(key)
    return key.reshape(-1, 2).contiguous(), tuple(key.shape[:-1])


def _hash(key, n: int, mode: str, backend: Optional[str], **kw
          ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    flat, batch = _rows(key)
    return kernel_ops.threefry2x32(flat, n, mode, backend=backend,
                                   **kw), batch


def split(key, num: Shape = 2, backend: Optional[str] = None
          ) -> torch.Tensor:
    """New keys (..., *num, 2) from each key (..., 2): the hash of the
    counters of ``num`` (``jax.random.split`` with
    ``jax_threefry_partitionable``)."""
    shape = _shape(num)
    out, batch = _hash(key, math.prod(shape), "pair", backend)
    return out.reshape(batch + shape + (2,))


def fold_in(key, data, backend: Optional[str] = None) -> torch.Tensor:
    """The key (..., 2) with ``data`` folded in: the hash of the pair
    (0, data). ``data`` is an int in [0, 2^32) or an integer tensor
    broadcast to the keys' batch shape (its low 32 bits are taken)."""
    flat, batch = _rows(key)
    if isinstance(data, (int, np.integer)):
        if not 0 <= int(data) <= MASK:
            raise ValueError(f"fold_in data must be in [0, 2^32), got "
                             f"{data}")
        d = torch.full((flat.shape[0],), int(data), dtype=torch.int64,
                       device=flat.device)
    else:
        d = torch.as_tensor(data).to(device=flat.device, dtype=torch.int64)
        d = (d.expand(batch).reshape(-1) & MASK).contiguous()
    out = kernel_ops.threefry2x32(flat, 0, "fold", data=d, backend=backend)
    return out.reshape(batch + (2,))


def bits(key, shape: Shape = (), backend: Optional[str] = None
         ) -> torch.Tensor:
    """32 random bits per element, (..., *shape) int64 (``jax.random.bits``
    with ``jax_threefry_partitionable``: x0 ^ x1 of each counter)."""
    shape = _shape(shape)
    out, batch = _hash(key, math.prod(shape), "bits", backend)
    return out.reshape(batch + shape)


def uniform(key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, backend: Optional[str] = None, *,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Uniforms in [minval, maxval), (..., *shape) of ``dtype``
    (``jax.random.uniform``). float32: the top 23 bits of ``bits`` as a
    mantissa, scaled and shifted, clamped below at minval (one kernel
    launch). bfloat16: JAX draws 8 bits for a type of fewer than 8 mantissa
    bits, so the low byte of ``bits`` gives 7 mantissa bits; minus 1, times
    (maxval - minval), plus minval and the clamp each round to bfloat16."""
    shape = _shape(shape)
    if dtype == torch.float32:
        out, batch = _hash(key, math.prod(shape), "uniform", backend,
                           minval=minval, maxval=maxval)
        return out.reshape(batch + shape)
    if dtype != torch.bfloat16:
        raise ValueError(f"uniform draws float32 or bfloat16, not {dtype}")
    b = bits(key, shape, backend)
    f = (((b & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    # the bounds as JAX forms them (a Python float is float32 first), and
    # their span, in bfloat16 on the host; as Python floats they are exact
    # scalars of each bfloat16 operation
    lo, hi = (torch.tensor(np.float32(v)).to(dtype) for v in (minval, maxval))
    return torch.clamp_min((f - 1.0) * float(hi - lo) + float(lo), float(lo))


def split_uniform(key, n: int, n2: int, minval: float = 0.0,
                  maxval: float = 1.0, backend: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``uniform(a, (n,))`` and ``uniform(b, (n2,))`` for
    ``a, b = split(key)``, (..., n) and (..., n2), from one kernel launch
    (the uniforms of a phase-1 row: u over the items, us over the
    phase-2 steps)."""
    flat, batch = _rows(key)
    u, us = kernel_ops.threefry2x32(flat, int(n), "split_uniform",
                                    minval=minval, maxval=maxval,
                                    n2=int(n2), backend=backend)
    return u.reshape(batch + (int(n),)), us.reshape(batch + (int(n2),))


def _mulmod32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for a of uint32 values and 0 <= m < 2^32, without
    leaving int64: m in 16-bit halves."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & MASK


def randint(key, shape: Shape, minval: int, maxval: int,
            backend: Optional[str] = None) -> torch.Tensor:
    """Integers in [minval, maxval), (..., *shape) int64 holding the values
    of ``jax.random.randint``'s int32 result: two 32-bit draws of a split
    key combined by its modulus construction (biased where the span is not
    a power of 2, exactly as there). Bounds are ints in the int32 range;
    maxval <= minval gives minval."""
    for name, v in (("minval", minval), ("maxval", maxval)):
        if not INT32_MIN <= int(v) <= INT32_MAX:
            raise ValueError(f"randint {name} = {v} outside the int32 range")
    minval, maxval = int(minval), int(maxval)
    shape = _shape(shape)
    keys = split(key, backend=backend)
    higher = bits(keys[..., 0, :], shape, backend)
    lower = bits(keys[..., 1, :], shape, backend)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK) % span
    offset = (_mulmod32(higher % span, multiplier) + lower % span) & MASK
    return minval + offset % span


def permutation(key, n: int, backend: Optional[str] = None) -> torch.Tensor:
    """A random permutation of range(n), (..., n) int64
    (``jax.random.permutation(key, n)``): ceil(3 ln n / ln(2^32 - 1))
    rounds, each ``key, sub = split(key)`` then a stable sort of the
    values by ``bits(sub, (n,))``."""
    flat, batch = _rows(key)
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=flat.device).expand(
        flat.shape[0], n)
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(2 ** 32 - 1)))
    for _ in range(rounds):
        pair = split(flat, backend=backend)
        flat, sub = pair[:, 0].contiguous(), pair[:, 1]
        order = torch.sort(bits(sub, (n,), backend), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x.reshape(batch + (n,))


def choice(key, n: int, shape: Shape = (), replace: bool = True,
           backend: Optional[str] = None) -> torch.Tensor:
    """``shape`` draws from range(n), (..., *shape) int64
    (``jax.random.choice(key, n, shape, replace)`` with uniform
    probabilities): with replacement ``randint(key, shape, 0, n)``, without
    it the first prod(shape) entries of ``permutation(key, n)``."""
    shape = _shape(shape)
    size, n = math.prod(shape), int(n)
    flat, batch = _rows(key)
    if size == 0:
        return torch.zeros(batch + shape, dtype=torch.int64,
                           device=flat.device)
    if n <= 0:
        raise ValueError("n must be greater than 0 unless no samples are "
                         "taken")
    if replace:
        return randint(key, shape, 0, n, backend)
    if size > n:
        raise ValueError(f"Cannot take a larger sample (size {size}) than "
                         f"population (size {n}) when 'replace=False'")
    return permutation(flat, n, backend)[:, :size].reshape(batch + shape)


def _float_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"draws are float32 or bfloat16, not {dtype}")
    return dtype


def normal(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           backend: Optional[str] = None) -> torch.Tensor:
    """Standard normals (..., *shape) (``jax.random.normal``):
    sqrt(2)·erfinv(u) for u uniform in [nextafter(-1, 0), 1) of ``dtype``.
    ``torch.erfinv`` is not XLA's polynomial (see the module docstring)."""
    dtype = _float_dtype(dtype)
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, lo, 1.0, backend, dtype=dtype)
    sqrt2 = float(torch.tensor(np.float32(np.sqrt(2.0))).to(dtype))
    # erfinv in float64, rounded once: the float32 CPU kernel of erfinv
    # is not reproducible from one process to the next (a worker thread's
    # share of the tensor now and then takes a less accurate path)
    return torch.erfinv(u.double()).to(dtype) * sqrt2


def gumbel(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           backend: Optional[str] = None) -> torch.Tensor:
    """Standard Gumbel draws (..., *shape) (``jax.random.gumbel``, its
    default "low" mode): -log(-log(u)) for u uniform in [tiny, 1) of
    ``dtype``, each operation rounded to ``dtype``."""
    dtype = _float_dtype(dtype)
    u = uniform(key, shape, torch.finfo(dtype).tiny, 1.0, backend,
                dtype=dtype)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, axis: int = -1,
                backend: Optional[str] = None) -> torch.Tensor:
    """One draw a row from softmax(logits) along ``axis``, int64 of
    logits' shape without ``axis`` (``jax.random.categorical`` with one
    key: the Gumbel-max trick, ``gumbel`` of logits' shape and dtype added
    to the logits; ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax``). ``key`` is one key (2,)."""
    key = as_key(key, logits.device)
    if key.dim() != 1:
        raise ValueError(f"categorical takes one key (2,), got "
                         f"{tuple(key.shape)}")
    g = gumbel(key, tuple(logits.shape), logits.dtype, backend)
    return torch.argmax(g + logits, dim=axis)
