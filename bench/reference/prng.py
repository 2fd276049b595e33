"""threefry2x32 keys and uniforms in plain NumPy.

The semantics of ``jax.random`` with ``jax_threefry_partitionable`` on and
x64 off (Salmon et al., SC 2011, for the hash): a key is two uint32 words;
``split`` and the bits of a draw hash the counters 0..n-1 as the pair
(0, i); ``fold_in`` hashes (0, data); a float32 uniform in [0, 1) takes
the top 23 bits of ``x0 ^ x1`` as the mantissa of a float in [1, 2), minus
1. Every function takes keys (R, 2) and returns R rows.
"""

from __future__ import annotations

import numpy as np

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of (x0, x1) under (k0, k1), uint32
    arrays broadcast together."""
    with np.errstate(over="ignore"):
        k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
        ks = (k0, k1, k0 ^ k1 ^ PARITY)
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """(1, 2): [0, seed mod 2^32]."""
    return np.array([[0, int(seed) & 0xFFFFFFFF]], np.uint32)


def fold_in(keys: np.ndarray, data: int) -> np.ndarray:
    y0, y1 = threefry(keys[:, 0], keys[:, 1], 0, np.uint32(data))
    return np.stack([y0, y1], axis=-1)


def split(keys: np.ndarray, num: int) -> np.ndarray:
    """(R, 2) -> (R * num, 2), the keys of each row together."""
    i = np.arange(num, dtype=np.uint32)[None, :]
    y0, y1 = threefry(keys[:, 0:1], keys[:, 1:2], 0, i)
    return np.stack(np.broadcast_arrays(y0, y1), axis=-1).reshape(-1, 2)


def uniform(keys: np.ndarray, n: int) -> np.ndarray:
    """(R, n) float32 in [0, 1)."""
    i = np.arange(n, dtype=np.uint32)[None, :]
    y0, y1 = threefry(keys[:, 0:1], keys[:, 1:2], 0, i)
    mant = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return mant.view(np.float32) - np.float32(1.0)


def split_uniform(keys: np.ndarray, n: int, n2: int):
    """``uniform(a, n)`` and ``uniform(b, n2)`` for ``a, b = split(key)``:
    the two uniform rows of a DPP draw (phase 1 over the items, phase 2
    over the steps)."""
    halves = split(keys, 2).reshape(-1, 2, 2)
    return uniform(halves[:, 0], n), uniform(halves[:, 1], n2)
