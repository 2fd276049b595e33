"""The threefry2x32 counter hash behind ``repro_torch.random``: the plain
PyTorch version and the wrapper of its hand-written Hopper kernel.

No Pallas kernel corresponds to this one: in the JAX package XLA fuses
``jax.random``'s threefry2x32 (``jax/_src/prng.py``, 20 rounds of add,
rotate and xor with a key injection every 4 rounds) into one kernel. The
port draws every keyed bit through this function, so that a key gives the
JAX package's bits on the card and on the CPU.

Keys are int64 tensors (R, 2) holding unsigned 32-bit words. The plain
version does its arithmetic in int64 masked with 0xFFFFFFFF, which runs on
the CPU and on CUDA alike (``torch.uint32`` has no ``add``; int32 sorts and
shifts as a signed type). Row r hashes the counter pairs of its own key:

    "pair"     (hi(i), lo(i)) for i < n -> (R, n, 2) int64: ``split``
    "bits"     the same counters, x0 ^ x1 -> (R, n) int64: ``bits``
    "uniform"  those bits as a float32 in [minval, maxval) -> (R, n):
               ((bits >> 9) | 0x3F800000) viewed as a float, minus 1,
               times (maxval - minval) plus minval in one fused
               multiply-add, at least minval
    "fold"     the one pair (0, data[r]) -> (R, 2) int64: ``fold_in``
    "split_uniform"  the "uniform" draws of both halves (a, b) of each
               key's split, n from a and n2 from b -> ((R, n), (R, n2)):
               a phase-1 row's two uniform vectors in one launch
    "select"   the partial Fisher-Yates draw of m = n2 of range(n) ->
               (R, m) int32: for t < m, ``key, sub = split(key)``,
               ``j = randint(sub, (), t, n)``, swap idx[t] and idx[j]
               (``core.distributed.shard_select_no_replace``; one launch
               walks every key's chain of m splits)

where hi(i), lo(i) are the words of the row-major counter i (the JAX
package's ``iota_2x32_shape`` with ``jax_threefry_partitionable``).
Counters stop below 2^32, so hi is 0; a larger n is refused.

``threefry2x32_plain`` serves any device; ``threefry2x32_cuda`` launches
``csrc/threefry.cu`` on CUDA tensors and raises on anything else. The two
agree bit for bit. The wrapper counts its launches in
``threefry2x32_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from ._build import require_real

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
MODES = ("pair", "bits", "uniform", "fold", "split_uniform", "select")
MAX_COUNT = 2 ** 32           # counters are hi = 0 below this

_LAUNCH_LOCK = threading.Lock()


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry_2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor):
    """The threefry2x32 hash of counter words (x0, x1) under key words
    (k0, k1): int64 tensors of uint32 values, broadcast together. Returns
    the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def uniform_span(minval: float, maxval: float):
    """(lo, span) in float32, as ``jax.random.uniform`` forms them:
    both bounds rounded to float32 first, then subtracted in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return lo, np.float32(hi - lo)


def fma32(f: torch.Tensor, span, lo) -> torch.Tensor:
    """f * span + lo rounded once to float32 (a fused multiply-add), for a
    float32 tensor f and float32 scalars. The product is exact in float64
    (24 by 24 bits); the sum is taken in float64 with its rounding error
    (TwoSum) and, where inexact, rounded to odd, so that the final rounding
    to float32 is the correctly rounded one."""
    lo = float(lo)
    p = f.double() * float(span)
    if lo == 0.0:
        return p.float()
    s = p + lo
    bb = s - p
    err = (p - (s - bb)) + (lo - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0,
                    maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms of 32-bit ``bits`` (int64 tensor), as
    ``jax.random.uniform`` turns them into floats: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, times (maxval - minval) plus
    minval in one fused multiply-add (XLA contracts the two; with minval 0
    it is the product), clamped below at minval."""
    lo, span = uniform_span(minval, maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(fma32(f, span, lo), float(lo))


def _check_mode(mode: str, n: int, data, n2: int = 0) -> None:
    if mode not in MODES:
        raise ValueError(f"threefry2x32 mode must be one of {MODES}, got "
                         f"{mode!r}")
    if mode == "fold":
        if data is None:
            raise ValueError("threefry2x32 mode 'fold' needs data (R,)")
        return
    if mode == "select" and not 0 <= int(n2) <= int(n) < 2 ** 31:
        raise ValueError(f"threefry2x32 mode 'select' draws 0 <= m <= n < "
                         f"2^31 indices, got m = {n2}, n = {n}")
    for count in (n, n2):
        if not 0 <= int(count) < MAX_COUNT:
            raise ValueError(f"threefry2x32: {count} counters out of range "
                             f"[0, 2^32): the counters' high word must stay "
                             f"0")


def threefry2x32_plain(keys: torch.Tensor, n: int, mode: str,
                       data: Optional[torch.Tensor] = None,
                       minval: float = 0.0, maxval: float = 1.0,
                       n2: int = 0):
    """The hash of row r's counters under keys[r], on keys' device, in
    int64 arithmetic masked to 32 bits. See the module docstring for the
    modes and the shapes they return."""
    _check_mode(mode, n, data, n2)
    if mode == "select":
        return _select_plain(keys, int(n), int(n2))
    if mode == "split_uniform":
        half = threefry2x32_plain(keys, 2, "pair")
        return tuple(threefry2x32_plain(half[:, h].contiguous(), c,
                                        "uniform", minval=minval,
                                        maxval=maxval)
                     for h, c in ((0, n), (1, n2)))
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    if mode == "fold":
        x1 = data.reshape(-1, 1).to(torch.int64)
        y0, y1 = threefry_2x32(k0, k1, torch.zeros_like(x1), x1)
        return torch.cat([y0, y1], dim=1)
    i = torch.arange(int(n), dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry_2x32(k0, k1, i >> 32, i & MASK)
    if mode == "pair":
        y0, y1 = torch.broadcast_tensors(y0, y1)
        return torch.stack([y0, y1], dim=-1)
    bits = y0 ^ y1
    if mode == "bits":
        return bits
    return bits_to_uniform(bits, minval, maxval)


def _select_plain(keys: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Mode "select": the chain of m splits, then the m randint draws of
    every key in one batched hash, then the swaps on the index rows."""
    R = int(keys.shape[0])
    idx = torch.arange(n, dtype=torch.int64, device=keys.device).repeat(R, 1)
    if m == 0:
        return idx[:, :0].to(torch.int32)
    subs = []
    for _ in range(m):
        pair = threefry2x32_plain(keys, 2, "pair")            # (R, 2, 2)
        keys, sub = pair[:, 0], pair[:, 1]
        subs.append(sub)
    half = threefry2x32_plain(torch.stack(subs, 1).reshape(-1, 2), 2, "pair")
    hi, lo = (threefry2x32_plain(half[:, h], 1, "bits").reshape(R, m)
              for h in (0, 1))
    # randint(sub_t, (), t, n): jax's modulus construction in uint32
    span = n - torch.arange(m, dtype=torch.int64, device=keys.device)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    low16 = ((hi % span) * (mult & 0xFFFF))
    high16 = ((((hi % span) * (mult >> 16)) & 0xFFFF) << 16)
    off = ((((low16 + high16) & MASK) + lo % span) & MASK) % span
    j = torch.arange(m, device=keys.device) + off
    rows = torch.arange(R, device=keys.device)
    for t in range(m):
        vi, vj = idx[:, t].clone(), idx[rows, j[:, t]]
        idx[:, t] = vj
        idx[rows, j[:, t]] = vi
    return idx[:, :m].to(torch.int32)


def _check_cuda_inputs(keys, data, mode):
    for name, x in (("keys", keys), ("data", data)):
        if x is None:
            continue
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"threefry2x32_cuda: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.dtype != torch.int64 or not x.is_contiguous():
            raise ValueError(f"threefry2x32_cuda: {name} must be contiguous "
                             f"int64, got {x.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"threefry2x32_cuda: keys must be (R, 2), got "
                         f"{tuple(keys.shape)}")
    R = int(keys.shape[0])
    if mode == "fold" and (tuple(data.shape) != (R,)
                           or data.device != keys.device):
        raise ValueError(f"threefry2x32_cuda: data must be ({R},) on "
                         f"{keys.device}, got {tuple(data.shape)} on "
                         f"{data.device}")
    if R >= 2 ** 31:
        raise ValueError(f"threefry2x32_cuda: {R} keys out of range")
    return R


def threefry2x32_cuda(keys: torch.Tensor, n: int, mode: str,
                      data: Optional[torch.Tensor] = None,
                      minval: float = 0.0, maxval: float = 1.0,
                      n2: int = 0):
    """Launch the Hopper kernel (``csrc/threefry.cu``) on PyTorch's current
    stream. Same contract as ``threefry2x32_plain``; keys (R, 2) and data
    (R,) contiguous int64 on the card. Raises on CPU tensors, a wrong
    dtype or shape, n >= 2^32 and a refused launch."""
    require_real("threefry2x32_cuda", keys, data)
    _check_mode(mode, n, data, n2)
    R = _check_cuda_inputs(keys, data, mode)
    n, n2 = int(n), int(n2)
    dev = keys.device
    out2 = None
    if mode == "split_uniform":
        out = torch.empty((R, n), dtype=torch.float32, device=dev)
        out2 = torch.empty((R, n2), dtype=torch.float32, device=dev)
        if R == 0 or n + n2 == 0:
            return out, out2
    elif mode == "select":
        out = torch.empty((R, n2), dtype=torch.int32, device=dev)
        if out.numel() == 0:
            return out
        out2 = torch.empty((R, n), dtype=torch.int32, device=dev)  # idx rows
    elif mode == "fold":
        out = torch.empty((R, 2), dtype=torch.int64, device=dev)
    elif mode == "pair":
        out = torch.empty((R, n, 2), dtype=torch.int64, device=dev)
    else:
        out = torch.empty((R, n), device=dev, dtype=torch.float32
                          if mode == "uniform" else torch.int64)
    if out2 is None and out.numel() == 0:
        return out
    lo, span = uniform_span(minval, maxval)
    from ._build import load_library
    lib = load_library("threefry", bind)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.threefry2x32_launch(
            keys.data_ptr(), None if data is None else data.data_ptr(),
            out.data_ptr(), R, n, MODES.index(mode), float(lo), float(span),
            stream, None if out2 is None else out2.data_ptr(), n2)
    if rc != 0:
        msg = lib.threefry2x32_error_string(rc).decode()
        raise RuntimeError(f"threefry2x32 kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _LAUNCH_LOCK:
        threefry2x32_cuda.launches += 1
    return out if out2 is None or mode == "select" else (out, out2)


#: Kernel launches since import (or since a caller reset it to 0).
threefry2x32_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/threefry.cu``."""
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.threefry2x32_launch.argtypes = [p, p, p, ll, ll, ctypes.c_int, f, f,
                                        p, p, ll]
    lib.threefry2x32_launch.restype = ctypes.c_int
    lib.threefry2x32_error_string.argtypes = [ctypes.c_int]
    lib.threefry2x32_error_string.restype = ctypes.c_char_p
