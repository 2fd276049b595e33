"""The dense Θ of a batch of subsets: the plain PyTorch version and the
wrapper of its hand-written Hopper kernel.

    Θ = (1/n) Σ_s U_s (mask_s ⊙ inv_s) U_sᵀ                      (N x N)

for idx (n, k) ground-set indices, mask (n, k) bool and inv (n, k, k) the
subsets' inverses, where U_s puts subset s's k slots into the ground set.
It replaces no Pallas kernel: the JAX package builds one dense N x N per
subset and takes their mean (``repro/core/krk_picard.py``
``theta_matrix_kron``); the port sums into one N x N buffer.

``theta_scatter_plain`` scatter-adds every slot pair, padded ones as
zeros, with ``index_put_(accumulate=True)`` and divides by n; it serves any
device. ``theta_scatter_cuda`` launches ``csrc/theta_scatter.cu`` on CUDA
tensors, which reads, adds and writes no padded slot, and raises on
anything else. On the same finite inputs the kernel's Θ is the plain
version's bit for bit where ``index_put_`` adds in (s, a, b) order, as the
CPU does in one thread, also for a subset that repeats an item; on the card
``index_put_`` sums long runs of one key as a tree, and the two agree to
rounding (the source's note says why).

``theta_scatter_cuda.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ._build import require_real

_LAUNCH_LOCK = threading.Lock()


def theta_scatter_plain(N: int, idx: torch.Tensor, mask: torch.Tensor,
                        inv: torch.Tensor) -> torch.Tensor:
    """Θ (N x N, inv's dtype): every slot pair of every subset
    scatter-added into one buffer, then divided by n. The division is by a
    tensor: a Python scalar would make it a product with 1/n on a card,
    one rounding away from the kernel's."""
    n = idx.shape[0]
    idx = idx.long()
    vals = inv * (mask[:, :, None] & mask[:, None, :])
    theta = torch.zeros((N, N), dtype=inv.dtype, device=inv.device)
    theta.index_put_((idx[:, :, None], idx[:, None, :]), vals,
                     accumulate=True)
    return theta / torch.full((), n, dtype=inv.dtype, device=inv.device)


def _check_cuda_inputs(N: int, idx: torch.Tensor, mask: torch.Tensor,
                       inv: torch.Tensor) -> Tuple[int, int]:
    op = "theta_scatter_cuda"
    for label, x in (("idx", idx), ("mask", mask), ("inv", inv)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{op}: {label} must be a CUDA tensor, got "
                             f"{getattr(x, 'device', type(x))}")
        if x.device != inv.device:
            raise ValueError(f"{op}: {label} is on {x.device}, inv on "
                             f"{inv.device}")
    if inv.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{op}: inv must be float32 or float64, got "
                         f"{inv.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{op}: idx must be int32 or int64, got {idx.dtype}")
    if mask.dtype != torch.bool:
        raise ValueError(f"{op}: mask must be bool, got {mask.dtype}")
    if not inv.is_contiguous():
        raise ValueError(f"{op}: inv must be contiguous")
    if idx.dim() != 2 or tuple(mask.shape) != tuple(idx.shape):
        raise ValueError(f"{op}: idx and mask must be (n, k), got "
                         f"{tuple(idx.shape)} and {tuple(mask.shape)}")
    n, k = (int(s) for s in idx.shape)
    if tuple(inv.shape) != (n, k, k):
        raise ValueError(f"{op}: inv must be ({n}, {k}, {k}), got "
                         f"{tuple(inv.shape)}")
    if not 0 <= N < 2 ** 31 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"{op}: N = {N}, n = {n}, k = {k} out of range")
    return n, k


def _raise_on(lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        msg = lib.theta_scatter_error_string(rc).decode()
        raise RuntimeError(f"theta_scatter kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def theta_scatter_cuda(N: int, idx: torch.Tensor, mask: torch.Tensor,
                       inv: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/theta_scatter.cu``): one warp a row
    of Θ, on PyTorch's current stream. Its index preparation: the slots'
    keys (idx where mask, N in padded slots) and their stable sort, which
    puts each item's real slots in subset order; nothing is sized from a
    device value, so nothing waits for the card. Same contract as
    ``theta_scatter_plain``; raises on CPU tensors, other dtypes, bad
    shapes, a non-contiguous inv and a refused launch."""
    require_real("theta_scatter_cuda", idx, mask, inv)
    n, k = _check_cuda_inputs(N, idx, mask, inv)
    theta = torch.empty((N, N), dtype=inv.dtype, device=inv.device)
    if N == 0:
        return theta
    from ._build import load_library
    lib = load_library("theta_scatter", bind)
    keys = torch.where(mask, idx.to(torch.int32), N).reshape(-1)
    sorted_keys, slot_of = torch.sort(keys, stable=True)
    stream = torch.cuda.current_stream(inv.device).cuda_stream
    with torch.cuda.device(inv.device):
        rc = lib.theta_scatter_launch(
            keys.data_ptr(), sorted_keys.data_ptr(), slot_of.data_ptr(),
            inv.data_ptr(), theta.data_ptr(), N, k, n * k, n,
            inv.element_size(), stream)
    _raise_on(lib, rc)
    with _LAUNCH_LOCK:
        theta_scatter_cuda.launches += 1
    return theta


#: Kernel launches since import (or since a caller reset them to 0).
theta_scatter_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/theta_scatter.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.theta_scatter_launch.argtypes = [p, p, p, p, p, i, i,
                                         ctypes.c_longlong, i, i, p]
    lib.theta_scatter_launch.restype = ctypes.c_int
    lib.theta_scatter_error_string.argtypes = [ctypes.c_int]
    lib.theta_scatter_error_string.restype = ctypes.c_char_p
