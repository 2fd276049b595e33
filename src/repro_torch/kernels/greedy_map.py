"""One fast-greedy MAP step: the plain PyTorch version and the wrapper of
its hand-written Hopper kernel.

Port of ``repro/kernels/greedy_map.py`` (the Pallas kernel
``greedy_map_update_pallas``) and of its oracle
``ref.greedy_map_update_ref``. For the chosen item j with conditional
variance dj, kernel column lcol = L[:, j], Cholesky buffer C (N, k) and its
row cj = C[j]:

    e     = (lcol - C · cj) / sqrt(max(dj, 1e-12))
    d_new = d - e²

both float32. ``greedy_map_update_plain`` serves any device;
``greedy_map_update_cuda`` launches ``csrc/greedy_map.cu`` on CUDA tensors
and raises on anything else. The kernel reads C through its strides, so C
may be row-major (N, k) or the transposed view of a (k, N) buffer (the
greedy loop's layout, whose loads coalesce). The two versions sum C · cj
in different orders: they agree to float32 roundoff, not bit for bit.

The wrapper counts its launches in ``greedy_map_update_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_LAUNCH_LOCK = threading.Lock()


def greedy_map_update_plain(lcol: torch.Tensor, C: torch.Tensor,
                            cj: torch.Tensor, dj: torch.Tensor,
                            d: torch.Tensor):
    """(e, d_new) of one step, as ``ref.greedy_map_update_ref``."""
    e = (lcol - C @ cj) / torch.sqrt(torch.clamp_min(dj[0], 1e-12))
    return e.to(torch.float32), (d - e * e).to(torch.float32)


def degeneracy_eps(L: torch.Tensor) -> torch.Tensor:
    """Conditional-variance collapse threshold of greedy MAP, relative to
    the kernel's own scale: 1e-8 · max(max diag L, 1e-30), a 0-d tensor on
    L's device (greedy MAP is scale-equivariant, so an absolute cutoff
    would zero every update of a small-magnitude kernel)."""
    return 1e-8 * torch.clamp_min(torch.diagonal(L).max(), 1e-30)


def _check_cuda_inputs(lcol, C, cj, dj, d):
    tensors = {"lcol": lcol, "C": C, "cj": cj, "dj": dj, "d": d}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"greedy_map_update_cuda: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.device != d.device:
            raise ValueError(f"greedy_map_update_cuda: {name} is on "
                             f"{x.device}, d on {d.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"greedy_map_update_cuda: {name} must be "
                             f"float32, got {x.dtype}")
        if name != "C" and not x.is_contiguous():
            raise ValueError(f"greedy_map_update_cuda: {name} must be "
                             f"contiguous")
    if C.dim() != 2:
        raise ValueError(f"greedy_map_update_cuda: C must be (N, k), got "
                         f"{tuple(C.shape)}")
    N, k = int(C.shape[0]), int(C.shape[1])
    want = {"lcol": (N,), "cj": (k,), "dj": (1,), "d": (N,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"greedy_map_update_cuda: {name} must be "
                             f"{shape} for C {tuple(C.shape)}, got "
                             f"{tuple(tensors[name].shape)}")
    if N >= 2 ** 31 - 32:
        raise ValueError(f"greedy_map_update_cuda: N = {N} out of range")
    return N, k


def greedy_map_update_cuda(lcol: torch.Tensor, C: torch.Tensor,
                           cj: torch.Tensor, dj: torch.Tensor,
                           d: torch.Tensor):
    """Launch the Hopper kernel (``csrc/greedy_map.cu``) on PyTorch's
    current stream. Same contract as ``greedy_map_update_plain``; C may
    have any strides. Raises on CPU tensors, wrong dtypes,
    non-contiguous vectors, bad shapes, and a refused launch."""
    N, k = _check_cuda_inputs(lcol, C, cj, dj, d)
    e = torch.empty((N,), dtype=torch.float32, device=d.device)
    d_new = torch.empty((N,), dtype=torch.float32, device=d.device)
    if N == 0:
        return e, d_new
    from ._build import load_library
    lib = load_library("greedy_map", bind)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    with torch.cuda.device(d.device):
        rc = lib.greedy_map_update_launch(
            lcol.data_ptr(), C.data_ptr(), cj.data_ptr(), dj.data_ptr(),
            d.data_ptr(), e.data_ptr(), d_new.data_ptr(), N, k,
            C.stride(0), C.stride(1), stream)
    if rc != 0:
        msg = lib.greedy_map_error_string(rc).decode()
        raise RuntimeError(f"greedy_map_update kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    with _LAUNCH_LOCK:
        greedy_map_update_cuda.launches += 1
    return e, d_new


#: Kernel launches since import (or since a caller reset it to 0).
greedy_map_update_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/greedy_map.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.greedy_map_update_launch.argtypes = [p, p, p, p, p, p, p, i, i, ll,
                                             ll, p]
    lib.greedy_map_update_launch.restype = ctypes.c_int
    lib.greedy_map_error_string.argtypes = [ctypes.c_int]
    lib.greedy_map_error_string.restype = ctypes.c_char_p
