"""Batched Kronecker matrix-vector product: the plain PyTorch version and
the wrapper of its hand-written Hopper kernel.

Port of ``repro/kernels/kron_matvec.py`` (the Pallas kernel
``kron_matvec_pallas``) and of its oracle ``ref.kron_matvec_ref``. With
A (N1, N1), B (N2, N2) and X (batch, N1·N2), row-major vec as everywhere
in the package:

    Y[b] = (A ⊗ B) X[b] = vec(A · mat(X[b]) · Bᵀ)

accumulated in float32, output in X's dtype (float32 or bfloat16).
``kron_matvec_plain`` computes it as the Pallas kernel does, on any device;
``kron_matvec_cuda`` launches ``csrc/kron_matvec.cu`` on CUDA tensors and
raises on anything else. The kernel takes any N1, N2 and batch (the JAX
wrapper padded to 128 for the TPU's matrix unit) by one of two routes
(``kron_matvec_route``): "one_launch" keeps T = mat(X[b])·Bᵀ in shared
memory and skips the all-zero rows of mat(X[b]) (unless A or its block's
tile of B holds an Inf or a NaN: then it takes every row, so that they
spread to Y as in the plain version); "two_pass", for factors too large
for a block's shared memory, sends T through a float32 scratch in device
memory. Both compute T = mat(X[b])·Bᵀ first, then A·T, as the Pallas
kernel does, and so does ``kron_matvec_plain``: the two orders of the
product spread an Inf in B to different NaNs (0 · Inf).

The wrapper counts its launches in ``kron_matvec_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ._build import require_real

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("one_launch", "two_pass")

_LAUNCH_LOCK = threading.Lock()


def kron_matvec_plain(A: torch.Tensor, B: torch.Tensor,
                      X: torch.Tensor) -> torch.Tensor:
    """Y[b] = (A ⊗ B) X[b]; A (N1, N1), B (N2, N2), X (batch, N1·N2).
    T = mat(X[b])·Bᵀ, then A·T, in float32 (the Pallas kernel's order)."""
    N1, N2 = int(A.shape[0]), int(B.shape[0])
    X3 = X.reshape(X.shape[0], N1, N2)
    T = X3.float() @ B.float().T
    return (A.float() @ T).reshape(X.shape[0], N1 * N2).to(X.dtype)


def _check_cuda_inputs(A, B, X):
    for name, x in (("A", A), ("B", B), ("X", X)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"kron_matvec_cuda: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.device != X.device:
            raise ValueError(f"kron_matvec_cuda: {name} is on {x.device}, "
                             f"X on {X.device}")
        if x.dtype != X.dtype:
            raise ValueError(f"kron_matvec_cuda: A, B and X must share a "
                             f"dtype, got {name} {x.dtype}, X {X.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"kron_matvec_cuda: {name} must be contiguous")
    if X.dtype not in _DTYPE_CODES:
        raise ValueError(f"kron_matvec_cuda takes float32 or bfloat16, got "
                         f"{X.dtype}")
    if A.dim() != 2 or A.shape[0] != A.shape[1] or B.dim() != 2 \
            or B.shape[0] != B.shape[1]:
        raise ValueError(f"kron_matvec_cuda: A and B must be square, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    N1, N2 = int(A.shape[0]), int(B.shape[0])
    if X.dim() != 2 or X.shape[1] != N1 * N2:
        raise ValueError(f"kron_matvec_cuda: X must be (batch, {N1 * N2}), "
                         f"got {tuple(X.shape)}")
    if N1 < 1 or N2 < 1 or N1 * N2 >= 2 ** 31 or N1 > 65535 * 64 \
            or X.shape[0] >= 2 ** 31:
        raise ValueError(f"kron_matvec_cuda: N1 = {N1}, N2 = {N2}, batch "
                         f"{X.shape[0]} out of range")
    return N1, N2, int(X.shape[0])


@functools.lru_cache(maxsize=None)
def _route(N1: int, N2: int, dtype_code: int, device_index: int) -> int:
    """The kernel's route for these sizes on this device (it depends on
    the device's shared memory per block): 0 one launch, 1 two passes.
    Asked once per key; the query also readies the device for route 0."""
    from ._build import load_library
    lib = load_library("kron_matvec", bind)
    route = ctypes.c_int(-1)
    with torch.cuda.device(device_index):
        rc = lib.kron_matvec_route(N1, N2, dtype_code, ctypes.byref(route))
    if rc != 0:
        msg = lib.kron_matvec_error_string(rc).decode()
        raise RuntimeError(f"kron_matvec route query failed: CUDA error "
                           f"{rc} ({msg})")
    return route.value


def kron_matvec_route(A: torch.Tensor, B: torch.Tensor,
                      X: torch.Tensor) -> str:
    """"one_launch" or "two_pass": the route ``kron_matvec_cuda`` takes for
    these CUDA tensors. Raises as ``kron_matvec_cuda`` does."""
    N1, N2, _ = _check_cuda_inputs(A, B, X)
    return _ROUTES[_route(N1, N2, _DTYPE_CODES[X.dtype], X.device.index)]


def kron_matvec_cuda(A: torch.Tensor, B: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/kron_matvec.cu``) on PyTorch's
    current stream: one launch with T on chip, or, on the "two_pass" route,
    two through a (batch, N1, N2) float32 scratch allocated here. Same
    contract as ``kron_matvec_plain``, an Inf or a NaN in A or B included.
    Raises on CPU tensors, mixed or other dtypes, non-contiguous inputs,
    bad shapes, and a refused launch."""
    require_real("kron_matvec_cuda", A, B, X)
    N1, N2, batch = _check_cuda_inputs(A, B, X)
    Y = torch.empty_like(X)
    if batch == 0:
        return Y
    from ._build import load_library
    lib = load_library("kron_matvec", bind)
    code = _DTYPE_CODES[X.dtype]
    route = _route(N1, N2, code, X.device.index)
    tmp = None
    if route == 1:
        tmp = torch.empty((batch, N1, N2), dtype=torch.float32,
                          device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    with torch.cuda.device(X.device):
        rc = lib.kron_matvec_launch(A.data_ptr(), B.data_ptr(), X.data_ptr(),
                                    None if tmp is None else tmp.data_ptr(),
                                    Y.data_ptr(), N1, N2, batch, code,
                                    route, stream)
    if rc != 0:
        msg = lib.kron_matvec_error_string(rc).decode()
        raise RuntimeError(f"kron_matvec kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _LAUNCH_LOCK:
        kron_matvec_cuda.launches += 1
    return Y


#: Kernel launches since import (or since a caller reset it to 0).
kron_matvec_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/kron_matvec.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kron_matvec_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.kron_matvec_launch.restype = ctypes.c_int
    lib.kron_matvec_route.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.kron_matvec_route.restype = ctypes.c_int
    lib.kron_matvec_error_string.argtypes = [ctypes.c_int]
    lib.kron_matvec_error_string.restype = ctypes.c_char_p
