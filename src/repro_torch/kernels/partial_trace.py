"""The Appendix-B partial traces of the dense Θ: the plain PyTorch versions
and the wrappers of their hand-written Hopper kernels.

Port of ``repro/kernels/partial_trace.py`` (the Pallas kernels
``partial_trace_A_pallas`` and ``partial_trace_C_pallas``) and of their
einsum oracles in ``repro/kernels/ref.py``. For Θ4 = Θ viewed as
(N1, N2, N1, N2), row-major:

    A[k,l] = Tr(Θ_(kl) · L2) = Σ_{u,v} Θ4[k,u,l,v] L2[v,u]      (B.1)
    C[u,v] = Σ_{i,j} L1[i,j] Θ4[i,u,j,v]                        (B.2)

``partial_trace_{A,C}_plain`` are the ``torch.einsum`` of the oracles and
serve any device; ``partial_trace_{A,C}_cuda`` launch
``csrc/partial_trace.cu`` on CUDA tensors and raise on anything else.
Neither assumes L1 or L2 symmetric, and the kernels take any N1, N2 (the
Pallas wrapper needed them divisible by its block sizes).

Each wrapper counts its launches in a plain integer attribute,
``partial_trace_A_cuda.launches`` and ``partial_trace_C_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ._build import require_real

#: Threads per block of the three kernels.
THREADS = 256

_LAUNCH_LOCK = threading.Lock()


def partial_trace_A_plain(theta4: torch.Tensor,
                          L2: torch.Tensor) -> torch.Tensor:
    """A[k,l] = Σ_{u,v} Θ4[k,u,l,v] L2[v,u]; theta4 (N1, N2, N1, N2)."""
    return torch.einsum("kulv,vu->kl", theta4, L2)


def partial_trace_C_plain(theta4: torch.Tensor,
                          L1: torch.Tensor) -> torch.Tensor:
    """C[u,v] = Σ_{i,j} L1[i,j] Θ4[i,u,j,v]; theta4 (N1, N2, N1, N2)."""
    return torch.einsum("iujv,ij->uv", theta4, L1)


def _check_cuda_inputs(op: str, theta4: torch.Tensor, L: torch.Tensor,
                       name: str, side: int) -> Tuple[int, int]:
    for label, x in (("theta4", theta4), (name, L)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{op}: {label} must be a CUDA tensor, got "
                             f"{getattr(x, 'device', type(x))}")
        if x.device != theta4.device:
            raise ValueError(f"{op}: {label} is on {x.device}, theta4 on "
                             f"{theta4.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{op}: {label} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {label} must be contiguous")
    if theta4.dim() != 4 or theta4.shape[0] != theta4.shape[2] \
            or theta4.shape[1] != theta4.shape[3]:
        raise ValueError(f"{op}: theta4 must be (N1, N2, N1, N2), got "
                         f"{tuple(theta4.shape)}")
    N1, N2 = int(theta4.shape[0]), int(theta4.shape[1])
    n = (N1, N2)[side]
    if tuple(L.shape) != (n, n):
        raise ValueError(f"{op}: {name} must be ({n}, {n}), got "
                         f"{tuple(L.shape)}")
    if N1 < 1 or N2 < 1 or N1 * N1 >= 2 ** 31 or N2 * N2 >= 2 ** 31:
        raise ValueError(f"{op}: N1 = {N1}, N2 = {N2} out of range")
    return N1, N2


def _raise_on(lib: ctypes.CDLL, rc: int, op: str) -> None:
    if rc != 0:
        msg = lib.partial_trace_error_string(rc).decode()
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def partial_trace_A_cuda(theta4: torch.Tensor,
                         L2: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel for A (``csrc/partial_trace.cu``): one
    block per (k, l), on PyTorch's current stream. Same contract as
    ``partial_trace_A_plain``. Raises on CPU tensors, wrong dtypes,
    non-contiguous inputs, bad shapes, and a refused launch."""
    require_real("partial_trace_A_cuda", theta4, L2)
    N1, N2 = _check_cuda_inputs("partial_trace_A_cuda", theta4, L2, "L2", 1)
    from ._build import load_library
    lib = load_library("partial_trace", bind)
    w = L2.t().contiguous()             # w[u, v] = L2[v, u]: coalesced in v
    out = torch.empty((N1, N1), dtype=torch.float32, device=theta4.device)
    stream = torch.cuda.current_stream(theta4.device).cuda_stream
    with torch.cuda.device(theta4.device):
        rc = lib.partial_trace_A_launch(theta4.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), N1, N2, THREADS,
                                        stream)
    _raise_on(lib, rc, "partial_trace_A")
    with _LAUNCH_LOCK:
        partial_trace_A_cuda.launches += 1
    return out


def partial_trace_C_cuda(theta4: torch.Tensor,
                         L1: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernels for C (``csrc/partial_trace.cu``): a
    partial sum per i over blocks of the (u, v) plane into an (N1, N2²)
    scratch, then a sum over i. Same contract as ``partial_trace_C_plain``;
    raises as ``partial_trace_A_cuda`` does."""
    require_real("partial_trace_C_cuda", theta4, L1)
    N1, N2 = _check_cuda_inputs("partial_trace_C_cuda", theta4, L1, "L1", 0)
    from ._build import load_library
    lib = load_library("partial_trace", bind)
    part = torch.empty((N1, N2 * N2), dtype=torch.float32,
                       device=theta4.device)
    out = torch.empty((N2, N2), dtype=torch.float32, device=theta4.device)
    stream = torch.cuda.current_stream(theta4.device).cuda_stream
    with torch.cuda.device(theta4.device):
        rc = lib.partial_trace_C_launch(theta4.data_ptr(), L1.data_ptr(),
                                        part.data_ptr(), out.data_ptr(), N1,
                                        N2, THREADS, stream)
    _raise_on(lib, rc, "partial_trace_C")
    with _LAUNCH_LOCK:
        partial_trace_C_cuda.launches += 1
    return out


#: Kernel launches since import (or since a caller reset them to 0).
partial_trace_A_cuda.launches = 0
partial_trace_C_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/partial_trace.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.partial_trace_A_launch.argtypes = [p, p, p, i, i, i, p]
    lib.partial_trace_A_launch.restype = ctypes.c_int
    lib.partial_trace_C_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.partial_trace_C_launch.restype = ctypes.c_int
    lib.partial_trace_error_string.argtypes = [ctypes.c_int]
    lib.partial_trace_error_string.restype = ctypes.c_char_p
