"""Fast greedy MAP: one update step and the whole selection of k items,
each as a plain PyTorch version and the wrapper of a hand-written Hopper
kernel (``csrc/greedy_map.cu``).

The step is the port of ``repro/kernels/greedy_map.py`` (the Pallas kernel
``greedy_map_update_pallas``) and of its oracle
``ref.greedy_map_update_ref``. For the chosen item j with conditional
variance dj, kernel column lcol = L[:, j], Cholesky buffer C (N, k) and its
row cj = C[j]:

    e     = (lcol - C · cj) / sqrt(max(dj, 1e-12))
    d_new = d - e²

both float32. ``greedy_map_update_plain`` serves any device;
``greedy_map_update_cuda`` launches ``greedy_map_update_kernel`` on CUDA
tensors and raises on anything else. The kernel reads C through its
strides, so C may be row-major (N, k) or the transposed view of a (k, N)
buffer (the plain loop's layout, whose loads coalesce). The two versions
sum C · cj in different orders: they agree to float32 roundoff, not bit
for bit.

The selection is the port of the JAX ``ops.greedy_map_kdpp`` (the step
kernel inside a ``scan`` of k steps, vmapped over heads by the KV
compaction): ``greedy_map_kdpp_plain`` is that loop over the plain step,
one matrix after another for a batch; ``greedy_map_kdpp_cuda`` runs all k
steps of every matrix of an (N, N) or (H, N, N) batch in one launch of
``greedy_map_kdpp_kernel``, one thread-block cluster a matrix. Their picks
agree in order up to a tie of two conditional variances within float32
roundoff (the dots are summed in other orders).

Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from ._build import require_real

_LAUNCH_LOCK = threading.Lock()
_PLANS: Dict[Tuple[int, int, int], dict] = {}


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


def greedy_map_kdpp_plain(L: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy MAP selection of k items (Chen et al. 2018 fast greedy) of L
    (N, N), or of each matrix of a batch (H, N, N) in turn, through the
    plain update step; (k,) or (H, k) int32 picks on L's device.

    A Python loop of k steps that never waits for the device (the pick j
    stays a device tensor). ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does. A degenerate pick (conditional variance at or below
    ``degeneracy_eps(L)``, k beyond numerical rank) clamps the divisor,
    zeroes its update and leaves d as it was. The Cholesky buffer is kept
    transposed, Cᵀ (k, N): step t writes row t."""
    if L.dim() == 3:
        return torch.stack([greedy_map_kdpp_plain(Lh, k) for Lh in L]) \
            if L.shape[0] else torch.empty((0, int(k)), dtype=torch.int32,
                                           device=L.device)
    k = int(k)
    N = int(L.shape[0])
    dev = L.device
    eps = degeneracy_eps(L)
    d = torch.diagonal(L).to(torch.float32)
    CT = torch.zeros((k, N), dtype=torch.float32, device=dev)
    chosen = torch.zeros((N,), dtype=torch.bool, device=dev)
    picks = torch.empty((k,), dtype=torch.int64, device=dev)
    for t in range(k):
        j = torch.argmax(torch.where(chosen, float("-inf"), d)).view(1)
        dj = d.index_select(0, j)
        ok = dj > eps
        e, d_upd = greedy_map_update_plain(
            L.index_select(1, j).view(N), CT.t(),
            CT.index_select(1, j).view(k), torch.maximum(dj, eps), d)
        e = torch.where(ok, e, 0.0)
        d = torch.where(ok, torch.clamp_min(d_upd, 0.0), d)
        CT[t] = e
        chosen.index_fill_(0, j, True)
        picks[t:t + 1] = j
    return picks.to(torch.int32)


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
    require_real("greedy_map_update_cuda", lcol, C, cj, dj, d)
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
    _raise_for(lib, rc, "greedy_map_update kernel launch")
    with _LAUNCH_LOCK:
        greedy_map_update_cuda.launches += 1
    return e, d_new


#: Kernel launches since import (or since a caller reset it to 0).
greedy_map_update_cuda.launches = 0


def _raise_for(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.greedy_map_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def greedy_map_kdpp_plan(N: int, k: int, device: torch.device) -> dict:
    """The launch plan of an (N, k) selection on a CUDA ``device``, asked of
    the C side once per (device, N, k): ``cluster`` (CTAs a matrix),
    ``c_in_smem`` (the Cholesky buffer in the cluster's shared memory, else
    a device scratch), ``threads`` a CTA, column ``slices``, ``items`` a CTA,
    ``smem_bytes`` a CTA, ``clusters_resident`` (how many the card holds at
    once) and ``c_stride`` (the scratch's row stride, 0 without one).
    Raises when no cluster fits the card."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, int(N), int(k))
    plan = _PLANS.get(key)
    if plan is None:
        from ._build import load_library
        lib = load_library("greedy_map", bind)
        out = (ctypes.c_int * 8)()
        with torch.cuda.device(index):
            rc = lib.greedy_map_kdpp_plan(int(N), int(k), out)
        _raise_for(lib, rc, f"greedy_map_kdpp plan at N = {N}, k = {k}")
        plan = dict(zip(("cluster", "c_in_smem", "threads", "slices",
                         "items", "smem_bytes", "clusters_resident",
                         "c_stride"), (int(x) for x in out)))
        plan["c_in_smem"] = bool(plan["c_in_smem"])
        _PLANS[key] = plan
    return plan


def greedy_map_kdpp_cuda(L: torch.Tensor, k: int) -> torch.Tensor:
    """Launch ``greedy_map_kdpp_kernel`` once on PyTorch's current stream:
    the k greedy-MAP picks of L (N, N), or of every matrix of L (H, N, N),
    as (k,) or (H, k) int32 on L's device. Same contract as
    ``greedy_map_kdpp_plain``. Raises ``ValueError`` on a CPU tensor, a
    dtype other than float32, a non-contiguous or non-square L and a k
    outside 1..N, and ``RuntimeError`` when the card refuses the launch;
    it never falls back to the step loop or the plain version."""
    require_real("greedy_map_kdpp_cuda", L)
    if not isinstance(L, torch.Tensor):
        raise ValueError(f"greedy_map_kdpp_cuda: L must be a tensor, got "
                         f"{type(L)}")
    if L.dtype != torch.float32:
        raise ValueError(f"greedy_map_kdpp_cuda: L must be float32, got "
                         f"{L.dtype}")
    if L.dim() not in (2, 3) or L.shape[-1] != L.shape[-2]:
        raise ValueError(f"greedy_map_kdpp_cuda: L must be (N, N) or (H, N, "
                         f"N), got {tuple(L.shape)}")
    if not L.is_contiguous():
        raise ValueError("greedy_map_kdpp_cuda: L must be contiguous")
    N, k = int(L.shape[-1]), int(k)
    if not 1 <= k <= N:
        raise ValueError(f"greedy_map_kdpp_cuda: k = {k} outside 1..N = "
                         f"1..{N}")
    if N > 2 ** 30:
        raise ValueError(f"greedy_map_kdpp_cuda: N = {N} out of range")
    if not L.is_cuda:
        raise ValueError(f"greedy_map_kdpp_cuda: L must be a CUDA tensor, "
                         f"got {L.device}")
    batched = L.dim() == 3
    H = int(L.shape[0]) if batched else 1
    picks = torch.empty((H, k), dtype=torch.int32, device=L.device)
    if H == 0:
        return picks
    plan = greedy_map_kdpp_plan(N, k, L.device)
    C = None if plan["c_in_smem"] else torch.empty(
        (H, k, plan["c_stride"]), dtype=torch.float32, device=L.device)
    from ._build import load_library
    lib = load_library("greedy_map", bind)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    with torch.cuda.device(L.device):
        rc = lib.greedy_map_kdpp_launch(
            L.data_ptr(), None if C is None else C.data_ptr(),
            picks.data_ptr(), H, N, k, plan["cluster"],
            int(plan["c_in_smem"]), stream)
    _raise_for(lib, rc, "greedy_map_kdpp kernel launch")
    with _LAUNCH_LOCK:
        greedy_map_kdpp_cuda.launches += 1
    return picks if batched else picks[0]


#: Kernel launches since import (or since a caller reset it to 0).
greedy_map_kdpp_cuda.launches = 0


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/greedy_map.cu``."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.greedy_map_update_launch.argtypes = [p, p, p, p, p, p, p, i, i, ll,
                                             ll, p]
    lib.greedy_map_update_launch.restype = ctypes.c_int
    lib.greedy_map_kdpp_plan.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.greedy_map_kdpp_plan.restype = ctypes.c_int
    lib.greedy_map_kdpp_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.greedy_map_kdpp_launch.restype = ctypes.c_int
    lib.greedy_map_error_string.argtypes = [ctypes.c_int]
    lib.greedy_map_error_string.restype = ctypes.c_char_p
