"""Phase-2 projection-DPP selection: the plain PyTorch version and the
wrapper of its hand-written Hopper kernel.

Port of ``repro/kernels/phase2_select.py`` (the Pallas kernel
``phase2_select_pallas``) and of the while_loop reference
``phase2_select_reference`` (``repro/sampling/batched.py``). For each
sample b, with the factored eigenvector columns canonicalized to one pair
(G1 (N1, k), Gr (Nr, k); ``canonical_pair``):

    norms[n1, nr] = Σ_c G1[n1, c]² · Gr[nr, c]²
    for t < k_eff[b], while alive:
        csum = inclusive_cumsum(norms); total = csum[-1]
        alive = total > MASS_EPS              (a collapsed step never picks)
        i = min(#(csum <= us[b, t] · total), N - 1)
        w = G1[i // Nr] ⊙ Gr[i % Nr]
        q = CGS2(w against the k x k basis B), normalized if ‖q‖² > EPS
        B[:, t] = q; picks[b, t] = i
        norms = max(norms - (G1 diag(q) Grᵀ)², 0); norms[i] = 0

Output: (B, k_max) int32 picks, -1 in padded and dead slots.

``phase2_select_plain`` runs this as batched tensor code (any device);
``phase2_select_cuda`` launches ``csrc/phase2_select.cu`` on CUDA tensors
and raises on anything else, by one of three routes
(``phase2_select_route``): "on_chip" keeps both factors and the residual
norms in the block's shared memory for the whole run, "global" (shapes
whose on-chip layout passes the device's shared memory per block) keeps
the norms in a (B, N) scratch in device memory, and "global_basis" (a k
whose k x k basis passes it too) also the basis, as B and Bᵀ in a
(B, 2, k, k) scratch. The kernel and the plain version agree draw for
draw except where
``us · total`` lands within roundoff of a CDF boundary (the kernel's
block-parallel scan rounds differently from ``torch.cumsum``), or where
the residual mass after the span is exhausted is float32 roundoff near
``MASS_EPS``. ``first_difference`` tells which, on the exact chain.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import require_real

#: A normalized q-column with squared norm below this is treated as zero
#: (the item was already in the selected span).
EPS = 1e-30

#: Total residual mass at or below this means the remaining columns span
#: nothing selectable: the sample stops instead of clamp-picking N-1.
MASS_EPS = 1e-6

#: Largest k_max the kernel takes: its "global_basis" route keeps 2 k²
#: floats a sample in device memory (128 MB at 4096), and indexes them
#: with 32-bit ints.
MAX_K = 4096

#: Threads per block of the kernel (one block per sample).
THREADS = 256

#: The routes of ``phase2_select_cuda``, in the order of the C launcher's
#: route code.
ROUTES = ("on_chip", "global", "global_basis")

#: The on-chip route's register tile: 4 rows of G1 by TN rows of Gr a
#: thread, TN the first of these that gives every tile a thread of the
#: block (else the last, and threads take several tiles).
TILE_ROWS = 4
TILE_COLS = (4, 8, 12, 16)

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0
_LAUNCH_LOCK = threading.Lock()


def fold_trailing(Gs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """(G_1, ..., G_m) -> (G_1, G_r): elementwise-product fold of the
    trailing factors, row-major — Gr[(n_2..n_m), c] = prod_{f>1} G_f[n_f, c].
    Works on unbatched (N_f, k) and batched (B, N_f, k) stacks alike."""
    if len(Gs) <= 2:
        return tuple(Gs)
    Gr = Gs[1]
    for G in Gs[2:]:
        k = Gr.shape[-1]
        Gr = (Gr[..., :, None, :] * G[..., None, :, :]).reshape(
            Gr.shape[:-2] + (Gr.shape[-2] * G.shape[-2], k))
    return (Gs[0], Gr)


def canonical_pair(Gs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly two factors: fold the trailing ones (m >= 3, once per
    sample), synthesize a ones() second factor for m = 1."""
    Gs = fold_trailing(Gs)
    if len(Gs) == 2:
        return Gs[0], Gs[1]
    G1 = Gs[0]
    ones = torch.ones(G1.shape[:-2] + (1, G1.shape[-1]), dtype=G1.dtype,
                      device=G1.device)
    return G1, ones


def phase2_select_plain(us: torch.Tensor, k_eff: torch.Tensor,
                        G1: torch.Tensor, Gr: torch.Tensor) -> torch.Tensor:
    """Batched PyTorch port of ``phase2_select_reference``.

    us (B, k_max) float32, k_eff (B,) int, G1 (B, N1, k_max),
    Gr (B, Nr, k_max) float32 -> (B, k_max) int32 picks, -1 padded.
    Each row follows the reference's while_loop exactly: it steps while
    t < k_eff and its residual mass has not collapsed, and stops for good
    at the first collapsed step. The loop ends when no row steps.
    The basis keeps its unused columns at zero; they take part in
    ``B @ (Bᵀ w)`` as in the reference.
    """
    nb, k_max = us.shape
    N1, Nr = int(G1.shape[1]), int(Gr.shape[1])
    N = N1 * Nr
    dev = us.device
    norms = ((G1 * G1) @ (Gr * Gr).transpose(1, 2)).reshape(nb, N)
    basis = torch.zeros((nb, k_max, k_max), dtype=us.dtype, device=dev)
    picks = torch.full((nb, k_max), -1, dtype=torch.int32, device=dev)
    live = torch.ones(nb, dtype=torch.bool, device=dev)
    rows = torch.arange(nb, device=dev)
    k_eff = k_eff.to(device=dev, dtype=torch.int64)
    for t in range(k_max):
        run = live & (t < k_eff)
        if not bool(run.any()):
            break
        csum = torch.cumsum(norms, dim=1)
        total = csum[:, -1]
        ok = run & (total > MASS_EPS)
        live = live & (ok | ~run)          # a collapsed row stops for good
        r = us[:, t] * total
        i = (csum <= r[:, None]).sum(dim=1).clamp_max(N - 1)
        w = G1[rows, i // Nr] * Gr[rows, i % Nr]
        bt = basis.transpose(1, 2)
        q = w - (basis @ (bt @ w[:, :, None]))[:, :, 0]
        q = q - (basis @ (bt @ q[:, :, None]))[:, :, 0]    # CGS2
        qn2 = (q * q).sum(dim=1, keepdim=True)
        q = torch.where(qn2 > EPS, q / torch.sqrt(torch.clamp_min(qn2, EPS)),
                        torch.zeros_like(q))
        ct = ((G1 * q[:, None, :]) @ Gr.transpose(1, 2)).reshape(nb, N)
        new = torch.clamp_min(norms - ct * ct, 0.0)
        new[rows, i] = 0.0
        norms = torch.where(ok[:, None], new, norms)
        basis[:, :, t] = torch.where(ok[:, None], q, basis[:, :, t])
        picks[:, t] = torch.where(ok, i.to(torch.int32), picks[:, t])
    return picks


def _check_cuda_inputs(us, k_eff, G1, Gr) -> Tuple[int, int, int, int]:
    tensors = {"us": us, "k_eff": k_eff, "G1": G1, "Gr": Gr}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"phase2_select_cuda: {name} must be a CUDA "
                             f"tensor, got {getattr(x, 'device', type(x))}")
        if x.device != us.device:
            raise ValueError(f"phase2_select_cuda: {name} is on {x.device}, "
                             f"us on {us.device}")
        if not x.is_contiguous():
            raise ValueError(f"phase2_select_cuda: {name} must be "
                             f"contiguous")
    for name in ("us", "G1", "Gr"):
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"phase2_select_cuda: {name} must be float32, "
                             f"got {tensors[name].dtype}")
    if k_eff.dtype != torch.int32:
        raise ValueError(f"phase2_select_cuda: k_eff must be int32, got "
                         f"{k_eff.dtype}")
    if us.dim() != 2 or k_eff.dim() != 1 or G1.dim() != 3 or Gr.dim() != 3:
        raise ValueError("phase2_select_cuda wants us (B, k), k_eff (B,), "
                         "G1 (B, N1, k), Gr (B, Nr, k)")
    nb, k = int(us.shape[0]), int(us.shape[1])
    if tuple(k_eff.shape) != (nb,) or G1.shape[0] != nb \
            or Gr.shape[0] != nb or G1.shape[2] != k or Gr.shape[2] != k:
        raise ValueError(
            f"phase2_select_cuda shape mismatch: us {tuple(us.shape)}, "
            f"k_eff {tuple(k_eff.shape)}, G1 {tuple(G1.shape)}, "
            f"Gr {tuple(Gr.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"phase2_select_cuda takes 1 <= k_max <= {MAX_K}, "
                         f"got {k}")
    N1, Nr = int(G1.shape[1]), int(Gr.shape[1])
    if N1 < 1 or Nr < 1 or N1 * Nr >= 2 ** 31:
        raise ValueError(f"phase2_select_cuda: N = {N1}*{Nr} out of range")
    return nb, N1, Nr, k


def onchip_geometry(N1: int, Nr: int, k: int) -> Tuple[int, int, int, int]:
    """``(TN, N1p, Pr, smem_bytes)`` of the on-chip route; mirrors
    ``onchip_geom`` in ``csrc/phase2_select.cu``. G1ᵀ (k, N1p) and Grᵀ
    (k, Pr) k-major, the norms as an (N1p, Pr) grid (N1p = N1 rounded up to
    TILE_ROWS, Pr = Nr to TN, padding held at zero), the k x k basis,
    three k-vectors and the 32 warp partials in floats, then 64 ints."""
    rows = -(-N1 // TILE_ROWS)
    tn = next((t for t in TILE_COLS if rows * -(-Nr // t) <= THREADS),
              TILE_COLS[-1])
    n1p, pr = rows * TILE_ROWS, -(-Nr // tn) * tn
    floats = k * n1p + k * pr + n1p * pr + k * k + 3 * k + 32
    return tn, n1p, pr, 4 * floats + 4 * 64


def global_smem_bytes(k: int, basis_in_smem: bool = True) -> int:
    """Shared memory of the global routes' block (``global_smem`` in
    ``csrc/phase2_select.cu``): the k x k basis where it lives there, three
    k-vectors, 32 warp partials and one spare k-vector in floats, then 64
    ints."""
    return 4 * ((k * k if basis_in_smem else 0) + 4 * k + 32) + 4 * 64


def phase2_select_route(N1: int, Nr: int, k: int,
                        limit: Optional[int] = None) -> str:
    """"on_chip" when the on-chip layout (``onchip_geometry``) fits
    ``limit`` bytes of shared memory a block, else "global" when the
    global route's basis does (``global_smem_bytes``), else
    "global_basis". ``limit`` None: the current CUDA device's opt-in
    limit, asked once per device (``_smem_optin``)."""
    if limit is None:
        limit = _smem_optin(torch.cuda.current_device())
    if onchip_geometry(N1, Nr, k)[3] <= limit:
        return ROUTES[0]
    return ROUTES[1] if global_smem_bytes(k) <= limit else ROUTES[2]


@functools.lru_cache(maxsize=None)
def _smem_optin(device_index: int) -> int:
    """The opt-in shared memory a block may use on this device, asked once;
    the query also raises both kernels' dynamic shared-memory caps to it,
    so that no launch queries or configures the device."""
    from ._build import load_library
    lib = load_library("phase2_select", bind)
    limit = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.phase2_select_prepare(ctypes.byref(limit))
    if rc != 0:
        msg = lib.phase2_select_error_string(rc).decode()
        raise RuntimeError(f"phase2_select device query failed: CUDA error "
                           f"{rc} ({msg})")
    return limit.value


def phase2_select_cuda(us: torch.Tensor, k_eff: torch.Tensor,
                       G1: torch.Tensor, Gr: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/phase2_select.cu``): one thread
    block per sample, on PyTorch's current stream, by the route
    ``phase2_select_route`` gives (the global routes' scratch is
    allocated here: the (B, N) norms, then on "global_basis" the
    (B, 2, k, k) basis). Same contract as ``phase2_select_plain``.
    Raises on CPU tensors, wrong dtypes, non-contiguous inputs, bad
    shapes, and a refused launch."""
    require_real("phase2_select_cuda", us, k_eff, G1, Gr)
    global launches
    nb, N1, Nr, k = _check_cuda_inputs(us, k_eff, G1, Gr)
    picks = torch.empty((nb, k), dtype=torch.int32, device=us.device)
    if nb == 0:
        return picks
    from ._build import load_library
    lib = load_library("phase2_select", bind)
    route = ROUTES.index(phase2_select_route(N1, Nr, k,
                                             _smem_optin(us.device.index)))
    scratch = None
    if route >= 1:      # the norms, then on "global_basis" B and Bᵀ
        scratch = torch.empty(nb * N1 * Nr + (route == 2) * nb * 2 * k * k,
                              dtype=torch.float32, device=us.device)
    stream = torch.cuda.current_stream(us.device).cuda_stream
    with torch.cuda.device(us.device):
        rc = lib.phase2_select_launch(
            us.data_ptr(), k_eff.data_ptr(), G1.data_ptr(), Gr.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            picks.data_ptr(), nb, N1, Nr, k, THREADS, route, stream)
    if rc != 0:
        msg = lib.phase2_select_error_string(rc).decode()
        raise RuntimeError(f"phase2_select kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    with _LAUNCH_LOCK:
        launches += 1
    return picks


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/phase2_select.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.phase2_select_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                         p]
    lib.phase2_select_launch.restype = ctypes.c_int
    lib.phase2_select_prepare.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.phase2_select_prepare.restype = ctypes.c_int
    lib.phase2_select_onchip_bytes.argtypes = [
        i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.phase2_select_onchip_bytes.restype = ctypes.c_int
    lib.phase2_select_error_string.argtypes = [ctypes.c_int]
    lib.phase2_select_error_string.restype = ctypes.c_char_p


# ---------------------------------------------------------------------------
# diagnosis: how close a draw came to a CDF boundary
# ---------------------------------------------------------------------------

def cdf_at_step(us_row, G1, Gr, prefix: Sequence[int]):
    """Replay one sample's chain in float64 along the picks ``prefix`` and
    return ``(csum, r, total)`` of the step that follows it. us_row (k,),
    G1 (N1, k), Gr (Nr, k): numpy arrays or tensors."""
    us_row, G1, Gr = (np.asarray(torch.as_tensor(x).detach().cpu(),
                                 np.float64) for x in (us_row, G1, Gr))
    k = G1.shape[1]
    Nr = Gr.shape[0]
    norms = ((G1 * G1) @ (Gr * Gr).T).reshape(-1)
    basis = np.zeros((k, k))
    for t, i in enumerate(prefix):
        w = G1[i // Nr] * Gr[i % Nr]
        q = w - basis @ (basis.T @ w)
        q = q - basis @ (basis.T @ q)
        qn2 = float(q @ q)
        q = q / np.sqrt(qn2) if qn2 > EPS else np.zeros_like(q)
        basis[:, t] = q
        ct = ((G1 * q[None, :]) @ Gr.T).reshape(-1)
        norms = np.maximum(norms - ct * ct, 0.0)
        norms[i] = 0.0
    csum = np.cumsum(norms)
    total = float(csum[-1])
    return csum, float(us_row[len(prefix)]) * total, total


def first_difference(us_row, G1, Gr, picks_a, picks_b):
    """Why two pick rows of one sample differ, judged on the exact chain
    (float64 replay along their common prefix). None for equal rows, else
    ``(t, kind, value)`` at the first differing step t:

    * ``"boundary"`` — both picked, different items. ``value`` is the
      largest distance, relative to the step's total mass, between
      ``r = us[t]·total`` and the CDF boundaries csum[j] that separate the
      two picks (j from the smaller pick to the larger minus one).
    * ``"collapse"`` — one row stopped (-1) where the other picked.
      ``value`` is the exact chain's residual mass at step t.

    ``is_roundoff_tie`` says whether the difference is float32 roundoff.
    """
    a = np.asarray(torch.as_tensor(picks_a).cpu())
    b = np.asarray(torch.as_tensor(picks_b).cpu())
    diff = np.nonzero(a != b)[0]
    if diff.size == 0:
        return None
    t = int(diff[0])
    csum, r, total = cdf_at_step(us_row, G1, Gr, [int(x) for x in a[:t]])
    if a[t] < 0 or b[t] < 0:
        return t, "collapse", total
    lo, hi = sorted((int(a[t]), int(b[t])))
    gap = float(np.max(np.abs(r - csum[lo:hi])))
    return t, "boundary", gap / max(total, 1e-300)


#: A boundary gap at or below this (relative to the step's total mass) is
#: float32 roundoff: the two versions sum the cumsum in different orders.
BOUNDARY_TOL = 1e-5


def is_roundoff_tie(kind: str, value: float) -> bool:
    """A ``first_difference`` that float32 rounding explains: a draw on a
    CDF boundary, or a step whose exact residual mass is already at or
    below ``MASS_EPS`` (so the float32 total sits on the stop threshold)."""
    if kind == "boundary":
        return value <= BOUNDARY_TOL
    return value <= MASS_EPS
