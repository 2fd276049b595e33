"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

The dispatch rule: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version — decided by where the
tensor lies, never by whether a build or a launch worked. Each dispatch
runs inside a ``kernels.<op>`` region on the profiler's timeline while it
records (``obs.spans.profiler_region``), so each wrapper's device time
reads off a trace, and, where a tracker listens, emits a
``kernels.<op>.<engine>`` counter through ``obs.current_tracker()``
(once per executed call; the JAX package counts once per compiled
specialization).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import obs
from .greedy_map import (greedy_map_kdpp_cuda, greedy_map_kdpp_plain,
                         greedy_map_update_cuda, greedy_map_update_plain)
from .kron_matvec import kron_matvec_cuda, kron_matvec_plain
from .partial_trace import (partial_trace_A_cuda, partial_trace_A_plain,
                            partial_trace_C_cuda, partial_trace_C_plain)
from .phase2_select import (canonical_pair, phase2_select_cuda,
                            phase2_select_plain)
from .theta_scatter import theta_scatter_cuda, theta_scatter_plain
from .threefry import threefry2x32_cuda, threefry2x32_plain


def _dispatch_span(op: str, engine: str, counted: Optional[str] = None):
    """One dispatch of ``op`` to ``engine``: where a tracker listens, the
    ``kernels.<counted or op>.<engine>`` counter; returns the
    ``kernels.<op>`` span around the dispatch, which only the profiler
    sees (``NULL_SPAN`` while it does not record)."""
    tracker = obs.current_tracker()
    if obs.enabled(tracker):
        tracker.counter(f"kernels.{counted or op}.{engine}")
    return obs.spans.profiler_region("kernels." + op)


def _resolve_backend(op: str, x: torch.Tensor, name: str,
                     backend: Optional[str]) -> str:
    """None -> "cuda" for a CUDA tensor ``x``, "reference" otherwise;
    "reference" and "cuda" pass through; "cuda" on a CPU tensor and any
    other value raise ``ValueError``."""
    if backend is None:
        backend = "cuda" if x.is_cuda else "reference"
    if backend not in ("reference", "cuda"):
        raise ValueError(f"{op} backend must be None, 'reference' or "
                         f"'cuda', got {backend!r}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"{op} backend='cuda' needs CUDA tensors, got "
                         f"{name} on {x.device}")
    return backend


# ---------------------------------------------------------------------------
# threefry2x32 (the bits of every keyed draw, ``repro_torch.random``)
# ---------------------------------------------------------------------------

def threefry2x32(keys: torch.Tensor, n: int, mode: str,
                 data: Optional[torch.Tensor] = None, minval: float = 0.0,
                 maxval: float = 1.0, n2: int = 0,
                 backend: Optional[str] = None):
    """The threefry2x32 hash of each key row's counters 0..n-1 (or, in
    mode "fold", of the pair (0, data[r])): keys (R, 2) int64 of uint32
    words. ``mode`` and the shapes returned as in ``kernels.threefry``
    ("split_uniform" returns two tensors, of n and n2 columns);
    ``backend`` as for ``phase2_select``."""
    backend = _resolve_backend("threefry2x32", keys, "keys", backend)
    with _dispatch_span("threefry2x32", backend):
        if backend == "reference":
            return threefry2x32_plain(keys, n, mode, data, minval, maxval,
                                      n2)
        return threefry2x32_cuda(
            keys.contiguous(), n, mode,
            None if data is None else data.contiguous(), minval, maxval, n2)


# ---------------------------------------------------------------------------
# kron_matvec (explicit Kronecker eigenvectors)
# ---------------------------------------------------------------------------

def kron_matvec(A: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                backend: Optional[str] = None) -> torch.Tensor:
    """Batched (A ⊗ B) X[b]; X (batch, N1·N2) float32 or bfloat16, output
    in X's dtype. ``backend`` as for ``phase2_select``."""
    backend = _resolve_backend("kron_matvec", X, "X", backend)
    with _dispatch_span("kron_matvec", backend):
        if backend == "reference":
            return kron_matvec_plain(A, B, X)
        return kron_matvec_cuda(A.contiguous(), B.contiguous(),
                                X.contiguous())


def kron_eigvec_batch(P1: torch.Tensor, P2: torch.Tensor, i: torch.Tensor,
                      j: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Columns of P1 ⊗ P2 at the index pairs (i, j), (k,) each -> (N, k).

    (P1 ⊗ P2) vec(e_i e_jᵀ) = vec(P1[:, i] P2[:, j]ᵀ): on a CUDA tensor
    (or with an explicit ``backend``) the one-hot batch goes through
    ``kron_matvec``, as the JAX package does on the TPU; on a CPU tensor
    the gather and outer product, O(N k) instead of O(N (N1+N2) k)."""
    N1, N2 = int(P1.shape[0]), int(P2.shape[0])
    k = int(i.shape[0])
    if P1.is_cuda or backend is not None:
        E = torch.zeros((k, N1 * N2), dtype=P1.dtype, device=P1.device)
        E[torch.arange(k, device=P1.device), i.long() * N2 + j.long()] = 1.0
        return kron_matvec(P1, P2, E, backend=backend).T
    return (P1[:, i.long()][:, None, :] * P2[:, j.long()][None, :, :]
            ).reshape(N1 * N2, k)


def phase2_select(us: torch.Tensor, Gs: Sequence[torch.Tensor],
                  sizes: Sequence[int], k_eff,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Projection-DPP phase-2 selection — the ops-level dispatch point.

    us:    (k_max,) or (B, k_max) per-step uniforms.
    Gs:    factored eigenvector columns, each (N_f, k_max) or
           (B, N_f, k_max) (``gather_factor_columns``).
    k_eff: () or (B,) live step counts.
    Returns int32 picks of shape us.shape, -1 in padded/dead slots.

    backend: None — the CUDA kernel for CUDA tensors, the plain version
        for CPU tensors; "reference" — the plain version on any device;
        "cuda" — the kernel, which raises on CPU tensors.
    """
    got = tuple(int(G.shape[-2]) for G in Gs)
    if got != tuple(int(s) for s in sizes):
        raise ValueError(f"sizes {tuple(sizes)} inconsistent with the "
                         f"factor-column row counts {got}")
    backend = _resolve_backend("phase2_select", us, "us", backend)
    with _dispatch_span("phase2_select", backend):
        batched = us.dim() == 2
        k_eff = torch.as_tensor(k_eff, device=us.device).to(torch.int32)
        if not batched:
            Gs = tuple(G[None] for G in Gs)
            us, k_eff = us[None], k_eff.reshape(1)
        G1, Gr = canonical_pair(tuple(Gs))
        if backend == "reference":
            picks = phase2_select_plain(us, k_eff, G1, Gr)
        else:
            picks = phase2_select_cuda(us.contiguous(), k_eff.contiguous(),
                                       G1.contiguous(), Gr.contiguous())
    return picks if batched else picks[0]


# ---------------------------------------------------------------------------
# partial traces (KrK-Picard dense-Θ batch route)
# ---------------------------------------------------------------------------

def partial_trace_A(theta: torch.Tensor, L2: torch.Tensor, N1: int, N2: int,
                    backend: Optional[str] = None) -> torch.Tensor:
    """A[k,l] = Σ_{u,v} Θ4[k,u,l,v] L2[v,u] of the N x N ``theta``
    (N = N1·N2) -> (N1, N1). ``backend`` as for ``phase2_select``."""
    theta4 = theta.reshape(N1, N2, N1, N2)
    backend = _resolve_backend("partial_trace_A", theta, "theta", backend)
    with _dispatch_span("partial_trace_A", backend):
        if backend == "reference":
            return partial_trace_A_plain(theta4, L2)
        return partial_trace_A_cuda(theta4.contiguous(), L2.contiguous())


def partial_trace_C(theta: torch.Tensor, L1: torch.Tensor, N1: int, N2: int,
                    backend: Optional[str] = None) -> torch.Tensor:
    """C[u,v] = Σ_{i,j} L1[i,j] Θ4[i,u,j,v] of the N x N ``theta``
    -> (N2, N2). ``backend`` as for ``phase2_select``."""
    theta4 = theta.reshape(N1, N2, N1, N2)
    backend = _resolve_backend("partial_trace_C", theta, "theta", backend)
    with _dispatch_span("partial_trace_C", backend):
        if backend == "reference":
            return partial_trace_C_plain(theta4, L1)
        return partial_trace_C_cuda(theta4.contiguous(), L1.contiguous())


# ---------------------------------------------------------------------------
# dense Θ (the dense-Θ route, full and joint Picard)
# ---------------------------------------------------------------------------

def theta_scatter(N: int, idx: torch.Tensor, mask: torch.Tensor,
                  inv: torch.Tensor,
                  backend: Optional[str] = None) -> torch.Tensor:
    """The dense Θ = (1/n) Σ_s U_s (mask_s ⊙ inv_s) U_sᵀ (N x N) of
    idx (n, k), mask (n, k) and the inverses inv (n, k, k): on a CUDA
    tensor one launch of ``theta_scatter_cuda``, which never touches a
    padded slot; on a CPU tensor the accumulating ``index_put_`` of
    ``theta_scatter_plain``. ``backend`` as for ``phase2_select``."""
    backend = _resolve_backend("theta_scatter", inv, "inv", backend)
    with _dispatch_span("theta_scatter", backend):
        if backend == "reference":
            return theta_scatter_plain(N, idx, mask, inv)
        return theta_scatter_cuda(N, idx, mask, inv.contiguous())


# ---------------------------------------------------------------------------
# greedy MAP (k-DPP): the update step, and the whole selection in one launch
# ---------------------------------------------------------------------------

def greedy_map_update(lcol: torch.Tensor, C: torch.Tensor, cj: torch.Tensor,
                      dj: torch.Tensor, d: torch.Tensor,
                      backend: Optional[str] = None):
    """One fast-greedy MAP step -> (e, d_new): lcol (N,), C (N, k) (any
    strides), cj (k,), dj (1,), d (N,). ``backend`` as for
    ``phase2_select``."""
    backend = _resolve_backend("greedy_map_update", d, "d", backend)
    with _dispatch_span("greedy_map_update", backend):
        if backend == "reference":
            return greedy_map_update_plain(lcol, C, cj, dj, d)
        return greedy_map_update_cuda(lcol.contiguous(), C, cj.contiguous(),
                                      dj.contiguous(), d.contiguous())


def greedy_map_kdpp(L: torch.Tensor, k: int,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Greedy MAP selection of k items (Chen et al. 2018 fast greedy) of L
    (N, N), or of each matrix of a batch L (H, N, N): (k,) or (H, k) int32
    picks on L's device, each matrix's the port of the JAX
    ``ops.greedy_map_kdpp`` (the batch that of its ``vmap``).

    On a CUDA tensor one launch of ``greedy_map_kdpp_cuda`` runs every step
    of every matrix; on a CPU tensor (or with ``backend="reference"``)
    ``greedy_map_kdpp_plain`` runs the k-step loop over the plain update.
    ``backend`` as for ``phase2_select``. The span is
    ``kernels.greedy_map_kdpp``; the dispatch counter keeps the
    reference's name, ``kernels.greedy_map_update.<engine>``, once a call
    (the JAX package counts the step once per traced ``scan``).

    With k > N every path gives the reference's answer: the N picks, then
    k - N zeros (past N its argmax over all ``-inf`` takes item 0). On the
    card the kernel selects min(k, N) and the picks are padded with int32
    zeros on L's device."""
    backend = _resolve_backend("greedy_map_update", L, "L", backend)
    with _dispatch_span("greedy_map_kdpp", backend,
                        counted="greedy_map_update"):
        if backend == "reference":
            return greedy_map_kdpp_plain(L, k)
        k, N = int(k), int(L.shape[-1])
        picks = greedy_map_kdpp_cuda(L.contiguous(), min(k, N))
        if k <= N:
            return picks
        pad = torch.zeros(picks.shape[:-1] + (k - N,), dtype=picks.dtype,
                          device=picks.device)
        return torch.cat([picks, pad], -1)
