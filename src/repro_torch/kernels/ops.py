"""Public wrappers around the kernels (port of ``repro/kernels/ops.py``).

The dispatch rule: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version — decided by where the
tensor lies, never by whether a build or a launch worked. Each dispatch
emits a ``kernels.<op>.<engine>`` counter through ``obs.current_tracker()``
(once per executed call; the JAX package counts once per compiled
specialization).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import obs
from .partial_trace import (partial_trace_A_cuda, partial_trace_A_plain,
                            partial_trace_C_cuda, partial_trace_C_plain)
from .phase2_select import (canonical_pair, phase2_select_cuda,
                            phase2_select_plain)


def _count_dispatch(op: str, engine: str) -> None:
    obs.current_tracker().counter(f"kernels.{op}.{engine}")


def _resolve_backend(op: str, x: torch.Tensor, name: str,
                     backend: Optional[str]) -> str:
    """None -> "cuda" for a CUDA tensor ``x``, "reference" otherwise;
    "reference" and "cuda" pass through; "cuda" on a CPU tensor and any
    other value raise ``ValueError``. Emits the dispatch counter."""
    if backend is None:
        backend = "cuda" if x.is_cuda else "reference"
    if backend not in ("reference", "cuda"):
        raise ValueError(f"{op} backend must be None, 'reference' or "
                         f"'cuda', got {backend!r}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"{op} backend='cuda' needs CUDA tensors, got "
                         f"{name} on {x.device}")
    _count_dispatch(op, backend)
    return backend


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
    if _resolve_backend("partial_trace_A", theta, "theta",
                        backend) == "reference":
        return partial_trace_A_plain(theta4, L2)
    return partial_trace_A_cuda(theta4.contiguous(), L2.contiguous())


def partial_trace_C(theta: torch.Tensor, L1: torch.Tensor, N1: int, N2: int,
                    backend: Optional[str] = None) -> torch.Tensor:
    """C[u,v] = Σ_{i,j} L1[i,j] Θ4[i,u,j,v] of the N x N ``theta``
    -> (N2, N2). ``backend`` as for ``phase2_select``."""
    theta4 = theta.reshape(N1, N2, N1, N2)
    if _resolve_backend("partial_trace_C", theta, "theta",
                        backend) == "reference":
        return partial_trace_C_plain(theta4, L1)
    return partial_trace_C_cuda(theta4.contiguous(), L1.contiguous())
