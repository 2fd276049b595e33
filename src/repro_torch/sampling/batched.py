"""Batched exact KronDPP sampling (port of ``repro/sampling/batched.py``).

phase 1  Bernoulli draw over the product spectrum, computed factor-wise as
         an O(N) log-eigenvalue vector; the selected eigen-indices are
         compacted into (k_max,) slots with a validity mask, and draws
         whose |J| exceeds k_max carry a truncation flag. The selected
         eigenvectors stay in *factored* form: one gathered column block
         per factor, O(sum N_f k) numbers per sample.
phase 2  The projection-DPP chain rule, the whole batch in one call to
         ``kernels.ops.phase2_select``: the hand-written CUDA kernel for
         tensors on the card, its plain PyTorch version on the CPU.

The batch dimension is written out (the JAX package vmaps one sample).
``sample_krondpp_from_uniforms`` takes every uniform as a tensor, so a
test can feed it the numbers JAX drew; ``sample_krondpp_batched`` draws
them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.kron import split_indices_multi
from ..kernels import ops as kernel_ops
from .spectral import FactorSpectrum, log_product_spectrum


def compact_selection(mask: torch.Tensor, k_max: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of up to k_max True entries of each row of ``mask``
    ((N,) or (B, N)), left-packed.

    Returns (sel (..., k_max) int32, valid (..., k_max) bool,
    truncated (...) bool). One cumsum plus k_max binary searches
    (``searchsorted(side="left")`` finds the c-th True); if more than
    k_max entries are set, the lowest indices win and ``truncated`` is
    True. ``sel`` is clamped to N - 1 in slots past the count.
    """
    N = mask.shape[-1]
    cs = torch.cumsum(mask.to(torch.int64), dim=-1)
    ranks = torch.arange(1, k_max + 1, dtype=torch.int64, device=mask.device)
    ranks = ranks.expand(cs.shape[:-1] + (k_max,)).contiguous()
    sel = torch.searchsorted(cs.contiguous(), ranks, side="left")
    count = cs[..., -1:]
    valid = ranks <= count
    truncated = count[..., 0] > k_max
    return sel.clamp_max(N - 1).to(torch.int32), valid, truncated


def gather_factor_columns(spectrum_vecs: Sequence[torch.Tensor],
                          sizes: Sequence[int], sel: torch.Tensor,
                          valid: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The selected eigenvectors in factored form: G_f = P_f[:, idx_f],
    (N_f, k_max) each, or (B, N_f, k_max) for a batch of ``sel`` rows.
    Invalid slots are zeroed in the first factor (the column products
    then vanish everywhere downstream)."""
    parts = split_indices_multi(sel.to(torch.int64), sizes)
    Gs = []
    for P, p in zip(spectrum_vecs, parts):
        G = P[:, p]                               # (N_f, [B,] k_max)
        if sel.dim() == 2:
            G = G.permute(1, 0, 2).contiguous()   # (B, N_f, k_max)
        Gs.append(G)
    Gs[0] = Gs[0] * valid.unsqueeze(-2).to(Gs[0].dtype)
    return tuple(Gs)


def _phase1_from_uniforms(u: torch.Tensor, us: torch.Tensor,
                          lams: Sequence[torch.Tensor],
                          vecs: Sequence[torch.Tensor], k_max: int):
    """Phase 1 for a batch from its uniforms (port of ``_phase1_one``).

    u (B, N) picks the eigen-indices (u < sigmoid(log λ)); us (B, k_max)
    passes through to phase 2. Returns (us, Gs, k_eff (B,) int32,
    truncated (B,) bool)."""
    sizes = tuple(int(lam.shape[0]) for lam in lams)
    ll = log_product_spectrum(tuple(lams))
    mask = u < torch.sigmoid(ll)[None, :]
    sel, valid, truncated = compact_selection(mask, k_max)
    k_eff = torch.clamp_max(mask.sum(dim=-1), k_max).to(torch.int32)
    Gs = gather_factor_columns(vecs, sizes, sel, valid)
    return us, Gs, k_eff, truncated


def sample_krondpp_from_uniforms(u: torch.Tensor, us: torch.Tensor,
                                 spectrum: FactorSpectrum, k_max: int,
                                 backend: Optional[str] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Exact KronDPP draws from given uniforms: u (B, N) for phase 1,
    us (B, k_max) for phase 2, on the spectrum's device.

    Returns (picks (B, k_max) int32 with -1 padding, counts (B,) int32,
    truncated (B,) bool). ``backend`` selects the phase-2 engine
    (``kernels.ops.phase2_select``)."""
    us, Gs, k_eff, truncated = _phase1_from_uniforms(
        u, us, spectrum.lams, spectrum.vecs, int(k_max))
    picks = kernel_ops.phase2_select(us, Gs, spectrum.sizes, k_eff,
                                     backend=backend)
    return picks, k_eff, truncated


def sample_krondpp_batched(generator: torch.Generator,
                           spectrum: FactorSpectrum,
                           k_max: Optional[int] = None,
                           num_samples: int = 1,
                           backend: Optional[str] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Draw ``num_samples`` exact KronDPP samples in one batched call on
    the spectrum's device; ``generator`` must live on that device.

    Returns (picks (num_samples, k_max) int32 with -1 padding,
    counts (num_samples,) int32, truncated (num_samples,) bool — True
    for draws whose |J| overflowed k_max and were clipped)."""
    if k_max is None:
        k_max = spectrum.suggested_k_max()
    dev = spectrum.device
    u = torch.rand((num_samples, spectrum.N), generator=generator,
                   dtype=torch.float32, device=dev)
    us = torch.rand((num_samples, int(k_max)), generator=generator,
                    dtype=torch.float32, device=dev)
    return sample_krondpp_from_uniforms(u, us, spectrum, int(k_max),
                                        backend=backend)


def picks_to_lists(picks: torch.Tensor) -> List[List[int]]:
    """(B, k_max) padded picks -> python lists (host boundary)."""
    arr = picks.cpu().numpy()
    return [row[row >= 0].tolist() for row in arr]
