"""Exact k-DPP sampling on the factored spectrum (port of
``repro/sampling/kdpp.py``; Kulesza & Taskar Alg. 8).

A k-DPP conditions the DPP on |Y| = k. Phase 1 becomes a sequential draw
over the N eigenvalues using elementary symmetric polynomials (ESPs):
processing eigenvalues from last to first, include eigenvalue n with

    P(include) = λ_n · e_{k-1}(λ_1..λ_{n-1}) / e_k(λ_1..λ_n),

decrementing k on inclusion, so exactly k eigenvectors survive. The ESP
table is computed in log space (ESPs of 10^4 eigenvalues overflow float32
long before N does) once per call, for the whole batch. Phase 2 is shared
with ``batched.py``: factored column gather, then one batched
``kernels.ops.phase2_select`` call (the CUDA kernel on the card, its plain
version on the CPU).

The batch dimension is written out (the JAX package vmaps one sample),
and both sequential scans of the JAX file are re-ordered so that eager
PyTorch runs O(k) tensor steps instead of O(N), with the same arithmetic
per element:

* the ESP table column by column, each a ``logcumsumexp`` over n of the
  previous column (the row recursion e_j^n = e_j^{n-1} + λ_n e_{j-1}^{n-1}
  read along n);
* the backward draw one inclusion at a time: while k_rem is fixed the
  inclusion probability of each remaining n is known, so the next
  inclusion is the largest n below the last one whose uniform is below
  p_n.

``sample_kdpp_from_uniforms`` takes every uniform as a tensor, so a test
can feed it the numbers JAX drew. The sampling entry points take a PRNG
key (``repro_torch.random``), whose uniforms are the JAX package's for the
same key (per row ``k1, k2 = split(key)``, u = uniform(k1, (N,)),
us = uniform(k2, (k,)); the scan order of ``u`` above is the JAX scan's),
or a ``torch.Generator``, whose uniforms come from ``torch.rand``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import random as prng
from ..kernels import ops as kernel_ops
from .batched import (is_mesh_runtime, compact_selection, gather_factor_columns,
                      keyed_uniforms, refuse_generator_on_mesh)
from .spectral import FactorSpectrum, log_product_spectrum


def log_esp_table(log_lam: torch.Tensor, k: int) -> torch.Tensor:
    """log e_j(λ_1..λ_n) for n = 0..N, j = 0..k — shape (N+1, k+1).

    ``log_lam`` may hold -inf (zero eigenvalues); the recursion is pure
    log-add-exp, so those contribute nothing. Column j is the running
    log-sum-exp over n of column j-1 shifted by log λ_n."""
    N = int(log_lam.shape[0])
    table = torch.full((N + 1, k + 1), float("-inf"), dtype=log_lam.dtype,
                       device=log_lam.device)
    table[:, 0] = 0.0
    for j in range(1, k + 1):
        table[1:, j] = torch.logcumsumexp(table[:-1, j - 1] + log_lam, dim=0)
    return table


def _phase1_kdpp_from_uniforms(u: torch.Tensor, log_lam: torch.Tensor,
                               k: int) -> torch.Tensor:
    """Conditional eigenvalue draw from the uniforms u (N,) or (B, N):
    a bool mask of u's shape with exactly min(k, rank) entries set per row.

    |Y| = k conditions on a zero-probability event when the kernel has
    fewer than k nonzero eigenvalues (every e_k denominator is -inf), so
    below rank the draw degrades to the largest achievable size,
    k0 = min(k, #finite log λ), and phase 2 pads the rest with -1.

    Same per-element arithmetic as the JAX scan over n = N..1
    (``p = exp(min(log λ_n + T[n-1, k_rem-1] - T[n, k_rem], 0))``, zero
    where k_rem = 0 or T[n, k_rem] = -inf; include when the step's uniform
    is below p), taken one inclusion at a time: k steps of (B, N) tensor
    work. As in the JAX scan, the uniforms are consumed in scan order, so
    item n-1 meets u[N-n]."""
    k = int(k)
    batched = u.dim() == 2
    U = torch.flip(u if batched else u[None], dims=(1,))  # [n-1]: u[N-n]
    B, N = int(U.shape[0]), int(U.shape[1])
    dev = U.device
    table = log_esp_table(log_lam, k)
    k0 = torch.clamp_max(torch.isfinite(log_lam).sum(), k)
    k_rem = k0.expand(B).clone()
    n_idx = torch.arange(1, N + 1, device=dev)            # n of item n-1
    pos = torch.full((B,), N, dtype=torch.int64, device=dev)
    mask = torch.zeros((B, N), dtype=torch.bool, device=dev)
    before = table[:-1].t()                               # [j, n-1]
    upto = table[1:].t()                                  # [j, n]
    for _ in range(k):
        log_num = log_lam[None, :] + before[torch.clamp_min(k_rem - 1, 0)]
        log_den = upto[k_rem]
        p = torch.exp(torch.clamp_max(log_num - log_den, 0.0))
        p = torch.where((k_rem > 0)[:, None] & torch.isfinite(log_den), p,
                        0.0)
        inc = (U < p) & (n_idx[None, :] <= pos[:, None])
        last = torch.where(inc, n_idx[None, :], 0).amax(dim=1)  # 0: none
        mask |= n_idx[None, :] == last[:, None]
        hit = last > 0
        k_rem = k_rem - hit.to(k_rem.dtype)
        pos = torch.where(hit, last - 1, 0)   # no inclusion: the scan is over
    return mask if batched else mask[0]


def _phase1_kdpp(generator: torch.Generator, log_lam: torch.Tensor, k: int,
                 num_samples: Optional[int] = None) -> torch.Tensor:
    """``_phase1_kdpp_from_uniforms`` on N uniforms per sample drawn from
    ``generator`` (on log_lam's device): (N,) or (num_samples, N)."""
    N = int(log_lam.shape[0])
    shape = (N,) if num_samples is None else (int(num_samples), N)
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=log_lam.device)
    return _phase1_kdpp_from_uniforms(u, log_lam, k)


def _select_kdpp(mask: torch.Tensor, us: torch.Tensor,
                 spectrum: FactorSpectrum, k: int,
                 backend: Optional[str]) -> torch.Tensor:
    """Phase 2 of the drawn masks: compaction into k slots (the ESP draw
    sets at most k entries, so nothing is truncated), factored column
    gather, one ``phase2_select`` call."""
    sel, valid, _ = compact_selection(mask, k)
    Gs = gather_factor_columns(spectrum.vecs, spectrum.sizes, sel, valid)
    k_eff = mask.sum(dim=-1).to(torch.int32)
    return kernel_ops.phase2_select(us, Gs, spectrum.sizes, k_eff,
                                    backend=backend)


def sample_kdpp_from_uniforms(u: torch.Tensor, us: torch.Tensor,
                              spectrum: FactorSpectrum, k: int,
                              backend: Optional[str] = None
                              ) -> torch.Tensor:
    """Exact k-DPP draws from given uniforms: u (B, N) for phase 1,
    us (B, k) for phase 2 (or one sample: (N,) and (k,)), on the
    spectrum's device. Returns int32 picks of us's shape, -1 padded below
    rank. ``backend`` selects the phase-2 engine."""
    mask = _phase1_kdpp_from_uniforms(u, log_product_spectrum(spectrum.lams),
                                      int(k))
    return _select_kdpp(mask, us, spectrum, int(k), backend)


def _keyed_kdpp_rows(keys: torch.Tensor, spectrum: FactorSpectrum,
                     k: int, backend: Optional[str]) -> torch.Tensor:
    """The k-DPP rows of keys already on the spectrum's device."""
    u, us = keyed_uniforms(keys, spectrum.N, k)
    return sample_kdpp_from_uniforms(u, us, spectrum, k, backend)


def sample_kdpp_batched(key, spectrum: FactorSpectrum, k: int,
                        num_samples: int = 1,
                        backend: Optional[str] = None,
                        runtime=None) -> torch.Tensor:
    """``num_samples`` exact k-DPP samples in one batched call on the
    spectrum's device, from a PRNG key (the JAX package's rows for the same
    key) or a ``torch.Generator`` on that device.

    Returns (num_samples, k) int32: every row has exactly k distinct items
    when the kernel has rank >= k; below rank exactly rank distinct items
    and trailing -1 padding (never duplicates, never an empty degenerate
    row). Phase 2 for the whole batch is one ``kernels.ops.phase2_select``
    call (``backend`` forces an engine). Under a ``repro_torch.dpp.runtime``
    ``Mesh`` the rows' keys are cut into shards (``runtime.map_keys``), one
    phase-2 call a shard, and the draws equal the one-device call's bit
    for bit; a generator is refused there (``ValueError``)."""
    k = int(k)
    # duck-typed dispatch, as in sample_krondpp_batched: a low-rank dual
    # spectrum runs the conditional draw on its r dual eigenvalues
    kdpp_hook = getattr(spectrum, "sample_rows_kdpp", None)
    if not isinstance(key, torch.Generator):
        keys = prng.split(prng.as_key(key, spectrum.device),
                          int(num_samples))
        if kdpp_hook is not None:
            return kdpp_hook(keys, k, backend=backend, runtime=runtime)
        if is_mesh_runtime(runtime):
            return runtime.map_keys(
                lambda ks, ops: _keyed_kdpp_rows(ks, FactorSpectrum(*ops), k,
                                                 backend),
                keys, operands=(tuple(spectrum.lams), tuple(spectrum.vecs)),
                static_key=("sample_kdpp_batched", k, backend))
        return _keyed_kdpp_rows(keys, spectrum, k, backend)
    if kdpp_hook is not None:
        return kdpp_hook(key, k, backend=backend,
                         num_samples=int(num_samples), runtime=runtime)
    refuse_generator_on_mesh(runtime)
    mask = _phase1_kdpp(key, spectrum.log_eigenvalues(), k, num_samples)
    us = torch.rand((int(num_samples), k), generator=key,
                    dtype=torch.float32, device=spectrum.device)
    return _select_kdpp(mask, us, spectrum, k, backend)


def sample_kdpp_dense(key, L: torch.Tensor, k: int) -> torch.Tensor:
    """One exact k-DPP sample (k,) int32 from a dense kernel L, on L's
    device (the m = 1 spectrum: one ``eigh``), from a PRNG key (drawn as
    the JAX package draws one sample: ``k1, k2 = split(key)``) or a
    ``torch.Generator``.

    The JAX version pins phase 2 to its reference engine because that one
    is transparent to ``vmap``; PyTorch has no such constraint here, so
    phase 2 takes the default dispatch: the CUDA kernel for a CUDA L, the
    plain version on the CPU."""
    lam, vec = torch.linalg.eigh(L)
    spectrum = FactorSpectrum((torch.clamp_min(lam, 0.0),), (vec,))
    k = int(k)
    if not isinstance(key, torch.Generator):
        u, us = keyed_uniforms(prng.as_key(key, L.device)[None],
                               spectrum.N, k)
        return sample_kdpp_from_uniforms(u[0], us[0], spectrum, k)
    mask = _phase1_kdpp(key, spectrum.log_eigenvalues(), k)
    us = torch.rand((k,), generator=key, dtype=torch.float32,
                    device=L.device)
    return _select_kdpp(mask, us, spectrum, k, None)
