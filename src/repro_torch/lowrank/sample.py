"""Batched dual-space sampling for low-rank kernels, O(Nr) a step (port of
``repro/lowrank/sample.py``).

The exact-DPP pipeline of ``sampling.batched`` moved to the rank-r dual:
phase 1 draws eigen-indices over the r dual eigenvalues (Bernoulli for the
DPP, the shared ESP draw for the k-DPP); phase 2 runs the projection-DPP
chain rule of ``phase2_select_plain`` (the same CGS2, ``EPS``/``MASS_EPS``,
inverse-CDF ``searchsorted(side="right")`` and -1 padding), except that the
orthonormal basis lives in r-dimensional coefficient space and rows of the
implicit eigenvector matrix U = φ·Γ are projected through φ on demand. A
step is one O(r·k) row product and one O(Nr) product per row; the N×N
kernel and its N-dimensional eigenvectors never exist.

This is plain PyTorch on every device: the JAX package has no kernel here
(``_check_backend`` refuses a fused engine). The batch dimension is written
out, and phase 2 is a fixed loop of ``k_max`` steps in which each row is
masked by ``(t < k_eff) & alive``, what the JAX package's vmapped
``while_loop`` computes: no step waits for the host.

Memory: the residual norms start as a sum over the k_max selected columns,
one (B, N) column at a time; ``((φΓ)²).sum(-1)`` would form a (B, N, k_max)
transient.

``sample_dual_from_uniforms`` takes every uniform as a tensor. The keyed
functions draw them as the JAX package's ``_phase1_dual_one`` does —
``k1, k2 = split(key)``, u = uniform(k1, (r,)), us = uniform(k2, (k_max,))
(``keyed_uniforms``, one ``threefry2x32`` launch on the card) — so a key
gives the JAX package's rows; the generator functions draw with
``torch.rand``, as the Kron path does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import random as prng
from ..kernels.phase2_select import EPS, MASS_EPS
from ..sampling.batched import (compact_selection, is_mesh_runtime,
                                keyed_uniforms)
from ..sampling.kdpp import _phase1_kdpp_from_uniforms
from .dual import DualSpectrum


def _check_backend(backend: Optional[str]) -> None:
    if backend not in (None, "reference"):
        raise ValueError(
            f"the dual-space sampler has no fused engine; backend must be "
            f"None or 'reference', got {backend!r}")


def _gamma(E: torch.Tensor, sel: torch.Tensor, valid: torch.Tensor
           ) -> torch.Tensor:
    """The selected coefficient columns Γ = E[:, sel], (B, r, k), invalid
    slots zeroed."""
    G = E[:, sel.to(torch.int64)].permute(1, 0, 2)
    return G * valid[:, None, :].to(E.dtype)


def phase2_dual(us: torch.Tensor, phi: torch.Tensor, Gamma: torch.Tensor,
                k_eff: torch.Tensor) -> torch.Tensor:
    """Projection-DPP selection in r-dimensional coefficient space, batched
    (port of ``_phase2_dual_one``).

    us (B, k_max) float32, phi (N, r), Gamma (B, r, k_max) (invalid slots
    zeroed), k_eff (B,) -> (B, k_max) int32 picks, -1 padded. Row i of a
    sample's selected eigenvector matrix is U[i] = Γᵀφ_i."""
    nb, k_max = us.shape
    N = int(phi.shape[0])
    dev = phi.device
    phiT = phi.T
    norms = torch.zeros((nb, N), dtype=phi.dtype, device=dev)
    for j in range(k_max):               # one (B, N) column at a time
        c = Gamma[:, :, j] @ phiT
        norms.addcmul_(c, c)
    GammaT = Gamma.transpose(1, 2)
    basis = torch.zeros((nb, k_max, k_max), dtype=phi.dtype, device=dev)
    picks = torch.full((nb, k_max), -1, dtype=torch.int32, device=dev)
    live = torch.ones(nb, dtype=torch.bool, device=dev)
    rows = torch.arange(nb, device=dev)
    k_eff = k_eff.to(device=dev, dtype=torch.int64)
    for t in range(k_max):
        run = live & (t < k_eff)
        csum = torch.cumsum(norms, dim=1)
        total = csum[:, -1]
        ok = run & (total > MASS_EPS)
        live = live & (ok | ~run)          # a collapsed row stops for good
        r = (us[:, t] * total)[:, None].contiguous()
        i = torch.searchsorted(csum, r, right=True)[:, 0].clamp_max(N - 1)
        w = (GammaT @ phi[i][:, :, None])[:, :, 0]           # U[i], O(r k)
        bt = basis.transpose(1, 2)
        q = w - (basis @ (bt @ w[:, :, None]))[:, :, 0]
        q = q - (basis @ (bt @ q[:, :, None]))[:, :, 0]      # CGS2
        qn2 = (q * q).sum(dim=1, keepdim=True)
        q = torch.where(qn2 > EPS, q / torch.sqrt(torch.clamp_min(qn2, EPS)),
                        torch.zeros_like(q))
        ct = (Gamma @ q[:, :, None])[:, :, 0] @ phiT         # U q, O(N r)
        new = torch.clamp_min(norms - ct * ct, 0.0)
        new[rows, i] = 0.0
        norms = torch.where(ok[:, None], new, norms)
        basis[:, :, t] = torch.where(ok[:, None], q, basis[:, :, t])
        picks[:, t] = torch.where(ok, i.to(torch.int32), picks[:, t])
    return picks


def sample_dual_from_uniforms(u: torch.Tensor, us: torch.Tensor,
                              dual: DualSpectrum, k_max: int
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Exact low-rank DPP draws from given uniforms: u (B, r) for phase 1,
    us (B, k_max) for phase 2, on the spectrum's device.

    Returns (picks (B, k_max) int32 with -1 padding, counts (B,) int32,
    truncated (B,) bool), the contract of ``sample_krondpp_from_uniforms``."""
    k_max = int(k_max)
    mask = u < torch.sigmoid(dual.log_eigenvalues())[None, :]
    sel, valid, truncated = compact_selection(mask, k_max)
    k_eff = torch.clamp_max(mask.sum(dim=-1), k_max).to(torch.int32)
    Gamma = _gamma(dual.basis(), sel, valid)
    return phase2_dual(us, dual.phi, Gamma, k_eff), k_eff, truncated


def sample_dual_kdpp_from_uniforms(u: torch.Tensor, us: torch.Tensor,
                                   dual: DualSpectrum, k: int
                                   ) -> torch.Tensor:
    """Exact low-rank k-DPP draws from given uniforms: u (B, r) for the
    ESP draw, us (B, k) for phase 2. Returns (B, k) int32 picks, exactly
    min(k, dual rank) distinct items a row, -1 padded."""
    k = int(k)
    mask = _phase1_kdpp_from_uniforms(u, dual.log_eigenvalues(), k)
    sel, valid, _ = compact_selection(mask, k)
    Gamma = _gamma(dual.basis(), sel, valid)
    return phase2_dual(us, dual.phi, Gamma, mask.sum(dim=-1))


def _dual_keyed_rows(row_keys: torch.Tensor, dual: DualSpectrum,
                     k_max: int):
    u, us = keyed_uniforms(row_keys, dual.rank, k_max)
    return sample_dual_from_uniforms(u, us, dual, k_max)


def _dual_kdpp_keyed_rows(row_keys: torch.Tensor, dual: DualSpectrum,
                          k: int) -> torch.Tensor:
    u, us = keyed_uniforms(row_keys, dual.rank, k)
    return sample_dual_kdpp_from_uniforms(u, us, dual, k)


def sample_dual_keyed(row_keys, dual: DualSpectrum, k_max: int,
                      backend: Optional[str] = None, runtime=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact low-rank DPP draws from per-row PRNG keys (B, 2) (twin keys or
    the JAX package's uint32 keys, moved to the spectrum's device).

    Same contract as ``sample_krondpp_keyed``. Row i is a function of
    ``row_keys[i]`` alone, whatever else shares the call, up to the
    rounding of the batched products (a roundoff tie at a CDF boundary).
    Under a ``Mesh`` runtime the keys are cut into shards
    (``runtime.map_keys``) with φ, λ and W as operands."""
    _check_backend(backend)
    k_max = int(k_max)
    row_keys = prng.as_key(row_keys, dual.device)
    if is_mesh_runtime(runtime):
        return runtime.map_keys(
            lambda ks, ops: _dual_keyed_rows(ks, DualSpectrum(*ops), k_max),
            row_keys, operands=(dual.phi, dual.lams, dual.W),
            static_key=("sample_dual", k_max))
    return _dual_keyed_rows(row_keys, dual, k_max)


def sample_dual_kdpp_keyed(row_keys, dual: DualSpectrum, k: int,
                           backend: Optional[str] = None, runtime=None
                           ) -> torch.Tensor:
    """Exact low-rank k-DPP draws from per-row keys: (B, k) int32 picks,
    exactly min(k, dual rank) distinct items a row, -1 padded; ``runtime``
    as in ``sample_dual_keyed``."""
    _check_backend(backend)
    k = int(k)
    row_keys = prng.as_key(row_keys, dual.device)
    if is_mesh_runtime(runtime):
        return runtime.map_keys(
            lambda ks, ops: _dual_kdpp_keyed_rows(ks, DualSpectrum(*ops), k),
            row_keys, operands=(dual.phi, dual.lams, dual.W),
            static_key=("sample_dual_kdpp", k))
    return _dual_kdpp_keyed_rows(row_keys, dual, k)


def _generator_uniforms(gen: torch.Generator, dual: DualSpectrum,
                        num_samples: int, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (num_samples, r) and us (num_samples, k) from ``torch.rand`` on
    the spectrum's device (the generator must live there)."""
    shape = (int(num_samples),)
    u = torch.rand(shape + (dual.rank,), generator=gen, dtype=torch.float32,
                   device=dual.device)
    us = torch.rand(shape + (int(k),), generator=gen, dtype=torch.float32,
                    device=dual.device)
    return u, us


def sample_dual_generator(gen: torch.Generator, dual: DualSpectrum,
                          k_max: int, num_samples: int,
                          backend: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``sample_dual_keyed``'s draws with uniforms from a generator."""
    _check_backend(backend)
    u, us = _generator_uniforms(gen, dual, num_samples, int(k_max))
    return sample_dual_from_uniforms(u, us, dual, int(k_max))


def sample_dual_kdpp_generator(gen: torch.Generator, dual: DualSpectrum,
                               k: int, num_samples: int,
                               backend: Optional[str] = None
                               ) -> torch.Tensor:
    """``sample_dual_kdpp_keyed``'s draws with uniforms from a generator."""
    _check_backend(backend)
    u, us = _generator_uniforms(gen, dual, num_samples, int(k))
    return sample_dual_kdpp_from_uniforms(u, us, dual, int(k))
