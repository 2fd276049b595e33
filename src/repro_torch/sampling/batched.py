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

``assemble_eigvecs`` materializes selected Kronecker eigenvectors for
callers that want them explicitly (through the ``kron_matvec`` kernel on
the card); the sampler never does.

The batch dimension is written out (the JAX package vmaps one sample).
``sample_krondpp_from_uniforms`` takes every uniform as a tensor, so a
test can feed it the numbers JAX drew. ``sample_krondpp_keyed`` draws them
from per-row PRNG keys exactly as the JAX package does
(``repro_torch.random``), so a key gives the JAX package's rows;
``sample_krondpp_batched`` takes one key (split into the rows' keys) or an
explicit ``torch.Generator``. A spectrum with a ``sample_rows`` hook (the
low-rank ``DualSpectrum``) draws its rows through the hook instead. Both
take ``runtime=``: a ``Mesh`` shards the rows' keys (``map_keys``).

The JAX package's single-sample compat surface is here too:
``phase2_select_reference`` (the plain chain rule on one sample, i.e.
``kernels.phase2_select.phase2_select_plain`` at B = 1) and
``phase2_select(key, ...)`` (the uniforms from a key, then one
``kernels.ops.phase2_select`` call: the CUDA kernel on the card), with
``compile_cache_size``, whose answer is -1: the port compiles nothing per
shape.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import random as prng
from ..core.kron import split_indices_multi
from ..kernels import ops as kernel_ops
from ..kernels.phase2_select import canonical_pair, phase2_select_plain
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


# global eigen-indices -> per-factor column indices, under the JAX name
split_mixed_radix = split_indices_multi


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


def assemble_eigvecs(spectrum_vecs: Sequence[torch.Tensor],
                     sizes: Sequence[int], sel: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The selected Kronecker eigenvectors, materialized: (N, k_max) for
    one row of ``sel``/``valid`` (k_max,). Invalid slots are zero columns.

    For m = 2 this is ``kernels.ops.kron_eigvec_batch``: the one-hot
    ``kron_matvec`` kernel on the card, gather and outer product on the
    CPU. For m >= 3 (and m = 1) the factor columns are folded by outer
    products. The sampler itself stays in factored form
    (``gather_factor_columns``) and never builds this matrix; this is for
    callers that want explicit eigenvectors.
    """
    parts = split_indices_multi(sel.to(torch.int64), sizes)
    if len(sizes) == 2:
        V = kernel_ops.kron_eigvec_batch(spectrum_vecs[0], spectrum_vecs[1],
                                         parts[0], parts[1])
    else:
        V = spectrum_vecs[0][:, parts[0]]
        for P, p in zip(spectrum_vecs[1:], parts[1:]):
            G = P[:, p]
            V = (V[:, None, :] * G[None, :, :]).reshape(-1, sel.shape[0])
    return V * valid[None, :].to(V.dtype)


def phase2_select_reference(us: torch.Tensor, Gs: Sequence[torch.Tensor],
                            sizes: Sequence[int], k_eff) -> torch.Tensor:
    """Projection-DPP selection of one sample from k_eff orthonormal
    Kronecker columns in factored form (``gather_factor_columns``), one
    uniform a step in ``us`` (k_max,): (k_max,) int32 picks, -1 in padded
    slots. The plain chain rule (``phase2_select_plain``) on a batch of
    one, on any device; ``sizes`` as in the JAX package's signature."""
    G1, Gr = canonical_pair(tuple(G[None] for G in Gs))
    k_eff = torch.as_tensor(k_eff, device=us.device).to(
        torch.int32).reshape(1)
    return phase2_select_plain(us[None], k_eff, G1, Gr)[0]


def phase2_select(key, Gs: Sequence[torch.Tensor], sizes: Sequence[int],
                  k_eff, backend: Optional[str] = None) -> torch.Tensor:
    """Single-sample phase-2 selection from a PRNG key (compat surface).

    Draws the k_max uniforms from ``key`` on the columns' device (the JAX
    package's ``uniform(key, (k_max,))``) and makes one
    ``kernels.ops.phase2_select`` call at B = 1: the CUDA kernel for
    columns on the card, the plain version for CPU ones; ``backend``
    forces one."""
    us = prng.uniform(prng.as_key(key, Gs[0].device), (Gs[0].shape[1],))
    return kernel_ops.phase2_select(us, Gs, sizes, k_eff, backend=backend)


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


def keyed_uniforms(row_keys: torch.Tensor, n: int, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The uniforms a row key gives phase 1 and phase 2, as the JAX
    package's ``_phase1_one`` draws them: ``k1, k2 = split(key)``,
    u = uniform(k1, (n,)), us = uniform(k2, (k,)); row_keys (B, 2) ->
    u (B, n), us (B, k) float32 on the keys' device, from one
    ``threefry2x32`` launch (``random.split_uniform``)."""
    return prng.split_uniform(row_keys, n, k)


def is_mesh_runtime(runtime) -> bool:
    # duck-typed, as the JAX package dispatches: importing dpp.runtime here
    # would import the facade, which imports this module
    return runtime is not None and getattr(runtime, "is_mesh", False)


def refuse_generator_on_mesh(runtime) -> None:
    """``ValueError`` under a ``Mesh``: a ``torch.Generator`` draws one
    stream for every row, so cutting the rows into shards would change the
    draws; a mesh shards PRNG keys only."""
    if is_mesh_runtime(runtime):
        raise ValueError(
            "a Mesh runtime shards a batch of PRNG keys; a torch.Generator "
            "draws one stream for every row — pass a key "
            "(repro_torch.random.PRNGKey) instead")


def _keyed_rows(row_keys: torch.Tensor, spectrum: FactorSpectrum,
                k_max: int, backend: Optional[str]):
    """The rows of keys already on the spectrum's device."""
    u, us = keyed_uniforms(row_keys, spectrum.N, k_max)
    return sample_krondpp_from_uniforms(u, us, spectrum, k_max,
                                        backend=backend)


def sample_krondpp_keyed(row_keys, spectrum: FactorSpectrum,
                         k_max: Optional[int] = None,
                         backend: Optional[str] = None, runtime=None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Exact KronDPP draws, row i from ``row_keys[i]`` alone ((B, 2) twin
    keys or the JAX package's uint32 keys; moved to the spectrum's
    device). The result for a key does not depend on which other keys
    share the call: the batching-invariance the keyed service
    (``SamplingService.draw_keyed``) builds on.

    ``runtime`` (``repro_torch.dpp.runtime``): under a ``Mesh`` the keys
    are cut into one shard a data-axis position (``runtime.map_keys``),
    each drawn by this pipeline on its shard's device with the spectrum
    as operands, so the rows equal the one-device call's bit for bit.

    Same return contract as ``sample_krondpp_batched``."""
    if k_max is None:
        k_max = spectrum.suggested_k_max()
    # duck-typed dispatch: a spectrum that carries its own row sampler (the
    # low-rank DualSpectrum) bypasses the Kronecker eigenvector machinery,
    # with the same (picks, counts, truncated) contract and keying
    rows_hook = getattr(spectrum, "sample_rows", None)
    if rows_hook is not None:
        return rows_hook(row_keys, int(k_max), backend=backend,
                         runtime=runtime)
    row_keys = prng.as_key(row_keys, spectrum.device)
    if is_mesh_runtime(runtime):
        # the spectrum flows through operands (not a closure), so the mesh
        # caches one shard plan per (k_max, backend)
        return runtime.map_keys(
            lambda ks, ops: _keyed_rows(ks, FactorSpectrum(*ops),
                                        int(k_max), backend),
            row_keys, operands=(tuple(spectrum.lams), tuple(spectrum.vecs)),
            static_key=("sample_krondpp_batched", int(k_max), backend))
    return _keyed_rows(row_keys, spectrum, int(k_max), backend)


def sample_krondpp_batched(key, spectrum: FactorSpectrum,
                           k_max: Optional[int] = None,
                           num_samples: int = 1,
                           backend: Optional[str] = None, runtime=None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Draw ``num_samples`` exact KronDPP samples in one batched call on
    the spectrum's device.

    ``key``: a PRNG key (2,) (``repro_torch.random``, or the JAX package's
    uint32 key), split into one key per row as the JAX package splits it,
    so the rows equal the JAX package's for the same key; or a
    ``torch.Generator`` on the spectrum's device, whose uniforms are drawn
    with ``torch.rand``.

    ``runtime``: under a ``Mesh`` the rows' keys are sharded as in
    ``sample_krondpp_keyed`` (draws equal the one-device call's bit for
    bit). A generator draws one stream for every row, so a ``Mesh`` takes
    keys only and refuses one with ``ValueError``.

    Returns (picks (num_samples, k_max) int32 with -1 padding,
    counts (num_samples,) int32, truncated (num_samples,) bool — True
    for draws whose |J| overflowed k_max and were clipped)."""
    if k_max is None:
        k_max = spectrum.suggested_k_max()
    dev = spectrum.device
    if not isinstance(key, torch.Generator):
        keys = prng.split(prng.as_key(key, dev), int(num_samples))
        return sample_krondpp_keyed(keys, spectrum, int(k_max),
                                    backend=backend, runtime=runtime)
    rows_hook = getattr(spectrum, "sample_rows", None)
    if rows_hook is not None:
        return rows_hook(key, int(k_max), backend=backend,
                         num_samples=int(num_samples), runtime=runtime)
    refuse_generator_on_mesh(runtime)
    u = torch.rand((num_samples, spectrum.N), generator=key,
                   dtype=torch.float32, device=dev)
    us = torch.rand((num_samples, int(k_max)), generator=key,
                    dtype=torch.float32, device=dev)
    return sample_krondpp_from_uniforms(u, us, spectrum, int(k_max),
                                        backend=backend)


def picks_to_lists(picks: torch.Tensor) -> List[List[int]]:
    """(B, k_max) padded picks -> python lists (host boundary)."""
    arr = picks.cpu().numpy()
    return [row[row >= 0].tolist() for row in arr]


def compile_cache_size() -> int:
    """The JAX package's count of compiled (k_max, batch) specializations;
    -1, its answer when there is no compile cache to inspect: the port
    runs eagerly and compiles nothing per shape."""
    return -1
