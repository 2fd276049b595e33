"""Host samplers and greedy MAP without the kernel seam (port of
``repro/core/sampling.py``).

``sample_dpp``, ``sample_full_dpp`` and ``sample_krondpp`` are the exact
DPP samplers of the paper (Alg. 2 and its Sec. 4 Kronecker form) as host
oracles, as in the JAX package: they take a ``numpy.random.Generator`` and
compute in float64 numpy on the CPU, one subset a call. They consume the
generator as the JAX package's do (one ``rng.random(N)`` for phase 1, one
``rng.choice`` a phase-2 step), so the same seed gives the same draws.
The facade's ``sample`` runs the batched device sampler
(``sampling.batched``), never these.

``greedy_map_kdpp`` is the kernel-free greedy MAP the tests hold
``kernels.ops.greedy_map_kdpp`` against, as the JAX tests do.

Full kernel:   O(N^3 + N k^3)   (eigendecomposition dominates)
KronDPP m=2:   O(N^{3/2} + N k^3)
KronDPP m=3:   O(N + N k^3)
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..kernels.greedy_map import degeneracy_eps


def _float64(x) -> np.ndarray:
    """A tensor (any device) or an array as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _phase2_select(rng: np.random.Generator, V: np.ndarray) -> List[int]:
    """Elementary-DPP projection sampling over the orthonormal columns of
    V (N, k): k selected item indices.

    Each step draws i with probability |V[i, :]|² / k_left, removes e_i
    from the span (eliminating along the column of largest |V[i, j]|) and
    re-orthonormalizes with a thin QR. The draw reads only the residual
    row norms, which do not depend on the basis, so the QR's column signs
    do not change the picks.
    """
    Y: List[int] = []
    V = _float64(V).copy()
    while V.shape[1] > 0:
        p = np.maximum((V ** 2).sum(axis=1), 0.0)
        p = p / p.sum()
        i = int(rng.choice(len(p), p=p))
        Y.append(i)
        j = int(np.argmax(np.abs(V[i])))
        col = V[:, j].copy()
        V = V - np.outer(col / col[i], V[i])
        V = np.delete(V, j, axis=1)
        if V.shape[1] > 0:
            V, _ = np.linalg.qr(V)
    return Y


def sample_dpp(rng: np.random.Generator, eigvals, eigvecs) -> List[int]:
    """Alg. 2 from a precomputed eigendecomposition of L: eigenvalues (N,)
    and eigenvector columns (N, N), tensors or arrays."""
    lam = _float64(eigvals)
    probs = lam / (1.0 + lam)
    J = np.nonzero(rng.random(lam.shape[0]) < probs)[0]
    if len(J) == 0:
        return []
    return _phase2_select(rng, _float64(eigvecs)[:, J])


def sample_full_dpp(rng: np.random.Generator, L) -> List[int]:
    """The O(N^3) baseline sampler for a dense kernel (tensor or array)."""
    lam, vecs = np.linalg.eigh(_float64(L))
    return sample_dpp(rng, np.maximum(lam, 0.0), vecs)


def sample_krondpp(rng: np.random.Generator, dpp) -> List[int]:
    """Sec. 4 sampler for anything with ``factors`` (a ``core.KronDPP``
    or a facade model): factor eigendecompositions, phase 1 over the
    product spectrum, and only the |J| selected eigenvectors built, each
    in O(N) — setup O(Σ N_i³ + N|J|)."""
    eigs = [np.linalg.eigh(_float64(f)) for f in dpp.factors]
    lams = [np.maximum(e[0], 0.0) for e in eigs]
    vecs = [e[1] for e in eigs]
    lam_all = lams[0]
    for lam in lams[1:]:
        lam_all = np.multiply.outer(lam_all, lam).reshape(-1)
    probs = lam_all / (1.0 + lam_all)
    J = np.nonzero(rng.random(lam_all.shape[0]) < probs)[0]
    if len(J) == 0:
        return []
    sizes = [v.shape[0] for v in vecs]
    cols = []
    for g in J:
        parts = []
        rem = int(g)
        for s in sizes[::-1]:
            parts.append(rem % s)
            rem //= s
        parts = parts[::-1]
        v = vecs[0][:, parts[0]]
        for f in range(1, len(sizes)):
            v = np.outer(v, vecs[f][:, parts[f]]).reshape(-1)
        cols.append(v)
    return _phase2_select(rng, np.stack(cols, axis=1))


def greedy_map_kdpp(L: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy MAP for a k-DPP: iteratively add the item of largest
    conditional variance (Chen et al. 2018 fast greedy, Cholesky-update
    form). O(N k²). Returns (k,) int32 picks on L's device.

    d tracks the conditional variance of every item; the columns of C
    build the Cholesky factor of L_Y over the chosen items. A degenerate
    pick (d_j at or below ``degeneracy_eps(L)``) clamps the divisor and
    zeroes its update, so later picks stay valid and finite.
    """
    k = int(k)
    N = int(L.shape[0])
    eps = degeneracy_eps(L)
    d = torch.diagonal(L)
    C = torch.zeros((N, k), dtype=L.dtype, device=L.device)
    chosen = torch.zeros((N,), dtype=torch.bool, device=L.device)
    picks = torch.empty((k,), dtype=torch.int64, device=L.device)
    for t in range(k):
        j = torch.argmax(torch.where(chosen, float("-inf"), d)).view(1)
        dj = d.index_select(0, j)
        ok = dj > eps
        e = (L.index_select(1, j).view(N) - C @ C.index_select(0, j).view(k)
             ) / torch.sqrt(torch.maximum(dj, eps))
        e = torch.where(ok, e, 0.0)
        d = torch.clamp_min(d - e * e, 0.0)
        C[:, t] = e
        chosen.index_fill_(0, j, True)
        picks[t:t + 1] = j
    return picks.to(torch.int32)
