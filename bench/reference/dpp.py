"""Plain exact DPP sampling of a Kronecker (or dense) L-ensemble, and the
judge of draws made by another sampler.

A draw (Hough et al. 2006; Kulesza & Taskar 2012, Alg. 1), from two rows
of uniforms:

    phase 1  eigen-index g is kept iff u[g] < λ_g / (1 + λ_g); the lowest
             k_max kept indices are used if more are kept;
    phase 2  with V the kept eigenvectors (N x k, orthonormal columns) and
             r_i = ‖P⊥ V_i‖² the squared norm of item i's row outside the
             span of the rows picked so far, step t picks the first item
             whose running sum of r passes us[t] · Σ r.

Eigen-index g of L = L_1 ⊗ ... ⊗ L_m is the row-major tuple (g_1, .., g_m)
of each factor's eigenpairs in ascending order, and item i likewise.

``judge`` holds a sampler's picks to this definition, in float64, step by
step along the picks it made (so one step decided on a rounding tie does
not change how the next steps are judged):

* ``phase1_gap``: the largest |u[g] - p_g| over the eigen-indices that
  have to be flipped from this definition's phase 1 to give a row its
  number of picks (0 where the number matches);
* ``phase2_gap``: the largest distance, as a share of the step's total
  mass Σ r, from us[t] · Σ r to the piece of the running sum that the
  picked item owns (0 where the pick is the one this definition makes);
* ``bad_rows``: rows whose picks are out of range, repeated, or not a
  prefix of the row.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from .precision import eigh, matmul

#: A basis column whose squared norm is below this is dropped (the picked
#: row was already in the span).
EPS = 1e-30


@dataclass
class Spectrum:
    """Per-factor eigenpairs, eigenvalues ascending."""
    lams: Tuple[torch.Tensor, ...]
    vecs: Tuple[torch.Tensor, ...]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(int(v.shape[0]) for v in self.vecs)

    @property
    def N(self) -> int:
        return int(np.prod(self.sizes))

    def log_eigenvalues(self) -> torch.Tensor:
        v = torch.log(self.lams[0])
        for lam in self.lams[1:]:
            v = (v[:, None] + torch.log(lam)[None, :]).reshape(-1)
        return v


def spectrum(factors: Sequence[torch.Tensor], dtype=torch.float64,
             precision: str = "exact") -> Spectrum:
    """Eigenpairs of each factor in ``dtype`` (at ``precision``),
    eigenvalues clipped at 0."""
    lams, vecs = [], []
    for f in factors:
        lam, V = eigh(f.to(dtype), precision)
        lams.append(torch.clamp_min(lam, 0.0))
        vecs.append(V)
    return Spectrum(tuple(lams), tuple(vecs))


def gain_for_expected_size(log_lams: torch.Tensor, target: float) -> float:
    """The scalar g with Σ sigmoid(log g + log λ) = target, by bisection on
    log g in float64."""
    ll = log_lams.double().cpu().numpy()
    lo, hi = -80.0, 80.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        e = float((1.0 / (1.0 + np.exp(-(ll + mid)))).sum())
        lo, hi = (lo, mid) if e > target else (mid, hi)
    return float(np.exp(0.5 * (lo + hi)))


def rescaled(spec: Spectrum, target: float) -> Tuple[Spectrum, float]:
    """The spectrum of the kernel scaled so that E|Y| = target (each of the
    m factors by g^(1/m)), and g."""
    g = gain_for_expected_size(spec.log_eigenvalues(), target)
    gm = g ** (1.0 / len(spec.lams))
    return Spectrum(tuple(l * gm for l in spec.lams), spec.vecs), g


def _unravel(idx: torch.Tensor, sizes: Sequence[int]):
    parts = []
    for s in tuple(sizes)[::-1]:
        parts.append(idx % s)
        idx = idx // s
    return parts[::-1]


def eigvec_rows(spec: Spectrum, sel: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """(B, N, K) the eigenvectors of eigen-indices ``sel`` (B, K) as
    columns, zero where not ``valid``."""
    parts = _unravel(sel.long(), spec.sizes)
    V = None
    for P, p in zip(spec.vecs, parts):
        G = P[:, p].permute(1, 0, 2)             # (B, N_f, K)
        V = G if V is None else (V[:, :, None, :] * G[:, None, :, :]) \
            .reshape(G.shape[0], -1, G.shape[2])
    return V * valid[:, None, :].to(V.dtype)


def first_kept(mask: torch.Tensor, k_max: int):
    """The lowest ``k_max`` True columns of each row: (sel, valid)."""
    N = mask.shape[1]
    order = torch.where(mask, torch.arange(N, device=mask.device)[None, :],
                        torch.full_like(mask, N, dtype=torch.long))
    sel = torch.sort(order, dim=1).values[:, :k_max]
    valid = sel < N
    return sel.clamp_max(N - 1), valid


def sample(spec: Spectrum, u: torch.Tensor, us: torch.Tensor, k_max: int,
           precision: str = "exact") -> torch.Tensor:
    """(B, k_max) picks, -1 padded, of the draws of uniforms u (B, N) and
    us (B, k_max), with every matrix product at ``precision``
    (``precision.matmul``) and everything else in the spectrum's dtype."""
    dt = spec.vecs[0].dtype
    B, N = u.shape
    p = torch.sigmoid(spec.log_eigenvalues())
    keep = u.to(dt) < p[None, :]
    sel, valid = first_kept(keep, k_max)
    count = valid.sum(1)
    V = eigvec_rows(spec, sel, valid)
    r = (V * V).sum(-1)
    basis = torch.zeros((B, k_max, k_max), dtype=dt, device=u.device)
    picks = torch.full((B, k_max), -1, dtype=torch.long, device=u.device)
    rows = torch.arange(B, device=u.device)
    for t in range(int(count.max()) if B else 0):
        act = t < count
        csum = torch.cumsum(r, 1)
        total = csum[:, -1]
        i = (csum <= (us[:, t].to(dt) * total)[:, None]).sum(1) \
            .clamp_max(N - 1)
        q = V[rows, i]
        for _ in range(2):
            q = q - matmul(basis, matmul(basis.transpose(1, 2), q[:, :, None],
                                         precision), precision)[:, :, 0]
        qn2 = (q * q).sum(1, keepdim=True)
        q = torch.where(qn2 > EPS, q / qn2.clamp_min(EPS).sqrt(),
                        torch.zeros_like(q))
        c = matmul(V, q[:, :, None], precision)[:, :, 0]
        new = (r - c * c).clamp_min(0.0)
        new[rows, i] = 0.0
        r = torch.where(act[:, None], new, r)
        basis[:, :, t] = torch.where(act[:, None], q, basis[:, :, t])
        picks[:, t] = torch.where(act, i, picks[:, t])
    return picks


def _phase1_sets(p, u, count, truncated, k_max):
    """Each row's kept eigen-indices, as the judge takes them: this
    definition's, with the fewest flips that give the row ``count`` picks,
    flipping the indices whose uniform lies nearest its threshold. Returns
    (sel, valid, gap (B,))."""
    keep = u < p[None, :]
    margin = (u - p[None, :]).abs()
    n_ref = keep.sum(1)
    gap = torch.zeros(u.shape[0], dtype=p.dtype, device=u.device)
    for b in torch.nonzero(n_ref.clamp_max(k_max) != count).flatten():
        b = int(b)
        d = int(count[b]) - int(n_ref[b])
        if bool(truncated[b]) or n_ref[b] > k_max or abs(d) > 3:
            gap[b] = float("inf")
            continue
        side = ~keep[b] if d > 0 else keep[b]
        m = torch.where(side, margin[b], torch.full_like(margin[b],
                                                         float("inf")))
        flip = torch.topk(m, abs(d), largest=False).indices
        keep[b, flip] = ~keep[b, flip]
        gap[b] = m[flip].max()
    sel, valid = first_kept(keep, k_max)
    return sel, valid, gap


def judge(spec: Spectrum, u: torch.Tensor, us: torch.Tensor,
          picks: torch.Tensor, truncated: torch.Tensor, block: int = 256
          ) -> dict:
    """Hold a sampler's draws, picks (B, k_max) -1 padded in pick order,
    made from uniforms u (B, N) and us (B, k_max), to this definition in
    float64 (see the module's docstring). Rows are judged ``block`` at a
    time."""
    out = {"phase1_gap": 0.0, "phase2_gap": 0.0, "bad_rows": 0, "rows": 0}
    for s in range(0, picks.shape[0], block):
        part = _judge_block(spec, u[s:s + block], us[s:s + block],
                            picks[s:s + block], truncated[s:s + block])
        out["phase1_gap"] = max(out["phase1_gap"], part["phase1_gap"])
        out["phase2_gap"] = max(out["phase2_gap"], part["phase2_gap"])
        out["bad_rows"] += part["bad_rows"]
        out["rows"] += part["rows"]
    return out


def _judge_block(spec, u, us, picks, truncated) -> dict:
    dt = torch.float64
    dev = spec.vecs[0].device
    u, us = u.to(dev, dt), us.to(dev, dt)
    picks, truncated = picks.to(dev).long(), truncated.to(dev)
    B, k_max = picks.shape
    N = spec.N
    taken = picks >= 0
    count = taken.sum(1)
    prefix = taken == (torch.arange(k_max, device=dev)[None, :]
                       < count[:, None])
    in_range = (~taken) | (picks < N)
    srt = torch.sort(torch.where(taken, picks, -1 - torch.arange(
        k_max, device=dev)[None, :]), 1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(1)
    bad = ~(prefix.all(1) & in_range.all(1) & distinct)
    p = torch.sigmoid(spec.log_eigenvalues().to(dt))
    sel, valid, gap1 = _phase1_sets(p, u, count, truncated, k_max)
    ok = ~bad & torch.isfinite(gap1)
    V = eigvec_rows(spec, sel, valid & ok[:, None])
    r = (V * V).sum(-1)
    basis = torch.zeros((B, k_max, k_max), dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    gap2 = torch.zeros(B, dtype=dt, device=dev)
    for t in range(int(count[ok].max()) if bool(ok.any()) else 0):
        act = ok & (t < count)
        i = picks[:, t].clamp(0, N - 1)
        csum = torch.cumsum(r, 1)
        total = csum[:, -1].clamp_min(1e-300)
        hi = csum[rows, i]
        lo = hi - r[rows, i]
        target = us[:, t] * total
        g = torch.maximum(lo - target, target - hi).clamp_min(0.0) / total
        gap2 = torch.where(act, torch.maximum(gap2, g), gap2)
        q = V[rows, i]
        for _ in range(2):
            q = q - (basis @ (basis.transpose(1, 2) @ q[:, :, None]))[:, :, 0]
        qn2 = (q * q).sum(1, keepdim=True)
        q = torch.where(qn2 > EPS, q / qn2.clamp_min(EPS).sqrt(),
                        torch.zeros_like(q))
        c = (V @ q[:, :, None])[:, :, 0]
        new = (r - c * c).clamp_min(0.0)
        new[rows, i] = 0.0
        r = torch.where(act[:, None], new, r)
        basis[:, :, t] = torch.where(act[:, None], q, basis[:, :, t])
    gap1 = torch.where(bad, torch.zeros_like(gap1), gap1)
    return {"phase1_gap": float(gap1.max()) if B else 0.0,
            "phase2_gap": float(gap2.max()) if B else 0.0,
            "bad_rows": int(bad.sum()), "rows": B}
