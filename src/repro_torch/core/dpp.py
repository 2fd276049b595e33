"""Full (unstructured) DPP operations (port of ``repro/core/dpp.py``):
subset batches, masked submatrix inverses and log-determinants, the
log-likelihood, Θ, and the marginal-kernel oracle.

A DPP over ground set {0..N-1} with L-ensemble kernel L:
    P(Y) = det(L_Y) / det(L + I)                                   (paper Eq. 2)

The JAX package ``vmap``s its per-subset functions; here they take the
batch as a leading dimension.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


@dataclasses.dataclass
class SubsetBatch:
    """n observed subsets, padded to k_max items.

    indices: (n, k_max) int32 — ground-set indices, 0 in padded slots.
    mask:    (n, k_max) bool  — True for real items.
    truncated: optional (n,) bool provenance from the device samplers —
        True for rows whose draw overflowed the sampler's static k_max
        budget and was clipped (``compact_selection``). None for batches
        that cannot truncate (observed data).
    """
    indices: torch.Tensor
    mask: torch.Tensor
    truncated: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return int(self.indices.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.indices.shape[1])

    def sizes(self) -> torch.Tensor:
        return self.mask.sum(-1)

    def truncation_count(self) -> int:
        """Rows clipped at the sampler's k_max budget (0 when provenance
        is absent)."""
        return 0 if self.truncated is None else int(self.truncated.sum())

    @staticmethod
    def from_lists(subsets: Sequence[Sequence[int]],
                   k_max: Optional[int] = None,
                   device: DeviceLike = "cuda") -> "SubsetBatch":
        dev = resolve_device(device)
        k_max = k_max or max(len(s) for s in subsets)
        n = len(subsets)
        idx = np.zeros((n, k_max), np.int32)
        mask = np.zeros((n, k_max), bool)
        for i, s in enumerate(subsets):
            s = list(s)
            idx[i, : len(s)] = s
            mask[i, : len(s)] = True
        return SubsetBatch(torch.from_numpy(idx).to(dev),
                           torch.from_numpy(mask).to(dev))

    def to_lists(self) -> List[List[int]]:
        idx = self.indices.cpu().numpy()
        msk = self.mask.cpu().numpy()
        return [idx[i][msk[i]].tolist() for i in range(self.n)]


def gather_submatrix(L: torch.Tensor, idx: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """L[idx, idx] with padded rows/cols replaced by identity, for idx and
    mask of shape (..., k) -> (..., k, k).

    det / inverse of the padded matrix then equal det / inverse of the true
    submatrix (embedded), keeping shapes static.
    """
    idx = idx.long()
    sub = L[idx[..., :, None], idx[..., None, :]]
    return identity_padded(sub, mask)


def identity_padded(sub: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``sub`` (..., k, k) with the rows and columns of masked-out slots
    replaced by the identity's."""
    m2 = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(sub.shape[-1], dtype=sub.dtype, device=sub.device)
    return torch.where(m2, sub, eye)


def masked_inv_and_logdet(subL: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky-based inverse and logdet of PD (identity-padded) matrices
    (..., k, k) -> ((..., k, k), (...)).

    ``torch.linalg.cholesky`` raises on a matrix that is not PD (and syncs
    to find out on a card), where ``jnp.linalg.cholesky`` returns NaN. So
    this uses ``cholesky_ex``, which neither raises nor syncs, and turns a
    failed factorization (``info != 0``) into a NaN logdet and a NaN
    inverse, as in the JAX package: an Armijo trial on a non-PD candidate
    then sees a non-finite log-likelihood instead of an exception.
    """
    chol, info = torch.linalg.cholesky_ex(subL)
    ok = info == 0
    nan = torch.full((), float("nan"), dtype=subL.dtype, device=subL.device)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    logdet = torch.where(ok, 2.0 * torch.log(diag).sum(-1), nan)
    eye = torch.eye(subL.shape[-1], dtype=subL.dtype,
                    device=subL.device).expand_as(subL)
    inv = torch.where(ok[..., None, None], torch.cholesky_solve(eye, chol),
                      nan)
    return inv, logdet


# ---------------------------------------------------------------------------
# Log-likelihood and Θ (paper Eqs. 3-5)
# ---------------------------------------------------------------------------

def log_likelihood(L: torch.Tensor, batch: SubsetBatch) -> torch.Tensor:
    """phi(L) = (1/n) sum_i [ log det(L_{Y_i}) ] - log det(L + I)."""
    _, lds = masked_inv_and_logdet(
        gather_submatrix(L, batch.indices, batch.mask))
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return lds.mean() - torch.linalg.slogdet(L + eye)[1]


def scatter_theta(N: int, idx: torch.Tensor, mask: torch.Tensor,
                  inv: torch.Tensor) -> torch.Tensor:
    """(1/n) Σ_i U_i inv_i U_i^T: the (n, k, k) masked inverses scattered
    into ONE N x N buffer (``index_put_`` with ``accumulate=True``) and
    divided by n.

    The JAX package builds one dense N x N per subset and takes the mean,
    which needs n·N² floats (400 GB at N = 10^4, n = 1000); this is the
    same sum in N² floats. On a card the accumulation runs in atomics, so
    the order of the sums, and the last bits of Θ, change from run to run.
    """
    n = idx.shape[0]
    idx = idx.long()
    vals = inv * (mask[:, :, None] & mask[:, None, :])
    theta = torch.zeros((N, N), dtype=inv.dtype, device=inv.device)
    theta.index_put_((idx[:, :, None], idx[:, None, :]), vals,
                     accumulate=True)
    return theta / n


def theta_matrix(L: torch.Tensor, batch: SubsetBatch) -> torch.Tensor:
    """Theta = (1/n) sum_i U_i L_{Y_i}^{-1} U_i^T (N x N, scatter-add)."""
    inv, _ = masked_inv_and_logdet(
        gather_submatrix(L, batch.indices, batch.mask))
    return scatter_theta(L.shape[0], batch.indices, batch.mask, inv)


def marginal_kernel(L: np.ndarray) -> np.ndarray:
    """K = L (L + I)^{-1} — the numpy oracle."""
    N = L.shape[0]
    return L @ np.linalg.inv(L + np.eye(N))
