"""Carry weights and state between the JAX package and the port as numpy
arrays. Both packages can then sample from the *same* eigenvectors:
``eigh`` sign and degenerate-basis choices differ between LAPACK and
cuSOLVER, so a spectrum (a low-rank model's dual eigenvectors too) is
carried across rather than recomputed. PRNG
keys cross as their uint32 words (``key_from_numpy``/``key_to_numpy``):
the port's ``repro_torch.random`` then draws the JAX package's numbers
from them."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from . import random as prng
from ._device import DeviceLike, as_float, resolve_device
from .core.dpp import SubsetBatch
from .dpp.model import Kron
from .lowrank import DualSpectrum, LowRank
from .sampling.spectral import FactorSpectrum


def kron_from_numpy(factors: Sequence[np.ndarray],
                    device: DeviceLike = "cuda") -> Kron:
    """The port's ``Kron`` over float32 copies of ``factors``."""
    return Kron(tuple(np.asarray(f, np.float32) for f in factors),
                device=device)


def spectrum_from_numpy(lams: Sequence[np.ndarray],
                        vecs: Sequence[np.ndarray],
                        device: DeviceLike = "cuda") -> FactorSpectrum:
    """The port's ``FactorSpectrum`` over float32 copies of per-factor
    eigenvalues ``lams[i]`` (N_i,) and eigenvector columns ``vecs[i]``
    (N_i, N_i)."""
    return FactorSpectrum(
        tuple(as_float(np.asarray(lam, np.float32), device) for lam in lams),
        tuple(as_float(np.asarray(v, np.float32), device) for v in vecs))


def lowrank_from_numpy(V: np.ndarray, q: Optional[np.ndarray] = None,
                       device: DeviceLike = "cuda") -> LowRank:
    """The port's ``LowRank`` over float32 copies of V (N, r) and q (N,)."""
    return LowRank(np.asarray(V, np.float32),
                   None if q is None else np.asarray(q, np.float32),
                   device=device)


def dual_spectrum_from_numpy(phi: np.ndarray, lams: np.ndarray,
                             W: np.ndarray, device: DeviceLike = "cuda"
                             ) -> DualSpectrum:
    """The port's ``DualSpectrum`` over float32 copies of φ (N, r), the dual
    eigenvalues (r,) and eigenvectors W (r, r), e.g. the JAX package's."""
    return DualSpectrum(*(as_float(np.asarray(x, np.float32), device)
                          for x in (phi, lams, W)))


def dual_spectrum_to_numpy(spec: DualSpectrum
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float32 numpy copies (φ, lams, W) of a ``DualSpectrum`` of either
    package."""
    return tuple(np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                            np.float32) for x in (spec.phi, spec.lams, spec.W))


def subset_batch_to_numpy(batch: SubsetBatch
                          ) -> Dict[str, Optional[np.ndarray]]:
    """``{"indices", "mask", "truncated"}`` numpy arrays of a batch
    (``truncated`` is None when the batch carries no provenance)."""
    return {"indices": batch.indices.cpu().numpy(),
            "mask": batch.mask.cpu().numpy(),
            "truncated": None if batch.truncated is None
            else batch.truncated.cpu().numpy()}


def subset_batch_from_numpy(indices: np.ndarray, mask: np.ndarray,
                            device: DeviceLike = "cuda") -> SubsetBatch:
    """The port's ``SubsetBatch`` over int32 ``indices`` and bool ``mask``
    (n, k_max), e.g. a JAX ``SubsetBatch``'s arrays."""
    dev = resolve_device(device)
    return SubsetBatch(
        torch.from_numpy(np.array(indices, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(mask, dtype=bool)).to(dev))


def factors_to_numpy(model) -> Tuple[np.ndarray, ...]:
    """float32 numpy copies of the factors of a ``dpp.Kron``, a
    ``core.KronDPP`` or a sequence of tensors (on any device)."""
    factors = model.factors if hasattr(model, "factors") else model
    return tuple(f.detach().cpu().numpy().astype(np.float32)
                 for f in factors)


def key_from_numpy(key: np.ndarray, device: DeviceLike = "cuda"
                   ) -> torch.Tensor:
    """The port's PRNG key (..., 2) int64 on ``device`` from the JAX
    package's uint32 key data (``np.asarray(jax_key)``)."""
    return prng.as_key(np.asarray(key), resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The uint32 words (..., 2) of a port key, which
    ``jnp.asarray(..., jnp.uint32)`` turns into the JAX package's key."""
    return prng.key_data(key)
