"""Carry weights and state between the JAX package and the port as numpy
arrays. Both packages can then sample from the *same* eigenvectors:
``eigh`` sign and degenerate-basis choices differ between LAPACK and
cuSOLVER, so a spectrum is carried across rather than recomputed."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from ._device import DeviceLike, as_float, resolve_device
from .core.dpp import SubsetBatch
from .dpp.model import Kron
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
