"""Carry weights and state between the JAX package and the port as numpy
arrays. Both packages can then sample from the *same* eigenvectors:
``eigh`` sign and degenerate-basis choices differ between LAPACK and
cuSOLVER, so a spectrum is carried across rather than recomputed."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ._device import DeviceLike, as_float
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
