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
from .models import DecodeState, KVCache
from .models.transformer import tree_map
from .optim import OptState
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


def _leaf_from_numpy(x, dev: torch.device) -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes) as a tensor on
    ``dev`` in its own dtype; a bfloat16 array (JAX's ``ml_dtypes`` type,
    which ``torch.from_numpy`` refuses) goes through float32, exactly."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_from_numpy(params, device: DeviceLike = "cuda"):
    """The port's LM parameter tree from the JAX package's, carried as
    numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``): the same
    nested dict paths and stacked ``(U, …)`` shapes, each leaf a tensor on
    ``device`` in its own dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), params)


def lm_params_to_numpy(params):
    """numpy copies of an LM parameter tree's leaves, the nesting kept
    (bfloat16 leaves as float32, exactly)."""
    return tree_map(_leaf_to_numpy, params)


def decode_state_from_numpy(state, device: DeviceLike = "cuda"
                            ) -> DecodeState:
    """The port's ``DecodeState`` from a decode state of either package
    whose leaves are numpy arrays (or anything ``np.asarray`` takes): every
    cache with fields ``k``, ``v`` and ``pos`` becomes a ``KVCache`` on
    ``device``, the dict nesting kept. A state with whisper's cross-attention
    or encoder output is refused (not ported)."""
    dev = resolve_device(device)
    if state.cross is not None or state.enc_out is not None:
        raise NotImplementedError("encoder-decoder decode states are not "
                                  "ported (ROADMAP.md, queue 1)")

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return KVCache(*(_leaf_from_numpy(x, dev)
                         for x in (tree.k, tree.v, tree.pos)))

    return DecodeState(walk(state.caches))


def decode_state_to_numpy(state: DecodeState) -> DecodeState:
    """A ``DecodeState`` whose ``KVCache`` leaves are numpy copies
    (bfloat16 caches as float32, exactly)."""
    return tree_map(_leaf_to_numpy, state)


def opt_state_from_numpy(state, device: DeviceLike = "cuda") -> OptState:
    """The port's ``OptState`` from either package's optimizer state
    (fields ``step``, ``m``, ``v``) whose leaves are numpy arrays (or
    anything ``np.asarray`` takes): the moments' nested dicts kept, every
    leaf a tensor on ``device`` in its own dtype."""
    dev = resolve_device(device)
    leaf = lambda a: _leaf_from_numpy(a, dev)
    return OptState(leaf(state.step), tree_map(leaf, state.m),
                    tree_map(leaf, state.v))


def opt_state_to_numpy(state: OptState) -> OptState:
    """An ``OptState`` whose leaves are numpy copies."""
    return OptState(_leaf_to_numpy(state.step),
                    tree_map(_leaf_to_numpy, state.m),
                    tree_map(_leaf_to_numpy, state.v))
