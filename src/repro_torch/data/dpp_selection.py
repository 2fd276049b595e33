"""KronDPP diverse minibatch selection — the paper's model as a first-class
data-pipeline feature, built on the ``repro_torch.dpp`` facade (port of
``repro/data/dpp_selection.py``: the same draws for the same numpy rng).

Ground set = the N = N1 x N2 training documents, factored as N1 shards x N2
offsets. L1 models inter-shard similarity (e.g. topic centroids), L2
intra-shard similarity. Exact sampling costs O(N1^3 + N2^3 + N k^3) per batch
(paper Sec. 4).

``from_features`` also has a **low-rank route** (default above
``LOWRANK_THRESHOLD`` documents): instead of materializing N×N (or
factor-sized) RBF kernels on the host, it builds an (N, r) Nyström or
random-Fourier feature basis and selects through ``dpp.LowRank`` — the
whole pipeline (r×r dual eigh, O(Nr) sampling) never touches an N×N
matrix, so corpus-scale selection stops being memory-bound.

Placement is a ``repro_torch.dpp.runtime`` Runtime:
  ``Local()`` (default) — ``model.service()``: the factor
      eigendecompositions are cached once in a SpectralCache and
      ``prefetch`` samples are drawn per batched device call (one
      ``phase2_select`` launch on the card) into a FIFO buffer, so
      steady-state selection is one device call every ``prefetch``
      batches.
  ``Mesh(axes=...)`` — the same service with each flush's key batch
      sharded over the mesh (identical draws; ``device`` is the mesh's
      first data shard's).
  ``Host()`` — ``model.sample(runtime=Host())``, the numpy reference
      oracle.
The pre-runtime ``backend="device"|"host"`` strings keep working as
DeprecationWarning shims.

Every key comes from the pipeline's numpy rng through the PRNG twin
(``repro_torch.random``): the service's seed and the Host draw's key are
the JAX package's for the same rng, so the selector picks the JAX
package's documents. ``device`` (default "cuda"; ``RuntimeError`` without
a card unless "cpu" is passed) is where the model lives and draws run.

The kernels can be LEARNED from batches that trained well (any subset
signal) via ``model.fit`` — `fit_from_subsets` wires that in (KrK-Picard
for Kron selectors, the dual-space learner for LowRank ones).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from .. import random as prng
from .._device import DeviceLike, resolve_device
from ..core.dpp import SubsetBatch
from ..dpp import Kron, LowRank
from ..dpp import runtime as runtime_mod

#: ``from_features(method="auto")`` switches to the low-rank route above
#: this many documents — the dense route's host RBF blocks are O(N²)-ish
#: in the worst factoring, and the LowRank model samples at O(Nr) anyway.
LOWRANK_THRESHOLD = 2048


def _rbf_kernel(X: np.ndarray, gamma: Optional[float] = None,
                reg: float = 1e-3) -> np.ndarray:
    d2 = ((X[:, None] - X[None, :]) ** 2).sum(-1)
    gamma = gamma or 1.0 / (np.median(d2) + 1e-9)
    return np.exp(-gamma * d2) + reg * np.eye(X.shape[0])


@dataclasses.dataclass
class DPPBatchSelector:
    """Samples diverse doc indices from a (Kron or LowRank) DPP over the
    corpus."""
    dpp: Union[Kron, LowRank]    # the facade model over the corpus
    n1: int
    n2: int
    #: execution placement (repro_torch.dpp.runtime); None = Local()
    runtime: Optional[runtime_mod.Runtime] = None
    prefetch: int = 16           # samples per coalesced device call
    #: deprecated "device"/"host" placement string (shimmed onto runtime)
    backend: Optional[str] = None
    #: where the draws (and fits) run
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.runtime = runtime_mod.resolve(self.runtime,
                                           backend=self.backend)
        self.backend = None      # consumed; replace() must not re-warn
        self._service = None
        self._buffer: List[List[int]] = []

    @staticmethod
    def from_features(doc_features: np.ndarray, n1: int, n2: int,
                      scale: float = 1.0,
                      runtime: Optional[runtime_mod.Runtime] = None,
                      backend: Optional[str] = None,
                      method: str = "auto", rank: int = 32,
                      features: str = "nystrom",
                      threshold: int = LOWRANK_THRESHOLD,
                      seed: int = 0,
                      device: DeviceLike = "cuda") -> "DPPBatchSelector":
        """Build a selection kernel from doc features (n1*n2, d) on
        ``device``.

        method="dense": the original Kron route — L1: RBF over shard
        centroids; L2: RBF over within-shard mean offsets (host O(n1²) +
        O(n2²) kernel blocks).
        method="lowrank": an (N, rank) RBF feature basis over the RAW
        per-document features (Nyström landmarks by default,
        ``features="rff"`` for random Fourier features) wrapped in
        ``dpp.LowRank`` — no N×N or factor-sized kernel is ever built,
        and per-document structure that the dense route's centroid
        averaging washes out is kept.
        method="auto" (default): "lowrank" when n1*n2 > ``threshold``,
        else "dense" — existing small-corpus callers keep their exact
        kernels; large corpora stop paying O(N²)-class host work.
        """
        if method not in ("auto", "dense", "lowrank"):
            raise ValueError(
                f"method must be auto|dense|lowrank, got {method!r}")
        dev = resolve_device(device)
        if method == "auto":
            method = "lowrank" if n1 * n2 > int(threshold) else "dense"
        if method == "lowrank":
            # consumer scope: the feature maps come through the facade's
            # re-exports, never repro_torch.lowrank internals
            from ..dpp import nystrom_features, random_fourier_features
            X = np.asarray(doc_features, np.float64).reshape(n1 * n2, -1)
            if features == "nystrom":
                B = nystrom_features(X, rank=rank, seed=seed)
            elif features == "rff":
                B = random_fourier_features(X, rank=rank, seed=seed)
            else:
                raise ValueError(
                    f"features must be nystrom|rff, got {features!r}")
            model = LowRank(np.asarray(B * np.sqrt(scale), np.float32),
                            device=dev)
            return DPPBatchSelector(model, n1, n2, runtime=runtime,
                                    backend=backend, device=dev)
        F = doc_features.reshape(n1, n2, -1)
        L1 = _rbf_kernel(F.mean(axis=1)) * scale
        L2 = _rbf_kernel(F.mean(axis=0)) * scale
        return DPPBatchSelector(
            Kron((np.asarray(L1, np.float32), np.asarray(L2, np.float32)),
                 device=dev),
            n1, n2, runtime=runtime, backend=backend, device=dev)

    # -- sampling ------------------------------------------------------------
    def reset(self) -> None:
        """Drop buffered samples (pipeline restore calls this so replayed
        draws regenerate identically from the replayed rng stream)."""
        self._buffer = []
        self._service = None

    def _draw_subset(self, rng: np.random.Generator) -> np.ndarray:
        if self.runtime.kind == "host":
            # key derived from the pipeline rng stream keeps restore/replay
            # deterministic, same as the device service seed below
            key = prng.PRNGKey(int(rng.integers(2 ** 31)), self.device)
            sub = self.dpp.sample(key, runtime=self.runtime,
                                  device=self.device).to_lists()[0]
            return np.asarray(sub, np.int64)
        if not self._buffer:
            if self._service is None:
                # Service PRNG is derived from the pipeline rng stream, so
                # restore/replay reproduces the same device draws.
                self._service = self.dpp.service(
                    seed=int(rng.integers(2 ** 31)), runtime=self.runtime,
                    device=self.device)
            self._buffer = self._service.sample(self.prefetch)
        return np.asarray(self._buffer.pop(0), np.int64)

    def select(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """Exact DPP sample, topped up / truncated to batch_size."""
        idx = self._draw_subset(rng)
        if len(idx) > batch_size:
            idx = rng.permutation(idx)[:batch_size]
        elif len(idx) < batch_size:
            rest = np.setdiff1d(np.arange(self.n1 * self.n2), idx)
            extra = rng.choice(rest, batch_size - len(idx), replace=False)
            idx = np.concatenate([idx, extra])
        return idx

    # -- learning ------------------------------------------------------------
    def fit_from_subsets(self, subsets: Sequence[Sequence[int]],
                         iters: int = 5, a: float = 1.0,
                         minibatch_size: Optional[int] = None,
                         schedule=None, log_every: int = 0,
                         ) -> "DPPBatchSelector":
        """Adapt the kernel to observed 'good' batches through
        ``model.fit`` on the selector's device: KrK-Picard for Kron
        selectors (batch, or stochastic when ``minibatch_size`` is set),
        the dual-space Picard/projected-gradient learner for LowRank ones.
        Pass a ``repro_torch.dpp.schedules`` schedule — e.g. ``armijo()`` —
        for monotone ascent."""
        k_max = max(len(s) for s in subsets)
        batch = SubsetBatch.from_lists(subsets, k_max, device=self.device)
        # learning follows the selector's placement (the host oracle has
        # no learner — that combination trains locally; the lowrank
        # learner is Local-only)
        fit_rt = self.runtime if self.runtime.kind != "host" else None
        if isinstance(self.dpp, LowRank):
            rep = self.dpp.fit(batch, algorithm="lowrank", iters=iters,
                               a=a, schedule=schedule,
                               minibatch_size=minibatch_size,
                               track_ll=log_every > 0,
                               log_every=log_every or iters,
                               runtime=None, device=self.device)
        else:
            if fit_rt is not None and fit_rt.is_mesh:
                batch = fit_rt.even_batch(batch)
            rep = self.dpp.fit(batch,
                               algorithm="krk" if minibatch_size is None
                               else "krk-stochastic",
                               iters=iters, a=a, schedule=schedule,
                               minibatch_size=minibatch_size,
                               track_ll=log_every > 0,
                               log_every=log_every or iters,
                               runtime=fit_rt, device=self.device)
        return dataclasses.replace(self, dpp=rep.model)
