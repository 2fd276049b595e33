"""Distributed KrK-Picard — the paper's learner over a ``Mesh`` of devices
(port of ``repro/core/distributed.py``).

Parallel decomposition (beyond the paper, which is single-node MATLAB):
  * Θ-statistics (the A and C matrices of Appendix B) are SUMS over training
    subsets → cut the subset batch into one shard a data-axis position,
    accumulate each shard's A/C on its device (``krk_picard``'s per-subset
    route), and sum the shard sums in shard order on the first shard's
    device: one (N1² + N2²)-sized reduction a sweep.
  * The closed-form (I+L)^{-1} contractions need only the factor
    eigendecompositions (N1³ + N2³ flops) → computed once, replicated.
  * Updates are rank-N1/N2 symmetric products → done once after the sum.

The JAX package runs this as one ``shard_map`` region with ``psum``; the
port's ``Mesh`` is driven by one process, so the region is a loop over the
shards, each under its device's context (``_device.device_context``),
and the ``psum`` is the fixed-order sum. ``shard_map_compat`` is jax-only
and has no counterpart: running a function a shard is ``Mesh.map_keys``'s
job, and the loops here. The sweep itself is the learning engine's
(``learning.engine.krk_sweep``): ``ShardedStatistics`` gives it the
sharded batch, minibatches and statistics, so ``fit(runtime=Mesh(...))``
runs the engine's own chunk loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import random as prng
from ..kernels import ops as kernel_ops
from .._device import device_context
from .dpp import SubsetBatch
from .krk_picard import _subset_AC


def _shard_devices(mesh, data_axes) -> Tuple[torch.device, ...]:
    return mesh.mesh.devices_along(tuple(data_axes))


def _shard_sum(fn, tensors, subs: Sequence[SubsetBatch],
               devs: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    """Σ_s fn(tensors on shard s's device, subs[s]) — each term computed
    under its device's context (a tensor already there is not copied),
    the terms added in shard order on the first shard's device (the port's
    ``psum``: the same order every call, so every shard's branch sees one
    value)."""
    total = None
    for dev, sub in zip(devs, subs):
        with device_context(dev):
            part = tuple(p.to(devs[0]) for p in fn(
                tuple(t.to(dev) for t in tensors), sub))
        total = part if total is None else tuple(
            t + p for t, p in zip(total, part))
    return total


class ShardedStatistics:
    """A KrK sweep's data and statistics over the data shards of a
    ``dpp.runtime.Mesh`` — the ``learning.engine.LocalStatistics``
    interface, so the engine's sweep (``learning.engine.krk_sweep``) and
    chunk loop drive a mesh as they drive one device:

      * ``place``: the batch cut into one ``SubsetBatch`` a shard on its
        device (``shard_subsets``);
      * ``select``: each shard draws its share (``size / P`` rows) from its
        own rows via ``shard_select_no_replace`` on
        ``fold_in(key, shard_index)`` — the JAX package's chain, so host
        code replays it with the same calls;
      * ``AC`` / ``C``: the shard sums of the per-subset route, summed in
        shard order, over the global count;
      * ``ll``: the acceptance log-likelihood from the shard sums of the
        subset log-determinants, so every shard takes the same Armijo
        branch on the GLOBAL sweep objective (Thm 3.2's PSD + ascent
        guarantee, and the schedule parity with the one-device engine).
    """

    runtime = "mesh"

    def __init__(self, mesh, data_axes=("data",)):
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.devs = _shard_devices(mesh, data_axes)

    def place(self, batch: SubsetBatch) -> Tuple[SubsetBatch, ...]:
        return shard_subsets(self.mesh, batch, self.data_axes)

    def share(self, size: int) -> int:
        """Each shard's rows of a ``size``-row minibatch."""
        P = len(self.devs)
        if size % P:
            raise ValueError(
                f"minibatch_size={size} must divide evenly over the {P} "
                f"data shards (each shard draws its share locally)")
        return size // P

    def select(self, key, shards: Sequence[SubsetBatch], size: int
               ) -> Tuple[SubsetBatch, ...]:
        n = sum(s.n for s in shards)
        if size > n:
            raise ValueError(f"cannot draw minibatches of {size} from a "
                             f"batch of {n} subsets")
        P = len(shards)
        key = prng.as_key(key)
        skeys = prng.fold_in(key.expand(P, 2),
                             torch.arange(P, device=key.device))
        sel = shard_select_no_replace(skeys, shards[0].n, self.share(size))
        return tuple(SubsetBatch(s.indices[i], s.mask[i]) for s, i in
                     zip(shards, (r.to(s.indices.device).long()
                                  for r, s in zip(sel, shards))))

    def AC(self, L1, L2, shards):
        A, C = _shard_sum(lambda f, sub: _subset_AC(f[0], f[1], sub),
                          (L1, L2), shards, self.devs)
        n = sum(s.n for s in shards)
        return A / n, C / n

    def C(self, L1, L2, shards):
        return self.AC(L1, L2, shards)[1]

    def ll(self, factors, shards) -> torch.Tensor:
        from ..learning.objective import (logdet_I_plus_kron,
                                          subset_logdets_factored)
        s, = _shard_sum(
            lambda f, sub: (subset_logdets_factored(f, sub).sum(),),
            tuple(factors), shards, self.devs)
        return s / sum(sh.n for sh in shards) - logdet_I_plus_kron(
            tuple(factors))


def make_distributed_krk_step(mesh, data_axes=("data",),
                              shard_updates: bool = True,
                              fresh_spectrum: bool = True):
    """Returns a ``(L1, L2, shards, a) -> (L1', L2')`` step: the sweep of
    ``make_distributed_krk_sweep`` at a constant step ``a``.

    ``mesh`` is a ``dpp.runtime.Mesh``; ``shards`` is the subset batch cut
    over ``data_axes`` (``shard_subsets``, one ``SubsetBatch`` a shard on
    its device); the factors live on the first shard's device.

      shard_updates: in the JAX package, a sharding constraint that
        spreads the O(N_i^3) update products over the "model" axis — a
        layout hint with identical math. Accepted here for the
        signature's sake; the updates are computed once, replicated.
      fresh_spectrum: paper-faithful recomputation of eigh(L1) after the L1
        update, used by the L2 update. False reuses the pre-update spectrum
        (one fewer N^{3/2} eigendecomposition a sweep); ascent is then no
        longer guaranteed by Thm 3.2.
    """
    from ..learning import schedules
    from ..learning.engine import krk_sweep
    stats = ShardedStatistics(mesh, data_axes)
    const = schedules.constant(1.0)

    def step(L1, L2, shards: Sequence[SubsetBatch], a: float = 1.0):
        (L1n, L2n), _, _ = krk_sweep((L1, L2), tuple(shards), a, const,
                                     stats, fresh_spectrum)
        return L1n, L2n

    return step


def shard_subsets(mesh, batch: SubsetBatch, data_axes=("data",)
                  ) -> Tuple[SubsetBatch, ...]:
    """A subset batch cut on dim 0 into one ``SubsetBatch`` a data shard,
    each on its shard's device (all fields, including the optional
    truncation provenance). The one batch-sharding helper —
    ``runtime.Mesh.shard_batch`` delegates here."""
    devs = _shard_devices(mesh, data_axes)
    n, P = batch.n, len(devs)
    if n % P:
        raise ValueError(
            f"batch of {n} subsets does not divide the mesh's {P} data "
            f"shards; trim with runtime.even_batch(batch)")
    per = n // P
    trunc = getattr(batch, "truncated", None)
    return tuple(SubsetBatch(
        batch.indices[s * per:(s + 1) * per].to(dev),
        batch.mask[s * per:(s + 1) * per].to(dev),
        None if trunc is None else trunc[s * per:(s + 1) * per].to(dev))
        for s, dev in enumerate(devs))


def shard_select_no_replace(key, n: int, m: int,
                            backend: Optional[str] = None) -> torch.Tensor:
    """(m,) uniform without-replacement indices into [0, n), int32 — a
    partial Fisher-Yates shuffle (m randint swaps), the JAX package's
    function bit for bit: for t < m, ``key, sub = split(key)``,
    ``j = randint(sub, (), t, n)``, swap idx[t] and idx[j]. Host code
    replaying a shard's selection calls this with
    ``fold_in(key, shard_index)``.

    ``key`` may be one key (2,) or a batch (..., 2) of them, giving
    (..., m): each key's selection alone, so the shards of a sweep draw in
    one call. The draw is the "select" mode of ``kernels.ops.threefry2x32``
    on the keys' device: one launch of the hand-written kernel walks every
    key's chain of m splits on the card, the plain version runs it for
    keys on the CPU (``backend`` forces one).
    """
    if m > n:
        raise ValueError(f"cannot draw {m} rows without replacement from "
                         f"a population of {n}")
    key = prng.as_key(key)
    out = kernel_ops.threefry2x32(key.reshape(-1, 2), int(n), "select",
                                  n2=int(m), backend=backend)
    return out.reshape(tuple(key.shape[:-1]) + (int(m),))


def make_distributed_krk_sweep(mesh, schedule, data_axes=("data",),
                               minibatch_size: Optional[int] = None,
                               fresh_theta: bool = True):
    """The full KrK-Picard sweep of ``learning.engine.krk_sweep`` over the
    data shards of a ``dpp.runtime.Mesh`` (``ShardedStatistics``: per-shard
    minibatches on ``fold_in(key, shard_index)``, Θ-statistics and Armijo
    acceptance log-likelihoods summed over the shards) — what the engine
    runs a sweep under ``fit(runtime=Mesh(...))``.

    Returns ``(L1, L2, shards, key, a_trial) -> (L1', L2', a_accepted,
    n_backtracks)``: ``shards`` one ``SubsetBatch`` a data shard on its
    device (``shard_subsets``), the factors, key and step on the first
    shard's device. Factor eigendecompositions and updates run once.
    """
    from ..learning.engine import krk_sweep
    stats = ShardedStatistics(mesh, data_axes)
    if minibatch_size is not None:
        stats.share(minibatch_size)

    def sweep(L1, L2, shards: Sequence[SubsetBatch], key, a_trial):
        subs = (stats.select(key, shards, minibatch_size)
                if minibatch_size else tuple(shards))
        (L1n, L2n), a, bt = krk_sweep((L1, L2), subs, a_trial, schedule,
                                      stats, fresh_theta)
        return L1n, L2n, a, bt

    return sweep
