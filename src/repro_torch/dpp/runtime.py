"""Execution placement for the ``repro_torch.dpp`` facade: where DPP work
runs (port of ``repro/dpp/runtime.py``).

``Local()``
    one device (the default): every tensor lives on the caller's
    ``device`` and a batch is one call.
``Mesh(axes={"data": n}, devices=[...])``
    data-parallel placement over a list of devices, driven by this one
    process: batches of PRNG keys are cut into one shard a data-axis
    position (``map_keys``), training subsets likewise (``shard_batch``),
    and learning's statistics are summed over the shards in a fixed shard
    order (``core.distributed``). The arithmetic of a row or a subset is
    that of ``Local``, so a draw reproduces the ``Local`` draw of the same
    key bit for bit.
``Host()``
    the numpy reference oracle (``core.sampling``): one eigh and one host
    loop a draw, on the CPU because the caller asked for it.

The JAX package's ``Mesh`` is a jax device mesh driven by one controller.
Its port is a list of ``torch.device``s, also driven by one process: each
shard runs under its device's context (``torch.cuda.device``), one after
the other, on that device's current stream, so shards on different cards
overlap as far as their launches are asynchronous. A device may repeat in
the list — ``Mesh(axes={"data": 4}, devices=["cuda:0"] * 4)`` cuts a batch
into four shards on one card, ``devices=["cpu"] * 8`` into eight on the
CPU — which is the port's counterpart of the JAX package's forced host
devices; a node of several cards passes its distinct devices. A
process-group backend (several processes, NCCL) belongs with the launch
scripts, not here.

This module imports nothing of the rest of ``repro_torch.dpp`` (models
import it, not the reverse), so ``repro_torch.sampling`` and
``repro_torch.learning`` depend on it without a cycle.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from .._device import DeviceLike, canonical_device, device_context


class Runtime:
    """Shared protocol for execution placements. ``kind`` is the stable
    discriminator subsystem code dispatches on (no isinstance chains, so
    duck-typed runtimes keep working across module reloads)."""

    kind: str = "local"

    #: True when batched device work should go through ``map_keys``/
    #: ``shard_batch`` instead of one flat call.
    @property
    def is_mesh(self) -> bool:
        return self.kind == "mesh"

    def map_keys(self, fn, keys: torch.Tensor, operands=(), static_key=None):
        """Run ``fn(keys, operands)`` (per-key independent; returns tensors
        whose leading dim matches ``keys``) under this placement."""
        return fn(keys, operands)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


@dataclasses.dataclass(frozen=True)
class Local(Runtime):
    """One device — the default placement everywhere."""
    kind = "local"


@dataclasses.dataclass(frozen=True)
class Host(Runtime):
    """The numpy reference oracle (plain-DPP sampling only)."""
    kind = "host"


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of equal-structured tuples/lists."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A resolved mesh: axis names, their sizes, and the devices in
    row-major order over the axes (a device may repeat)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def devices_along(self, axes: Sequence[str]) -> Tuple[torch.device, ...]:
        """One device per position on ``axes`` (row-major): the device at
        index 0 of every other axis — a shard is replicated over those."""
        keep = [a in axes for a in self.axis_names]
        return tuple(dev for idx, dev in zip(np.ndindex(*self.shape),
                                             self.devices)
                     if all(k or i == 0 for k, i in zip(keep, idx)))


class Mesh(Runtime):
    """Data-parallel placement over a list of devices.

    axes: ordered ``{axis_name: size}`` — e.g. ``{"data": 8}`` or
        ``{"data": 4, "model": 2}``; -1 takes every device left. Every
        axis except ``"model"`` shards data (batches of PRNG keys and
        training subsets); ``"model"`` is reserved, as in the JAX package
        (``core.distributed.make_distributed_krk_step(shard_updates=)``),
        and its shards replicate the data shard they sit on.
    devices: the devices, ``torch.device``s or their names (default:
        every visible card, ``cuda:0 … cuda:{device_count-1}``), of which
        the first prod(axes) are used. A device may repeat.

    The device list is resolved on first use, so building a ``Mesh`` spec
    touches no device. The first data shard's device holds a mapped
    call's keys, operands and results (``home``).
    """

    kind = "mesh"
    _PINNED_MAX = 64

    def __init__(self, axes: Optional[Dict[str, int]] = None, *,
                 devices: Optional[Sequence[DeviceLike]] = None):
        if axes is None:
            axes = {"data": -1}          # -1: all available devices
        self._axes = dict(axes)
        self._devices = None if devices is None else list(devices)
        self._mesh: Optional[DeviceMesh] = None
        #: static_key -> the shard plan of a mapped sampler (see map_keys)
        self._mapped_cache: Dict = {}
        #: id(tensor) -> (source ref, {device: copy}) for long-lived
        #: tensors (cached spectra); see ``replicate_pinned``
        self._pinned = collections.OrderedDict()

    # -- mesh construction --------------------------------------------------
    @property
    def mesh(self) -> DeviceMesh:
        if self._mesh is None:
            devs = (self._devices if self._devices is not None else
                    [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
            axes = dict(self._axes)
            for name, size in axes.items():
                if size == -1:
                    fixed = math.prod(s for s in axes.values() if s != -1)
                    axes[name] = max(1, len(devs) // max(1, fixed))
            shape = tuple(int(s) for s in axes.values())
            n = math.prod(shape)
            if len(devs) < n:
                raise ValueError(
                    f"Mesh(axes={axes}) needs {n} devices, have "
                    f"{len(devs)} — pass devices= (a device may repeat, "
                    f"e.g. devices=['cpu'] * {n} or ['cuda:0'] * {n})")
            self._mesh = DeviceMesh(
                tuple(axes), shape,
                tuple(canonical_device(d) for d in devs[:n]))
        return self._mesh

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh.axis_names

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes that shard data batches — everything but ``model``."""
        return tuple(a for a in self.mesh.axis_names if a != "model")

    @property
    def num_data_shards(self) -> int:
        return len(self.data_devices)

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The device of each data shard, in shard order."""
        return self.mesh.devices_along(self.data_axes)

    def home(self, device: DeviceLike) -> torch.device:
        """The device a mapped call's inputs and results live on — the
        first data shard's — checked against the caller's ``device``
        (``ValueError`` when it names another)."""
        dev = canonical_device(device)
        first = self.data_devices[0]
        if dev != first:
            raise ValueError(
                f"{self!r} gathers on its first data shard's device "
                f"{first}; got device={str(dev)!r}")
        return first

    def __repr__(self) -> str:
        if self._mesh is not None:
            return (f"Mesh(axes="
                    f"{dict(zip(self._mesh.axis_names, self._mesh.shape))})")
        return f"Mesh(axes={self._axes})"

    # -- placement primitives ------------------------------------------------
    def replicate(self, tree) -> list:
        """``tree`` (a tensor or a tuple/list of them) on every data
        shard's device: one tree a shard, one copy a distinct device
        (shards on one device share it; a leaf already there is itself)."""
        copies = {}
        out = []
        for dev in self.data_devices:
            if dev not in copies:
                copies[dev] = _tree_map(lambda x: x.to(dev), tree)
            out.append(copies[dev])
        return out

    def replicate_pinned(self, arrays: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
        """The tensors on the first data shard's device, with a copy on
        every other distinct device of the mesh held in an identity-keyed
        LRU cache (strong refs pin the ids, as ``SpectralCache`` does), so
        that ``map_keys`` finds them and repeated placement of long-lived
        tensors such as cached spectra is a dict hit, not a transfer a
        call. Do NOT use for per-step tensors (learner params): every new
        tensor would make a new entry."""
        devs = list(dict.fromkeys(self.data_devices))
        out = []
        for x in arrays:
            hit = self._pinned.get(id(x))
            if hit is None or hit[0] is not x:
                copies = {dev: x.to(dev) for dev in devs}
                hit = (x, copies)
                self._pin(x, hit)
                home = copies[devs[0]]
                if home is not x:            # map_keys looks it up by id
                    self._pin(home, (home, copies))
            else:
                self._pinned.move_to_end(id(x))
            out.append(hit[1][devs[0]])
        return tuple(out)

    def pin_spectrum(self, spec):
        """A spectrum (a frozen dataclass of tensors and tuples of them:
        ``FactorSpectrum``, ``DualSpectrum``) with every tensor placed by
        ``replicate_pinned`` — on the first data shard's device, its copies
        on the others found by ``map_keys``."""
        fields = {}
        for f in dataclasses.fields(spec):
            v = getattr(spec, f.name)
            fields[f.name] = (self.replicate_pinned(v) if isinstance(v, tuple)
                              else self.replicate_pinned((v,))[0])
        return dataclasses.replace(spec, **fields)

    def _pin(self, x, entry) -> None:
        self._pinned[id(x)] = entry
        while len(self._pinned) > self._PINNED_MAX:
            self._pinned.popitem(last=False)

    def _on(self, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """Operand ``x`` on ``dev``: itself when it is there, its pinned
        copy when ``replicate_pinned`` made one, else a transfer."""
        if x.device == dev:
            return x
        hit = self._pinned.get(id(x))
        if hit is not None and hit[0] is x and dev in hit[1]:
            return hit[1][dev]
        return x.to(dev)

    def shard_batch(self, batch):
        """A ``SubsetBatch`` cut into one batch a data shard, on that
        shard's device (``even_batch`` first when n does not divide the
        shard count)."""
        from ..core.distributed import shard_subsets
        return shard_subsets(self, batch, self.data_axes)

    def even_batch(self, batch):
        """Trim a ``SubsetBatch`` to the largest length divisible by the
        data-shard count (the shards must be even)."""
        from ..core.dpp import SubsetBatch
        n = batch.indices.shape[0]
        keep = n - n % self.num_data_shards
        if keep == n:
            return batch
        if keep == 0:
            raise ValueError(
                f"batch of {n} subsets cannot be sharded over "
                f"{self.num_data_shards} data shards")
        trunc = getattr(batch, "truncated", None)
        return SubsetBatch(batch.indices[:keep], batch.mask[:keep],
                           None if trunc is None else trunc[:keep])

    # -- the sampling seam ---------------------------------------------------
    def map_keys(self, fn, keys: torch.Tensor, operands=(), static_key=None):
        """Cut a batch of PRNG keys (n, 2) into one shard a data-axis
        position and run ``fn(shard_keys, operands)`` on each shard's
        device, under its context, with ``operands`` (tensors, or
        tuples/lists of them, e.g. a spectrum) placed there; the results
        (a tensor or a tuple of them, leading dim = keys) are concatenated
        in shard order on the first shard's device.

        ``fn`` must be per-key independent (every sampler in
        ``repro_torch.sampling`` is), so the result equals the unsharded
        ``fn(keys, operands)`` draw for draw. A key count that does not
        divide the shard count is padded with repeated keys
        (``keys[arange(n + pad) % n]``) and the pad rows are sliced off
        before anything is counted — so the shard count never changes
        what callers see, and per-row statistics (truncation flags) never
        count a pad row.

        ``static_key`` (a hashable tag of ``fn``'s static config) caches
        the shard plan on this Mesh, one entry a tag, where the JAX
        package caches a compiled executable; its hits and misses are
        counted under the JAX package's names. A cached ``fn`` closes over
        static config only; every tensor input flows through
        ``operands``.
        """
        if not isinstance(keys, torch.Tensor):
            raise ValueError(
                f"a Mesh shards a batch of PRNG keys; got "
                f"{type(keys).__name__} — a torch.Generator draws one stream "
                f"for every row, so pass a key (repro_torch.random.PRNGKey)")
        n = int(keys.shape[0])
        tracker = obs.current_tracker()
        if static_key is not None:
            plan = self._mapped_cache.get(static_key)
            if plan is None:
                tracker.counter("runtime.mesh.exec_cache_misses")
                plan = self._mapped_cache[static_key] = self.data_devices
            else:
                tracker.counter("runtime.mesh.exec_cache_hits")
        else:
            plan = self.data_devices
        shards = len(plan)
        pad = (-n) % shards
        if pad:
            keys = keys[torch.arange(n + pad, device=keys.device) % n]
        home = plan[0]
        if obs.enabled(tracker):
            # the sync exists only to make the span an honest wall-clock
            # sample, and only when someone is listening
            with obs.spans.start_span("runtime.mesh.map_keys",
                                      tracker=tracker, keys=n,
                                      shards=shards):
                out = self._run_shards(fn, keys, operands, plan)
                if home.type == "cuda":
                    for dev in set(plan):
                        torch.cuda.synchronize(dev)
        else:
            out = self._run_shards(fn, keys, operands, plan)
        if pad:
            out = _tree_map(lambda x: x[:n], out)
        # emitted AFTER the pad slice, so per-shard row stats downstream
        # consumers derive (e.g. ServiceStats.truncations) and the counts
        # here agree on what a "row" is: real keys only, all shards
        if obs.enabled(tracker):
            tracker.counter("runtime.mesh.map_keys_calls")
            tracker.counter("runtime.mesh.keys", n)
            tracker.counter("runtime.mesh.pad_rows", pad)
            tracker.gauge("runtime.mesh.data_shards", shards)
        return out

    def _run_shards(self, fn, keys, operands, plan):
        per = int(keys.shape[0]) // len(plan)
        home = plan[0]
        outs = []
        for s, dev in enumerate(plan):
            with device_context(dev):
                ops = _tree_map(lambda x: self._on(x, dev), operands)
                outs.append(fn(keys[s * per:(s + 1) * per].to(dev), ops))
        return _tree_map(lambda *parts: torch.cat(
            [p.to(home) for p in parts]), *outs)


# ---------------------------------------------------------------------------
# Resolution / CLI helpers
# ---------------------------------------------------------------------------

def default_runtime() -> Runtime:
    return Local()


def from_spec(spec: "str | Runtime | None") -> Runtime:
    """CLI-friendly constructor: ``"local"`` / ``"host"`` / ``"mesh"``
    (all devices on one ``data`` axis) or an existing ``Runtime``."""
    if spec is None:
        return Local()
    if isinstance(spec, Runtime):
        return spec
    name = str(spec).lower()
    if name == "local":
        return Local()
    if name == "host":
        return Host()
    if name == "mesh":
        return Mesh()
    raise ValueError(f"unknown runtime spec {spec!r}; "
                     f"expected 'local', 'host' or 'mesh'")


def resolve(runtime: Optional[Runtime] = None, *,
            backend: Optional[str] = None,
            mesh=None, stacklevel: int = 3) -> Runtime:
    """One resolution point for the deprecated placement spellings.

    ``backend="device"|"host"`` (pre-runtime sampler strings) and
    ``mesh=<Mesh>`` (pre-runtime fit plumbing) warn and map onto
    runtimes; passing either together with ``runtime=`` is an error —
    there must be exactly one source of placement truth. There is no jax
    mesh to adopt here: ``mesh=`` takes a ``Mesh`` of this module.
    """
    legacy = []
    if backend is not None:
        if backend not in ("device", "host"):
            raise ValueError(f"backend must be 'device' or 'host', "
                             f"got {backend!r}")
        warnings.warn(
            "backend= placement strings are deprecated; pass "
            "runtime=repro_torch.dpp.runtime.Local() (was backend='device') "
            "or runtime=repro_torch.dpp.runtime.Host() (was "
            "backend='host')", DeprecationWarning, stacklevel=stacklevel)
        legacy.append(Host() if backend == "host" else Local())
    if mesh is not None:
        warnings.warn(
            "mesh= is deprecated; pass runtime=Mesh(axes={'data': n}, "
            "devices=[...]) (repro_torch.dpp.runtime.Mesh)",
            DeprecationWarning, stacklevel=stacklevel)
        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh= wants a repro_torch.dpp.runtime.Mesh, got "
                f"{type(mesh).__name__}")
        legacy.append(mesh)
    if legacy:
        if runtime is not None or len(legacy) > 1:
            raise ValueError(
                "conflicting placements: pass exactly one of runtime=, "
                "backend= (deprecated) or mesh= (deprecated)")
        return legacy[0]
    if isinstance(runtime, str):
        if runtime in ("device", "host"):
            # a pre-runtime backend string in the runtime slot — the shape
            # legacy POSITIONAL callers of the old backend= parameters
            # produce; honor the shim contract rather than TypeError-ing
            return resolve(backend=runtime, stacklevel=stacklevel + 1)
        raise TypeError(
            f"runtime= wants a Runtime object, got the string {runtime!r} "
            f"— use repro_torch.dpp.runtime.from_spec({runtime!r}) for "
            f"CLI-style specs")
    if runtime is None:
        return Local()
    if not isinstance(runtime, Runtime) and not hasattr(runtime, "kind"):
        raise TypeError(
            f"runtime= wants a repro_torch.dpp.runtime Runtime, got "
            f"{type(runtime).__name__}")
    return runtime
