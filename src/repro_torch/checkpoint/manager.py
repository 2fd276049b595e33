"""Fault-tolerant checkpointing: async save, atomic commit, retention,
auto-resume and emergency save (port of ``repro/checkpoint/manager.py``).

Layout (per step), the JAX package's:
    <dir>/step_<n>.tmp/           # written first
        meta.json                 # step, leaf count, tree skeleton, time
        arr_<i>.npy               # one file per leaf
    <dir>/step_<n>/               # atomic rename marks the commit

A tree is a tensor, a numpy array, a ``torch.Generator`` or a scalar, or a
dict, list or tuple (a NamedTuple too, ``optim.OptState``: its fields in
order) of trees, or an object with the pair ``tree_flatten()``
/ ``tree_unflatten(leaves, like)`` (``learning.LearnerState``). Leaves are
taken in the JAX package's pytree order (a dict's keys sorted), so the
same state gives the same files in either package. A generator's leaf is
its ``get_state()``. The leaves are copied to the host when ``save`` is
called (a device sync); the files are written by a background thread.
``restore`` places each leaf where the target's leaf lives, or where
``shardings=`` says (the JAX package's ``device_put`` targets).

Sharded state (a tree holding DTensors): ``save`` gathers each DTensor
leaf to its full value, a collective that every rank of its mesh joins,
and one rank (the mesh's first) copies the leaves to the host and writes
them; the others drop each gathered leaf at once. A blocking ``save``,
and ``wait`` after a sharded save, then meet the ranks of the saved
tree's mesh (and no other rank: after an elastic re-mesh the ranks
outside the smaller mesh do not save) at a barrier, so that a restore
after them finds the commit. ``restore`` places a leaf onto a target
DTensor's mesh and placements, or onto a ``(mesh, placements)`` pair or
a ``distributed.sharding.NamedSharding`` in ``shardings`` — a mesh other
than the one saved from (the elastic re-mesh path).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep: int = 3
    save_interval_steps: int = 100
    async_save: bool = True


def _is_node(tree) -> bool:
    return hasattr(tree, "tree_flatten") and hasattr(type(tree),
                                                     "tree_unflatten")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in the JAX package's pytree order (None is an
    empty subtree, as in JAX)."""
    if tree is None:
        return []
    if _is_node(tree):
        return list(tree.tree_flatten())
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _skeleton(tree):
    """``tree`` with every leaf None — its JSON form; TypeError for an
    object node, which restores only through a ``target``."""
    if _is_node(tree):
        raise TypeError(f"{type(tree).__name__} has no JSON form")
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(t) for t in tree]
    return None


def _to_host(leaf) -> np.ndarray:
    """A numpy snapshot of one leaf, never a view of the caller's memory."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, DTensor):
        return leaf.detach().full_tensor().to("cpu", copy=True).numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _is_sharding(s) -> bool:
    """A DTensor layout: a ``(DeviceMesh, placements)`` pair or an object
    with ``mesh`` and ``placements`` (``distributed.sharding.
    NamedSharding``)."""
    if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0],
                                                           DeviceMesh):
        return True
    return hasattr(s, "mesh") and hasattr(s, "placements")


def _place(arr: np.ndarray, where) -> torch.Tensor:
    """A saved array on a device, or distributed by a layout."""
    if _is_sharding(where):
        mesh, placements = (where if isinstance(where, tuple)
                            else (where.mesh, where.placements))
        t = torch.as_tensor(arr).to(mesh.device_type)
        return distribute_tensor(t, mesh, placements)
    return torch.as_tensor(arr).to(where)


def _like(arr: np.ndarray, target, device=None):
    """One restored leaf, placed as ``target``'s leaf is (a DTensor on its
    mesh and placements), or where ``device`` says when ``restore`` was
    given ``shardings``."""
    if isinstance(target, torch.Generator):
        target.set_state(torch.as_tensor(arr))
        return target
    if device is not None:
        return _place(arr, device)
    if isinstance(target, DTensor):
        return _place(arr, (target.device_mesh, target.placements))
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(arr).to(target.device)
    return arr


def _unflatten(target, leaves: Iterator[np.ndarray], devices=None):
    if target is None:
        return None
    if _is_node(target):
        n = len(target.tree_flatten())
        part = [next(leaves) for _ in range(n)]
        if devices is None:
            return type(target).tree_unflatten(part, target)
        devs = {next(devices) for _ in range(n)}
        if len(devs) != 1:
            raise ValueError(f"a {type(target).__name__} restores onto one "
                             f"device, got shardings {sorted(map(str, devs))}")
        return type(target).tree_unflatten(part, target, device=devs.pop())
    if isinstance(target, dict):
        return {k: _unflatten(target[k], leaves, devices)
                for k in sorted(target)}
    if isinstance(target, (list, tuple)):
        children = [_unflatten(t, leaves, devices) for t in target]
        # a NamedTuple (optim.OptState) takes its fields positionally
        return type(target)(*children) if hasattr(target, "_fields") \
            else type(target)(children)
    return _like(next(leaves), target,
                 None if devices is None else next(devices))


def _from_skeleton(skeleton, leaves: Iterator[np.ndarray], devices=None):
    if isinstance(skeleton, dict):
        return {k: _from_skeleton(v, leaves, devices)
                for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_from_skeleton(v, leaves, devices) for v in skeleton]
    arr = next(leaves)
    return arr if devices is None else _place(arr, next(devices))


def _sharding_leaves(tree) -> list:
    """The placement leaves of a ``shardings`` tree: a layout is a leaf,
    not a tuple node."""
    if _is_sharding(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sharding_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sharding_leaves(t)]
    return [] if tree is None else [tree]


def _leaf_devices(shardings, n: int) -> list:
    """Where each of ``n`` leaves goes: ``shardings`` is one device (or its
    name) or one layout for all, or a tree of them holding n. A device is
    returned as a ``torch.device``, a layout as it is."""
    if isinstance(shardings, (str, torch.device)):
        return [torch.device(shardings)] * n
    if _is_sharding(shardings):
        return [shardings] * n
    out = [s if _is_sharding(s) else torch.device(s)
           for s in _sharding_leaves(shardings)]
    if len(out) != n:
        raise ValueError(f"shardings names {len(out)} devices for a tree "
                         f"of {n} leaves")
    return out


def _mesh_of(leaves) -> Optional[DeviceMesh]:
    """The mesh of the first DTensor leaf, or None for plain leaves."""
    for leaf in leaves:
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _writes(mesh: Optional[DeviceMesh]) -> bool:
    """The mesh's first rank writes a sharded tree; a tree of plain leaves
    is written by whoever saves it."""
    if mesh is None:
        return True
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def _barrier(mesh: DeviceMesh) -> None:
    """Every rank of ``mesh`` meets, and no other: a barrier over each mesh
    dim's group in turn (after the k-th, a rank's peers along the first k
    dims have all arrived)."""
    for group in mesh.get_all_groups():
        dist.barrier(group=group)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self._mesh: Optional[DeviceMesh] = None   # wait() meets its ranks
        if cfg.async_save:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- public API -----------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step % self.cfg.save_interval_steps == 0

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk async."""
        if self._pending_error:
            raise self._pending_error
        leaves = _flatten(tree)
        mesh = _mesh_of(leaves)
        if not _writes(mesh):
            for leaf in leaves:           # join each gather, keep nothing
                if isinstance(leaf, DTensor):
                    leaf.full_tensor()
        else:
            host = ([_to_host(leaf) for leaf in leaves],
                    self._tree_json(tree))
            if self.cfg.async_save and not blocking:
                self._q.put((step, host))
            else:
                self._write(step, host)
        if mesh is not None and (blocking or not self.cfg.async_save):
            _barrier(mesh)
        elif mesh is not None:
            self._mesh = mesh

    def emergency_save(self, step: int, tree: Any) -> None:
        """Blocking save used from failure handlers (signal/except hooks)."""
        self.save(step, tree, blocking=True)

    def wait(self) -> None:
        self._q.join()
        if self._pending_error:
            raise self._pending_error
        if self._mesh is not None:
            _barrier(self._mesh)
            self._mesh = None

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, target: Any = None,
                shardings: Any = None) -> Any:
        """Load a checkpoint.

        target: an example tree providing the structure — required to
        restore an object node (``LearnerState``) — and the placement:
        each tensor leaf is restored onto the device of the target's leaf,
        a generator leaf into the target's generator. Without a target the
        result is the saved dicts and lists of numpy arrays.
        shardings: where the leaves go, in place of the target's
        placement (the JAX package's ``device_put`` targets): one
        ``torch.device`` (or its name) or one layout for every leaf, or a
        tree of them with one a leaf (an object node's leaves on one
        device). A layout is a ``(DeviceMesh, placements)`` pair or a
        ``NamedSharding``: the leaf becomes a DTensor there
        (``distribute_tensor``; every rank of the mesh calls ``restore``).
        Each other leaf becomes a tensor on its device; a generator's
        state goes into the target's generator.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.cfg.directory}")
        d = os.path.join(self.cfg.directory, f"step_{step}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves = [np.load(os.path.join(d, f"arr_{i}.npy"))
                  for i in range(meta["n_leaves"])]
        devices = (None if shardings is None
                   else iter(_leaf_devices(shardings, len(leaves))))
        if target is not None:
            want = len(_flatten(target))
            if want != len(leaves):
                raise ValueError(f"checkpoint step_{step} holds "
                                 f"{len(leaves)} leaves, the target {want}")
            return _unflatten(target, iter(leaves), devices)
        if meta.get("tree") is None:
            raise ValueError(
                f"checkpoint step_{step} holds custom tree nodes; pass a "
                "`target` tree to restore it")
        return _from_skeleton(json.loads(meta["tree"]), iter(leaves),
                              devices)

    # -- internals ---------------------------------------------------------------
    @staticmethod
    def _tree_json(tree) -> Optional[str]:
        try:
            return json.dumps(_skeleton(tree))
        except TypeError:
            # object nodes (e.g. learning.LearnerState) have no JSON form;
            # such checkpoints restore via an explicit `target` tree.
            return None

    def _committed_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def _write(self, step: int, host) -> None:
        leaves, tree_json = host
        # unique tmp dir: concurrent writers of the same step never collide;
        # the atomic rename still publishes exactly one complete snapshot.
        d_tmp = os.path.join(self.cfg.directory,
                             f"step_{step}.{os.getpid()}_{id(host)}.tmp")
        d_final = os.path.join(self.cfg.directory, f"step_{step}")
        os.makedirs(d_tmp)
        with open(os.path.join(d_tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(leaves),
                       "tree": tree_json, "time": time.time()}, f)
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(d_tmp, f"arr_{i}.npy"), leaf)
        if os.path.exists(d_final):
            shutil.rmtree(d_final)
        try:
            os.rename(d_tmp, d_final)      # atomic commit
        except OSError:
            shutil.rmtree(d_tmp, ignore_errors=True)   # lost the race: drop
        self._gc()

    def _gc(self) -> None:
        steps = self._committed_steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s}"),
                          ignore_errors=True)

    def _drain(self) -> None:
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:              # surfaced on next save/wait
                self._pending_error = e
            finally:
                self._q.task_done()
