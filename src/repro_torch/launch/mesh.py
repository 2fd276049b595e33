"""Production mesh construction (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialised process group, one process a card. The reference's TPU pod is
16 x 16 chips; an H100 node is 8 cards joined by NVLink, so the ``model``
axis (tensor parallelism, the chattiest) stays inside a node and ``data``
spans nodes: 256 cards are ``(data, model) = (32, 8)``, 512 cards ``(pod,
data, model) = (2, 32, 8)``.

Defined as FUNCTIONS (never module-level constants): importing this module
touches no process group.

Every rank of a mesh must run with one ``PYTHONHASHSEED``: DTensor breaks
ties between sharding strategies of equal cost in an order that follows
string hashes, so ranks whose hashes differ may place one op apart and
wait in different collectives for ever. ``make_mesh_from_devices`` checks
it first and raises on every rank instead.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

NODE_CARDS = 8          # the model axis: the cards of one NVLink node
POD_CARDS = 256         # the reference's pod (16 x 16 chips)
HASH_PROBE = "repro_torch.launch.mesh"   # hashed alike under one hash seed


def production_shape(world: int, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) of a ``world``-card production mesh:
    ``(world / 8, 8)``, or ``(2, world / 16, 8)`` across two pods."""
    if multi_pod:
        return (2, world // (2 * NODE_CARDS), NODE_CARDS), \
            ("pod", "data", "model")
    return (world // NODE_CARDS, NODE_CARDS), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The 256-card mesh (512 across two pods) over the first 256 (512)
    ranks of the initialised process group, as the reference takes the
    first devices of a larger set; ``RuntimeError`` with fewer ranks.
    ``device_type`` as for ``make_mesh_from_devices``."""
    n = 2 * POD_CARDS if multi_pod else POD_CARDS
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need a process group of {n} ranks for the "
            f"{'multi-pod' if multi_pod else 'single-pod'} mesh, have "
            f"{world}; start one process a card and call "
            "torch.distributed.init_process_group first")
    shape, axes = production_shape(n, multi_pod)
    return make_mesh_from_devices(range(n), shape, axes, device_type)


def make_mesh_from_devices(ranks: Sequence[int], shape, axes,
                           device_type: Optional[str] = None) -> DeviceMesh:
    """Elastic path: a (possibly smaller) mesh over the first prod(shape)
    of ``ranks`` (a DeviceMesh is over ranks, not device objects), on the
    process group's device type: "cuda" under NCCL, "cpu" otherwise. A
    "fake" group (the planner's) has no device of its own, so its caller
    names the type of the shards it places (``DTensor.from_local`` moves a
    shard to its mesh's device type). Every rank of the group calls it,
    as ``DeviceMesh`` asks; a rank outside the mesh gets an object it must
    not use. Raises ``RuntimeError`` on every rank when the ranks run
    under different ``PYTHONHASHSEED``s (``check_hash_seed``)."""
    n = int(np.prod(shape))
    assert len(ranks) >= n, (len(ranks), shape)
    checked = dist.is_initialized()
    if checked:
        check_hash_seed()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = np.asarray(list(ranks)[:n], dtype=np.int64).reshape(shape)
    mesh = DeviceMesh(device_type, grid.tolist(), mesh_dim_names=tuple(axes))
    if not checked:
        # DeviceMesh started the default group from the environment
        check_hash_seed()
    return mesh


def check_hash_seed() -> None:
    """All-gather ``hash(HASH_PROBE)`` over the default process group and
    raise ``RuntimeError`` on every rank if the ranks' values differ: they
    run under different ``PYTHONHASHSEED``s. A collective of the whole
    group, so every rank calls it; skipped on a world of one and on the
    planner's "fake" group, whose collectives move no data."""
    if dist.get_world_size() == 1 or dist.get_backend() == "fake":
        return
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([hash(HASH_PROBE)], dtype=torch.int64, device=dev)
    seen = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(seen, mine)
    values = [int(v) for v in seen]
    if len(set(values)) > 1:
        raise RuntimeError(
            f"rank {dist.get_rank()}: the ranks hash strings apart (hash of "
            f"{HASH_PROBE!r} per rank: {values}); start every rank with one "
            f"PYTHONHASHSEED, e.g. PYTHONHASHSEED=0, or DTensor may place "
            f"an op apart on two ranks and hang them in different "
            f"collectives")


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (and FSDP params): ('pod','data') or
    ('data',)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.mesh_dim_names else None
