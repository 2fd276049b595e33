"""Activation sharding constraints: layout hints inside model code (port of
``repro/distributed/constraints.py``).

Model code calls these unconditionally. They return their input object
unchanged when no mesh is active (``with use_mesh(mesh):`` sets one, the
reference's ``with mesh:``) or when the input is not a DTensor, so every
single-device path runs as before. The active mesh is the process's, not
a thread's: on a card autograd runs the backward, and the recompute of a
``torch.utils.checkpoint`` unit, in its own device thread, which must
see the mesh the forward saw. Otherwise they ``redistribute`` to the
canonical layout:

    batch over ("pod","data");  heads / experts / ffn-hidden over "model".

Where DTensor's sharding propagation would keep a layout that a later op
has no rule for, or that holds a replicated (B, S, V) tensor, these pin
the reference's layout instead.
"""

from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from .sharding import (axis_sizes, map_with_path, param_partition_spec,
                       path_leaves, spec_to_placements)

_MESHES: list = []       # the process's stack of ``use_mesh`` blocks


def current_mesh():
    """The mesh of the innermost ``use_mesh`` block, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside the block, for every thread
    of the process."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def sharded_context(params):
    """The context a step on ``params`` runs in: none for plain tensors;
    for DTensors their mesh (when no mesh is set) and implicit
    replication of plain tensors (the model's constants, rope's tables
    and masks, act as replicated DTensors)."""
    leaf = next((leaf for _, leaf in path_leaves(params)), None)
    if not isinstance(leaf, DTensor):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if current_mesh() is None:
        stack.enter_context(use_mesh(leaf.device_mesh))
    stack.enter_context(implicit_replication())
    return stack


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _fits(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _fits_uneven(dim: int, size: int) -> bool:
    """The reference lets GSPMD pad uneven shardings while pad waste stays
    under ~2x (40 heads over 16 shards -> 48, 1.2x; 14 -> 16, 1.14x);
    DTensor shards such a dim unevenly."""
    return size > 0 and (dim % size == 0 or dim >= size // 2)


def _place(x, mesh, spec):
    placements = spec_to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain(x, *axes):
    """axes: per-dim entries of None | 'batch' | 'model' | explicit tuple."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    dp = _dp_axes(mesh)
    spec = []
    for dim, a in zip(x.shape, axes):
        if a == "batch":
            size = 1
            for ax in dp:
                size *= sizes[ax]
            spec.append(dp if dp and _fits(dim, size) else None)
        elif a == "model":
            ok = "model" in sizes and _fits_uneven(dim, sizes["model"])
            spec.append("model" if ok else None)
        else:
            spec.append(a)
    return _place(x, mesh, spec)


def constrain_bsd(x):
    """(B, S, d) activations: batch over dp, d replicated."""
    return constrain(x, "batch", None, None)


def constrain_heads(x):
    """(B, S, H, hd): batch over dp, heads over model."""
    return constrain(x, "batch", None, "model", None)


def splittable(x, parts: int, dim: int = -1):
    """``x`` ready for a view that splits its dim ``dim`` into ``parts``
    (heads, or KV groups) of equal width: a DTensor whose ``dim`` is
    sharded over a mesh dim of a size that does not divide ``parts`` is
    gathered on that dim first (DTensor does not unflatten such a shard;
    the reference's GSPMD pads it). Anything else comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    mesh = x.device_mesh
    placements = tuple(
        Replicate() if isinstance(p, Shard) and p.dim == dim
        and parts % mesh.size(i) != 0 else p
        for i, p in enumerate(x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def constrain_params(tree):
    """Pin each DTensor leaf of a params tree (or of a unit's slice of it,
    or of a tree congruent with it: grads, the fp32 grad accumulator) to
    its param layout, so that no leaf drifts to a replicated or partial
    layout through a loop of steps."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    dp = _dp_axes(mesh)
    tp = "model" if "model" in axis_sizes(mesh) else None

    def one(path, leaf):
        if not isinstance(leaf, DTensor):
            return leaf
        return _place(leaf, mesh, param_partition_spec(path, leaf.shape,
                                                       mesh, dp, tp))

    return map_with_path(one, tree)
