"""Sharding policy: maps every param / activation / cache tensor to a
per-dim spec on the (pod, data, model) mesh, and a spec to DTensor
placements (port of ``repro/distributed/sharding.py``).

Policy (the reference's):
  * TP over "model": attention heads, FFN hidden dim, expert dim (EP), vocab
    for the LM head.
  * FSDP over ("pod","data"): the non-TP dim of every large param and its
    optimizer state (ZeRO-3).
  * batch over ("pod","data"); long-context decode (batch=1) shards the KV
    sequence instead (SP).
  * Divisibility guard: any dim not divisible by its axis group is
    replicated instead (keeps every arch on the same mesh — e.g.
    whisper-tiny's 6 heads on a 16-way model axis).

A spec is the reference's ``PartitionSpec`` as a plain tuple (``P``), one
entry a tensor dim: None, an axis name, or a tuple of axis names (pod
major).
``spec_to_placements`` turns it into DTensor placements, one a mesh dim;
a sharding is ``NamedSharding(mesh, spec)``, whose ``placements`` are
those; ``distribute(tree, shardings)`` places a tree of tensors.

DTensor shards unevenly where the reference's GSPMD pads (TP dims with
``dim >= size // 2``): the numbers are the same, the local shapes differ.

A mesh here is a ``DeviceMesh`` or any object with a ``shape`` mapping
axis name -> size (the rule table reads only sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..config import ModelConfig, ParallelConfig

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """The reference's ``PartitionSpec(*entries)`` as a tuple: a one-axis
    tuple entry becomes its axis name, an empty one None."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in entries)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a sizes object."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one a mesh dim: ``Shard(d)`` on the
    mesh dims named by tensor dim d's entry (a tuple ("pod", "data") on
    both, pod major as the mesh orders them), ``Replicate()`` elsewhere."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout: the mesh and the reference's spec."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return spec_to_placements(self.spec, self.mesh)


def path_leaves(tree, prefix: str = ""):
    """(path, leaf) of every leaf of nested dicts, in insertion order; the
    path joins the keys with "/" (the reference's ``_path_str``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from path_leaves(v, f"{prefix}{k}/")
    elif tree is not None:
        yield prefix[:-1], tree


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` on every leaf of nested dicts, NamedTuples and
    tuples (a NamedTuple's field names in the path, a tuple's index)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        items = [map_with_path(fn, v, f"{prefix}{n}/")
                 for n, v in zip(names, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return None if tree is None else fn(prefix[:-1], tree)


def distribute(tree, shardings):
    """Each tensor leaf of ``tree`` placed by the ``NamedSharding`` leaf of
    ``shardings`` (``distribute_tensor``: every rank passes the whole
    tensor, rank 0's values are broadcast)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [distribute(v, s) for v, s in zip(tree, shardings)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    if tree is None:
        return None
    if isinstance(tree, DTensor):
        return tree.redistribute(shardings.mesh, shardings.placements)
    return distribute_tensor(tree, shardings.mesh, shardings.placements)


class ShardingPolicy:
    def __init__(self, mesh, cfg: ModelConfig,
                 parallel: Optional[ParallelConfig] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.par = parallel or ParallelConfig()
        names = tuple(axis_sizes(mesh))
        self.dp: Tuple[str, ...] = tuple(
            a for a in names if a in ("pod", "data"))
        self.tp: Optional[str] = "model" if "model" in names else None

    def _div(self, dim: int, axes) -> bool:
        if axes is None or (isinstance(axes, tuple) and not axes):
            return False
        return dim % _axis_size(self.mesh, axes) == 0

    def _named(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    # -- parameters ----------------------------------------------------------
    def param_spec(self, path: str, shape) -> Spec:
        return param_partition_spec(path, shape, self.mesh, self.dp, self.tp,
                                    fsdp=self.par.fsdp, tp_on=self.par.tp)

    def params_shardings(self, params_shapes) -> Any:
        """A ``NamedSharding`` for every leaf (a tensor or anything with a
        ``shape``) of the params tree (or of a tree congruent with it:
        the optimizer's moments)."""
        return map_with_path(
            lambda path, leaf: self._named(self.param_spec(path,
                                                           leaf.shape)),
            params_shapes)

    # -- batches ---------------------------------------------------------------
    def batch_shardings(self, batch_shapes) -> Any:
        def one(path, leaf):
            if len(leaf.shape) >= 1 and self._div(leaf.shape[0], self.dp):
                return self._named((self.dp,))
            return self._named(())
        return map_with_path(one, batch_shapes)

    # -- decode state ------------------------------------------------------------
    def decode_state_shardings(self, state_shapes) -> Any:
        """KV cache k/v: (units, B, S, KV, hd); SSM state: (units, B, nh, hp, N);
        conv state: (units, B, k-1, conv_dim); enc_out: (B, S_enc, d)."""
        dp, tp = self.dp, self.tp

        def one(path, leaf):
            leafname = path.split("/")[-1]
            shape = tuple(leaf.shape)
            spec = [None] * len(shape)
            batch_ok = len(shape) >= 2 and self._div(shape[1], dp)
            if leafname in ("k", "v") and len(shape) == 5:
                if batch_ok:
                    spec[1] = dp
                    seq_axes = []
                else:
                    seq_axes = list(dp)
                if self.par.tp and tp and self._div(shape[3], tp):
                    spec[3] = tp
                elif self.par.tp and tp:
                    seq_axes.append(tp)
                if seq_axes and self.par.seq_shard_decode and \
                        shape[2] % _axis_size(self.mesh,
                                              tuple(seq_axes)) == 0:
                    spec[2] = tuple(seq_axes)
            elif leafname == "state" and len(shape) == 5:
                if batch_ok:
                    spec[1] = dp
                if self.par.tp and tp and self._div(shape[2], tp):
                    spec[2] = tp     # SSM heads over model
            elif leafname == "conv" and len(shape) == 4:
                if batch_ok:
                    spec[1] = dp
                if self.par.tp and tp and self._div(shape[3], tp):
                    spec[3] = tp
            elif leafname == "enc_out" and len(shape) == 3:
                if self._div(shape[0], dp):
                    spec[0] = dp
            return self._named(spec)

        return map_with_path(one, state_shapes)

    # -- outputs -----------------------------------------------------------------
    def logits_shardings(self, batch: int) -> NamedSharding:
        spec = [None, None, None]
        if self._div(batch, self.dp):
            spec[0] = self.dp
        if self.par.tp and self.tp and self._div(self.cfg.vocab, self.tp):
            spec[2] = self.tp
        return self._named(spec)

    def replicated(self) -> NamedSharding:
        return self._named(())


# ---------------------------------------------------------------------------
# Shared rule table (also used by constraints.constrain_params, which pins
# each unit's params and the fp32 grad accumulator to their layout)
# ---------------------------------------------------------------------------

def _uneven_ok(dim: int, size: int) -> bool:
    return dim % size == 0 or dim >= size // 2


def param_partition_spec(path: str, shape, mesh, dp, tp,
                         fsdp: bool = True, tp_on: bool = True,
                         **kw) -> Spec:
    parts = path.split("/")
    leaf = parts[-1]
    # leading stack dims: one for the units (blocks/encoder/cross), one
    # more for a unit's tail repeats — e.g. blocks/tail/... has two.
    off = 0
    if parts[0] in ("blocks", "encoder", "cross"):
        off += 1
    if "tail" in parts[:-1]:
        off += 1
    s = tuple(shape[off:])
    nd = len(s)
    dp_size = _axis_size(mesh, dp)
    tp_size = _axis_size(mesh, tp) if tp else 0

    def mat(tp_dim, fsdp_dim):
        spec = [None] * (off + nd)
        if tp_on and tp and _uneven_ok(s[tp_dim], tp_size):
            spec[off + tp_dim] = tp
        if fsdp and fsdp_dim is not None and dp and s[fsdp_dim] % dp_size == 0:
            spec[off + fsdp_dim] = dp
        return P(*spec)

    if "moe" in path and leaf in ("w_gate", "w_up", "w_down") and nd == 3:
        spec = [None] * (off + 3)
        if tp_on and tp and s[0] % tp_size == 0:
            spec[off + 0] = tp                    # EP: experts over model
            if fsdp and dp and s[2] % dp_size == 0:
                spec[off + 2] = dp
        elif tp_on and tp:
            # few-expert models (Mixtral E=8 < TP=16): expert-internal TP on
            # the ffn-hidden dim instead of replicating 47B of experts
            f_dim = 2 if leaf in ("w_gate", "w_up") else 1
            if s[f_dim] % tp_size == 0:
                spec[off + f_dim] = tp
            other = 2 if f_dim == 1 else 1
            if fsdp and dp and s[other] % dp_size == 0:
                spec[off + other] = dp
        return P(*spec)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj") and nd == 2:
        return mat(1, 0)
    if leaf in ("wo", "w_down", "out_proj") and nd == 2:
        return mat(0, 1)
    if leaf in ("bq", "bk", "bv", "conv_b", "norm") and nd == 1:
        return mat(0, None)
    if leaf == "conv_w" and nd == 2:
        return mat(1, None)
    if leaf == "embed":
        # vocab over TP (Megatron-style: masked local gather + small
        # all-reduce; keeps tied-head logits V-sharded), d_model over FSDP.
        return mat(0, 1)
    if leaf == "lm_head":
        return mat(1, 0)
    return P(*([None] * (off + nd)))
