"""Ops written out on local shards of DTensors: the vocab-parallel
embedding lookup and cross entropy, and attention on each rank's (batch,
heads) shard.

The reference shards ``embed`` (vocab, d_model) as ``P("model", data)``:
vocab over the model axis, d_model over the data axes (FSDP), and its
comment names the lookup it intends: a masked local gather over each
model rank's vocab shard, then an all-reduce over "model". DTensor's own
rules fail on that layout (an embedding of batch-sharded tokens, and the
label gather of the tied head's vocab-sharded logits, raise), so these
two ops are written out on local shards:

* ``embed_lookup``: all-gather d_model over the data axes, gather the
  rows of this rank's vocab shard (rows of other shards are 0), sum over
  "model" (a ``Partial`` redistributed to ``Replicate``).
* ``vocab_logsumexp`` / ``vocab_gold``: the logsumexp of vocab-sharded
  logits from a max and a sum over "model" (DTensor reductions), and the
  label's logit by a masked local gather summed over "model".

Both give the unsharded values up to the order of a float sum; a zero
row added in the all-reduce is exact, so the lookup is exact. Gradients
follow the placements: the table's local grad is ``Partial`` over every
data axis that shards the tokens, and reduces onto its FSDP shard.

``heads_local`` runs an attention core on local tensors: attention is
independent across batch rows and KV groups, so with q, k and v placed
batch over the data axes and heads over "model" (KV groups whole on each
rank; heads replicated where the KV heads do not divide over "model")
every rank computes its own block, and no collective runs. DTensor's
propagation through the core's batched products would pick the same
layout after seconds of strategy search a shape.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


def _as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A contiguous DTensor of global ``shape`` from this rank's part."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _vocab_window(x: DTensor, dim: int):
    """(first global index, length) of this rank's shard of ``x`` on
    ``dim``."""
    local, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], local[dim]


def _masked_take(local: torch.Tensor, idx: torch.Tensor, lo: int, n: int,
                 dim: int):
    """``local`` indexed on ``dim`` by the global indices ``idx`` that fall
    in [lo, lo + n), and 0 for the others, with ``ok`` the in-range mask."""
    rel = idx - lo
    ok = (rel >= 0) & (rel < n)
    rel = torch.where(ok, rel, 0)
    if dim == 0:
        if n == 0:
            return local.new_zeros(idx.shape + local.shape[1:]), ok
        return local[rel], ok
    if n == 0:
        return local.new_zeros(idx.shape), ok
    return torch.gather(local, dim, rel[..., None])[..., 0], ok


def embed_lookup(table, tokens):
    """``table[tokens]``; for a DTensor table the vocab-parallel lookup,
    (B, S, d) placed as the tokens (batch over the data axes)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    # FSDP gather of d_model; vocab keeps its shard
    tab_pl = tuple(p if p == Shard(0) else Replicate()
                   for p in table.placements)
    table = table.redistribute(mesh, tab_pl)
    grad_pl = tuple(Partial() if isinstance(t, Shard) else p
                    for p, t in zip(tab_pl, tokens.placements))
    lo, n = _vocab_window(table, 0)
    rows, ok = _masked_take(table.to_local(grad_placements=grad_pl),
                            tokens.to_local(), lo, n, 0)
    rows = torch.where(ok[..., None], rows, 0)
    out_pl = tuple(Partial() if p == Shard(0) else t
                   for p, t in zip(tab_pl, tokens.placements))
    out = _from_local(rows, mesh, out_pl,
                      tuple(tokens.shape) + (table.shape[1],))
    return out.redistribute(mesh, tuple(Replicate() if p.is_partial()
                                        else p for p in out_pl))


def _reduced(x: DTensor) -> DTensor:
    """``x`` with its partial placements (a reduction over a sharded dim)
    reduced: DTensor's pointwise rules may pass a ``Partial("max")``
    through a subtraction unreduced."""
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def vocab_logsumexp(lg: DTensor) -> DTensor:
    """logsumexp over the last dim of (B, C, V) logits sharded on it."""
    m = _reduced(torch.amax(lg, dim=-1, keepdim=True).detach())
    s = _reduced(torch.sum(torch.exp(lg - m), dim=-1))
    return torch.log(s) + m[..., 0]


def vocab_gold(lg: DTensor, labels) -> DTensor:
    """``lg[b, c, labels[b, c]]`` of (B, C, V) logits sharded on V (and
    on B over the data axes): a masked gather on each vocab shard, summed
    over the shards."""
    mesh = lg.device_mesh
    for p in lg.placements:
        if p.is_partial() or (isinstance(p, Shard) and p.dim not in (0, 2)):
            raise ValueError(f"logits placed {lg.placements}: the gold "
                             "gather takes a batch or vocab shard only")
    lab_pl = tuple(Replicate() if p == Shard(2) else p
                   for p in lg.placements)
    labels = _as_dtensor(labels, mesh).redistribute(mesh, lab_pl)
    lo, n = _vocab_window(lg, 2)
    gold, ok = _masked_take(lg.to_local(), labels.to_local(), lo, n, 2)
    gold = torch.where(ok, gold, 0)
    out_pl = tuple(Partial() if p == Shard(2) else p
                   for p in lg.placements)
    return _from_local(gold, mesh, out_pl, tuple(labels.shape))


def heads_local(fn, q, k, v):
    """``fn(q, k, v)`` -> (B, Cq, H * hd) on each rank's shard of DTensors
    q (B, Cq, H, hd), k and v (B, Sk, KV, hd)."""
    mesh = q.device_mesh
    kv = k.shape[2]
    placements = tuple(
        p if p == Shard(0) or (p == Shard(2) and kv % mesh.size(i) == 0)
        else Replicate() for i, p in enumerate(q.placements))
    q, k, v = (_as_dtensor(t, mesh).redistribute(mesh, placements)
               for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local())
    B, Cq, H, hd = q.shape
    return _from_local(out, mesh, placements, (B, Cq, H * hd))
