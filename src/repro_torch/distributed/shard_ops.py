"""Ops written out on local shards of DTensors: the vocab-parallel
embedding lookup and cross entropy, attention on each rank's (batch,
heads) shard, and the families' layers (below).

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

The families' layers run on local shards too: a model function on plain
tensors is called with this rank's block (``local_in``) and its result
wrapped back (``from_partial``, ``allreduce``):

* ``experts_local`` (``models/moe.py``): a group is a batch row, so the
  routing, the sort-based slot map, the dispatch scatter and the combine
  gather run on each data shard's rows. The experts' einsums run on each
  model rank's expert shard (EP), or, where the experts do not divide the
  model axis, on its shard of the ffn-hidden dim; either way a rank's
  output is its share of a sum, reduced over "model". The float32 router
  stays replicated.
* ``ssm_local`` (``models/ssm.py``): the depthwise conv and the SSD chunk
  loop are independent across (batch, heads), so each rank runs its
  batch rows and its heads (all heads where they do not divide "model").
  The in_proj, conv and out_proj params are gathered and this rank's
  channels taken (the reference shards their channel dims contiguously,
  which does not follow the head boundaries); the gated RMSNorm over
  d_inner sums its squares over "model"; the out projection is a share
  of a sum, reduced over "model". The decode state keeps the layout of
  ``decode_state_shardings``: heads over "model", the conv window's
  channels over "model".
* ``slot_write`` / ``cache_attend`` (``models/attention.py``): a decode
  step writes its token's K/V into a cache DTensor on local shards (in a
  sequence-sharded cache only the rank whose window holds the slot
  changes, and no collective runs) and attends over the cache on local
  shards. Where the cache's sequence is sharded (``long_500k``, B = 1),
  each rank attends its own keys and the shards combine a max and a sum
  per row over the sequence's mesh dims: the unsharded softmax, without
  gathering the cache.

Gradients: a local result that is a rank's share of a sum is wrapped as
``Partial`` and reduced to ``Replicate`` (its backward hands every rank
the whole gradient); a gathered param's local grad is marked ``Partial``
over the mesh dims whose ranks use other rows or other parts of it, so
that it reduces onto the param's own shard.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def wrap_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A contiguous DTensor of global ``shape`` from this rank's part."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def local_block(shape, mesh, placements, dim: int):
    """(first global index, length) on ``dim`` of this rank's block of a
    tensor of ``shape`` placed as ``placements``: each mesh dim that
    shards ``dim``, in mesh order, cuts the block before it into chunks
    of ceil(n / size), as ``Shard`` does (trailing chunks may be short
    or empty). Pure Python, so it holds under a fake tensor mode."""
    off, n = 0, int(shape[dim])
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim % len(shape) == dim:
            size, r = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-n // size)
            start = min(r * chunk, n)
            off, n = off + start, min(start + chunk, n) - start
    return off, n


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of this rank's block of a tensor of ``shape``."""
    return tuple(local_block(shape, mesh, placements, d)[1]
                 for d in range(len(shape)))


def _window(x: DTensor, dim: int):
    """(first global index, length) of this rank's shard of ``x`` on
    ``dim``."""
    return local_block(x.shape, x.device_mesh, x.placements, dim)


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
    lo, n = _window(table, 0)
    rows, ok = _masked_take(table.to_local(grad_placements=grad_pl),
                            tokens.to_local(), lo, n, 0)
    rows = torch.where(ok[..., None], rows, 0)
    out_pl = tuple(Partial() if p == Shard(0) else t
                   for p, t in zip(tab_pl, tokens.placements))
    out = wrap_local(rows, mesh, out_pl,
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
    lo, n = _window(lg, 2)
    gold, ok = _masked_take(lg.to_local(), labels.to_local(), lo, n, 2)
    gold = torch.where(ok, gold, 0)
    out_pl = tuple(Partial() if p == Shard(2) else p
                   for p in lg.placements)
    return wrap_local(gold, mesh, out_pl, tuple(labels.shape))


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
    return wrap_local(out, mesh, placements, (B, Cq, H * hd))


# ---------------------------------------------------------------------------
# Local blocks and reductions
# ---------------------------------------------------------------------------

def mesh_dims(mesh, names) -> tuple:
    """Indices of the mesh dims named in ``names``."""
    return tuple(i for i, n in enumerate(mesh.mesh_dim_names) if n in names)


def dp_dims(mesh) -> tuple:
    return mesh_dims(mesh, ("pod", "data"))


def tp_dim(mesh):
    """Index of the "model" mesh dim, or None."""
    dims = mesh_dims(mesh, ("model",))
    return dims[0] if dims else None


def local_in(x, mesh, placements, grad_placements=None) -> torch.Tensor:
    """This rank's block of ``x`` placed as ``placements`` (a plain tensor
    counts as replicated); its grad flows back placed as
    ``grad_placements`` (default: ``placements``)."""
    x = _as_dtensor(x, mesh)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, tuple(placements))
    return x.to_local(grad_placements=grad_placements)


def allreduce(local: torch.Tensor, mesh, dims, op: str = "sum"
              ) -> torch.Tensor:
    """``local`` reduced ("sum" or "max") over the mesh dims ``dims``, on
    every rank. Differentiable for "sum": each rank's grad is the sum of
    the ranks' grads."""
    if not dims:
        return local
    pl = [Replicate()] * mesh.ndim
    for d in dims:
        pl[d] = Partial(op)
    out = DTensor.from_local(local, mesh, pl, run_check=False)
    out = out.redistribute(mesh, [Replicate()] * mesh.ndim)
    return out.to_local(grad_placements=pl if op == "sum" else None)


def from_partial(local: torch.Tensor, mesh, placements, partial_dims,
                 shape) -> DTensor:
    """The DTensor of global ``shape`` whose rank blocks are ``local``
    placed as ``placements``, each rank's block a share of a sum over the
    mesh dims ``partial_dims``, reduced there to ``Replicate``."""
    pl = tuple(Partial() if i in partial_dims else p
               for i, p in enumerate(placements))
    out = wrap_local(local, mesh, pl, tuple(shape))
    if not partial_dims:
        return out
    return out.redistribute(mesh, tuple(Replicate() if p.is_partial()
                                        else p for p in pl))


def _batch_placements(x: DTensor) -> tuple:
    """``x``'s batch (dim 0) shards on the data dims, replicated
    elsewhere."""
    dp = dp_dims(x.device_mesh)
    return tuple(Shard(0) if i in dp and p == Shard(0) else Replicate()
                 for i, p in enumerate(x.placements))


def _marked(placements, dims) -> tuple:
    """``placements`` with the replicated mesh dims among ``dims`` marked
    ``Partial`` (a sharded dim keeps its shard)."""
    return tuple(Partial() if i in dims and p == Replicate() else p
                 for i, p in enumerate(placements))


def _params_local(p: dict, mesh, keep: dict, partial_dims) -> dict:
    """Each leaf of ``p`` gathered onto every rank but on the mesh dims
    that ``keep[name]`` shards (placements to keep, default none), its
    grad ``Partial`` over ``partial_dims``."""
    out = {}
    for name, leaf in p.items():
        pl = keep.get(name, (Replicate(),) * mesh.ndim)
        out[name] = local_in(leaf, mesh, pl, _marked(pl, partial_dims))
    return out


def _mesh_of(x, leaf):
    return x.device_mesh if isinstance(x, DTensor) else leaf.device_mesh


# ---------------------------------------------------------------------------
# MoE: experts on each model rank's shard
# ---------------------------------------------------------------------------

def experts_local(fn, p: dict, x) -> DTensor:
    """``x + y`` for a DTensor ``x`` (B, S, d), where ``fn(x_local,
    p_local, e0, n_local)`` runs the MoE FFN of this rank's batch rows on
    the experts e0 .. e0 + n_local - 1 (on this rank's ffn-hidden shard of
    their weights, where the experts do not divide "model") and returns
    this rank's share of y, (B_local, S, d); the shares sum over
    "model"."""
    mesh = _mesh_of(x, p["w_gate"])
    x = _as_dtensor(x, mesh)
    dp, tp = dp_dims(mesh), tp_dim(mesh)
    x_pl = _batch_placements(x)
    w = _as_dtensor(p["w_gate"], mesh)
    split = None if tp is None else w.placements[tp]
    if not isinstance(split, Shard):
        split = None
    keep = {}
    if split is not None:
        for name in ("w_gate", "w_up", "w_down"):
            pl = [Replicate()] * mesh.ndim
            # EP: experts (dim 0); else ffn-hidden: dim 2 of w_gate/w_up,
            # dim 1 of w_down
            pl[tp] = Shard(0 if split.dim == 0 else
                           (1 if name == "w_down" else 2))
            keep[name] = tuple(pl)
    model = (tp,) if split is not None else ()
    data = tuple(d for d in dp if x_pl[d] == Shard(0))
    x_local = local_in(x, mesh, x_pl, _marked(x_pl, model))
    p_local = _params_local(p, mesh, keep, data + model)
    e0, n_local = 0, w.shape[0]
    if split is not None and split.dim == 0:
        e0, n_local = local_block(w.shape, mesh, keep["w_gate"], 0)
    y = fn(x_local, p_local, e0, n_local)
    return x + from_partial(y.to(x_local.dtype), mesh, x_pl, model,
                            tuple(x.shape))


# ---------------------------------------------------------------------------
# SSM: heads on each model rank
# ---------------------------------------------------------------------------

def ssm_local(fn, p: dict, x, n_heads: int, conv=None, state=None):
    """A Mamba2 layer on local shards of a DTensor ``x`` (B, S, d).

    ``fn(x_local, p_local, h0, n_local, reduce, conv_local, state_local,
    window)`` runs heads h0 .. h0 + n_local - 1 of this rank's batch rows
    with every param gathered; ``reduce`` sums a local tensor over the
    ranks that split the heads; ``window`` is (first channel, count) of
    this rank's shard of the conv window, whose channels lie over "model"
    where they divide it (as ``decode_state_shardings`` places them).
    ``conv`` (B, k-1, conv_dim) and ``state`` (B, nh, hp, N), DTensors,
    are a decode step's cache: ``conv_local`` holds every channel,
    ``state_local`` this rank's heads. ``fn`` returns (this rank's share
    of the layer's output (B_local, S, d), its shard of the new conv
    window or None, the new state of its heads or None). Returns (x +
    output, conv, state), conv and state DTensors placed as the decode
    state or None."""
    mesh = _mesh_of(x, p["in_proj"])
    x = _as_dtensor(x, mesh)
    dp, tp = dp_dims(mesh), tp_dim(mesh)
    x_pl = _batch_placements(x)
    tp_size = 1 if tp is None else mesh.size(tp)
    split = tp is not None and n_heads % tp_size == 0
    model = (tp,) if split else ()
    data = tuple(d for d in dp if x_pl[d] == Shard(0))
    x_local = local_in(x, mesh, x_pl, _marked(x_pl, model))
    p_local = _params_local(p, mesh, {}, data + model)
    h0, n_local = 0, n_heads
    if split:
        n_local = n_heads // tp_size
        h0 = mesh.get_local_rank(tp) * n_local
    B = x.shape[0]
    k1, conv_dim = p["conv_w"].shape[-2] - 1, p["conv_w"].shape[-1]
    conv_shape = (B, k1, conv_dim)
    conv_pl = tuple(Shard(2) if i == tp and conv_dim % tp_size == 0
                    else q for i, q in enumerate(x_pl))
    state_pl = tuple(Shard(1) if i == tp and split else q
                     for i, q in enumerate(x_pl))
    window = local_block(conv_shape, mesh, conv_pl, 2)
    conv_local = state_local = None
    if conv is not None:
        conv_local = local_in(conv, mesh, x_pl)
        state_local = local_in(state, mesh, state_pl)

    def reduce(t):
        return allreduce(t, mesh, model)

    y, new_conv, new_state = fn(x_local, p_local, h0, n_local, reduce,
                                conv_local, state_local, window)
    out = x + from_partial(y.to(x_local.dtype), mesh, x_pl, model,
                           tuple(x.shape))
    if new_conv is not None:
        new_conv = wrap_local(new_conv, mesh, conv_pl, conv_shape)
        new_state = wrap_local(new_state, mesh, state_pl, (B, n_heads)
                                + tuple(new_state.shape[2:]))
    return out, new_conv, new_state


# ---------------------------------------------------------------------------
# Decode attention over a cache DTensor
# ---------------------------------------------------------------------------

def _cache_placements(cache: DTensor) -> tuple:
    """The cache's placements, a KV-head shard that does not divide its
    mesh dim replicated (``decode_state_shardings`` shards the heads only
    where they divide)."""
    mesh, kv = cache.device_mesh, cache.shape[2]
    return tuple(Replicate() if p == Shard(2) and kv % mesh.size(i)
                 else p for i, p in enumerate(cache.placements))


def _token_placements(cache_pl) -> tuple:
    """A (B, Cq, heads, hd) tensor placed as a cache of ``cache_pl``: batch
    and heads as the cache's, replicated over the sequence's dims."""
    return tuple(Replicate() if p == Shard(1) else p for p in cache_pl)


def slot_write(cache: DTensor, new, slot: torch.Tensor) -> DTensor:
    """``cache`` (B, S, KV, hd) with ``new`` (B, 1, KV, hd) written at
    sequence index ``slot`` (a device scalar), on local shards: a rank
    whose sequence window does not hold the slot writes its own row back,
    so its shard keeps its values, and no collective runs."""
    mesh = cache.device_mesh
    pl = _cache_placements(cache)
    local = local_in(cache, mesh, pl)
    new_l = local_in(new, mesh, _token_placements(pl)).to(local.dtype)
    lo, n = local_block(cache.shape, mesh, pl, 1)
    if isinstance(slot, DTensor):
        slot = slot.to_local()
    rel = slot - lo
    ok = (rel >= 0) & (rel < n)
    at = torch.where(ok, rel, 0).reshape(1).long()
    src = torch.where(ok, new_l, local.index_select(1, at))
    return wrap_local(local.index_copy(1, at, src), mesh, pl,
                       tuple(cache.shape))


def cache_attend(attend, stats, q, k: DTensor, v: DTensor,
                 k_pos: torch.Tensor) -> DTensor:
    """Decode attention of q (B, Cq, H, hd) over a cache k, v (B, S, KV,
    hd) on local shards, q placed by the cache's batch and heads.

    Where each rank holds the cache's whole sequence, ``attend(q, k, v,
    k_pos)`` -> (B, Cq, H·hd) runs on the local blocks. Where the
    sequence is sharded, ``stats(q, k, v, k_pos)`` runs on each rank's
    keys (``k_pos``, the global positions of the cache's slots, cut to
    the rank's window) and returns the masked max, the sum of exp(score -
    max) and the unnormalised output of each query row, (B, KV, g, Cq)
    and (B, KV, g, Cq, hd); the shards combine: the max over the
    sequence's mesh dims, then each shard's sum and output rescaled by
    exp(its max - that max) and summed."""
    mesh = k.device_mesh
    pl = _cache_placements(k)
    seq = tuple(i for i, p in enumerate(pl) if p == Shard(1))
    q_pl = _token_placements(pl)
    q_l = local_in(q, mesh, q_pl)
    k_l, v_l = local_in(k, mesh, pl), local_in(v, mesh, pl)
    lo, n = local_block(k.shape, mesh, pl, 1)
    kp = k_pos[lo:lo + n]
    B, Cq, H, hd = q.shape
    if not seq:
        return wrap_local(attend(q_l, k_l, v_l, kp), mesh, q_pl,
                           (B, Cq, H * hd))
    m, s, o = stats(q_l, k_l, v_l, kp)
    top = allreduce(m, mesh, seq, "max")
    w = torch.exp(m - top)
    s = allreduce(s * w, mesh, seq)
    o = allreduce(o * w[..., None], mesh, seq)
    o = o / torch.clamp_min(s, 1e-30)[..., None]          # (B,KV,g,Cq,hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(o.shape[0], Cq, -1)
    return wrap_local(o.to(q_l.dtype), mesh, q_pl, (B, Cq, H * hd))


# ---------------------------------------------------------------------------
# Dense FFN: ffn-hidden over "model" (Megatron)
# ---------------------------------------------------------------------------

def ffn_local(fn, p: dict, x) -> DTensor:
    """``x + y`` for a DTensor ``x`` (B, S, d), where ``fn(x_local,
    p_local)`` runs the dense FFN of this rank's batch rows on its shard of
    the ffn-hidden dim (``w_up``/``w_gate`` columns, ``w_down`` rows, as
    the policy places them over "model") and returns its share of y; the
    shares sum over "model". DTensor's own propagation through the three
    products picks layouts by cost, and on the 512-card mesh it took a
    strided sequence shard whose bookkeeping lists every global index."""
    mesh = _mesh_of(x, p["w_up"])
    x = _as_dtensor(x, mesh)
    dp, tp = dp_dims(mesh), tp_dim(mesh)
    x_pl = _batch_placements(x)
    w = _as_dtensor(p["w_up"], mesh)
    split = tp is not None and isinstance(w.placements[tp], Shard)
    keep = {}
    if split:
        for name in ("w_gate", "w_up", "w_down"):
            pl = [Replicate()] * mesh.ndim
            pl[tp] = Shard(0 if name == "w_down" else 1)
            keep[name] = tuple(pl)
    model = (tp,) if split else ()
    data = tuple(d for d in dp if x_pl[d] == Shard(0))
    x_local = local_in(x, mesh, x_pl, _marked(x_pl, model))
    p_local = _params_local(p, mesh, keep, data + model)
    y = fn(x_local, p_local)
    return x + from_partial(y.to(x_local.dtype), mesh, x_pl, model,
                            tuple(x.shape))
