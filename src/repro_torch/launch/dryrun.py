"""The planner of the 256- and 512-card meshes (port of
``repro/launch/dryrun.py``): for every cell of ``configs.cells()`` it
builds the sharded train step, prefill or decode step on the production
mesh, runs it once on shapes with no values, and records what one rank
computes, sends and holds.

"Lower" and "compile" in the port: there is no compiler between the
step and the card, so "lower" is building the cell (the mesh over a fake
process group, the policy's placements, and every input as a DTensor
whose local shard is a fake tensor, a shape with no storage), and
"compile" is one eager run of the step on those inputs under
``FakeTensorMode``. Every op runs on each rank's local shapes, so the
counts are one rank's, exact, and at full depth: an eager step runs
every layer and every microbatch, where the reference's HLO cost
analysis counts a scanned loop body once.

The world is one process: ``dist.init_process_group("fake", ...)`` of
512 ranks (``FakeStore``), this process rank 0 of it, and
``launch.mesh.make_production_mesh`` over it, the (32, 8) mesh on the
first 256 ranks or (2, 32, 8) on all 512. Collectives on a fake group
move nothing; their local operands are counted. The planner refuses to
start while a process group is up, and destroys its fake group when it
is done. Params, optimizer moments and decode states are shaped on the
``meta`` device (no draw runs: ``init_params`` takes only the plain
threefry there), and their fake local shards are made from those shapes
(``shard_ops.local_shape``); no global tensor is ever
made. A kernel wrapper that meets a fake or meta tensor raises.

A record has the reference's keys, counted per rank by ``LocalCounter``
(a dispatch mode under DTensor's, so it sees the local ops; DTensor's
sharding bookkeeping, its shape propagation on global fake tensors and
its strategy and offset planning, runs apart and is left out):

* ``flops_per_device``: the FLOPs of matrix products
  (``torch.utils.flop_counter``'s formulas), forward and backward;
* ``collectives``: bytes of each collective's local operand and counts
  (``CommDebugMode``), under the reference's five names;
* ``argument_size_in_bytes``: the local bytes of the step's inputs
  (params, optimizer state and batch; params, tokens and decode state)
  that the step reads (XLA drops an argument no op reads, such as
  whisper's encoder params in a decode step);
  ``temp_size_in_bytes``: the peak of the local bytes the step allocates
  beyond them, its outputs included; ``output_size_in_bytes``: the
  local bytes of its outputs;
* ``microbatches`` and ``budget_bytes`` (train): ``microbatches_for``'s
  factor under the activation budget it was given; ``uneven_shards``:
  the inputs sharded unevenly (rank 0 holds the largest block, the size
  of the reference's padded block).

The reference's ``bytes_accessed_per_device``, ``transcendentals``,
``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` have no
counterpart here (no compiler's buffer assignment or code), and are left
out, as are their extrapolations. ``lower_cell`` keeps the reference's
depth-1 and depth-2 probes and its formula, so that the records compare
with the reference's; here they equal the full-depth counts wherever
each unit does the same work.

Run ``python -m repro_torch.launch.dryrun`` (``--device cpu
--budget-gib 6`` on a machine without a card; on a card the budget
defaults to a quarter of its memory). The records go to ``--out``
(``build/dryrun.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import os
import threading
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..config import ModelConfig, ParallelConfig, ShapeConfig
from ..configs import cells, get_config, get_shape, list_archs
from ..distributed.shard_ops import local_shape, wrap_local
from ..distributed.sharding import ShardingPolicy, map_with_path
from ..models import LM
from ..models.transformer import tree_map
from ..optim import AdamW, OptState
from ..train.steps import make_serve_steps, make_train_step
from .mesh import make_production_mesh

WORLD = 512
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
DEFAULT_OUT = os.path.join("build", "dryrun.json")


# ---------------------------------------------------------------------------
# Per-rank accounting
# ---------------------------------------------------------------------------

def collective_name(op) -> Optional[str]:
    """The reference's name of a c10d (functional) collective op or op
    packet, or None for any other op (``wait_tensor`` included)."""
    qual = str(op)               # e.g. "_c10d_functional.all_reduce.default"
    if "c10d" not in qual.split(".")[0]:
        return None
    name = qual.split(".")[1]
    for key, label in (("all_reduce", "all-reduce"),
                       ("allreduce", "all-reduce"),
                       ("all_gather", "all-gather"),
                       ("allgather", "all-gather"),
                       ("reduce_scatter", "reduce-scatter"),
                       ("all_to_all", "all-to-all"),
                       ("alltoall", "all-to-all"),
                       ("permute", "collective-permute"),
                       ("send", "collective-permute"),
                       ("recv", "collective-permute")):
        if key in name:
            return label
    return None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


_PROPAGATING = threading.local()

# DTensor's sharding bookkeeping: the shape propagation runs ops on global
# fake tensors, and the strategy, redistribution and offset planning runs
# small tensor ops on ints (``.tolist()``, ``int()``), which a fake tensor
# mode cannot answer. Each runs with the fake mode unset and unseen by
# ``LocalCounter``. (module, owner, attribute) of each; an attribute this
# torch does not have is passed over.
_BOOKKEEPING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._redistribute", None,
     "_gen_transform_infos_non_cached"),
    ("torch.distributed.tensor._utils", None,
     "_compute_local_shape_and_global_offset"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "_local_shard_size"),
)


@contextlib.contextmanager
def _bookkeeping_apart():
    """Run DTensor's sharding bookkeeping outside the fake tensor mode, and
    mark it so that ``LocalCounter`` leaves it out."""
    import importlib
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    patched = []

    def wrap(orig):
        def wrapped(*args, **kwargs):
            depth = getattr(_PROPAGATING, "depth", 0)
            _PROPAGATING.depth = depth + 1
            try:
                with unset_fake_temporarily():
                    return orig(*args, **kwargs)
            finally:
                _PROPAGATING.depth = depth
        return wrapped

    for module, owner, attr in _BOOKKEEPING:
        obj = importlib.import_module(module)
        if owner is not None:
            obj = getattr(obj, owner, None)
        if obj is None or not hasattr(obj, attr):
            continue
        orig = inspect.getattr_static(obj, attr)
        if isinstance(orig, staticmethod):
            new = staticmethod(wrap(orig.__func__))
        else:
            new = wrap(orig)
        setattr(obj, attr, new)
        patched.append((obj, attr, orig))
    if not patched:
        raise RuntimeError("this torch's DTensor has none of the "
                           "bookkeeping functions the planner knows")
    try:
        yield
    finally:
        for obj, attr, orig in reversed(patched):
            setattr(obj, attr, orig)


class LocalCounter(TorchDispatchMode):
    """One rank's FLOPs, collective bytes and live memory of the ops run
    inside the mode, counted on local tensors: a DTensor op is handed to
    DTensor first, and its local ops come back here.

    ``flops``: matrix-product FLOPs. ``bytes_by_op`` / ``counts``: each
    collective's local operand bytes and calls by the reference's names
    (point-to-point sends and receives as "collective-permute").
    ``live``/``peak``:
    bytes of the storages that ops made inside the mode and that are
    still referenced (a view or an in-place result adds nothing).
    ``read``: the storages that ops took as inputs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_by_op = {c: 0 for c in COLLECTIVES}
        self.counts = {c: 0 for c in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.read = set()
        self._storages: Dict[int, int] = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_bookkeeping_apart())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _free(self, key: int, nbytes: int):
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_PROPAGATING, "depth", 0):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = collective_name(func)
        if name is not None:
            self.bytes_by_op[name] += sum(t.numel() * t.element_size()
                                          for t in _tensors(args))
            self.counts[name] += 1
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)
                  if t.layout == torch.strided}
        self.read |= inputs
        for t in _tensors(out):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._storages:
                continue
            nbytes = st.nbytes()
            self._storages[key] = nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, nbytes)
        return out

    def collectives(self) -> Dict[str, Any]:
        return {"bytes_by_op": dict(self.bytes_by_op),
                "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_op.values())}


def comm_counts(comm) -> Dict[str, int]:
    """``CommDebugMode``'s counts under the reference's names."""
    out = {c: 0 for c in COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        name = collective_name(op)
        if name is not None:
            out[name] += int(n)
    return out


def local_bytes(tree, read=None) -> int:
    """Bytes of the local shards of every tensor leaf of ``tree`` (with
    ``read``, a set of storages, of the leaves whose storage is in it)."""
    total = 0

    def one(_, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            if read is None or t.untyped_storage()._cdata in read:
                total += t.numel() * t.element_size()
    map_with_path(one, tree)
    return total


def uneven_shards(tree) -> int:
    """The DTensor leaves of ``tree`` with a dim that does not divide over
    the mesh dims that shard it (ranks hold blocks of different sizes,
    where the reference's GSPMD pads every block to one size)."""
    count = 0

    def one(_, leaf):
        nonlocal count
        if not isinstance(leaf, DTensor):
            return
        parts = [1] * leaf.dim()
        for i, p in enumerate(leaf.placements):
            if p.is_shard():
                parts[p.dim] *= leaf.device_mesh.size(i)
        count += any(n % k for n, k in zip(leaf.shape, parts))
    map_with_path(one, tree)
    return count


# ---------------------------------------------------------------------------
# The fake world and shapes with no values
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int = WORLD):
    """A process group of ``world`` ranks in this process (the "fake"
    backend; this process is rank 0), destroyed on exit. Refuses to start
    while a process group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the planner runs in a process group of its own; "
                           "a process group is already up in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_shards(specs, shardings, fake_mode, device):
    """Each meta-tensor leaf of ``specs`` as a DTensor placed by the
    ``NamedSharding`` leaf of ``shardings``, its local shard a fake
    tensor on ``device`` of the local shape (no global tensor is made)."""

    def one(spec, sh):
        placements = sh.placements
        with fake_mode:
            local = torch.empty(local_shape(spec.shape, sh.mesh, placements),
                                dtype=spec.dtype, device=device)
        return wrap_local(local, sh.mesh, placements, spec.shape)

    def walk(spec, sh):
        if isinstance(spec, dict):
            return {k: walk(v, sh[k]) for k, v in spec.items()}
        if isinstance(spec, tuple):
            items = [walk(v, s) for v, s in zip(spec, sh)]
            return type(spec)(*items) if hasattr(spec, "_fields") \
                else tuple(items)
        return None if spec is None else one(spec, sh)

    return walk(specs, shardings)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def params_specs(lm: LM):
    """The params of ``lm`` (an LM on the meta device) as meta tensors."""
    return lm.init_params(torch.zeros((2,), dtype=torch.int64,
                                      device="meta"))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, lm: LM):
    """Abstract inputs for one cell (meta tensors), as the reference's
    ``input_specs``: the batch of a train or prefill cell, the token and
    the decode state of S tokens of a decode cell. ``lm`` lives on the
    meta device."""
    B, S = shape.global_batch, shape.seq_len
    enc = None
    if cfg.encoder_layers:
        enc = _meta((B, cfg.encoder_seq, cfg.d_model), torch.float32)
    if shape.kind == "train":
        batch = {"tokens": _meta((B, S + 1), torch.int32)}
        if enc is not None:
            batch["enc_embeds"] = enc
        return batch
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), torch.int32)}
        if enc is not None:
            out["enc_embeds"] = enc
        return out
    token = _meta((B, 1), torch.int32)
    if cfg.encoder_layers:
        with torch.no_grad():
            state = lm.init_decode_state(
                B, S, enc_embeds=_meta(enc.shape, lm._compute_dtype()),
                params=params_specs(lm))
    else:
        state = lm.init_decode_state(B, S)
    return {"token": token, "state": state}


def serve_params_specs(lm: LM):
    """Serving params are in the compute dtype (inference memory layout)."""
    dt = lm._compute_dtype()
    return tree_map(lambda a: _meta(a.shape, dt if a.dtype == torch.float32
                                    else a.dtype), params_specs(lm))


# ---------------------------------------------------------------------------
# Microbatching
# ---------------------------------------------------------------------------

def _unit_size(cfg: ModelConfig) -> int:
    if cfg.hybrid_period:
        return cfg.hybrid_period
    if cfg.n_experts > 0 and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, n_data: int,
                     budget: int) -> int:
    """Gradient-accumulation factor bounding the live per-rank activation
    working set under ``budget`` bytes (the reference's formula):

      outer residuals:  n_units · tok_mb · d · 2B
      per-unit working set:  Σ_layers tok_mb · (24·d + 6·f_eff) bytes
        f_eff = d_ff (dense) | top_k·cf·d_ff (MoE) | 4·d (SSM in_proj)
    """
    if shape.kind != "train":
        return 1
    u = _unit_size(cfg)
    n_units = max(cfg.n_layers // u, 1)
    per_dev_batch = max(shape.global_batch // n_data, 1)

    def unit_bytes(tok):
        total = 0.0
        for j in range(u):
            kind = cfg.layer_kind(j)
            width = 24.0 * cfg.d_model
            if kind.value.startswith("ssm"):
                width += 24.0 * cfg.ssm_expand * cfg.d_model
            if kind.value.endswith("moe"):
                width += 6.0 * cfg.experts_per_token * cfg.capacity_factor \
                    * cfg.d_ff
            elif cfg.d_ff:
                width += 6.0 * cfg.d_ff
            total += tok * width
        return total

    mb = 1
    while mb < per_dev_batch and shape.global_batch % (2 * mb) == 0:
        tok = (per_dev_batch // mb) * shape.seq_len
        est = n_units * tok * cfg.d_model * 2 + unit_bytes(tok)
        if est <= budget:
            break
        mb *= 2
    return mb


def default_budget(device) -> int:
    """A quarter of the card's memory for one unit's activations; the rest
    holds the params' and moments' shards, caches and allocator slack."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the activation budget defaults to a quarter of a "
                         "card's memory; on another device pass one")
    return torch.cuda.get_device_properties(dev).total_memory // 4


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _run_counted(fn, fake_mode):
    """``fn()`` once under ``fake_mode`` with the counters: (its result,
    the ``LocalCounter``, ``CommDebugMode``'s counts, seconds)."""
    from torch.distributed.tensor.debug import CommDebugMode
    counter, comm = LocalCounter(), CommDebugMode()
    t0 = time.perf_counter()
    with fake_mode, comm, counter:
        result = fn()
    return result, counter, comm_counts(comm), time.perf_counter() - t0


def plan_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              parallel: Optional[ParallelConfig] = None, *,
              device="cuda", budget: Optional[int] = None,
              microbatches: Optional[int] = None) -> Dict[str, Any]:
    """The step of ``shape``'s kind for ``cfg`` on ``mesh`` (any mesh over
    the process group, the fake one as a rule), run once on fake shards:
    the per-rank part of a record. ``microbatches`` forces the train
    step's factor; else ``microbatches_for`` under ``budget`` bytes
    (default: a quarter of the card's memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    device = torch.device(device)
    lm = LM(cfg, device="meta")
    run_lm = LM(cfg, device=device)
    policy = ShardingPolicy(mesh, cfg, parallel)
    record: Dict[str, Any] = {"device": device.type}
    fake_mode = FakeTensorMode(allow_non_fake_inputs=False)

    if shape.kind == "train":
        params_s = params_specs(lm)
        opt = AdamW()
        opt_s = OptState(step=_meta((), torch.int32),
                         m=tree_map(lambda a: _meta(a.shape, torch.float32),
                                    params_s),
                         v=tree_map(lambda a: _meta(a.shape, torch.float32),
                                    params_s))
        batch_s = input_specs(cfg, shape, lm)
        p_sh = policy.params_shardings(params_s)
        o_sh = OptState(step=policy.replicated(), m=p_sh, v=p_sh)
        b_sh = policy.batch_shardings(batch_s)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        n_data = math.prod(sizes[a] for a in policy.dp)
        mb = microbatches
        if mb is None:
            if budget is None:
                budget = default_budget(device)
            mb = microbatches_for(cfg, shape, n_data, budget)
            record["budget_bytes"] = int(budget)
        record["microbatches"] = mb
        args = (fake_shards(params_s, p_sh, fake_mode, device),
                fake_shards(opt_s, o_sh, fake_mode, device),
                fake_shards(batch_s, b_sh, fake_mode, device))
        step = make_train_step(run_lm, opt, microbatches=mb)

        def run():
            return step(*args)
    elif shape.kind == "prefill":
        params_s = serve_params_specs(lm)
        ins = input_specs(cfg, shape, lm)
        args = (fake_shards(params_s, policy.params_shardings(params_s),
                            fake_mode, device),
                fake_shards(ins, policy.batch_shardings(ins), fake_mode,
                            device))
        prefill, _ = make_serve_steps(run_lm, policy)

        def run():
            # no_grad, not inference_mode: a view of a fake DTensor made
            # outside inference mode cannot be taken inside it
            with torch.no_grad():
                return prefill(args[0], args[1]["tokens"],
                               args[1].get("enc_embeds"))
    else:
        params_s = serve_params_specs(lm)
        ins = input_specs(cfg, shape, lm)
        st_sh = policy.decode_state_shardings(ins["state"])
        tok_sh = policy.batch_shardings({"token": ins["token"]})
        args = (fake_shards(params_s, policy.params_shardings(params_s),
                            fake_mode, device),
                fake_shards({"token": ins["token"]}, tok_sh, fake_mode,
                            device)["token"],
                fake_shards(ins["state"], st_sh, fake_mode, device))
        _, decode = make_serve_steps(run_lm, policy)

        def run():
            with torch.no_grad():
                return decode(*args)

    record["uneven_shards"] = uneven_shards(args)
    record["lower_s"] = round(time.perf_counter() - t0, 2)
    out, counter, counts, seconds = _run_counted(run, fake_mode)
    record["compile_s"] = round(seconds, 2)
    record["argument_size_in_bytes"] = local_bytes(args, counter.read)
    record["output_size_in_bytes"] = local_bytes(out)
    record["temp_size_in_bytes"] = int(counter.peak)
    record["flops_per_device"] = float(counter.flops)
    coll = counter.collectives()
    if coll["counts"] != counts:
        raise RuntimeError(f"collective counts disagree: the dispatch mode "
                           f"{coll['counts']}, CommDebugMode {counts}")
    record["collectives"] = coll
    return record


def compile_once(arch: str, shape_name: str, multi_pod: bool,
                 parallel: Optional[ParallelConfig] = None,
                 cfg_overrides: Optional[dict] = None,
                 force_microbatches: Optional[int] = None, *,
                 device="cuda", budget: Optional[int] = None):
    """Build one cell on the production mesh and run its step once on fake
    shards: (record, cfg). Needs the fake world (``fake_world``)."""
    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type=torch.device(device).type)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "chips": math.prod(mesh.shape), "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    record.update(plan_step(cfg, shape, mesh, parallel, device=device,
                            budget=budget, microbatches=force_microbatches))
    return record, cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               parallel: Optional[ParallelConfig] = None,
               cfg_overrides: Optional[dict] = None,
               extrapolate: bool = True, *, device="cuda",
               budget: Optional[int] = None) -> Dict[str, Any]:
    """Full-cell record: the full-depth run, and the reference's depth
    probes at 1 and 2 units (one microbatch) extrapolated linearly in
    depth,

        total(D) = c1 + (D - 1) * (c2 - c1)        [per rank]

    applied to FLOPs and per-op collective bytes and counts, reported as
    *_extrapolated beside the full-depth counts."""
    kw = dict(device=device, budget=budget)
    record, cfg = compile_once(arch, shape_name, multi_pod, parallel,
                               cfg_overrides, **kw)
    if not extrapolate:
        return record
    u = _unit_size(cfg)
    n_units = cfg.n_layers // u
    if n_units < 2:
        record["flops_extrapolated"] = record["flops_per_device"]
        record["collectives_extrapolated"] = record["collectives"]
        record["collective_bytes_extrapolated"] = \
            record["collectives"]["total_bytes"]
        return record

    def depth_overrides(mult: int) -> dict:
        ov = dict(cfg_overrides or {})
        ov["n_layers"] = mult * u
        ov["unroll_scans"] = True
        if cfg.encoder_layers:
            ov["encoder_layers"] = mult
        return ov

    r1, _ = compile_once(arch, shape_name, multi_pod, parallel,
                         depth_overrides(1), force_microbatches=1, **kw)
    r2, _ = compile_once(arch, shape_name, multi_pod, parallel,
                         depth_overrides(2), force_microbatches=1, **kw)

    def extr(v1, v2):
        # clamp, as the reference: a per-unit delta is not negative
        return v1 + (n_units - 1) * max(v2 - v1, 0)

    record["flops_extrapolated"] = extr(r1["flops_per_device"],
                                        r2["flops_per_device"])
    coll = {key: {op: extr(r1["collectives"][key][op],
                           r2["collectives"][key][op])
                  for op in COLLECTIVES}
            for key in ("bytes_by_op", "counts")}
    coll["total_bytes"] = sum(coll["bytes_by_op"].values())
    record["collectives_extrapolated"] = coll
    record["collective_bytes_extrapolated"] = coll["total_bytes"]
    record["depth_probe_compile_s"] = [r1["compile_s"], r2["compile_s"]]
    return record


def plan_cells(todo, *, device, budget, out_path=None, results=None):
    """Records of the (arch, shape, multi_pod) cells of ``todo``, each in
    the fake world; a failed cell records ``error``. With ``out_path``
    the records so far are written after each cell."""
    results = list(results or [])
    for i, (arch, shape_name, mp) in enumerate(todo):
        tag = f"{arch} x {shape_name} x {'2x32x8' if mp else '32x8'}"
        print(f"[{i + 1}/{len(todo)}] {tag} ...", flush=True)
        try:
            with fake_world():
                rec = lower_cell(arch, shape_name, mp, device=device,
                                 budget=budget)
            print(f"    ok: run {rec['compile_s']}s, flops/rank "
                  f"{rec['flops_per_device']:.3e}, coll "
                  f"{rec['collectives']['total_bytes'] / 2 ** 20:.1f} MiB",
                  flush=True)
        except Exception as e:
            rec = {"arch": arch, "shape": shape_name,
                   "chips": 2 * 256 if mp else 256,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"    FAILED: {rec['error'][:200]}", flush=True)
        results = [r for r in results
                   if not (r["arch"] == rec["arch"]
                           and r["shape"] == rec["shape"]
                           and r["chips"] == rec["chips"])]
        results.append(rec)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    return results


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _worker(todo, device, budget, path):
    plan_cells(todo, device=device, budget=budget, out_path=path)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--print-hlo", action="store_true",
                    help="accepted for the reference's command lines; "
                    "there is no HLO, and nothing more is printed")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake shards: cuda (the card's, "
                    "needs one) or cpu")
    ap.add_argument("--budget-gib", type=float, default=None,
                    help="activation budget of microbatches_for; default "
                    "a quarter of the card's memory (required on cpu)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells planned in this many processes at once")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a card; pass --device cpu "
                         "--budget-gib N to plan on the CPU")
    budget = int(args.budget_gib * 2 ** 30) if args.budget_gib else \
        default_budget(device) if device.type == "cuda" else None
    if budget is None:
        raise SystemExit("--device cpu needs --budget-gib")
    if args.arch != "all" and args.arch not in list_archs():
        raise SystemExit(f"unknown arch {args.arch!r}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["chips"]) for r in results
            if "error" not in r}
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    todo = []
    for arch, shape_name in cells():
        if args.arch != "all" and arch != args.arch:
            continue
        if args.shape != "all" and shape_name != args.shape:
            continue
        for mp in meshes:
            if (arch, shape_name, 512 if mp else 256) not in done:
                todo.append((arch, shape_name, mp))

    print(f"dry-run: {len(todo)} cells to plan", flush=True)
    t0 = time.perf_counter()
    if args.jobs <= 1:
        results = plan_cells(todo, device=device, budget=budget,
                             out_path=args.out, results=results)
    else:
        import multiprocessing as mp_
        ctx = mp_.get_context("spawn")
        parts = [todo[i::args.jobs] for i in range(args.jobs)]
        paths = [f"{args.out}.part{i}" for i in range(args.jobs)]
        procs = [ctx.Process(target=_worker, args=(part, device, budget,
                                                   path))
                 for part, path in zip(parts, paths) if part]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        for path in paths:
            if os.path.exists(path):
                with open(path) as f:
                    for rec in json.load(f):
                        results = [r for r in results if not (
                            r["arch"] == rec["arch"]
                            and r["shape"] == rec["shape"]
                            and r["chips"] == rec["chips"])]
                        results.append(rec)
                os.remove(path)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    errors = sum("error" in r for r in results)
    print(f"dry-run complete: {len(results)} records, {errors} with an "
          f"error, {time.perf_counter() - t0:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    main()
