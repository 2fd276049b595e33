"""One gloo rank of ``tests/test_torch_sharded_families.py`` (run as a
script: ``python _sharded_families_worker.py RANK WORLD DIR``).

The rank rendezvouses through a ``FileStore`` in DIR, reads the JAX params
and inputs the test wrote there (``inputs.npz``), runs the port's sharded
train step, prefill and decode steps of the MoE, SSM, hybrid and
encoder-decoder smoke configs on a (2, 2) and a (4, 1) mesh, a batch-of-one
decode on a sequence-sharded cache, and writes what it saw: rank 0 the
gathered tensors (``results.npz``), every rank its own checks
(``rank<r>.json``). It imports torch and the port only. Every collective
runs on every rank of its group; a rank that fails writes its traceback
and exits 1, and the others end at the group's 60 s timeout.
"""

import dataclasses
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import ShardingPolicy
from repro_torch.distributed.sharding import (distribute, map_with_path,
                                              path_leaves)
from repro_torch.launch.dryrun import collective_name
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models import LM
from repro_torch.models.moe import moe_aux_loss
from repro_torch.optim import AdamW, OptState
from repro_torch.train import make_serve_steps, make_train_step

from _sharded_train_worker import json_tree

LR = 1e-3
TAIL = dict(hybrid_period=8, unit_head=2, unit_tail_period=2, n_layers=8)
CASES = {"mixtral": ("mixtral-8x7b", {}),
         "mixtral-e3": ("mixtral-8x7b", {"n_experts": 3}),
         "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
         "mamba2": ("mamba2-2.7b", {}),
         "jamba": ("jamba-1.5-large-398b", {}),
         "jamba-tail": ("jamba-1.5-large-398b", TAIL),
         "whisper": ("whisper-tiny", {})}
MESHES = ((2, 2), (4, 1))
DECODE_STEPS = 3


def meshes(case: str):
    """The meshes a case runs on: both, but the 3-expert mixtral only on
    (2, 2), where its experts do not divide "model" (on (4, 1) its layout
    is the 4-expert mixtral's)."""
    return MESHES[:1] if case == "mixtral-e3" else MESHES


def config(case: str):
    arch, over = CASES[case]
    return dataclasses.replace(smoke_config(arch), **over)


def full(x):
    """The global value of a DTensor (a collective on its mesh), as numpy."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().numpy()


def flat(tree, prefix: str) -> dict:
    """{prefix + path: tensor} of every leaf of nested dicts and
    NamedTuples."""
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(prefix + path, leaf),
                  tree)
    return out


def batch_of(inputs, case, kind):
    batch = {"tokens": torch.from_numpy(inputs[f"{case}/{kind}"])}
    if f"{case}/{kind}_enc" in inputs.files:
        batch["enc_embeds"] = torch.from_numpy(inputs[f"{case}/{kind}_enc"])
    return batch


def one_case(case, inputs, out, checks):
    lm = LM(config(case), device="cpu")
    params = lm_params_from_numpy(json_tree(inputs, f"{case}/params/"), "cpu")
    for shape in meshes(case):
        mesh = make_mesh_from_devices(range(4), shape, ("data", "model"))
        tag = f"{case}/{shape[0]}x{shape[1]}"
        policy = ShardingPolicy(mesh, lm.cfg)
        ps = policy.params_shardings(params)
        dparams = distribute(params, ps)

        # one train step
        opt = AdamW(lr=LR)
        dost = distribute(opt.init(params), OptState(policy.replicated(),
                                                     ps, ps))
        batch = batch_of(inputs, case, "train")
        newp, _, m = make_train_step(lm, opt)(
            dparams, dost, distribute(batch, policy.batch_shardings(batch)))
        out[f"{tag}/train/loss"] = full(m["loss"])
        out[f"{tag}/train/grad_norm"] = full(m["grad_norm"])
        for path, leaf in path_leaves(newp):
            out[f"{tag}/train/params/{path}"] = full(leaf)
        checks[f"{tag}/layouts_kept"] = all(
            a.placements == b.placements for a, b in zip(
                (leaf for _, leaf in path_leaves(newp)),
                (leaf for _, leaf in path_leaves(dparams))))
        gates = [leaf for path, leaf in path_leaves(dparams)
                 if path.endswith("moe/w_gate")]
        if gates:
            checks[f"{tag}/w_gate"] = [str(p) for p in gates[0].placements]

        # prefill, then decode steps, outputs placed by the policy
        prefill, decode = make_serve_steps(lm, policy)
        pb = batch_of(inputs, case, "prefill")
        pb = distribute(pb, policy.batch_shardings(pb))
        with torch.inference_mode():
            logits, state = prefill(dparams, pb["tokens"],
                                    pb.get("enc_embeds"))
            out[f"{tag}/prefill/logits"] = full(logits)
            for path, leaf in flat(state, "").items():
                out[f"{tag}/prefill/state/{path}"] = full(leaf)
            toks = inputs[f"{case}/decode"]
            for i in range(DECODE_STEPS):
                tok = distribute({"t": torch.from_numpy(toks[i])},
                                 policy.batch_shardings(
                                     {"t": torch.from_numpy(toks[i])}))["t"]
                logits, state = decode(dparams, tok, state)
                out[f"{tag}/decode/logits{i}"] = full(logits)
            for path, leaf in flat(state, "").items():
                out[f"{tag}/decode/state/{path}"] = full(leaf)
        want = policy.decode_state_shardings(state)
        checks[f"{tag}/state_placed"] = all(
            not isinstance(leaf, DTensor)
            or tuple(leaf.placements) == flat(want, "")[path].placements
            for path, leaf in flat(state, "").items())
    long_decode(case, lm, params, inputs, out, checks)


def long_decode(case, lm, params, inputs, out, checks):
    """B = 1 on (2, 2): the unsharded prefill's state placed by the policy
    (the KV sequence over "data", as ``long_500k``), one decode step
    against the unsharded step on the same state."""
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))
    policy = ShardingPolicy(mesh, lm.cfg)
    tag = f"{case}/long"
    pb = batch_of(inputs, case, "long")
    tok = torch.from_numpy(inputs[f"{case}/long_token"])
    with torch.inference_mode():
        _, state = lm.prefill(params, pb["tokens"], pb.get("enc_embeds"))
        want_logits, want_state = lm.decode_step(params, tok, state)
        dparams = distribute(params, policy.params_shardings(params))
        placed = distribute(state, policy.decode_state_shardings(state))
        gathered = GatherShapes()
        with gathered:
            logits, new = lm.decode_step(dparams, tok, placed)
    seq = []
    unchanged = []
    for path, leaf in flat(placed, "").items():
        if isinstance(leaf, DTensor) and Shard(2) in leaf.placements \
                and path.endswith(("/k", "/v")):
            seq.append(path)
            before = leaf.to_local()
            after = flat(new, "")[path].to_local()
            # the slot written, in the stacked (U, B, S, KV, hd) layout
            slot = int(state_pos(state)) % leaf.shape[2]
            lo = leaf.to_local().shape[2] * _seq_rank(leaf)
            mine = lo <= slot < lo + before.shape[2]
            unchanged.append(bool(torch.equal(before, after)) != mine)
    checks[f"{tag}/seq_sharded"] = seq
    checks[f"{tag}/only_owner_writes"] = all(unchanged)
    # a KV cache (U, B, S, KV, hd) gathered whole would show as an
    # all-gather result of its (S, KV, hd) or (U, B, S, KV, hd)
    caches = {tuple(leaf.shape[2:]) for path, leaf in flat(placed, "")
              .items() if path in seq}
    checks[f"{tag}/cache_gathered"] = any(
        tuple(s[-3:]) in caches for s in gathered.shapes)
    out[f"{tag}/logits"] = full(logits)
    out[f"{tag}/want_logits"] = full(want_logits)
    got, want = flat(new, ""), flat(want_state, "")
    for path in want:
        out[f"{tag}/state/{path}"] = full(got[path])
        out[f"{tag}/want_state/{path}"] = full(want[path])


class GatherShapes(TorchDispatchMode):
    """The result shapes of the all-gathers run inside the mode (on local
    tensors: DTensor's ops come back here as local ops)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if collective_name(func) == "all-gather":
            self.shapes.append(tuple(out.shape))
        return out


def state_pos(state):
    """The decode position of a state: the first ``pos`` leaf."""
    return next(leaf for path, leaf in flat(state, "").items()
                if path.endswith("pos")).reshape(-1)[0]


def _seq_rank(leaf: DTensor) -> int:
    """This rank's index along the mesh dims that shard dim 2 (the
    sequence of a stacked cache), major first."""
    mesh, idx = leaf.device_mesh, 0
    for i, p in enumerate(leaf.placements):
        if p == Shard(2):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def microbatched_remat(inputs, out):
    """jamba (attention, SSM and MoE layers) on (2, 2) with every unit and
    layer under ``torch.utils.checkpoint`` (``remat``) and 2 microbatches:
    one train step's loss, grad norm and params."""
    lm = LM(dataclasses.replace(config("jamba"), remat=True), device="cpu")
    params = lm_params_from_numpy(json_tree(inputs, "jamba/params/"), "cpu")
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))
    policy = ShardingPolicy(mesh, lm.cfg)
    ps = policy.params_shardings(params)
    opt = AdamW(lr=LR)
    batch = batch_of(inputs, "jamba", "train")
    newp, _, m = make_train_step(lm, opt, microbatches=2)(
        distribute(params, ps),
        distribute(opt.init(params), OptState(policy.replicated(), ps, ps)),
        distribute(batch, policy.batch_shardings(batch)))
    out["mb2_remat/loss"] = full(m["loss"])
    out["mb2_remat/grad_norm"] = full(m["grad_norm"])
    for path, leaf in path_leaves(newp):
        out[f"mb2_remat/params/{path}"] = full(leaf)


def aux_loss(inputs, out, checks):
    """``moe_aux_loss`` on a batch-sharded DTensor input and DTensor
    params equals the unsharded loss."""
    lm = LM(config("mixtral"), device="cpu")
    params = lm_params_from_numpy(json_tree(inputs, "mixtral/params/"),
                                  "cpu")
    p = {k: v[0] for k, v in
         params["blocks"]["head"]["layer0"]["moe"].items()}
    x = torch.from_numpy(inputs["aux_x"])
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))
    policy = ShardingPolicy(mesh, lm.cfg)
    dx = distribute({"x": x}, policy.batch_shardings({"x": x}))["x"]
    dp = distribute(p, {k: policy._named(()) for k in p})
    from repro_torch.distributed.constraints import sharded_context
    with sharded_context(dp):
        got = moe_aux_loss(dp, dx, lm.cfg)
    out["aux/got"] = full(got)
    out["aux/want"] = full(moe_aux_loss(p, x, lm.cfg))


def main(rank: int, world: int, work: str):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out, checks = {}, {}
    try:
        inputs = np.load(os.path.join(work, "inputs.npz"))
        cases = os.environ.get("SHARDED_FAMILIES_CASES")
        for case in (cases.split(",") if cases else CASES):
            one_case(case, inputs, out, checks)
        aux_loss(inputs, out, checks)
        if not cases or "jamba" in cases.split(","):
            microbatched_remat(inputs, out)
        if rank == 0:
            np.savez(os.path.join(work, "results.npz"), **out)
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(checks, f)
    except Exception:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
