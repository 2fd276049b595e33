"""One gloo rank of ``tests/test_torch_sharded_train.py`` (run as a
script: ``python _sharded_train_worker.py RANK WORLD DIR``).

The rank rendezvouses through a ``FileStore`` in DIR, reads the JAX
params and token batches the test wrote there (``inputs.npz``), runs the
port's sharded paths on 4 CPU ranks and writes what it saw: rank 0 the
gathered tensors (``results.npz``), every rank its own checks
(``rank<r>.json``). It imports torch and the port only. Every collective
runs on every rank of its group; a rank that fails writes its traceback
and exits 1, and the others end at the group's 60 s timeout.
"""

import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import ShardingPolicy
from repro_torch.distributed.elastic import elastic_remesh
from repro_torch.distributed.sharding import (NamedSharding, distribute,
                                              path_leaves)
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models import LM
from repro_torch.optim import AdamW, OptState, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.optim.compression import int8_allreduce_grads, int8_psum
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from torch.distributed.tensor import DTensor, Replicate

ARCH = "qwen2-0.5b"
LR = 1e-3
MESHES = ((4, 1), (2, 2), (1, 4))


def full(x):
    """The global value of a DTensor (a collective on its mesh), as numpy."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().numpy()


def optimizer():
    return AdamW(lr=LR, schedule=cosine_schedule(1, 3))


def placed(lm, params, mesh):
    """(policy, params, opt state) placed on ``mesh`` as the reference's
    ``device_put`` onto ``params_shardings``/``replicated``."""
    policy = ShardingPolicy(mesh, lm.cfg)
    ost = optimizer().init(params)
    ps = policy.params_shardings(params)
    os_ = OptState(step=policy.replicated(), m=ps, v=ps)
    return policy, distribute(params, ps), distribute(ost, os_)


def sharded_steps(lm, params, batches, out, checks):
    """3 steps on each mesh with 1 and 2 microbatches: losses, grad norms,
    params and moments after the last."""
    for shape in MESHES:
        mesh = make_mesh_from_devices(range(4), shape, ("data", "model"))
        for mb in (1, 2):
            policy, dp, dost = placed(lm, params, mesh)
            step = make_train_step(lm, optimizer(), mb)
            tag = f"{shape[0]}x{shape[1]}_mb{mb}"
            losses, norms = [], []
            for tokens in batches:
                batch = {"tokens": torch.from_numpy(tokens)}
                dbatch = distribute(batch, policy.batch_shardings(batch))
                dp, dost, m = step(dp, dost, dbatch)
                losses.append(full(m["loss"]))
                norms.append(full(m["grad_norm"]))
                checks[f"{tag}_norm_replicated"] = all(
                    p == Replicate() for p in m["grad_norm"].placements)
            for path, leaf in path_leaves(dp):
                out[f"{tag}/params/{path}"] = full(leaf)
            for path, leaf in path_leaves(dost.m):
                out[f"{tag}/m/{path}"] = full(leaf)
            out[f"{tag}/loss"] = np.array(losses)
            out[f"{tag}/grad_norm"] = np.array(norms)
            checks[f"{tag}_step_replicated"] = all(
                p == Replicate() for p in dost.step.placements)
            checks[f"{tag}_layouts_kept"] = all(
                a.placements == b.placements for a, b in zip(
                    tree_leaves(dp), tree_leaves(dost.m)))
            checks[f"{tag}_local_on_cpu"] = all(
                leaf.to_local().device.type == "cpu"
                for leaf in tree_leaves(dp))
            if shape == (2, 2) and mb == 1:
                wq = dp["blocks"]["head"]["layer0"]["attn"]["wq"]
                checks["wq_placements"] = [str(p) for p in wq.placements]
                checks["embed_placements"] = [
                    str(p) for p in dp["embed"].placements]
                init = optimizer().init(dp)
                checks["init_on_dtensors"] = all(
                    a.placements == b.placements for a, b in
                    zip(tree_leaves(dp), tree_leaves(init.m))) and all(
                    p == Replicate() for p in init.step.placements)


def remat_steps(params, batches, out):
    """The (2, 2) step with every unit under ``torch.utils.checkpoint``
    (the full configs' ``remat``): one step's loss and grad norm."""
    import dataclasses
    lm = LM(dataclasses.replace(smoke_config(ARCH), remat=True),
            device="cpu")
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))
    policy, dp, dost = placed(lm, params, mesh)
    batch = {"tokens": torch.from_numpy(batches[0])}
    _, _, m = make_train_step(lm, optimizer())(
        dp, dost, distribute(batch, policy.batch_shardings(batch)))
    out["remat/loss"] = full(m["loss"])
    out["remat/grad_norm"] = full(m["grad_norm"])


def compression(rank, out, checks):
    """Per-rank grads through ``int8_psum`` and ``int8_allreduce_grads``
    over the data group of a (4, 1) and a (2, 2) mesh."""
    rng = np.random.default_rng(100 + rank)
    grads = {"a": torch.from_numpy(rng.standard_normal((5, 3))
                                   .astype(np.float32)),
             "b": torch.from_numpy((rng.standard_normal(7) * 1e-3)
                                   .astype(np.float32))}
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh_from_devices(range(4), shape, ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        reduced, residual = int8_allreduce_grads(grads, mesh, ("data",))
        again, _ = int8_allreduce_grads(grads, mesh, ("data",), residual)
        psum = int8_psum(grads["a"], mesh.get_group("data"))
        gathered = [None] * 4
        dist.all_gather_object(gathered, {
            "reduced": {k: v.numpy() for k, v in reduced.items()},
            "again": {k: v.numpy() for k, v in again.items()},
            "residual": {k: v.numpy() for k, v in residual.items()},
            "psum": psum.numpy()})
        if rank == 0:
            for r, got in enumerate(gathered):
                for key in ("reduced", "again", "residual"):
                    for k, v in got[key].items():
                        out[f"int8/{tag}/{r}/{key}/{k}"] = v
                out[f"int8/{tag}/{r}/psum"] = got["psum"]


def elastic(rank, lm, params, batches, out, checks, ckpt_dir):
    """Save on (2, 2), one more step there; re-mesh to ranks 0, 1 as (1, 2),
    restore onto it, the same step with microbatches x the plan's
    multiplier, and a save there (async then blocking) while ranks 2 and 3
    run collectives of their own."""
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))
    policy, dp, dost = placed(lm, params, mesh)
    step = make_train_step(lm, optimizer(), 1)
    batch = {"tokens": torch.from_numpy(batches[0])}
    dp, dost, _ = step(dp, dost, distribute(
        batch, policy.batch_shardings(batch)))
    ckpt = CheckpointManager(CheckpointConfig(directory=ckpt_dir,
                                              async_save=False))
    ckpt.save(1, {"params": dp, "opt": dost}, blocking=True)
    saved = {path: full(leaf) for path, leaf in path_leaves(dp)}
    batch = {"tokens": torch.from_numpy(batches[1])}
    p22, _, m22 = step(dp, dost, distribute(
        batch, policy.batch_shardings(batch)))
    out22 = {path: full(leaf) for path, leaf in path_leaves(p22)}
    loss22 = full(m22["loss"])

    plan = elastic_remesh([0, 1], model_parallel=2, old_data_parallel=2)
    checks["plan"] = [plan.data_parallel, plan.model_parallel,
                      plan.microbatch_multiplier, list(plan.mesh.shape)]
    others = dist.new_group([2, 3])
    if rank >= 2:
        # the ranks outside the plan's mesh: collectives of their own
        x = torch.ones(3)
        for _ in range(3):
            dist.all_reduce(x, group=others)
        checks["others_sum"] = x.tolist()
    else:
        new = ShardingPolicy(plan.mesh, lm.cfg)
        host = optimizer().init(params)
        ps = new.params_shardings(params)
        target = {"params": params, "opt": host}
        state = ckpt.restore(1, target=target, shardings={
            "params": ps, "opt": OptState(new.replicated(), ps, ps)})
        rp, rost = state["params"], state["opt"]
        restored = {path: full(leaf) for path, leaf in path_leaves(rp)}
        checks["restored_bitwise"] = all(
            np.array_equal(restored[k], saved[k]) for k in saved)
        checks["restored_on_plan_mesh"] = all(
            leaf.device_mesh.shape == (1, 2) for leaf in tree_leaves(rp))
        mb = plan.microbatch_multiplier
        pstep = make_train_step(lm, optimizer(), mb)
        p12, _, m12 = pstep(rp, rost, distribute(
            batch, new.batch_shardings(batch)))
        loss12 = full(m12["loss"])
        gathered = {path: full(leaf) for path, leaf in path_leaves(p12)}
        # the plan mesh's checkpoints: an async save met by ``wait`` and a
        # blocking one, each meeting ranks 0 and 1 only
        plan_ckpt = CheckpointManager(CheckpointConfig(
            directory=ckpt_dir + "_plan", keep=2))
        plan_ckpt.save(2, {"params": p12})
        plan_ckpt.wait()
        plan_ckpt.save(3, {"params": p12}, blocking=True)
        checks["plan_latest_step"] = plan_ckpt.latest_step()
        back = dict(path_leaves(plan_ckpt.restore(2)["params"]))
        checks["plan_saved_bitwise"] = set(back) == set(gathered) and all(
            np.array_equal(back[k], gathered[k]) for k in gathered)
        if rank == 0:
            out["elastic/loss22"] = loss22
            out["elastic/loss12"] = loss12
            for path, value in gathered.items():
                out[f"elastic/p12/{path}"] = value
                out[f"elastic/p22/{path}"] = out22[path]
    dist.barrier()


def trainer(lm, params, batches, out, checks, ckpt_dir):
    """``Trainer.fit`` on (2, 2) DTensors: 2 steps checkpointed every step,
    resumed by ``try_resume`` to 3, against a one-shot 3-step run."""
    mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"))

    def dbatches():
        policy = ShardingPolicy(mesh, lm.cfg)
        for tokens in batches:
            batch = {"tokens": torch.from_numpy(tokens)}
            yield distribute(batch, policy.batch_shardings(batch))

    def run(total, ckpt, state=None, start=0, skip=0):
        opt = optimizer()
        tr = Trainer(lm, opt, make_train_step(lm, opt), TrainerConfig(
            total_steps=total, log_every=1, checkpoint_dir=ckpt,
            checkpoint_every=1))
        _, dp, dost = placed(lm, params, mesh)
        if state == "resume":
            dp, dost, start = tr.try_resume(dp, dost)
        draws = dbatches()
        for _ in range(skip):
            next(draws)
        return tr.fit(dp, dost, draws, start_step=start), start

    first, _ = run(2, ckpt_dir)
    resumed, start = run(3, ckpt_dir, state="resume", skip=2)
    oneshot, _ = run(3, None)
    got = {path: full(leaf) for path, leaf in path_leaves(resumed["params"])}
    want = {path: full(leaf) for path, leaf in path_leaves(oneshot["params"])}
    checks["trainer_start"] = start
    checks["trainer_steps"] = [first["final_step"], resumed["final_step"],
                               oneshot["final_step"]]
    checks["trainer_losses"] = [h["loss"] for h in oneshot["history"]]
    checks["trainer_resumed_bitwise"] = all(
        np.array_equal(got[k], want[k]) for k in want)
    checks["trainer_history_floats"] = all(
        isinstance(h["loss"], float) for h in first["history"])


def pod_major(rank, checks):
    """A (pod, data, model) = (2, 2, 1) mesh: a dim sharded on ("pod",
    "data") holds rank r's rows at its r-th pod-major chunk."""
    mesh = make_mesh_from_devices(range(4), (2, 2, 1),
                                  ("pod", "data", "model"))
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    d = distribute({"x": x}, {"x": NamedSharding(mesh,
                                                 (("pod", "data"), None))})
    checks["pod_major"] = bool(torch.equal(d["x"].to_local(),
                                           x[2 * rank:2 * rank + 2]))


def main(rank: int, world: int, work: str):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out, checks = {}, {}
    try:
        inputs = np.load(os.path.join(work, "inputs.npz"))
        lm = LM(smoke_config(ARCH), device="cpu")
        params = lm_params_from_numpy(
            json_tree(inputs, "params/"), "cpu")
        batches = [inputs[f"tokens{i}"] for i in range(3)]
        pod_major(rank, checks)
        compression(rank, out, checks)
        sharded_steps(lm, params, batches, out, checks)
        remat_steps(params, batches, out)
        elastic(rank, lm, params, batches, out, checks,
                os.path.join(work, "ckpt"))
        trainer(lm, params, batches, out, checks,
                os.path.join(work, "trainer_ckpt"))
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


def json_tree(npz, prefix: str):
    """The nested dict of arrays stored under ``prefix`` with "/" paths."""
    tree: dict = {}
    for key in npz.files:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
