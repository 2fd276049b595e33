"""Sharded LM training over four cards: ``chip_smoke.py``'s phase 27 on
(data, model) meshes of four NCCL ranks, one process a card.

    python3 tools/sharded_train_cards.py

qwen2-0.5b at full width in float32 compute (phase 27's reason), phase
24's params (``init_params(PRNGKey(0))``), corpus, KronDPP selector and
B = 8 x 128 (the 3 batches drawn on rank 0, one ``phase2_select``
launch, and broadcast). Every rank runs the unsharded step on its own
card (the one-card step); then on each mesh of ``MESHES`` the same 3
steps of the sharded step (``ShardingPolicy`` placements,
``make_train_step``), each held against the one-card step under phase
24's rules: loss and grad norm within ``LT_F32_TOL`` of max(1, |one
card|), params by ``lt_check_gap`` (every element within 2·lr a step, at
most 1% past 1e-6). Then ``int8_allreduce_grads`` over the data group of
(4, 1) and (2, 2) with each rank's own grads, against the mean of the
group's local dequantizations (float32 sums in another order: 1e-6
relative); and the elastic flow: save on (2, 2) after a step, one more
step there; ``elastic_remesh([0, 1], model_parallel=2,
old_data_parallel=2)``; ``restore(shardings=)`` onto the plan's (1, 2)
mesh on ranks 0 and 1; the same step there with 1 x
``microbatch_multiplier`` microbatches, its loss and params against the
(2, 2) step's; then on the plan's mesh an async save met by ``wait`` and
a blocking save (each meets ranks 0 and 1 only, while ranks 2 and 3 run
all-reduces of their own), read back bit for bit.

Prints one ``sharded_train_cards`` JSON line (each mesh's step time, the
host clock around a synchronized step, median of steps 2-3; the peak of
``max_memory_allocated`` on each card; each step's collectives by op,
their count and the bytes a rank passes into them) beside the cards'
``nvidia-smi --query-gpu=name,power.limit`` lines. Exits non-zero on any
failed check, a rank that fails or hangs past ``DEADLINE_S``, or with
fewer than four cards. Rendezvous through a ``FileStore`` under
``build/``; the checkpoints (about 6 GB, and 2 x 2 GB on the plan's mesh) go
there too and are removed.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

WORLD = 4
MESHES = ((4, 1), (2, 2), (1, 4))
STEPS = 3
TIMED = slice(1, None)          # steps 2-3
INT8_RTOL = 1e-6
COLLECTIVE_TIMEOUT_S = 300
DEADLINE_S = 1500
FAILED: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        FAILED.append(msg)
        print(f"rank {dist.get_rank()}: FAILED {msg}", file=sys.stderr,
              flush=True)


class CommBytes:
    """``CommDebugMode`` counts of the collectives a block runs, by op, and
    the bytes this rank passes into each op (its input tensors)."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.distributed.tensor.debug import _comm_mode as cm
        bytes_by_op = self.bytes = collections.Counter()

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                packet = getattr(func, "_overloadpacket", None)
                # the ops CommDebugMode counts (DTensor's all-to-all too)
                if out is not NotImplemented and (
                        packet in self.comm_registry
                        or packet in cm.c10d_collective_ops):
                    first = args[0]
                    tensors = first if isinstance(first, (list, tuple)) \
                        else [first]
                    name = str(cm.NATIVE_TO_PY_MAPPING.get(packet, packet))
                    bytes_by_op[name] += sum(
                        t.numel() * t.element_size() for t in tensors
                        if isinstance(t, torch.Tensor))
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def counts(self) -> dict:
        return {str(k): v for k, v in self.mode.get_comm_counts().items()}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def full_tree(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: a.full_tensor(), tree)


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def draw_batches(cfg, dev, rank: int) -> tuple:
    """Phase 24's 3 first batches, drawn on rank 0 (the selector's phase-2
    launches counted) and broadcast: ((3, B, S + 1) tokens, launches)."""
    from repro_torch.data import TokenPipeline, synthetic_corpus
    tokens = torch.zeros((STEPS, cs.LT_BATCH, cs.LT_SEQ + 1),
                         dtype=torch.int64, device=dev)
    launches = {}
    if rank == 0:
        corpus = synthetic_corpus(cs.LT_DOCS, cs.LT_SEQ, cfg.vocab,
                                  cs.LM_SEED)
        draws = iter(TokenPipeline(corpus, cs.LT_BATCH, cs.LM_SEED,
                                   cs.lt_selector(corpus, cfg, dev)))
        counters = cs.lr_counters()
        for obj in counters.values():
            obj.launches = 0
        batches = [next(draws)["tokens"] for _ in range(STEPS)]
        launches = {k: obj.launches for k, obj in counters.items()}
        check(launches["phase2_select"] == 1, f"the selector launched "
              f"phase 2 {launches['phase2_select']} times for {STEPS} "
              f"batches, not 1")
        tokens.copy_(torch.as_tensor(np.stack(batches)))
    dist.broadcast(tokens, src=0)
    return tokens, launches


def placed(lm, params, ost, mesh):
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.optim import OptState
    policy = ShardingPolicy(mesh, lm.cfg)
    ps = policy.params_shardings(params)
    return policy, distribute(params, ps), distribute(
        ost, OptState(policy.replicated(), ps, ps))


def sharded_meshes(lm, opt, params0, tokens, dev, out) -> None:
    """The one-card step, then each mesh's 3 sharded steps against it."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_train_step
    step = make_train_step(lm, opt)
    params, ost = params0, opt.init(params0)
    ref, one_card_s = [], []
    for i in range(STEPS):
        sync(dev)
        t0 = time.perf_counter()
        params, ost, m = step(params, ost, {"tokens": tokens[i]})
        sync(dev)
        one_card_s.append(time.perf_counter() - t0)
        ref.append((params, float(m["loss"]), float(m["grad_norm"])))
    out["one_card"] = {"step_times_s": one_card_s,
                       "step_s": statistics.median(one_card_s[TIMED]),
                       "losses": [r[1] for r in ref]}
    ost0 = opt.init(params0)
    for shape in MESHES:
        mesh = make_mesh_from_devices(range(WORLD), shape,
                                      ("data", "model"))
        policy, dp, dost = placed(lm, params0, ost0, mesh)
        check(all(a.to_local().device == dev for a in
                  [*tree_leaves(dp), *tree_leaves(dost)]),
              f"{shape}: a local shard is not on this rank's card")
        tag = f"{shape[0]}x{shape[1]}"
        res = {"placements": {
            k: [str(p) for p in v.placements] for k, v in (
                ("embed", dp["embed"]),
                ("wq", dp["blocks"]["head"]["layer0"]["attn"]["wq"]),
                ("wo", dp["blocks"]["head"]["layer0"]["attn"]["wo"]))},
            "steps": []}
        times = []
        reset_peak(dev)
        for i in range(STEPS):
            batch = {"tokens": tokens[i]}
            dbatch = distribute(batch, policy.batch_shardings(batch))
            sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            dp, dost, m = step(dp, dost, dbatch)
            sync(dev)
            times.append(time.perf_counter() - t0)
            want, loss, gnorm = ref[i]
            got = {"loss": float(m["loss"].full_tensor()),
                   "grad_norm": float(m["grad_norm"].full_tensor())}
            r = {"loss_rel": rel(got["loss"], loss),
                 "grad_norm_rel": rel(got["grad_norm"], gnorm)}
            gap = cs.lt_params_gap(full_tree(dp), want)
            check(max(r.values()) <= cs.LT_F32_TOL, f"{tag} step {i + 1} "
                  f"against one card: {r}")
            check(gap["max_rel"] <= 2 * cs.LT_LR * (i + 1)
                  and gap["elements_past_step_tol"] <= cs.LT_PAST_SHARE
                  * gap["elements"], f"{tag} step {i + 1} params: {gap}")
            res["steps"].append({"loss": got["loss"], **r, "params": gap})
        res["peak_memory_gb"] = peak_gb(dev)
        comm = CommBytes()
        with comm:
            step(dp, dost, dbatch)
        sync(dev)
        res["collectives_per_step"] = comm.counts()
        res["collective_bytes_per_step"] = dict(comm.bytes)
        res["step_times_s"] = times
        res["step_s"] = statistics.median(times[TIMED])
        res["tokens_per_s"] = cs.LT_BATCH * cs.LT_SEQ / res["step_s"]
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, res["peak_memory_gb"])
        res["peak_memory_gb_per_card"] = gathered
        out[tag] = res
        if dist.get_rank() == 0:
            print(f"{tag}: step {res['step_s'] * 1e3:.1f} ms, losses "
                  f"{[s['loss'] for s in res['steps']]}, peak "
                  f"{gathered} GiB, collectives "
                  f"{res['collectives_per_step']}", flush=True)
        del dp, dost, m


def int8_grads(dev, out) -> None:
    """Each rank's own grads through ``int8_allreduce_grads`` over the
    data group: the mean of the group's local dequantizations."""
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim import int8_allreduce_grads
    from repro_torch.optim.compression import _quantize
    rank = dist.get_rank()
    gen = torch.Generator(device=dev).manual_seed(100 + rank)
    grads = {"w": torch.randn((896, 4864), generator=gen, device=dev),
             "b": torch.randn((896,), generator=gen, device=dev) * 1e-3}
    deq = {}
    for k, g in grads.items():
        q, s = _quantize(g)
        deq[k] = (q.float() * s).cpu().numpy()
    everyone = [None] * WORLD
    dist.all_gather_object(everyone, deq)
    for shape in ((4, 1), (2, 2)):
        mesh = make_mesh_from_devices(range(WORLD), shape,
                                      ("data", "model"))
        group = dist.get_process_group_ranks(mesh.get_group("data"))
        reduced, residual = int8_allreduce_grads(grads, mesh, ("data",))
        worst = 0.0
        for k in grads:
            want = np.sum([everyone[r][k] for r in group], axis=0) \
                / len(group)
            got = reduced[k].cpu().numpy()
            err = float(np.abs(got - want).max() / np.abs(want).max())
            worst = max(worst, err)
            check(err <= INT8_RTOL, f"int8 {shape} {k}: {err}")
            check(torch.equal(residual[k].cpu(),
                              grads[k].cpu() - torch.from_numpy(deq[k])),
                  f"int8 {shape} {k}: the residual is not g - deq")
        out[f"int8_{shape[0]}x{shape[1]}"] = {"data_group": group,
                                              "max_rel": worst}


def elastic(lm, opt, params0, tokens, dev, work: Path, out) -> None:
    """Save on (2, 2), re-mesh to ranks 0 and 1, restore, step there and
    save there, while ranks 2 and 3 run collectives of their own."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.elastic import elastic_remesh
    from repro_torch.distributed.sharding import distribute, path_leaves
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim import OptState
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_train_step
    rank = dist.get_rank()
    mesh = make_mesh_from_devices(range(WORLD), (2, 2), ("data", "model"))
    policy, dp, dost = placed(lm, params0, opt.init(params0), mesh)
    step = make_train_step(lm, opt)
    b0, b1 = {"tokens": tokens[0]}, {"tokens": tokens[1]}
    dp, dost, _ = step(dp, dost, distribute(b0, policy.batch_shardings(b0)))
    ckpt = CheckpointManager(CheckpointConfig(directory=str(work / "ckpt"),
                                              async_save=False))
    t0 = time.perf_counter()
    ckpt.save(1, {"params": dp, "opt": dost}, blocking=True)
    save_s = time.perf_counter() - t0
    p22, _, m22 = step(dp, dost, distribute(b1, policy.batch_shardings(b1)))
    want = full_tree(p22)
    loss22 = float(m22["loss"].full_tensor())
    del dp, dost, p22
    plan = elastic_remesh([0, 1], model_parallel=2, old_data_parallel=2)
    res = {"plan": [plan.data_parallel, plan.model_parallel,
                    plan.microbatch_multiplier], "save_s": save_s,
           "loss22": loss22}
    check(res["plan"] == [1, 2, 2], f"elastic plan {res['plan']}")
    others = dist.new_group([2, 3])
    if rank >= 2:
        # the ranks outside the plan's mesh: collectives of their own
        x = torch.ones(3, device=dev)
        for _ in range(3):
            dist.all_reduce(x, group=others)
        check(x.tolist() == [8.0] * 3, f"ranks 2 and 3 summed {x}")
    else:
        new = ShardingPolicy(plan.mesh, lm.cfg)
        ps = new.params_shardings(params0)
        t0 = time.perf_counter()
        state = ckpt.restore(1, target={"params": params0,
                                        "opt": opt.init(params0)},
                             shardings={"params": ps, "opt": OptState(
                                 new.replicated(), ps, ps)})
        res["restore_s"] = time.perf_counter() - t0
        rp, rost = state["params"], state["opt"]
        check(all(a.device_mesh.shape == (1, 2) and a.to_local().device
                  == dev for a in tree_leaves(rp)),
              "the restored params are not on the plan's mesh")
        pstep = make_train_step(lm, opt, plan.microbatch_multiplier)
        p12, _, m12 = pstep(rp, rost, distribute(b1, new.batch_shardings(b1)))
        res["loss12"] = float(m12["loss"].full_tensor())
        res["loss_rel"] = rel(res["loss12"], loss22)
        f12 = full_tree(p12)
        gap = cs.lt_params_gap(f12, want)
        res["params"] = gap
        check(res["loss_rel"] <= cs.LT_F32_TOL, f"elastic loss {res}")
        check(gap["max_rel"] <= 2 * cs.LT_LR and gap[
            "elements_past_step_tol"] <= cs.LT_PAST_SHARE * gap["elements"],
            f"elastic params {gap}")
        # checkpoints on the plan's mesh meet ranks 0 and 1 only: an async
        # save met by ``wait``, then a blocking one
        plan_ckpt = CheckpointManager(CheckpointConfig(
            directory=str(work / "plan_ckpt"), keep=2))
        t0 = time.perf_counter()
        plan_ckpt.save(2, {"params": p12})
        plan_ckpt.wait()
        plan_ckpt.save(3, {"params": p12}, blocking=True)
        res["plan_saves_s"] = time.perf_counter() - t0
        back = dict(path_leaves(plan_ckpt.restore(2)["params"]))
        got = dict(path_leaves(f12))
        check(plan_ckpt.latest_step() == 3 and set(back) == set(got)
              and all(np.array_equal(back[k], got[k].cpu().numpy())
                      for k in got), "the plan mesh's checkpoint does not "
              "read back the (1, 2) step's params")
    dist.barrier()
    out["elastic"] = res


def run(rank: int, dev, work: Path, smoke: bool) -> dict:
    from repro_torch import random as prng
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, cosine_schedule
    cfg = dataclasses.replace((smoke_config if smoke else get_config)(
        cs.LM_ARCH), dtype="float32")
    lm = LM(cfg, device=dev)
    params0 = lm.init_params(prng.PRNGKey(cs.LM_SEED, dev))
    opt = AdamW(lr=cs.LT_LR, schedule=cosine_schedule(
        max(cs.LT_STEPS // 10, 1), cs.LT_STEPS))
    out = {"arch": cs.LM_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype,
           "batch": cs.LT_BATCH, "seq": cs.LT_SEQ, "steps": STEPS}
    tokens, out["selector_launches"] = draw_batches(cfg, dev, rank)
    sharded_meshes(lm, opt, params0, tokens, dev, out)
    int8_grads(dev, out)
    elastic(lm, opt, params0, tokens, dev, work, out)
    return out


def worker(rank: int, work: str, backend: str, smoke: bool) -> None:
    work = Path(work)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, store=dist.FileStore(str(work / "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = run(rank, dev, work, smoke)
        if rank == 0:
            (work / "result.json").write_text(json.dumps(out))
    except Exception:
        FAILED.append(traceback.format_exc())
        print(f"rank {rank}: {FAILED[-1]}", file=sys.stderr, flush=True)
    finally:
        dist.destroy_process_group()
    sys.exit(1 if FAILED else 0)


def spawn_ranks(target, work: Path, backend: str, smoke: bool):
    """Start ``WORLD`` spawned ranks of ``target(rank, work, backend,
    smoke)`` in a fresh ``work`` directory and wait for them, killing all
    past ``DEADLINE_S`` or when one fails: (exit codes, rank 0's
    ``result.json`` or None). Every rank gets one ``PYTHONHASHSEED``:
    DTensor breaks ties between sharding strategies in an order that
    follows string hashes, and ranks that choose apart wait on different
    collectives."""
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    os.environ["PYTHONHASHSEED"] = "0"       # read by each spawned rank
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(work), backend, smoke))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    end = time.monotonic() + DEADLINE_S
    while time.monotonic() < end:
        codes = [p.exitcode for p in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            break
        time.sleep(0.5)
    for p in procs:
        if p.exitcode is None:
            p.kill()
        p.join()
    result = work / "result.json"
    out = json.loads(result.read_text()) if result.exists() else None
    shutil.rmtree(work, ignore_errors=True)
    return [p.exitcode for p in procs], out


def main(backend: str = "nccl", smoke: bool = False) -> None:
    """Spawn the 4 ranks and wait for them (``backend`` "gloo" and
    ``smoke`` rehearse the control flow on the CPU)."""
    smi = []
    if backend == "nccl":
        n = torch.cuda.device_count()
        if n < WORLD:
            cs.fail(f"{n} cards visible: this tool needs {WORLD}")
        from repro_torch.kernels import _build
        for name in ("phase2_select", "threefry"):
            _build.build(name)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    work = ROOT / "build" / "sharded_train_cards"
    t0 = time.perf_counter()
    codes, out = spawn_ranks(worker, work, backend, smoke)
    print(json.dumps({"sharded_train_cards": out, "exit_codes": codes,
                      "wall_s": time.perf_counter() - t0, "cards": smi}))
    if codes != [0] * WORLD or out is None:
        cs.fail(f"ranks exited {codes}")


if __name__ == "__main__":
    main()
