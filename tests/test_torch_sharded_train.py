"""Sharded LM training in the PyTorch port (``repro_torch.distributed``,
DTensor params under ``make_train_step``, ``optim.compression``, the
elastic re-mesh, DTensor checkpoints and the ``Trainer``) on 4 gloo
ranks, against the JAX package's single-device step.

The reference's own sharded step cannot be the reference: it raises
``DuplicateSpecError`` at ``repro/models/transformer.py:327`` (``embed``
placed ``P("model", "data")`` gathered by data-sharded tokens). So the
port's sharded step is held against the JAX single-device
``jax.jit(make_train_step)`` on the same converted params and tokens, and
against the port's unsharded step, at qwen2-0.5b's smoke size (2 layers,
d_model 64, 4 heads of 16 with 2 KV heads, vocab 256; (1, 4) shards the
KV heads unevenly), B = 8 x 33 tokens, 3 steps at lr 1e-3.

One module fixture starts 4 ranks (``tests/_sharded_train_worker.py``,
one process each, one thread each) that rendezvous through a
``FileStore`` under ``tmp_path``, with a 60 s collective timeout; it
waits for them with a deadline and kills them all if one fails. The tests
read what the ranks wrote. Tolerances are ``tests/test_torch_train.py``'s:
``F32_TOL`` (2e-5 of max(1, max |JAX|)) for losses, grad norms and
moments, and for params the count rule (every element within 2·lr a step,
at most ``PAST_SHARE`` = 1% past ``STEP_TOL`` = 1e-6).
"""

import functools
import json
import os
from pathlib import Path

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.configs import smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.distributed.sharding import path_leaves
from repro_torch.models import LM
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.compression import _quantize
from repro_torch.train import make_train_step
from test_torch_models import F32_TOL
from test_torch_train import PAST_SHARE, STEP_TOL
from _ranks import run_ranks

WORKER = Path(__file__).with_name("_sharded_train_worker.py")
ARCH = "qwen2-0.5b"
LR = 1e-3
WORLD = 4
DEADLINE_S = 400
CASES = [f"{m}_mb{mb}" for m in ("4x1", "2x2", "1x4") for mb in (1, 2)]


def _batches():
    rng = np.random.default_rng(7)
    vocab = jax_smoke_config(ARCH).vocab
    return [rng.integers(0, vocab, (8, 33), dtype=np.int32)
            for _ in range(3)]


def _jax_params():
    return jax.tree_util.tree_map(
        np.asarray, JaxLM(jax_smoke_config(ARCH)).init_params(
            jax.random.PRNGKey(0)))


def _flat(tree, prefix=""):
    return {f"{prefix}{p}": np.asarray(v) for p, v in path_leaves(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 ranks once: (results.npz, [rank checks])."""
    work = tmp_path_factory.mktemp("sharded")
    inputs = _flat(_jax_params(), "params/")
    for i, b in enumerate(_batches()):
        inputs[f"tokens{i}"] = b
    np.savez(work / "inputs.npz", **inputs)
    run_ranks(WORKER, work, WORLD, DEADLINE_S)
    checks = [json.loads((work / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return dict(np.load(work / "results.npz")), checks


@functools.lru_cache(maxsize=None)
def _reference(mb):
    """Per step (loss, grad norm) and the params and m after 3 steps of the
    jitted JAX step and of the port's unsharded step."""
    jcfg = jax_smoke_config(ARCH)
    jlm = JaxLM(jcfg)
    jp = jlm.init_params(jax.random.PRNGKey(0))
    jopt = JaxAdamW(lr=LR, schedule=jax_cosine(1, 3))
    jstep = jax.jit(jax_make_train_step(jlm, jopt, mb))
    js = jopt.init(jp)
    lm = LM(smoke_config(ARCH), device="cpu")
    topt = AdamW(lr=LR, schedule=cosine_schedule(1, 3))
    tstep = make_train_step(lm, topt, mb)
    tp = lm_params_from_numpy(_jax_params(), "cpu")
    ts = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    jm_all, tm_all = [], []
    for tokens in _batches():
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tokens)})
        tp, ts, tm = tstep(tp, ts, {"tokens": tokens})
        jm_all.append((float(jm["loss"]), float(jm["grad_norm"])))
        tm_all.append((float(tm["loss"]), float(tm["grad_norm"])))
    jax_tree = {"params": jax.tree_util.tree_map(np.asarray, jp),
                "m": jax.tree_util.tree_map(np.asarray, js.m)}
    port_tree = {"params": {p: v.numpy() for p, v in path_leaves(tp)},
                 "m": {p: v.numpy() for p, v in path_leaves(ts.m)}}
    return jm_all, tm_all, jax_tree, port_tree


def _close_count(got, want, slack, label):
    """The count rule of ``test_torch_train.assert_params_close`` over
    {path: array} pairs. Returns the count past ``STEP_TOL``."""
    past = total = 0
    for path, w in want.items():
        d = np.abs(got[path] - w) / max(1.0, float(np.abs(w).max()))
        assert d.max() <= slack, (label, path, d.max())
        past += int((d > STEP_TOL).sum())
        total += d.size
    assert past <= PAST_SHARE * total, (label, past, total)
    return past


def _tree_close(got, want, label):
    for path, w in want.items():
        err = np.abs(got[path] - w).max() / max(1.0, float(np.abs(w).max()))
        assert err <= F32_TOL, (label, path, err)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_jax_single_device_step(ranks, case):
    """3 steps of the sharded step on a (data, model) gloo mesh: loss and
    grad norm each step within ``F32_TOL`` of the JAX jitted single-device
    step and of the port's unsharded step; params after the 3 steps by the
    count rule and moments within ``F32_TOL`` of both; the grad norm and
    the step count replicated, every leaf's layout kept, local shards on
    the CPU."""
    out, checks = ranks
    mb = int(case[-1])
    jm, tm, jax_tree, port_tree = _reference(mb)
    for r in range(WORLD):
        for key in ("norm_replicated", "step_replicated", "layouts_kept",
                    "local_on_cpu"):
            assert checks[r][f"{case}_{key}"], (r, key)
    for i in range(3):
        for j, name in enumerate(("loss", "grad_norm")):
            got = float(out[f"{case}/{name}"][i])
            for want in (jm[i][j], tm[i][j]):
                np.testing.assert_allclose(got, want, rtol=F32_TOL,
                                           err_msg=f"{case} {name} {i}")
    flat_jax = {"params": _flat(jax_tree["params"]),
                "m": _flat(jax_tree["m"])}
    got = {k: {p: out[f"{case}/{k}/{p}"] for p in flat_jax[k]}
           for k in ("params", "m")}
    for want in (flat_jax, port_tree):
        _close_count(got["params"], want["params"], 2 * LR * 3, case)
        _tree_close(got["m"], want["m"], case)


def test_remat_sharded_step_matches(ranks):
    """With every unit under ``torch.utils.checkpoint`` (``remat``, as the
    full configs), the (2, 2) step's loss and grad norm are the
    unsharded step's within ``F32_TOL`` (the recompute sees the forward's
    layouts)."""
    out, _ = ranks
    jm, tm, _, _ = _reference(1)
    for j, name in enumerate(("loss", "grad_norm")):
        got = float(out[f"remat/{name}"])
        for want in (jm[0][j], tm[0][j]):
            np.testing.assert_allclose(got, want, rtol=F32_TOL, err_msg=name)


def test_placements_follow_the_policy(ranks):
    """On (2, 2): wq out dim over model and d_model over data, embed vocab
    over model and d_model over data (the reference's ``P("model",
    "data")``); ``AdamW.init`` of DTensor params keeps their placements
    and replicates the step; a ("pod", "data") dim holds each rank's rows
    pod major."""
    _, checks = ranks
    for c in checks:
        assert c["wq_placements"] == [str(Shard(1)), str(Shard(2))]
        assert c["embed_placements"] == [str(Shard(1)), str(Shard(0))]
        assert c["init_on_dtensors"] and c["pod_major"]


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_int8_allreduce_grads_with_per_rank_grads(ranks, mesh):
    """Each rank's own grads: ``int8_allreduce_grads`` over the data group
    is the mean of the data group's local dequantizations (float32 sums in
    another order: within 1e-6 relative), equal on every rank of a group;
    the residual is the rank's g - deq exactly, and a second call with it
    quantizes g + residual; ``int8_psum`` is the int32 sum of the group's
    codes times its mean scale."""
    out, _ = ranks
    dp = 4 if mesh == "4x1" else 2
    grads = []
    for r in range(WORLD):
        rng = np.random.default_rng(100 + r)
        grads.append({"a": rng.standard_normal((5, 3)).astype(np.float32),
                      "b": (rng.standard_normal(7) * 1e-3)
                      .astype(np.float32)})
    group = {r: [q for q in range(WORLD) if q % 2 == r % 2] if dp == 2
             else list(range(WORLD)) for r in range(WORLD)}

    def local(g):
        q, s = _quantize(torch.from_numpy(g))
        return q.numpy().astype(np.float32) * s.numpy(), q.numpy(), s.numpy()

    for r in range(WORLD):
        for k in ("a", "b"):
            deq = [local(grads[q][k])[0] for q in group[r]]
            want = np.sum(deq, axis=0) / dp
            got = out[f"int8/{mesh}/{r}/reduced/{k}"]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(
                got, out[f"int8/{mesh}/{group[r][0]}/reduced/{k}"])
            res = out[f"int8/{mesh}/{r}/residual/{k}"]
            np.testing.assert_array_equal(res, grads[r][k] - deq[
                group[r].index(r)])
            again = [local(grads[q][k] + out[f"int8/{mesh}/{q}/residual/{k}"])
                     [0] for q in group[r]]
            np.testing.assert_allclose(out[f"int8/{mesh}/{r}/again/{k}"],
                                       np.sum(again, axis=0) / dp,
                                       rtol=1e-6, atol=1e-7)
        codes = [local(grads[q]["a"]) for q in group[r]]
        want = np.sum([c[1].astype(np.int32) for c in codes], axis=0) \
            .astype(np.float32) * (np.sum([c[2] for c in codes]) / dp)
        np.testing.assert_allclose(out[f"int8/{mesh}/{r}/psum"], want,
                                   rtol=1e-6)


def test_checkpoint_restores_onto_the_elastic_plan_then_steps(ranks):
    """Saved on (2, 2) (every rank gathers, rank 0 writes); the plan of
    ranks 0 and 1 at model parallel 2 from data parallel 2 is (1, 2) with
    a microbatch multiplier of 2; ``restore(shardings=)`` places the saved
    params there bit for bit; a step there with 2 microbatches equals the
    (2, 2) step with 1: loss within ``F32_TOL``, params by the count
    rule."""
    out, checks = ranks
    for r in range(WORLD):
        assert checks[r]["plan"] == [1, 2, 2, [1, 2]]
    for r in range(2):
        assert checks[r]["restored_bitwise"]
        assert checks[r]["restored_on_plan_mesh"]
    np.testing.assert_allclose(float(out["elastic/loss12"]),
                               float(out["elastic/loss22"]), rtol=F32_TOL)
    p22 = {k[len("elastic/p22/"):]: v for k, v in out.items()
           if k.startswith("elastic/p22/")}
    p12 = {k[len("elastic/p12/"):]: v for k, v in out.items()
           if k.startswith("elastic/p12/")}
    assert set(p12) == set(p22) and p22
    _close_count(p12, p22, 2 * LR, "elastic")


def test_checkpoint_saves_on_the_elastic_plan_mesh(ranks):
    """After the restore, ranks 0 and 1 save the (1, 2) step's params on
    the plan's mesh, async then blocking, while ranks 2 and 3 run
    all-reduces of their own: ``wait`` and the blocking save meet the
    plan's ranks only, both steps commit, and either plan rank reads the
    saved params back bit for bit."""
    _, checks = ranks
    for r in range(2):
        assert checks[r]["plan_latest_step"] == 3
        assert checks[r]["plan_saved_bitwise"]
    for r in range(2, WORLD):
        assert checks[r]["others_sum"] == [8.0] * 3


def test_trainer_on_dtensors_checkpoints_and_resumes(ranks):
    """``Trainer.fit`` on (2, 2) DTensor state: its history holds floats,
    its checkpoints (every rank gathers, rank 0 writes, all meet) resume
    through ``try_resume`` at step 2, and the resumed run's params after
    step 3 equal a one-shot 3-step run's bit for bit (the same float32
    operations in the same order), on every rank."""
    _, checks = ranks
    for c in checks:
        assert c["trainer_start"] == 2
        assert c["trainer_steps"] == [2, 3, 3]
        assert c["trainer_history_floats"] and c["trainer_resumed_bitwise"]
        assert np.isfinite(c["trainer_losses"]).all()


@pytest.mark.cuda
def test_world1_nccl_sharded_step_on_card_equals_unsharded(tmp_path):
    """On a card: an NCCL group of one rank, a (1, 1) mesh; one sharded
    step of the smoke LM equals the unsharded step on the card (loss and
    grad norm within ``F32_TOL``, params by the count rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim import OptState
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        lm = LM(smoke_config(ARCH), device="cuda")
        params = lm_params_from_numpy(_jax_params(), "cuda")
        opt = AdamW(lr=LR, schedule=cosine_schedule(1, 3))
        ost = opt.init(params)
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        pol = ShardingPolicy(mesh, lm.cfg)
        ps = pol.params_shardings(params)
        dp = distribute(params, ps)
        dost = distribute(ost, OptState(pol.replicated(), ps, ps))
        batch = {"tokens": torch.from_numpy(_batches()[0]).cuda()}
        step = make_train_step(lm, opt)
        dp, _, dm = step(dp, dost, distribute(batch,
                                              pol.batch_shardings(batch)))
        p, _, m = step(params, ost, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(dm[k].full_tensor()),
                                       float(m[k]), rtol=F32_TOL)
        got = {k: v.full_tensor().cpu().numpy()
               for k, v in path_leaves(dp)}
        want = {k: v.cpu().numpy() for k, v in path_leaves(p)}
        _close_count(got, want, 2 * LR, "card")
    finally:
        dist.destroy_process_group()
