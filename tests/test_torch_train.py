"""LM training in the PyTorch port (``repro_torch.optim``, ``LM.loss_fn``,
``repro_torch.train``, ``repro_torch.launch.train``) against the JAX
package's ``repro.optim``, ``repro.models``, ``repro.train`` and
``repro.launch.train`` on the CPU, at smoke size (2 layers, d_model 64, 4
heads of 16, vocab 256).

The JAX params and optimizer state cross to the port through
``convert.lm_params_from_numpy``/``opt_state_from_numpy``, so both
packages train the same float32 weights. Tolerances (``F32_TOL`` of
``tests/test_torch_models.py``, 2e-5 of max(1, max |JAX|), a leaf at a
time):

* AdamW's update, the cosine schedule, the loss and its grads, the grad
  norm: ``F32_TOL`` — float32 roundoff of the same operations in other
  orders (measured: under 1e-6);
* params after train steps, either package or the card against the CPU
  (``assert_params_close``): AdamW divides m by √v + eps, so an update
  element is about lr·g / (|g| + 1e-8). Where a grad element is within
  roundoff of 0 (a few eps, or float32 roundoff of its leaf's sums) the
  packages' grads part by a few per cent or in sign, and so do the
  updates, by up to 2·lr a step; elsewhere the params agree to float32
  roundoff. So every element lies within 2·lr a step of max(1, max |JAX
  leaf|), and at most ``PAST_SHARE`` = 1% of them past ``STEP_TOL`` = 1e-6
  of it (measured after 3 steps at lr 1e-3: at most 1.4e-5, and 5 to 8
  elements of 90688 past 1e-6);
* resumed against one-shot training, within the port on the CPU: bit for
  bit (the same float32 operations in the same order; the checkpoint
  holds float32 exactly).
"""

import dataclasses
import json
import os
import sys
import time

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JaxCheckpointConfig
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import train as jax_train_launch
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.optim import OptState as JaxOptState
from repro.optim import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.data import DPPBatchSelector, TokenPipeline, synthetic_corpus
from repro_torch.launch import train as train_launch
from repro_torch.models import LM
from repro_torch.optim import AdamW, OptState, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (Trainer, TrainerConfig, make_eval_step,
                               make_train_step)
from test_torch_models import F32_TOL

STEP_TOL = 1e-6
PAST_SHARE = 0.01
ARCH = "qwen2-0.5b"


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_tree_close(got, want, tol=F32_TOL, label=""):
    """Every leaf of the port's ``got`` within ``tol`` of max(1, max |JAX
    leaf|) of ``want``'s (the JAX pytree order: a dict's keys sorted)."""
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves), label
    worst = 0.0
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (label, i, g.shape, w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / scale
        worst = max(worst, err)
        assert err <= tol, f"{label} leaf {i}: {err} > {tol}"
    return worst


def setup(**overrides):
    """(JAX LM, JAX params, port LM, the JAX params in the port)."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **overrides)
    tcfg = dataclasses.replace(smoke_config(ARCH), **overrides)
    jlm = JaxLM(jcfg)
    jp = jlm.init_params(jax.random.PRNGKey(0))
    return jlm, jp, LM(tcfg, device="cpu"), lm_params_from_numpy(
        np_tree(jp), "cpu")


def token_batch(vocab, B=4, S=33, seed=1):
    return {"tokens": np.random.default_rng(seed).integers(
        0, vocab, (B, S), dtype=np.int32)}


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def small_tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
            "blocks": {"b": (rng.standard_normal((2, 4)) * scale).astype(
                np.float32), "a": (rng.standard_normal(7) * scale).astype(
                np.float32)}}


@pytest.mark.parametrize("clip, gscale, sched", [
    (1.0, 3.0, False),          # the global norm is above 1: clipped
    (1.0, 0.01, False),         # under it: not clipped
    (None, 3.0, False),         # no clipping: gn is 0
    (0.5, 1.0, True),           # clipped, under cosine_schedule(2, 6)
])
def test_adamw_update_matches_the_reference(clip, gscale, sched):
    """Three updates on the same numpy params and grads: params, m, v, the
    step and the grad norm against ``repro.optim.AdamW``."""
    rng = np.random.default_rng(0)
    params = small_tree(rng)
    kw = dict(lr=1e-2, clip_norm=clip, weight_decay=0.1)
    jopt = JaxAdamW(**kw, schedule=jax_cosine(2, 6) if sched else None)
    topt = AdamW(**kw, schedule=cosine_schedule(2, 6) if sched else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = lm_params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    assert all(m.dtype == torch.float32 and not m.any()
               for m in tree_leaves(ts.m))
    for _ in range(3):
        grads = small_tree(rng, gscale)
        jp, js, jgn = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  js, jp)
        tp, ts, tgn = topt.update(lm_params_from_numpy(grads, "cpu"), ts,
                                  tp)
        assert isinstance(ts, OptState) and int(ts.step) == int(js.step)
        assert_tree_close(tp, jp, label="params")
        assert_tree_close(ts.m, js.m, label="m")
        assert_tree_close(ts.v, js.v, label="v")
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=F32_TOL)
    if clip is None:
        assert float(tgn) == 0.0


def test_cosine_schedule_matches_the_reference():
    for warmup, total in ((0, 5), (2, 10), (10, 10)):
        f, g = cosine_schedule(warmup, total), jax_cosine(warmup, total)
        for s in range(total + 3):
            np.testing.assert_allclose(
                float(f(torch.tensor(s, dtype=torch.int32))),
                float(g(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# loss_fn and its grads
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "two CE chunks": (dict(), 33),
    "one CE chunk (S % C != 0)": (dict(), 30),
    "padded vocab": (dict(vocab=250), 33),
    "remat": (dict(remat=True), 33),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_match_jax(case):
    """``loss_fn`` and ``jax.grad`` of it against the port's loss and
    ``torch.autograd.grad`` over every parameter leaf."""
    overrides, S = LOSS_CASES[case]
    jlm, jp, lm, tp = setup(**overrides)
    batch = token_batch(lm.cfg.vocab, S=S)
    jloss, jgrads = jax.value_and_grad(jlm.loss_fn)(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss = lm.loss_fn(tp, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=F32_TOL)
    grads = torch.autograd.grad(loss, leaves)
    assert_tree_close(list(grads), jgrads, label=f"{case}: grads")
    with torch.no_grad():
        assert float(make_eval_step(lm)(tp, batch)) == float(loss)


def test_remat_gives_the_same_grads():
    """``cfg.remat`` (each unit under ``torch.utils.checkpoint``) changes
    memory, not the grads: equal to the grads without it; and it is off
    under no_grad and inference_mode, where serving runs."""
    _, _, lm, tp = setup()
    lm_r = LM(dataclasses.replace(lm.cfg, remat=True), device="cpu")
    batch = token_batch(lm.cfg.vocab)
    out = []
    for model in (lm, lm_r):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        from repro_torch.optim.adamw import tree_unflatten
        loss = model.loss_fn(tree_unflatten(tp, leaves), batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.inference_mode():
        assert torch.equal(lm_r.forward(tp, batch["tokens"][:, :-1]),
                           lm.forward(tp, batch["tokens"][:, :-1]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def assert_params_close(got, want, slack: float, label: str):
    """Every leaf within ``slack`` of max(1, max |want leaf|) and at most
    ``PAST_SHARE`` of all elements past ``STEP_TOL`` of it. Returns the
    count past it."""
    past = total = 0
    for i, (g, w) in enumerate(zip(tree_leaves(got),
                                   jax.tree_util.tree_leaves(want))):
        w = np.asarray(w)
        d = np.abs(np.asarray(g) - w) / max(1.0, float(np.abs(w).max()))
        assert d.max() <= slack, (label, i, d.max())
        past += int((d > STEP_TOL).sum())
        total += d.size
    assert past <= PAST_SHARE * total, (label, past, total)
    return past


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(microbatches):
    """Three ``make_train_step`` steps from the same params, optimizer state
    and batches: the loss, the grad norm and the step of every step, and
    the params and moments after each, against the reference's jitted
    step (gradient accumulation over 2 microbatches too)."""
    jlm, jp, lm, tp = setup()
    lr = 1e-3
    jopt = JaxAdamW(lr=lr, schedule=jax_cosine(1, 3))
    topt = AdamW(lr=lr, schedule=cosine_schedule(1, 3))
    jstep = jax.jit(jax_make_train_step(jlm, jopt, microbatches))
    tstep = make_train_step(lm, topt, microbatches)
    js = jopt.init(jp)
    ts = opt_state_from_numpy(np_tree(js), "cpu")
    for i in range(3):
        batch = token_batch(lm.cfg.vocab, B=4, S=33, seed=10 + i)
        jb = {"tokens": jnp.asarray(batch["tokens"])}
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, batch)
        assert float(tm["step"]) == float(jm["step"]) == i + 1
        for k in ("loss", "grad_norm"):
            assert tm[k].dtype == torch.float32
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=F32_TOL, err_msg=k)
        assert_params_close(tp, np_tree(jp), 2 * lr * (i + 1),
                            label=f"step {i}: params")
        assert_tree_close(ts.m, js.m, label=f"step {i}: m")
        assert_tree_close(ts.v, js.v, label=f"step {i}: v")
    assert not any(p.requires_grad for p in tree_leaves(tp))


def test_microbatched_grads_are_the_mean_of_the_slices():
    """With 2 microbatches the step's loss is the mean of the two halves'
    losses (the reference's scan carry)."""
    _, _, lm, tp = setup()
    opt = AdamW(lr=1e-3)
    batch = token_batch(lm.cfg.vocab, B=4, S=17, seed=3)
    _, _, m2 = make_train_step(lm, opt, 2)(tp, opt.init(tp), batch)
    halves = [float(lm.loss_fn(tp, {"tokens": batch["tokens"][i:i + 2]}))
              for i in (0, 2)]
    np.testing.assert_allclose(float(m2["loss"]), np.mean(halves),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the trainer (tests/test_system.py and tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _train(steps=12, selector=None, microbatches=1, corpus=None):
    cfg = smoke_config(ARCH)
    lm = LM(cfg, device="cpu")
    opt = AdamW(lr=3e-3, schedule=cosine_schedule(2, steps))
    params = lm_params_from_numpy(np_tree(JaxLM(jax_smoke_config(
        ARCH)).init_params(jax.random.PRNGKey(0))), "cpu")
    step = make_train_step(lm, opt, microbatches=microbatches)
    corpus = synthetic_corpus(128, 32, cfg.vocab, n_topics=8) \
        if corpus is None else corpus
    pipe = TokenPipeline(corpus, 8, seed=0, selector=selector)
    tr = Trainer(lm, opt, step, TrainerConfig(total_steps=steps, log_every=1))
    return tr.fit(params, opt.init(params), iter(pipe))


def test_training_reduces_loss():
    res = _train(steps=12)
    losses = [h["loss"] for h in res["history"]]
    assert losses[-1] < losses[0] - 0.1, losses
    assert res["final_step"] == 12 and len(losses) == 12


def test_training_with_microbatches_matches_trend():
    res = _train(steps=8, microbatches=2)
    losses = [h["loss"] for h in res["history"]]
    assert losses[-1] < losses[0], losses


def test_training_with_dpp_batch_selection():
    """The paper feature in the loop: KronDPP-selected diverse batches,
    the selector's draws the reference selector's."""
    corpus = synthetic_corpus(144, 32, 256, n_topics=8)
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((256, 8)).astype(np.float32) / 8
    feats = np.stack([proj[c].mean(0) for c in corpus])
    sel = DPPBatchSelector.from_features(feats, 12, 12, device="cpu")
    out = _train(steps=6, selector=sel, corpus=corpus)
    assert len(out["history"]) == 6
    assert np.isfinite([h["loss"] for h in out["history"]]).all()


def test_straggler_hook_fires():
    cfg = smoke_config(ARCH)
    lm = LM(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    params = lm.init_params(torch.tensor([0, 0]))
    fired, took = [], []
    inner = make_train_step(lm, opt)

    def slow_step(p, o, b):
        if len(took) == 8:         # synthetic straggler: step 9, slower
            # than 3x the median however slow the loaded CPU's steps are
            time.sleep(1.5 + 5 * max(took))
        t0 = time.perf_counter()
        out = inner(p, o, b)
        took.append(time.perf_counter() - t0)
        return out

    corpus = synthetic_corpus(64, 32, cfg.vocab)
    tr = Trainer(lm, opt, slow_step,
                 TrainerConfig(total_steps=10, log_every=100,
                               straggler_deadline_factor=3.0),
                 straggler_hook=lambda s, dt: fired.append((s, dt)))
    tr.fit(params, opt.init(params), iter(TokenPipeline(corpus, 4)))
    assert fired, "straggler deadline hook did not fire"
    assert 9 in [step for step, _ in fired] and tr.stragglers == fired


def _resume_setup():
    cfg = smoke_config(ARCH)
    lm = LM(cfg, device="cpu")
    opt = AdamW(lr=1e-3, schedule=cosine_schedule(1, 6))
    params = lm.init_params(torch.tensor([0, 0]))
    return lm, opt, params, make_train_step(lm, opt), \
        synthetic_corpus(64, 32, cfg.vocab)


def test_trainer_resume_equals_one_shot(tmp_path):
    """``tests/test_checkpoint.py::test_trainer_resume`` on the port: train
    4 steps with checkpoints every 2, resume to 6 (the checkpoint holds an
    ``OptState``); with the pipeline restored to step 4 the resumed params
    and moments equal a one-shot 6-step run bit for bit."""
    lm, opt, params, step, corpus = _resume_setup()
    tc = lambda n, d: TrainerConfig(total_steps=n, checkpoint_dir=d,
                                    checkpoint_every=2, log_every=1)
    t1 = Trainer(lm, opt, step, tc(4, str(tmp_path)))
    r1 = t1.fit(params, opt.init(params), iter(TokenPipeline(corpus, 4)))
    assert r1["final_step"] == 4 and t1.ckpt.latest_step() == 4
    t2 = Trainer(lm, opt, step, tc(6, str(tmp_path)))
    p2, o2, start = t2.try_resume(params, opt.init(params))
    assert start == 4 and isinstance(o2, OptState) and int(o2.step) == 4
    assert o2.step.dtype == torch.int32
    pipe = TokenPipeline(corpus, 4)
    pipe.restore({"step": 4, "seed": 0})
    r2 = t2.fit(p2, o2, iter(pipe), start_step=start)
    assert r2["final_step"] == 6 and [h["step"] for h in r2["history"]] == \
        [5, 6]
    one = Trainer(lm, opt, step, TrainerConfig(total_steps=6, log_every=1)) \
        .fit(params, opt.init(params), iter(TokenPipeline(corpus, 4)))
    for a, b in zip(tree_leaves((r2["params"], r2["opt_state"])),
                    tree_leaves((one["params"], one["opt_state"]))):
        assert torch.equal(a, b)
    assert [h["loss"] for h in one["history"][4:]] == \
        [h["loss"] for h in r2["history"]]


def test_trainer_without_checkpoints_starts_at_zero_and_saves_at_the_end(
        tmp_path):
    lm, opt, params, step, corpus = _resume_setup()
    t = Trainer(lm, opt, step, TrainerConfig(total_steps=3))
    p, o, start = t.try_resume(params, opt.init(params))
    assert start == 0 and p is params
    t = Trainer(lm, opt, step, TrainerConfig(
        total_steps=3, checkpoint_dir=str(tmp_path), checkpoint_every=2))
    assert t.try_resume(params, opt.init(params))[2] == 0
    t.fit(params, opt.init(params), iter(TokenPipeline(corpus, 4)))
    assert t.ckpt._committed_steps() == [2, 3]      # the final blocking save


def test_emergency_save_on_keyboard_interrupt(tmp_path):
    lm, opt, params, step, corpus = _resume_setup()

    def batches():
        it = iter(TokenPipeline(corpus, 4))
        for _ in range(3):
            yield next(it)
        raise KeyboardInterrupt

    t = Trainer(lm, opt, step, TrainerConfig(
        total_steps=10, checkpoint_dir=str(tmp_path), checkpoint_every=100))
    with pytest.raises(KeyboardInterrupt):
        t.fit(params, opt.init(params), batches())
    assert t.ckpt.latest_step() == 3
    _, o, start = t.try_resume(params, opt.init(params))
    assert start == 3 and int(o.step) == 3


# ---------------------------------------------------------------------------
# OptState checkpoints
# ---------------------------------------------------------------------------

def test_opt_state_checkpoint_round_trip(tmp_path):
    """A ``NamedTuple`` restores as itself (its fields positionally), every
    leaf equal, in its dtype; without a target it reads back as lists."""
    _, _, lm, tp = setup()
    opt = AdamW()
    st = opt.init(tp)
    st = OptState(st.step + 5, *(
        {k: v for k, v in tree.items()} for tree in (st.m, st.v)))
    st.m["ln_f"].fill_(0.25)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    mgr.save(5, {"params": tp, "opt": st})
    out = mgr.restore(5, target={"params": tp, "opt": opt.init(tp)})
    assert type(out["opt"]) is OptState
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 5
    for a, b in zip(tree_leaves(out), tree_leaves({"params": tp, "opt": st})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    raw = mgr.restore(5)
    assert isinstance(raw["opt"], list) and int(raw["opt"][0]) == 5


def test_jax_written_train_state_restores_into_the_port(tmp_path):
    """The reference manager's checkpoint of {"params", "opt": OptState}
    restores into the port's tree with the same leaves, and the port's
    converters carry the state leaf for leaf."""
    jlm, jp, lm, tp = setup()
    jopt = JaxAdamW()
    batch = {"tokens": jnp.asarray(token_batch(256)["tokens"])}
    jp, js, _ = jax.jit(jax_make_train_step(jlm, jopt))(jp, jopt.init(jp),
                                                        batch)
    assert isinstance(js, JaxOptState)
    jm = JaxCheckpointManager(JaxCheckpointConfig(str(tmp_path),
                                                  async_save=False))
    jm.save(1, {"params": jp, "opt": js})
    opt = AdamW()
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_save=False))
    out = mgr.restore(1, target={"params": tp, "opt": opt.init(tp)})
    assert type(out["opt"]) is OptState and int(out["opt"].step) == 1
    want = jax.tree_util.tree_leaves({"params": jp, "opt": js})
    got = tree_leaves(out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conv = opt_state_from_numpy(np_tree(js), "cpu")
    back = opt_state_to_numpy(conv)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        tree_leaves(lm_params_to_numpy(out["params"]))[0],
        jax.tree_util.tree_leaves(jp)[0])


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def run_launcher(main, argv, capsys, monkeypatch=None):
    if monkeypatch is not None:          # the reference reads sys.argv
        monkeypatch.setattr(sys, "argv", ["train", *argv])
        main()
    else:
        main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("extra", [["--dpp-batch-selection"],
                                   ["--microbatches", "2"]])
def test_train_launcher_equals_the_reference(extra, capsys, monkeypatch):
    """``main([... "--smoke", "--device", "cpu"])`` prints the reference
    launcher's lines: the logged step's loss and grad norm within
    ``F32_TOL``, the final step, no stragglers counted on either."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "12", "--batch", "8",
            "--seq", "32", "--docs", "64"] + extra
    want = run_launcher(jax_train_launch.main, argv, capsys, monkeypatch)
    got = run_launcher(train_launch.main, argv + ["--device", "cpu"], capsys)
    assert len(got) == len(want) == 2
    assert got[0]["step"] == want[0]["step"] == 10
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=F32_TOL)
    assert got[1] == {"final_step": 12, "stragglers": got[1]["stragglers"]}
    assert want[1]["final_step"] == 12


def test_train_launcher_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "16",
            "--docs", "32", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2", "--device", "cpu"]
    train_launch.main(argv + ["--steps", "2"])
    res = train_launch.main(argv + ["--steps", "4", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert res["final_step"] == 4


@pytest.mark.cuda
def test_train_step_on_card_equals_the_cpu_copy():
    """On a card: one ``make_train_step`` of the smoke LM (float32) from the
    same params, state and batch as a CPU copy: the loss and the grad norm
    within ``F32_TOL``, the params by ``assert_params_close`` after one
    step, with 1 and 2 microbatches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, jp, lm, tp = setup()
    card = LM(lm.cfg, device="cuda")
    tp_card = lm_params_from_numpy(np_tree(jp), "cuda")
    lr = 1e-3
    opt = AdamW(lr=lr, schedule=cosine_schedule(1, 3))
    batch = token_batch(lm.cfg.vocab, B=4, S=33, seed=5)
    for mb in (1, 2):
        p_c, s_c, m_c = make_train_step(lm, opt, mb)(tp, opt.init(tp), batch)
        p_g, s_g, m_g = make_train_step(card, opt, mb)(
            tp_card, opt.init(tp_card), batch)
        assert all(p.is_cuda for p in tree_leaves((p_g, s_g)))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_g[k]), float(m_c[k]),
                                       rtol=F32_TOL, err_msg=k)
        assert_params_close(_to_cpu(p_g), p_c, 2 * lr,
                            label=f"card vs CPU, {mb} microbatches")


def _to_cpu(tree):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: a.cpu(), tree)
