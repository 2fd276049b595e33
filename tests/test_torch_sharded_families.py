"""Sharded steps of the MoE, SSM, hybrid and encoder-decoder families in
the PyTorch port (``repro_torch.distributed.shard_ops``: experts on each
model rank's shard, SSM heads over "model", decode attention over a cache
DTensor) on 4 gloo ranks, against the JAX package's single-device jitted
functions on the same numpy params and inputs.

Smoke configs (``repro.configs.smoke_config``): mixtral-8x7b and
qwen3-moe-235b-a22b (4 experts, top 2: on the (2, 2) mesh the experts
divide "model", EP), mixtral with 3 experts (they do not divide 2, so the
ffn-hidden dim is sharded instead, the full mixtral's layout on 8 cards a
node), mamba2-2.7b, jamba-1.5-large-398b without and with a unit tail
(``TAIL``), whisper-tiny. Each on meshes (data, model) = (2, 2) and
(4, 1) (the 3-expert mixtral on (2, 2) only): one train step (loss, grad norm, params after it), a prefill of
4 prompts (last logits, every cache) and 3 decode steps (logits each,
the state after), the outputs placed by ``ShardingPolicy`` as the
reference's ``out_shardings``. Then a batch-of-one decode on (2, 2) with
the prefill's state placed as ``long_500k`` places it (the KV sequence
over "data") against the port's unsharded decode on the same state; and
jamba's train step under ``remat`` with 2 microbatches on (2, 2).

One module fixture starts the 4 ranks (``tests/_sharded_families_worker
.py``, one process each, one thread each, ``tests/_ranks.py``) that
rendezvous through a ``FileStore`` under ``tmp_path``, with a 60 s
collective timeout, and computes the JAX references while they run; it
kills them all past a deadline or when one fails. Tolerances: ``F32_TOL`` (2e-5 of max(1,
|JAX|)) for losses and grad norms; for params after a step the count
rule of ``tests/test_torch_train.py`` (every element within 2·lr, at
most ``PAST_SHARE`` = 1% past ``STEP_TOL`` = 1e-6); logits and caches
within ``TOL`` = 1e-4 of max(1, max |JAX|), the tolerance of
``tests/test_torch_model_families.py`` (measured here: under 1e-5).
"""

import dataclasses
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

from repro.configs import smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.optim import AdamW as JaxAdamW
from repro.train import make_train_step as jax_make_train_step
from repro_torch.distributed.sharding import map_with_path, path_leaves
from test_torch_models import F32_TOL
from test_torch_train import PAST_SHARE, STEP_TOL

import _sharded_families_worker as worker
from _ranks import run_ranks

WORKER = Path(worker.__file__)
WORLD = 4
DEADLINE_S = 400
TOL = 1e-4
LR = worker.LR
CASES = list(worker.CASES)
GRID = [(c, f"{a}x{b}") for c in CASES for a, b in worker.meshes(c)]
GRID_IDS = [f"{c}-{m}" for c, m in GRID]


def jax_config(case):
    arch, over = worker.CASES[case]
    return dataclasses.replace(jax_smoke_config(arch), **over)


def case_inputs(case) -> dict:
    """Seeded tokens (and whisper's frame embeddings) of one case: a train
    batch (4, S + 1), prompts (4, S), 3 decode tokens (4, 1), a prompt of
    one row and its decode token. S: 40 past the SWA window, else 24."""
    cfg = jax_config(case)
    rng = np.random.default_rng(3)
    S = 40 if cfg.sliding_window else 24
    out = {"train": rng.integers(0, cfg.vocab, (4, S + 1), dtype=np.int32),
           "prefill": rng.integers(0, cfg.vocab, (4, S), dtype=np.int32),
           "decode": rng.integers(0, cfg.vocab, (worker.DECODE_STEPS, 4, 1),
                                  dtype=np.int32),
           "long": rng.integers(0, cfg.vocab, (1, S), dtype=np.int32),
           "long_token": rng.integers(0, cfg.vocab, (1, 1),
                                      dtype=np.int32)}
    if cfg.encoder_layers:
        for kind, B in (("train", 4), ("prefill", 4), ("long", 1)):
            out[f"{kind}_enc"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jax_params(case):
    return jax.tree_util.tree_map(np.asarray, JaxLM(jax_config(case))
                                  .init_params(jax.random.PRNGKey(0)))


def flat(tree) -> dict:
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, np.asarray(
        leaf, np.float32)), tree)
    return out


def jax_reference(case) -> dict:
    """The jitted JAX single-device train step, prefill and decode steps of
    one case on its inputs."""
    cfg = jax_config(case)
    lm = JaxLM(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(case))
    ins = case_inputs(case)
    enc = {k: jnp.asarray(ins[f"{k}_enc"]) if f"{k}_enc" in ins else None
           for k in ("train", "prefill")}
    opt = JaxAdamW(lr=LR)
    batch = {"tokens": jnp.asarray(ins["train"])}
    if enc["train"] is not None:
        batch["enc_embeds"] = enc["train"]
    newp, _, m = jax.jit(jax_make_train_step(lm, opt))(
        params, opt.init(params), batch)
    ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": {p: np.asarray(v) for p, v in path_leaves(
               jax.tree_util.tree_map(np.asarray, newp))}}
    logits, state = jax.jit(lambda p, t, e: lm.prefill(p, t, enc_embeds=e))(
        params, jnp.asarray(ins["prefill"]), enc["prefill"])
    ref["prefill_logits"] = np.asarray(logits)
    ref["prefill_state"] = flat(state)
    decode = jax.jit(lm.decode_step)
    ref["decode_logits"] = []
    for i in range(worker.DECODE_STEPS):
        logits, state = decode(params, jnp.asarray(ins["decode"][i]), state)
        ref["decode_logits"].append(np.asarray(logits))
    ref["decode_state"] = flat(state)
    return ref


def jax_microbatched_remat() -> dict:
    """The jitted JAX step of jamba with ``remat`` and 2 microbatches."""
    lm = JaxLM(dataclasses.replace(jax_config("jamba"), remat=True))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params("jamba"))
    opt = JaxAdamW(lr=LR)
    newp, _, m = jax.jit(jax_make_train_step(lm, opt, 2))(
        params, opt.init(params),
        {"tokens": jnp.asarray(case_inputs("jamba")["train"])})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {p: np.asarray(v) for p, v in path_leaves(
                jax.tree_util.tree_map(np.asarray, newp))}}


def assert_step_close(out, tag, ref):
    """A step's loss and grad norm within ``F32_TOL`` of ``ref``, its
    params by the count rule (2·lr)."""
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[f"{tag}/{name}"]), ref[name],
                                   rtol=F32_TOL, err_msg=f"{tag} {name}")
    past = total = 0
    for path, w in ref["params"].items():
        d = np.abs(out[f"{tag}/params/{path}"] - w) \
            / max(1.0, float(np.abs(w).max()))
        assert d.max() <= 2 * LR, (tag, path, d.max())
        past += int((d > STEP_TOL).sum())
        total += d.size
    assert past <= PAST_SHARE * total, (tag, past, total)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 ranks once, the JAX references meanwhile: (results.npz,
    [rank checks], {case: reference})."""
    work = tmp_path_factory.mktemp("families")
    inputs = {}
    for case in CASES:
        for path, v in path_leaves(jax_params(case)):
            inputs[f"{case}/params/{path}"] = v
        for key, v in case_inputs(case).items():
            inputs[f"{case}/{key}"] = v
    inputs["aux_x"] = np.random.default_rng(5).standard_normal(
        (4, 24, jax_config("mixtral").d_model)).astype(np.float32)
    np.savez(work / "inputs.npz", **inputs)
    refs = run_ranks(WORKER, work, WORLD, DEADLINE_S, lambda: {
        **{case: jax_reference(case) for case in CASES},
        "mb2_remat": jax_microbatched_remat()})
    checks = [json.loads((work / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return dict(np.load(work / "results.npz")), checks, refs


def assert_close(got, want, tol, label):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: max |Δ| {err} > {tol} · {scale}"


def live(x, case):
    """Logits cut to the live vocab (the padded columns are -1e30)."""
    return np.asarray(x)[..., :jax_config(case).vocab]


@pytest.mark.parametrize("case, mesh", GRID, ids=GRID_IDS)
def test_sharded_train_step_matches_jax(ranks, case, mesh):
    """One sharded train step: loss and grad norm within ``F32_TOL`` of
    the JAX jitted step, the params after it by the count rule (2·lr), and
    every leaf's layout kept."""
    out, checks, refs = ranks
    assert_step_close(out, f"{case}/{mesh}/train", refs[case])
    for c in checks:
        assert c[f"{case}/{mesh}/layouts_kept"]


def test_microbatched_remat_step_matches_jax(ranks):
    """jamba's sharded train step on (2, 2) with ``remat`` (every unit and
    layer recomputed under ``torch.utils.checkpoint``) and 2 microbatches
    (the fp32 accumulator on DTensors) against the JAX jitted step with
    the same: loss and grad norm within ``F32_TOL``, params by the count
    rule."""
    out, _, refs = ranks
    assert_step_close(out, "mb2_remat", refs["mb2_remat"])


@pytest.mark.parametrize("case, mesh", GRID, ids=GRID_IDS)
def test_sharded_prefill_matches_jax(ranks, case, mesh):
    """The sharded prefill's last logits and every cache leaf (KV, SSM
    conv window and state, whisper's encoder states, positions) within
    ``TOL`` of the JAX prefill."""
    out, _, refs = ranks
    ref, tag = refs[case], f"{case}/{mesh}/prefill"
    assert_close(live(out[f"{tag}/logits"], case),
                 live(ref["prefill_logits"], case), TOL, f"{tag} logits")
    for path, want in ref["prefill_state"].items():
        assert_close(out[f"{tag}/state/{path}"], want, TOL, f"{tag} {path}")


@pytest.mark.parametrize("case, mesh", GRID, ids=GRID_IDS)
def test_sharded_decode_matches_jax(ranks, case, mesh):
    """3 decode steps from the sharded prefill's state: each step's logits
    and the state after the last within ``TOL`` of the JAX decode steps;
    the state comes back placed by ``decode_state_shardings``."""
    out, checks, refs = ranks
    ref, tag = refs[case], f"{case}/{mesh}/decode"
    for i, want in enumerate(ref["decode_logits"]):
        assert_close(live(out[f"{tag}/logits{i}"], case), live(want, case),
                     TOL, f"{tag} logits {i}")
    for path, want in ref["decode_state"].items():
        assert_close(out[f"{tag}/state/{path}"], want, TOL, f"{tag} {path}")
    for c in checks:
        assert c[f"{case}/{mesh}/state_placed"]


@pytest.mark.parametrize("case", CASES)
def test_sequence_sharded_decode_matches_unsharded(ranks, case):
    """A batch of one on (2, 2), its state placed as ``long_500k`` places it
    (each attention layer's KV sequence over "data"): one decode step's
    logits and state within ``TOL`` of the unsharded step on the same
    state; only the rank whose sequence window holds the written slot
    changes its shard; no all-gather brings a cache together (no result
    has a cache's (S, KV, hd))."""
    out, checks, _ = ranks
    tag = f"{case}/long"
    assert_close(live(out[f"{tag}/logits"], case),
                 live(out[f"{tag}/want_logits"], case), TOL, tag)
    for key in out:
        if key.startswith(f"{tag}/want_state/"):
            path = key[len(f"{tag}/want_state/"):]
            assert_close(out[f"{tag}/state/{path}"], out[key], TOL, path)
    has_attention = case != "mamba2"
    for c in checks:
        assert bool(c[f"{tag}/seq_sharded"]) == has_attention, c
        assert c[f"{tag}/only_owner_writes"]
        assert not c[f"{tag}/cache_gathered"]


def test_expert_layouts_ep_and_ffn_hidden(ranks):
    """On (2, 2) the stacked (U, E, d, f) ``w_gate`` is placed experts over
    "model" (EP) for 4 experts, and ffn-hidden over "model" for 3 (which do
    not divide it), d_ff over "data" (FSDP) in the first and d_model in
    the second."""
    _, checks, _ = ranks
    for c in checks:
        assert c["mixtral/2x2/w_gate"] == ["S(3)", "S(1)"]
        assert c["qwen3-moe/2x2/w_gate"] == ["S(3)", "S(1)"]
        assert c["mixtral-e3/2x2/w_gate"] == ["S(2)", "S(3)"]


def test_moe_aux_loss_on_dtensors_equals_unsharded(ranks):
    """``moe_aux_loss`` of a batch-sharded DTensor input and DTensor params
    (its means reduce over the batch shards) equals the unsharded loss
    within ``F32_TOL``."""
    out, _, _ = ranks
    np.testing.assert_allclose(float(out["aux/got"]), float(out["aux/want"]),
                               rtol=F32_TOL)


@pytest.mark.cuda
def test_world1_nccl_families_on_card_equal_unsharded(tmp_path):
    """On a card: an NCCL group of one rank, a (1, 1) mesh; for mixtral,
    mamba2 and whisper one sharded train step (loss and grad norm within
    ``F32_TOL``), a sharded prefill and a decode step (logits within
    ``TOL``) equal the unsharded steps on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState
    from repro_torch.train import make_serve_steps, make_train_step
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        for case in ("mixtral", "mamba2", "whisper"):
            lm = LM(worker.config(case), device="cuda")
            params = lm_params_from_numpy(jax_params(case), "cuda")
            pol = ShardingPolicy(mesh, lm.cfg)
            ps = pol.params_shardings(params)
            dparams = distribute(params, ps)
            ins = case_inputs(case)
            batch = {"tokens": torch.from_numpy(ins["train"]).cuda()}
            pb = {"tokens": torch.from_numpy(ins["prefill"]).cuda()}
            if "train_enc" in ins:
                batch["enc_embeds"] = torch.from_numpy(ins["train_enc"]).cuda()
                pb["enc_embeds"] = torch.from_numpy(ins["prefill_enc"]).cuda()
            opt = AdamW(lr=LR)
            ost = opt.init(params)
            _, _, dm = make_train_step(lm, opt)(
                dparams, distribute(ost, OptState(pol.replicated(), ps, ps)),
                distribute(batch, pol.batch_shardings(batch)))
            _, _, m = make_train_step(lm, opt)(params, ost, batch)
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(dm[k].full_tensor()),
                                           float(m[k]), rtol=F32_TOL)
            prefill, decode = make_serve_steps(lm, pol)
            dpb = distribute(pb, pol.batch_shardings(pb))
            tok = torch.from_numpy(ins["decode"][0]).cuda()
            with torch.inference_mode():
                dl, dst = prefill(dparams, dpb["tokens"],
                                  dpb.get("enc_embeds"))
                dl2, _ = decode(dparams, distribute(
                    {"t": tok}, pol.batch_shardings({"t": tok}))["t"], dst)
                ul, ust = lm.prefill(params, pb["tokens"],
                                     pb.get("enc_embeds"))
                ul2, _ = lm.decode_step(params, tok, ust)
            for got, want in ((dl, ul), (dl2, ul2)):
                assert_close(live(got.full_tensor().cpu().numpy(), case),
                             live(want.cpu().numpy(), case), TOL, case)
    finally:
        dist.destroy_process_group()
