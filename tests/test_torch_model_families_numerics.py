"""The port's MoE, SSM, hybrid and encoder-decoder families against the
JAX package on the CPU, at smoke size: ``init_params`` from a key and the
bfloat16 compute paths. The cases and tolerances are those of
``tests/test_torch_model_families.py`` (its module docstring), which
holds the rest of the families' cases; the two files share its helpers
and run on two workers under ``--dist loadfile``."""

import dataclasses
import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro_torch import configs as tconfigs
from repro_torch import random as tr
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import LM
from test_torch_model_families import (ARCHS, BF16_TOL, IDS, as_np,
                                       assert_close, configs, inputs, setup)
from test_torch_models import INIT_RTOL


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, overrides", ARCHS, ids=IDS)
def test_init_params_match_jax_from_the_same_key(arch, overrides):
    """Every leaf, the unit tail's (U, reps, …), the encoder's and the
    cross-attention's too, from ``PRNGKey(7)``."""
    jcfg, tcfg = configs(arch, overrides)
    want = jax.tree_util.tree_map(
        np.asarray, JaxLM(jcfg).init_params(jax.random.PRNGKey(7)))
    got = lm_params_to_numpy(LM(tcfg, device="cpu").init_params(
        tr.PRNGKey(7, "cpu")))
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, got_leaves)) == sorted(str(p) for p, _ in
                                                  want_leaves)
    for path, w in want_leaves:
        g = got_leaves[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= INIT_RTOL * scale, path
    if overrides:
        assert got["blocks"]["tail"]["layer1"]["moe"]["w_up"].shape[:2] == \
            (1, 3)


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2.7b"])
def test_bfloat16_compute_matches_jax_at_bf16_tolerance(arch):
    """dtype="bfloat16": the router, ``A_log``, ``D`` and ``dt_bias`` are
    cast with every stacked leaf (only ``ln_f`` stays float32); prefill and
    forward logits within 0.05 of max |JAX|, the caches as the module
    docstring says."""
    jlm, jp, lm, params = setup(arch, dtype="bfloat16")
    cast = lm._cast(params)
    assert cast["ln_f"].dtype == torch.float32
    assert all(a.dtype == torch.bfloat16 for a in jax.tree_util.tree_leaves(
        cast["blocks"]))
    toks, _ = inputs(lm.cfg)
    jl, js = jlm.prefill(jp, jnp.asarray(toks))
    tl, ts = lm.prefill(params, toks)
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    live = slice(0, lm.cfg.vocab)
    assert_close(tl[..., live], jl[..., live], BF16_TOL, "bf16 prefill")
    jf = jlm.forward(jp, jnp.asarray(toks))
    assert_close(lm.forward(params, toks)[..., live], jf[..., live],
                 BF16_TOL, "bf16 forward")
    c, jc = ts.caches["head"]["layer0"], js.caches["head"]["layer0"]
    for name in c._fields[:-1]:
        got, want = as_np(getattr(c, name)), as_np(getattr(jc, name))
        scale = float(np.abs(want).max())
        bf16 = getattr(c, name).dtype == torch.bfloat16
        tol = 4 * 2 ** -8 if bf16 else BF16_TOL
        assert float(np.abs(got - want).max()) <= tol * scale, name


@pytest.mark.parametrize("layers", [4, 16, 64])
def test_bfloat16_error_grows_with_depth_as_in_jax(layers):
    """The reference for ``chip_smoke.py``'s per-depth bfloat16 limits:
    mamba2-2.7b's layers (state 128, heads of 64, chunk 256) at d_model 256,
    the JAX init from PRNGKey(0), 2 seeded prompts of 256 tokens. The
    forward logits in bfloat16 against float32, max |Δ| over max
    |float32|, grow with depth in the JAX package, past 0.05 at 64 layers
    (measured 0.023 / 0.045 / 0.105 at 4 / 16 / 64), and the port's are
    within a factor of 1.5 of the JAX package's at each depth (measured
    0.91 to 0.93 of them)."""
    over = dict(n_layers=layers, d_model=256, remat=False)
    jcfg = dataclasses.replace(jconfigs.get_config("mamba2-2.7b"), **over)
    tcfg = dataclasses.replace(tconfigs.get_config("mamba2-2.7b"), **over)
    jlm16 = JaxLM(jcfg)
    jlm32 = JaxLM(dataclasses.replace(jcfg, dtype="float32"))
    jp = jlm16.init_params(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 256),
                                             dtype=np.int32)
    live = slice(0, jcfg.vocab)
    rel = {}
    for pkg, runs in (
            ("jax", [lambda: jlm16.forward(jp, jnp.asarray(toks)),
                     lambda: jlm32.forward(jp, jnp.asarray(toks))]),
            ("port", [lambda: LM(tcfg, device="cpu").forward(params, toks),
                      lambda: LM(dataclasses.replace(tcfg, dtype="float32"),
                                 device="cpu").forward(params, toks)])):
        with torch.inference_mode():
            l16, l32 = (as_np(run()[..., live]) for run in runs)
        rel[pkg] = float(np.abs(l16 - l32).max() / np.abs(l32).max())
    print(f"mamba2 at d_model 256, {layers} layers: bfloat16 vs "
          f"float32 logits, JAX {rel['jax']}, port {rel['port']}")
    assert rel["jax"] / 1.5 <= rel["port"] <= 1.5 * rel["jax"], rel
    if layers == 64:
        assert rel["jax"] > BF16_TOL, rel
