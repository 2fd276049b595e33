"""Quickstart for the ``repro_torch.dpp`` facade: build a Kronecker DPP
model, sample from it exactly on the card, learn the factored kernel back
from the samples, condition on observed items, and take a greedy MAP
subset — all through one model object. The steps of
``examples/quickstart.py``, through the PyTorch port: the same keys give
the JAX package's draws and inits.

    PYTHONPATH=src python examples/port/quickstart.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch import dpp
from repro_torch import random as prng


def run(device: str = "cuda") -> dict:
    """The quickstart's steps on ``device``; prints what the JAX example
    prints and returns its values."""
    # 1) a ground-truth Kronecker model over N = 20 x 25 = 500 items,
    #    rescaled so samples average ~10 items
    true = dpp.random_kron(prng.PRNGKey(7, device), (20, 25),
                           device=device).rescale(10.0)
    print(f"ground set N = {true.N}, factors {true.sizes}, "
          f"E|Y| = {true.expected_size():.1f}")

    # 2) exact sampling — the spectrum is eigendecomposed once per factor
    #    (O(N1^3 + N2^3), cached) and all 80 draws happen in one batched
    #    call (phase 2: one launch of the CUDA kernel on the card); the
    #    N x N kernel is never materialized
    t0 = time.perf_counter()
    batch = true.sample(prng.PRNGKey(0, device), 80, device=device)
    sizes = batch.sizes().cpu().numpy()   # host sync — include it in the time
    dt = time.perf_counter() - t0
    print(f"drew {batch.n} exact samples in {dt * 1e3:.0f} ms, |Y| in "
          f"[{sizes.min()}, {sizes.max()}], mean {sizes.mean():.1f}")

    # 3) per-subset probabilities and marginals off the same spectrum
    logp = true.log_prob(batch).cpu().numpy()
    p0, p01 = float(true.marginal(0)), float(true.marginal([0, 1]))
    print(f"log P(Y): mean {logp.mean():.2f}, best {logp.max():.2f}")
    print(f"P(0 in Y) = {p0:.3f}, P({{0,1}} ⊆ Y) = {p01:.4f}")

    # 4) learn a fresh Kronecker kernel from the samples (KrK-Picard,
    #    Alg. 1; the Armijo schedule guarantees PSD factors + monotone
    #    ascent)
    init = dpp.random_kron(prng.PRNGKey(3, device), (20, 25), device=device)
    rep = init.fit(batch, algorithm="krk", iters=10,
                   schedule=dpp.schedules.armijo(a0=1.0), device=device)
    lls = rep.log_likelihoods
    print("log-likelihood:", " -> ".join(f"{v:.2f}" for v in lls[::3]))
    assert all(b >= a - 1e-3 for a, b in zip(lls, lls[1:])), \
        "ascent violated!"
    print(f"monotone ascent verified over {rep.sweeps} sweeps "
          f"({rep.sweeps_per_sec:.0f} sweeps/s)")
    model = rep.model

    # 5) closure operations: condition on observed items (the conditional
    #    is a new model over the remaining ground set) and take a greedy
    #    MAP subset (one launch of the fused greedy-MAP kernel on the card)
    observed = [0, 1]
    cond = model.condition(observed)
    cond_size = cond.expected_size()
    print(f"conditioned on {observed}: new ground set of {cond.N} items, "
          f"E|Y'| = {cond_size:.1f}")
    picks = model.map(10)
    print("greedy MAP-10:", sorted(int(i) for i in picks))
    return {"true": true, "batch": batch, "sample_s": dt, "log_prob": logp,
            "marginals": (p0, p01), "fit": rep, "model": model,
            "cond_N": cond.N, "cond_expected_size": cond_size,
            "map": picks}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
