"""End to end: train a (reduced) qwen2-0.5b for a few hundred steps
with KronDPP diverse minibatch selection — the paper's model running inside
the training data pipeline. Before training, the selection kernel is
calibrated by maximum likelihood on its own observed diverse batches through
the ``repro_torch.dpp`` facade (``model.fit``): KrK-Picard sweeps under the
Armijo schedule, so the refined factors are guaranteed PSD. The steps of
``examples/train_dpp_selection.py``, through the PyTorch port: on the card
the selector's flushes run phase 2's CUDA kernel and ``threefry2x32``.

    PYTHONPATH=src python examples/port/train_dpp_selection.py \\
        [--steps 200] [--device cpu] [--checkpoint-dir DIR]
"""

import argparse
import json

import numpy as np

from repro_torch import random as prng
from repro_torch.configs import smoke_config
from repro_torch.core import SubsetBatch
from repro_torch.data import DPPBatchSelector, TokenPipeline, synthetic_corpus
from repro_torch.dpp import schedules
from repro_torch.models import LM
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import Trainer, TrainerConfig, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calibrate-subsets", type=int, default=32,
                    help="observed diverse batches to fit the kernel on "
                         "(0: off)")
    ap.add_argument("--calibrate-iters", type=int, default=3)
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_ckpt_dpp")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The example's steps for the parsed ``args``. Prints what the JAX
    example prints and returns the calibration LLs and the trainer's
    result."""
    device = args.device
    cfg = smoke_config("qwen2-0.5b")
    lm = LM(cfg, device=device)
    opt = AdamW(lr=3e-3, schedule=cosine_schedule(10, args.steps))
    params = lm.init_params(prng.PRNGKey(0, device))
    step = make_train_step(lm, opt)

    corpus = synthetic_corpus(args.docs, 32, cfg.vocab, n_topics=12)
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((cfg.vocab, 16)).astype(np.float32) / 16
    feats = np.stack([proj[c].mean(0) for c in corpus])
    n1 = int(np.sqrt(args.docs))
    selector = DPPBatchSelector.from_features(feats, n1, args.docs // n1,
                                              device=device)

    lls = None
    if args.calibrate_subsets:
        # observe diverse batches from the feature-built kernel, then refine
        # the factors by MLE on them with the learning engine
        cal_rng = np.random.default_rng(1)
        observed = [list(selector.select(cal_rng, args.batch))
                    for _ in range(args.calibrate_subsets)]
        cal_batch = SubsetBatch.from_lists(observed, device=device)
        ll0 = float(selector.dpp.log_likelihood(cal_batch))
        selector = selector.fit_from_subsets(
            observed, iters=args.calibrate_iters,
            schedule=schedules.armijo(a0=1.0))
        ll1 = float(selector.dpp.log_likelihood(cal_batch))
        lls = (ll0, ll1)
        print(f"kernel calibration: ll {ll0:.2f} -> {ll1:.2f} "
              f"over {args.calibrate_subsets} observed batches")

    pipe = TokenPipeline(corpus, args.batch, seed=0, selector=selector)

    trainer = Trainer(lm, opt, step, TrainerConfig(
        total_steps=args.steps, log_every=max(args.steps // 10, 1),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.steps // 2))
    res = trainer.fit(params, opt.init(params), iter(pipe))
    for h in res["history"]:
        print(json.dumps(h))
    print(f"done at step {res['final_step']}; "
          f"loss {res['history'][0]['loss']:.3f} -> "
          f"{res['history'][-1]['loss']:.3f}")
    return {"calibration_ll": lls, "result": res}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
