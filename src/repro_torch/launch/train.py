"""Training launcher: --arch <id> end-to-end driver (port of
``repro/launch/train.py``; the same flags and JSON lines, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

The params come from ``LM.init_params(PRNGKey(seed))`` (the JAX package's
values for the seed), the step is the eager train step of
``repro_torch.train`` (no compilation, no buffer donation), and
``--dpp-batch-selection`` picks every batch with the KronDPP selector
built from the reference's document features. --device defaults to
"cuda" and fails without a card; --device cpu runs on the CPU (a --smoke
config there).

The reference's docstring runs the same entry point on a fleet under
``jax.distributed.initialize()``; its code initializes nothing and trains
on what it is given. This launcher trains on one device. Sharded training
is the same train step on DTensor params, optimizer state and batches,
placed by ``repro_torch.distributed.ShardingPolicy`` on a ``DeviceMesh``
(``launch.mesh``) over a ``torch.distributed`` process group, one process
a card: ``tools/sharded_train_cards.py`` drives it on four cards.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--dpp-batch-selection", action="store_true",
                    help="KronDPP diverse minibatch selection (paper core)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    args = ap.parse_args(argv)

    from .. import random as prng
    from ..configs import get_config, smoke_config
    from ..data import DPPBatchSelector, TokenPipeline, synthetic_corpus
    from ..models import LM
    from ..optim import AdamW, cosine_schedule
    from ..train import Trainer, TrainerConfig, make_train_step

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=args.device)
    params = lm.init_params(prng.PRNGKey(args.seed, lm.device))
    opt = AdamW(lr=args.lr,
                schedule=cosine_schedule(max(args.steps // 10, 1), args.steps))
    opt_state = opt.init(params)
    step_fn = make_train_step(lm, opt, microbatches=args.microbatches)

    corpus = synthetic_corpus(args.docs, args.seq, cfg.vocab, args.seed)
    selector = None
    if args.dpp_batch_selection:
        # doc features: topic-ish unigram histogram projections
        rng = np.random.default_rng(args.seed)
        proj = rng.standard_normal((cfg.vocab, 16)).astype(np.float32) / 16
        feats = np.stack([proj[c].mean(0) for c in corpus])
        n1 = int(np.sqrt(args.docs))
        while args.docs % n1:
            n1 -= 1
        selector = DPPBatchSelector.from_features(feats, n1, args.docs // n1,
                                                  device=lm.device)
    pipeline = TokenPipeline(corpus, args.batch, args.seed, selector)

    trainer = Trainer(lm, opt, step_fn, TrainerConfig(
        total_steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every))
    start = 0
    if args.resume and args.checkpoint_dir:
        params, opt_state, start = trainer.try_resume(params, opt_state)
        print(f"resumed from step {start}")
    result = trainer.fit(params, opt_state, iter(pipeline), start_step=start)
    for h in result["history"]:
        print(json.dumps(h))
    print(json.dumps({"final_step": result["final_step"],
                      "stragglers": len(result["stragglers"])}))
    return result


if __name__ == "__main__":
    main()
