"""KronDPP learning launcher: the paper's Sec. 3 learners end to end,
driven entirely through the ``repro_torch.dpp`` facade (port of
``repro/launch/learn.py``; the same flags and JSON lines, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.learn --n1 16 --n2 16 \
        --subsets 128 --algorithm krk-stochastic --minibatch 32 \
        --iters 40 --schedule armijo --log-every 10 --device cpu

Training data is drawn from a ground-truth model with ``model.sample`` (one
batched device call for the whole dataset), then the chosen learner runs
through ``model.fit`` — chunked sweeps, checkpoint/resume, and (with
``--runtime mesh``) the port's single-process ``Mesh``: the KrK sweep's
Θ-statistics and Armijo acceptance LLs summed over the data shards, one a
card of the node (on the CPU one shard). The keys are the JAX package's
(``repro_torch.random``), so the same seed draws the reference's subsets
and init. The old ``--distributed`` flag is a DeprecationWarning alias for
``--runtime mesh``. With ``--dense-theta`` each sweep runs the two
partial-trace kernels on the card.

--device defaults to "cuda" and fails without a card; --device cpu runs
on the CPU.
"""

from __future__ import annotations

import argparse
import json
import warnings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n1", type=int, default=16)
    ap.add_argument("--n2", type=int, default=16)
    ap.add_argument("--subsets", type=int, default=128,
                    help="number of training subsets to draw")
    ap.add_argument("--expected-size", type=float, default=10.0,
                    help="rescale the true kernel so E|Y| hits this")
    ap.add_argument("--algorithm", default="krk",
                    choices=["krk", "krk-stochastic", "em", "joint"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--minibatch", type=int, default=None)
    ap.add_argument("--a", type=float, default=1.0, help="step size a0")
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "inv-sqrt", "armijo"])
    ap.add_argument("--log-every", type=int, default=5,
                    help="sweeps per chunk / host LL sync")
    ap.add_argument("--ll-mode", default="chunk",
                    choices=["sweep", "chunk", "none"])
    ap.add_argument("--dense-theta", action="store_true",
                    help="paper batch route (dense Θ) instead of sparse")
    ap.add_argument("--stale-theta", action="store_true",
                    help="cache Θ-statistics across the two half-updates")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--runtime", default=None,
                    choices=["local", "mesh"],
                    help="execution placement (repro_torch.dpp.runtime): "
                         "'mesh' shards the batch over every card of the "
                         "node ('data' axis; one shard on the CPU); "
                         "default local")
    ap.add_argument("--distributed", action="store_true",
                    help="(deprecated) alias for --runtime mesh")
    ap.add_argument("--max-dense", type=int, default=None,
                    help="raise the dense-materialization guard (em on a "
                         "Kron model needs N <= this; default 4096)")
    ap.add_argument("--jsonl", default=None, metavar="PATH",
                    help="append every repro_torch.obs emission "
                         "(learning.* metrics, spans, health.* sentinels) "
                         "to PATH as a JSONL run log")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="after the fit, export the --jsonl run log as a "
                         "chrome://tracing trace-event file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    args = ap.parse_args(argv)
    if args.trace and not args.jsonl:
        ap.error("--trace needs --jsonl (the trace is exported from the "
                 "run log)")
    if args.distributed:
        if args.runtime is not None:    # one source of placement truth,
            ap.error("pass --runtime or --distributed, not both")  # as in
        warnings.warn("--distributed is deprecated; use --runtime mesh",
                      DeprecationWarning, stacklevel=2)   # runtime.resolve
        args.runtime = "mesh"

    from .. import obs
    if not args.jsonl:
        return _learn(args)
    with obs.JsonlTracker(args.jsonl) as sink, \
            obs.use(obs.tee(obs.current_tracker(), sink)):
        _learn(args)
    if args.trace:
        exported = obs.ChromeTraceExporter().export(args.jsonl, args.trace)
        print(f"learn: wrote {args.trace} "
              f"({len(exported['traceEvents'])} events)")


def _learn(args) -> None:
    from .. import random as prng
    from .._device import resolve_device
    from ..dpp import MAX_DENSE_N, random_kron, runtime, schedules

    dev = resolve_device(args.device)
    # ---- ground-truth model + device-drawn training subsets ----
    key = prng.PRNGKey(args.seed, dev)
    k_true, k_data = prng.split(key)
    true = random_kron(k_true, (args.n1, args.n2), device=dev) \
        .rescale(args.expected_size)
    batch = _nonempty(true.sample(k_data, args.subsets, device=dev))

    init = random_kron(prng.PRNGKey(args.seed + 1, dev),
                       (args.n1, args.n2), device=dev)

    rt = runtime.from_spec(args.runtime or "local")
    if rt.is_mesh:
        if dev.type == "cpu":
            rt = runtime.Mesh(devices=[dev])
        batch = rt.even_batch(batch)  # even data shards, as the reference

    rep = init.fit(batch, algorithm=args.algorithm, iters=args.iters,
                   max_dense=args.max_dense or MAX_DENSE_N,
                   a=args.a, schedule=schedules.by_name(args.schedule, args.a),
                   minibatch_size=args.minibatch, seed=args.seed,
                   log_every=args.log_every, ll_mode=args.ll_mode,
                   use_dense_theta=args.dense_theta,
                   fresh_theta=not args.stale_theta,
                   checkpoint_dir=args.checkpoint_dir,
                   save_every=args.save_every, resume=args.resume,
                   runtime=rt, device=dev)

    for sweep, ll in zip(rep.ll_sweeps, rep.log_likelihoods):
        print(json.dumps({"sweep": sweep, "ll": round(ll, 4)}))
    print(json.dumps({
        "algorithm": args.algorithm, "sweeps": rep.sweeps,
        "sweeps_per_sec": round(rep.sweeps_per_sec, 2),
        "ll_final": round(rep.log_likelihoods[-1], 4)
        if rep.log_likelihoods else None,
        "armijo_backtracks": int(rep.state.sched.backtracks),
        "health": rep.health["verdict"] if rep.health else None,
        "health_triggered": sorted(rep.health["triggered"])
        if rep.health else [],
    }))


def _nonempty(batch):
    """Drop empty subsets (an empty Y contributes a constant to the LL)."""
    from ..core import SubsetBatch
    keep = batch.mask.any(dim=1)
    return SubsetBatch(batch.indices[keep], batch.mask[keep])


if __name__ == "__main__":
    main()
