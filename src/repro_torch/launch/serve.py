"""Serving launcher: --arch <id>, batched generation with optional DPP
KV-cache compaction (port of ``repro/launch/serve.py``; the same flags and
JSON output, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --prompt-len 64 --max-new 32

With --kv-budget the cache is compacted (exact k-DPP eviction) between
prefill and decode. With --tenants the launcher runs one concurrent
decode stream per tenant, all sharing one async
``repro_torch.serving.KVCompactionClient``, so compaction calls from
different streams coalesce into shared flushes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --device cpu --batch 2 --prompt-len 48 --max-new 8 \
        --kv-budget 24 --tenants "interactive:2,batch:1" --deadline-ms 10

The weights come from the seeded init, as in the reference's launcher.
--device defaults to "cuda" and fails without a card; --device cpu runs
on the CPU (a --smoke config there).
"""

from __future__ import annotations

import argparse
import json
import threading
import zlib

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-budget", type=int, default=None,
                    help="compact KV caches to this many slots after "
                         "prefill (exact k-DPP eviction)")
    ap.add_argument("--kv-recency", type=int, default=8,
                    help="always-kept most-recent positions within the "
                         "budget")
    ap.add_argument("--tenants", default=None,
                    help='concurrent decode streams sharing one async '
                         'compaction client, as "name[:weight],..." — '
                         'requires --kv-budget')
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="async flush deadline (with --tenants)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="async flush row budget (with --tenants)")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    args = ap.parse_args(argv)

    import torch

    from .. import random as prng
    from ..configs import get_config, smoke_config
    from ..models import LM
    from ..serve import ServeEngine

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, device=args.device)
    with torch.inference_mode():
        params = lm.init_params(prng.PRNGKey(args.seed, lm.device))
    engine = ServeEngine(lm, params, temperature=args.temperature,
                         seed=args.seed, device=lm.device)
    rng = np.random.default_rng(args.seed)
    enc = None
    if cfg.encoder_layers:
        # the stub frontend's frame embeddings, drawn before the prompts as
        # the reference's launcher draws them
        enc = rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)

    if args.tenants is None:
        prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                               dtype=np.int32)
        out = engine.generate(prompts, args.max_new, enc_embeds=enc,
                              kv_budget=args.kv_budget,
                              kv_recency=args.kv_recency)
        print(json.dumps({
            "generated_shape": list(out["tokens"].shape),
            "prefill_s": round(out["prefill_s"], 4),
            "compact_s": round(out["compact_s"], 4),
            "decode_s": round(out["decode_s"], 4),
            "decode_tok_per_s": round(out["decode_tok_per_s"], 1)}))
        return

    if args.kv_budget is None:
        ap.error("--tenants needs --kv-budget (the streams exist to "
                 "exercise coalesced KV compaction)")
    from ..serving import KVCompactionClient, ServingConfig, parse_tenants

    tenants = parse_tenants(args.tenants)
    client = KVCompactionClient(
        args.kv_budget, args.kv_recency,
        ServingConfig(max_batch=args.max_batch,
                      deadline_ms=args.deadline_ms),
        tenants=tenants, seed=args.seed, device=lm.device)
    results, errors = {}, {}

    def stream(name):
        srng = np.random.default_rng(
            args.seed + (zlib.crc32(name.encode()) & 0xFFFF))
        prompts = srng.integers(0, cfg.vocab,
                                (args.batch, args.prompt_len),
                                dtype=np.int32)
        try:
            results[name] = engine.generate(prompts, args.max_new,
                                            enc_embeds=enc,
                                            kv_client=client,
                                            kv_tenant=name)
        except Exception as e:          # reported after the join
            errors[name] = e

    threads = [threading.Thread(target=stream, args=(name,), name=name)
               for name in tenants]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    client.close()
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"stream {name!r} failed") from err
    m = client._metrics
    print(json.dumps({
        "streams": {name: {
            "generated_shape": list(out["tokens"].shape),
            "compact_s": round(out["compact_s"], 4),
            "decode_tok_per_s": round(out["decode_tok_per_s"], 1)}
            for name, out in results.items()},
        "coalescing": {
            "device_calls": int(m.counter_value("serving.device_calls")),
            "heads_selected": int(
                m.counter_value("serving.heads_selected")),
            "flushes": int(m.counter_value("serving.flushes")),
            "deadline_fires": int(
                m.counter_value("serving.deadline_fires")),
            "batch_fires": int(m.counter_value("serving.batch_fires"))},
        "per_tenant": client.per_tenant()}))


if __name__ == "__main__":
    main()
