"""Serve a small model under traffic: two concurrent decode streams whose
DPP KV-cache compactions coalesce through the async serving tier. The
steps of ``examples/serve_kv_compaction.py``, through the PyTorch port.

Each stream prefills, submits every layer's kv-heads to a shared
``repro_torch.serving.KVCompactionClient`` (exact k-DPP eviction,
Diversity-Networks [26] applied to cached tokens), and decodes on the
compacted cache. The client's background flush thread batches both
streams' heads into ONE device call per flush window — check the
``device_calls`` line — and emits each request's ``queue-wait → coalesce
→ device-call → scatter`` span tree, tenant-tagged, into the run log.
The per-tenant latency breakdown at the end is rendered straight off
that log by ``repro_torch.obs.report``. On the card every head's k-DPP
draw runs phase 2's CUDA kernel and its keys ``threefry2x32``.

    PYTHONPATH=src python examples/port/serve_kv_compaction.py [--device cpu]
"""

import argparse
import tempfile
import threading

import numpy as np

from repro_torch import obs
from repro_torch import random as prng
from repro_torch.configs import smoke_config
from repro_torch.models import LM
from repro_torch.obs import report
from repro_torch.serve import ServeEngine
from repro_torch.serving import KVCompactionClient, ServingConfig

B, S, BUDGET, MAX_NEW = 4, 48, 24, 12


def run(device: str = "cuda", run_log=None) -> dict:
    """The example's steps on ``device``, the run log written to
    ``run_log`` (default a new temporary file). Prints what the JAX
    example prints and returns the three generations and the client's
    counts."""
    cfg = smoke_config("qwen2-0.5b")
    lm = LM(cfg, device=device)
    params = lm.init_params(prng.PRNGKey(0, device))
    engine = ServeEngine(lm, params, temperature=0.0, device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)

    # --- plain generation ---------------------------------------------------
    plain = engine.generate(prompts, MAX_NEW)
    print(f"plain decode:       tokens {plain['tokens'].shape}, "
          f"{plain['decode_tok_per_s']:.0f} tok/s")

    # --- inline compaction (single stream, engine-owned keys) ---------------
    inline = engine.generate(prompts, MAX_NEW, kv_budget=BUDGET,
                             kv_recency=8)
    print(f"compacted decode:   cache {S} -> {BUDGET} slots/layer, "
          f"tokens {inline['tokens'].shape}, "
          f"compact {inline['compact_s']:.2f}s")

    # --- two concurrent streams through the async tier ----------------------
    if run_log is None:
        run_log = tempfile.NamedTemporaryFile(suffix=".jsonl",
                                              delete=False).name
    obs.configure(jsonl=str(run_log))
    try:
        client = KVCompactionClient(
            BUDGET, recency=8,
            config=ServingConfig(max_batch=64, deadline_ms=10.0),
            tenants={"interactive": 2, "batch": 1}, seed=0, device=device)
        results = {}

        def stream(tenant: str, seed: int):
            srng = np.random.default_rng(seed)
            p = srng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
            results[tenant] = engine.generate(p, MAX_NEW, kv_client=client,
                                              kv_tenant=tenant)

        threads = [threading.Thread(target=stream, args=("interactive", 1)),
                   threading.Thread(target=stream, args=("batch", 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        client.close()
    finally:
        obs.configure()   # detach the jsonl sink before reading it

    m = client._metrics
    calls = int(m.counter_value("serving.device_calls"))
    heads = int(m.counter_value("serving.heads_selected"))
    print(f"two async streams:  device_calls={calls} for {heads} kv-heads "
          f"across both tenants (coalesced), per-tenant "
          f"{client.per_tenant()}")
    for tenant, res in results.items():
        print(f"  {tenant:12s} tokens {res['tokens'].shape}, "
              f"compact {res['compact_s']:.2f}s")

    # --- per-tenant span breakdown off the run log --------------------------
    print("\nrepro_torch.obs.report — slowest request traces "
          "(spans are tenant-tagged):")
    report.main([str(run_log), "--traces", "2", "--top", "6"])
    return {"plain": plain, "inline": inline, "streams": results,
            "device_calls": calls, "heads_selected": heads,
            "per_tenant": client.per_tenant(), "run_log": str(run_log)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default; fails without a card) or "cpu"')
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
