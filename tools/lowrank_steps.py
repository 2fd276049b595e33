"""Where a step of the low-rank dual chain spends its time, on one card.

    python3 tools/lowrank_steps.py

Builds ``chip_smoke.py``'s low-rank models (``lr_model``: N = 65536, r = 32
and N = 2^20, r = 128, rescaled to E|Y| = 8), draws the phase-1 inputs of
``sample(key, 16)`` from a key, and runs phase 2
(``repro_torch.lowrank.sample.phase2_dual``) three times under
``torch.profiler``. For each size it prints the call's time (CUDA events),
the device time of each PyTorch operation summed over the call and divided
by k_max (the time a step spends in it; the residual-norm init is the
``addcmul_`` and the first k_max products), the share of the call's device
time each takes, and one read of φ (N·r·4 bytes at the HBM rate) beside
them. One JSON line per size, with the card's name and power limit. Under
a minute.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = 3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/lowrank_steps.py needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as prng
    from repro_torch.lowrank.sample import _gamma, phase2_dual
    from repro_torch.sampling import SpectralCache
    from repro_torch.sampling.batched import compact_selection
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for N, r in ((cs.LR_N, cs.LR_RANK), (cs.LR_BIG_N, cs.LR_BIG_RANK)):
        cache = SpectralCache()
        spec = cs.lr_model(N, r, dev, cache).spectrum(cache)
        k_max = spec.suggested_k_max()
        keys = prng.split(prng.PRNGKey(1, dev), cs.LR_BATCH)
        u, us = prng.split_uniform(keys, r, k_max)
        mask = u < torch.sigmoid(spec.log_eigenvalues())[None, :]
        sel, valid, _ = compact_selection(mask, k_max)
        Gamma = _gamma(spec.basis(), sel, valid)
        k_eff = torch.clamp_max(mask.sum(-1), k_max).to(torch.int32)

        def call():
            return phase2_dual(us, spec.phi, Gamma, k_eff)

        ms = cs.cuda_ms(call, reps=5, warmup=2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.key_averages():
            t = e.self_device_time_total if hasattr(
                e, "self_device_time_total") else e.self_cuda_time_total
            if t > 0 and e.device_type != DeviceType.CUDA:
                ops[e.key] = t / 1e3 / REPS
        total = sum(ops.values())
        phi_ms = N * r * 4 / cs.HBM_BYTES_S * 1e3
        rows = sorted(ops.items(), key=lambda kv: -kv[1])
        print(json.dumps({
            "N": N, "rank": r, "batch": cs.LR_BATCH, "k_max": k_max,
            "call_ms": ms, "device_ms": total,
            "device_ms_a_step": total / k_max,
            "phi_read_ms": phi_ms,
            "ops_ms_a_step": {k: v / k_max for k, v in rows[:14]},
            "ops_share": {k: v / total for k, v in rows[:14]},
            "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
        del spec, cache, Gamma
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
