"""How far the float32 baselines (full Picard, joint Picard, EM) lie from
float64 runs of the same sweeps, through the port's step functions.

    python3 tools/learning_precision.py        # on a card, about 30 s

On a card: 3 sweeps of each baseline at N = 100 x 100 on the 1000-subset
batch of ``chip_smoke.py`` phase 8, from its init (the paper's §5.1 random
factors) and from that init rescaled to E|Y| = 20, in float32 and float64
on the card: the LL tracks, the extreme eigenvalues of the kernel or the
factors, and each float32 result's distance from the float64 one as a share
of max |entry| (L1 ⊗ L2 for joint Picard); and one float32 sweep of each
from both starts, timed with CUDA events (3 calls after a warm-up), to
show which sweep times depend on the data. Then the three at 24 x 24 (60
subsets, ``benchmarks/paper_fig1_synthetic.py``'s size) in float32 on the
card and on the CPU, against float64 on the CPU (the JAX package's own
float32 sweeps there are held against the same float64 run by
``tests/test_torch_picard.py``).

Prints one JSON object a line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got.cpu() if hasattr(got, "cpu")
                                     else got)).double()
    want = want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


def extremes(M) -> list:
    e = torch.linalg.eigvalsh(M.double())
    return [float(e[0]), float(e[-1])]


def sweep_ms(factors, batch) -> dict:
    """CUDA-event time of one float32 sweep of each baseline from
    ``factors`` (mean of 3 calls after one warm-up)."""
    from repro_torch.core import em
    from repro_torch.core.joint_picard import joint_picard_step
    from repro_torch.core.picard import picard_step
    L1, L2 = factors
    L = torch.kron(L1, L2)
    lam, V = torch.linalg.eigh(L)
    lam = torch.clamp_min(lam, 1e-6)

    def em_sweep():
        return em.eigvec_ascent(em.m_step_eigvals(em.e_step(lam, V, batch)),
                                V, batch, 1e-3)

    out = {}
    for name, fn in (("picard", lambda: picard_step(L, batch, 1.0)),
                     ("joint", lambda: joint_picard_step(L1, L2, batch, 1.0,
                                                         50)),
                     ("em", em_sweep)):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out[name] = t0.elapsed_time(t1) / 3
    return out


def sweeps(factors, batch, dtype) -> dict:
    """3 sweeps of each baseline from ``factors`` in ``dtype``, where the
    factors and the batch live: {name: (LL track, model, extremes)}."""
    from repro_torch.core import em
    from repro_torch.core.dpp import log_likelihood
    from repro_torch.core.joint_picard import joint_picard_step
    from repro_torch.core.picard import picard_step
    from repro_torch.learning.objective import (log_likelihood_eig,
                                                log_likelihood_factored)
    L1, L2 = (f.to(dtype) for f in factors)
    out = {}
    L = torch.kron(L1, L2)
    lls = [float(log_likelihood(L, batch))]
    for _ in range(3):
        L = picard_step(L, batch, 1.0)
        lls.append(float(log_likelihood(L, batch)))
    out["picard"] = (lls, L, extremes(L) if bool(torch.isfinite(L).all())
                     else None)
    A, B = L1, L2
    lls = [float(log_likelihood_factored((A, B), batch))]
    for _ in range(3):
        A, B = joint_picard_step(A, B, batch, 1.0, 50)
        lls.append(float(log_likelihood_factored((A, B), batch)))
    out["joint"] = (lls, torch.kron(A, B), [extremes(A), extremes(B)])
    lam, V = torch.linalg.eigh(torch.kron(L1, L2))
    lam = torch.clamp_min(lam, 1e-6)
    lls = [float(log_likelihood_eig(lam, V, batch))]
    for _ in range(3):
        lam = em.m_step_eigvals(em.e_step(lam, V, batch))
        V = em.eigvec_ascent(lam, V, batch, 1e-3)
        lls.append(float(log_likelihood_eig(lam, V, batch)))
    out["em"] = (lls, (V * lam[None, :]) @ V.T,
                 [float(lam.min()), float(lam.max())])
    return out


def compare(name: str, runs: dict, exact: dict) -> None:
    for where, res in runs.items():
        row = {"case": name, "run": where}
        for algo, (lls, model, ext) in res.items():
            ll64, model64, _ = exact[algo]
            row[algo] = {"lls": lls, "lls_float64": ll64, "extremes": ext,
                         "model_vs_float64": rel(model, model64)}
        print(json.dumps(row), flush=True)


def small_case(dev) -> None:
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.core.dpp import SubsetBatch
    true = dpp.random_kron(prng.PRNGKey(0, dev), (24, 24),
                           device=dev).rescale(10.0)
    rows = [r for r in true.sample(prng.PRNGKey(1, dev), 60,
                                   device=dev).to_lists() if r]
    init = dpp.random_kron(prng.PRNGKey(2, dev), (24, 24), device=dev)
    cpu = SubsetBatch.from_lists(rows, device="cpu")
    F = tuple(f.cpu() for f in init.factors)
    compare("24x24 raw init", {
        "cpu_float32": sweeps(F, cpu, torch.float32),
        "card_float32": sweeps(init.factors, SubsetBatch.from_lists(
            rows, device=dev), torch.float32)},
        sweeps(F, cpu, torch.float64))


def full_width(dev) -> None:
    from repro_torch import dpp
    from repro_torch.core.dpp import SubsetBatch
    from repro_torch.kernels import _build
    for name in ("phase2_select", "threefry"):
        _build.build(name)
    main = dpp.random_kron(torch.Generator(device=dev).manual_seed(1),
                           (100, 100)).rescale(20.0)
    rows = [r for r in main.service(seed=2).sample(1000) if r]
    batch = SubsetBatch.from_lists(rows, device=dev)
    init = dpp.random_kron(torch.Generator(device=dev).manual_seed(2),
                           (100, 100))
    for name, m in (("N=10^4 raw init", init),
                    ("N=10^4 init rescaled to E|Y| = 20", init.rescale(20.0))):
        print(json.dumps({"case": name, "factor_extremes":
                          [extremes(f) for f in m.factors]}), flush=True)
        exact = sweeps(m.factors, batch, torch.float64)
        compare(name, {"card_float32": sweeps(m.factors, batch,
                                              torch.float32)}, exact)
        del exact
        torch.cuda.empty_cache()
        print(json.dumps({"case": name, "sweep_ms_float32": sweep_ms(
            m.factors, batch)}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/learning_precision.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    full_width(dev)
    small_case(dev)


if __name__ == "__main__":
    main()
