"""Drive the PyTorch/CUDA port of the Kronecker DPP sampler on one GPU.

    python3 chip_smoke.py

Phases, in order, none of them guarded by a try: any failure exits
non-zero and prints no result line.

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: nvcc compiles ``src/repro_torch/kernels/csrc/phase2_select.cu``
   into ``build/kernels/``; the ``-Xptxas -v`` lines give registers and
   shared memory;
3. the phase-2 kernel against its plain PyTorch version on the card, at
   the main path's shapes (N = 100 x 100, E|Y| = 20, B = 1 and 64) and at
   the edges (m = 1, m = 3, degenerate columns), on the same uniforms;
4. statistics on the kernel path: singleton marginals of a (2, 3) kernel
   from 3000 draws against diag K;
5. the main path: ``dpp.random_kron(gen, (100, 100)).rescale(20.0)``,
   ``model.service(seed=0)``, tickets of 1, 4, 16, 64 and 200 samples,
   one flush; the kernel's launch count and the
   ``kernels.phase2_select.cuda`` counter are reset just before and read
   just after. The flush's own launch (285 rows served of one call at
   B = 512) is then held against the plain version: the flush's uniforms
   are replayed from the service generator's saved state;
6. times with CUDA events (kernel, plain version, the bound) and one
   ``svc.sample(16)`` request on the host clock;
7. the partial-trace kernels (``csrc/partial_trace.cu``) against their
   plain versions on random non-symmetric Θ, L1, L2 at N1 x N2 = 100 x 100
   (the main shape), 64 x 150 and 7 x 13;
8. data for the fit: n = 1000 subsets drawn through the service of the
   phase-5 model (E|Y| = 20, N = 100 x 100); the init is a second
   ``random_kron(gen2, (100, 100))`` (paper §5.1);
9. at the init, on the full batch, the A and C of the dense route through
   the kernels, of the dense route through the plain versions
   (``backend="reference"``) and of the per-subset route
   (``accumulate_AC``) agree;
10. the learning main path: ``model.fit(batch, algorithm="krk",
   use_dense_theta=True, schedule=armijo(a0=1.5), iters=5, log_every=5)``
   under an ``InMemoryTracker`` (so the health check reads CUDA factors).
   The partial-trace launch counts and the ``kernels.partial_trace_*.cuda``
   counters are reset just before and read just after: 5 sweeps make 5 A
   and 10 C launches (A once per sweep; C once per Θ build, twice with the
   block-CCCP refresh). The tracked LL never falls by more than
   ``_ASCENT_TOL``, ends above the init's, both factors stay PD, and
   ``FitReport.health`` is present. The same 5 sweeps with the plain
   partial traces give the same accepted step and backtrack count and
   factors within tolerance;
11. times with CUDA events for each partial trace (kernel, plain version,
   the ``torch.einsum`` library call, the bound), the Θ build and its
   steps, a factor eigh and one log-likelihood, and one sweep on the host
   clock (both fits run after a 1-sweep warm-up fit).

Tolerances: picks of kernel and plain version are compared row by row.
A differing row is accepted only when the exact chain (float64, along the
common prefix) explains its first differing step as float32 roundoff:
the draw ``r = us·total`` lies within 1e-5·total of every CDF boundary
between the two picks (the kernel's block-parallel scan rounds
differently from ``torch.cumsum``), or one version stopped where the
exact residual mass is already at or below MASS_EPS. With degenerate
columns a row may pick past the span only on such exhausted mass; those
rows are counted and printed. Marginals: atol 0.05 at 3000 draws (about 5 standard
errors). Mean |Y| of the service rows: within 1 of E|Y|.

Partial traces, kernel against plain version on the same Θ: elementwise
``|kernel - plain| <= 1e-4 * (the same contraction over |Θ| and |L|) +
1e-7``, because the two sum N2² or N1² float32 terms in other orders.
Dense route against the per-subset route: ``max |Δ| <= 1e-4 * max |ref|``
(the same float32 terms, summed through Θ or straight into A and C). The
kernel fit against the plain fit after 5 sweeps: accepted step and
backtracks equal, LLs within rtol 1e-4, factors within
``1e-3 * max |L|``. The trajectory itself amplifies float32 noise: on the
CPU two runs of the same fit already differ by 1e-5 to 3e-5 of max |L|
after 5 sweeps (threaded sums), and taking the partial traces in float64
moves them by 2e-5 to 4e-5 (20 x 20 and 50 x 50); on the card the scatter
into Θ also runs in atomics.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the kernel table and the timing line as JSON, each with the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 3 helpers: hold kernel picks against plain picks
# ---------------------------------------------------------------------------

def check_rows(picks: np.ndarray, k_eff: np.ndarray, N: int,
               label: str) -> None:
    """No duplicates, picks in range, a -1 tail, at most k_eff picks."""
    for b, row in enumerate(picks):
        real = row[row >= 0]
        n = len(real)
        check(len(set(real.tolist())) == n, f"{label}: row {b} repeats an "
              f"item: {row.tolist()}")
        check((row[n:] == -1).all(), f"{label}: row {b} has no -1 tail")
        check(n <= int(k_eff[b]), f"{label}: row {b} has {n} picks > "
              f"k_eff {int(k_eff[b])}")
        check(n == 0 or int(real.max()) < N, f"{label}: row {b} out of range")


def check_span(picks: np.ndarray, us, G1, Gr, span: int, label: str) -> int:
    """Rows may not pick more than ``span`` items, except on residual mass
    that the exact chain (float64) has already exhausted: float32 roundoff
    left above MASS_EPS. Returns the count of such rows."""
    from repro_torch.kernels.phase2_select import MASS_EPS, cdf_at_step
    over = 0
    for b, row in enumerate(picks):
        if int((row >= 0).sum()) <= span:
            continue
        _, _, exact = cdf_at_step(us[b], G1[b], Gr[b],
                                  [int(x) for x in row[:span]])
        check(exact <= MASS_EPS, f"{label}: row {b} picks beyond the span "
              f"{span} with exact residual mass {exact!r}")
        over += 1
    print(f"  {label}: {over} rows picked past the span {span} on float32 "
          f"roundoff mass above MASS_EPS (exact mass <= MASS_EPS)")
    return over


def compare(us, k_eff, G1, Gr, label: str, span=None) -> dict:
    """Run the kernel and the plain version on the same inputs and hold
    them against each other (``compare_picks``)."""
    from repro_torch.kernels.phase2_select import (phase2_select_cuda,
                                                   phase2_select_plain)
    pk = phase2_select_cuda(us, k_eff, G1, Gr)
    pp = phase2_select_plain(us, k_eff, G1, Gr)
    torch.cuda.synchronize()
    return compare_picks(pk.cpu().numpy(), pp.cpu().numpy(), us, k_eff, G1,
                         Gr, label, span)


def compare_picks(pk_np, pp_np, us, k_eff, G1, Gr, label: str,
                  span=None) -> dict:
    """Check kernel picks ``pk_np`` and plain picks ``pp_np`` of the same
    inputs, and prove every differing row is a float32 roundoff tie on
    the exact chain (a CDF boundary, or the MASS_EPS stop threshold)."""
    from repro_torch.kernels.phase2_select import (first_difference,
                                                   is_roundoff_tie)
    ke = k_eff.cpu().numpy()
    N = int(G1.shape[1] * Gr.shape[1])
    check_rows(pk_np, ke, N, f"{label} kernel")
    check_rows(pp_np, ke, N, f"{label} plain")
    out = {}
    if span is not None:
        out["over_span_kernel"] = check_span(pk_np, us, G1, Gr, span,
                                             f"{label} kernel")
        out["over_span_plain"] = check_span(pp_np, us, G1, Gr, span,
                                            f"{label} plain")
    same = (pk_np == pp_np).all(axis=1)
    worst, ties = 0.0, {"boundary": 0, "collapse": 0}
    for b in np.nonzero(~same)[0]:
        t, kind, value = first_difference(us[b], G1[b], Gr[b], pk_np[b],
                                          pp_np[b])
        print(f"  {label}: row {b} differs first at step {t}: {kind} "
              f"{value!r}")
        check(is_roundoff_tie(kind, value), f"{label}: row {b} differs at "
              f"step {t} and is no roundoff tie ({kind} {value!r})")
        ties[kind] += 1
        if kind == "boundary":
            worst = max(worst, value)
    out.update({"rows": int(len(same)), "identical": int(same.sum()),
                "agree_rows": float(same.mean()), "max_boundary_gap": worst,
                "boundary_ties": ties["boundary"],
                "collapse_ties": ties["collapse"],
                "picks": int((pk_np >= 0).sum())})
    print(f"  {label}: {json.dumps(out)}")
    return out


def phase1_inputs(spec, k_max: int, B: int, gen):
    from repro_torch.kernels.phase2_select import canonical_pair
    from repro_torch.sampling.batched import _phase1_from_uniforms
    dev = spec.device
    u = torch.rand((B, spec.N), generator=gen, device=dev)
    us = torch.rand((B, k_max), generator=gen, device=dev)
    us, Gs, k_eff, _ = _phase1_from_uniforms(u, us, spec.lams, spec.vecs,
                                             k_max)
    G1, Gr = canonical_pair(Gs)
    return us.contiguous(), k_eff.contiguous(), G1.contiguous(), \
        Gr.contiguous()


# ---------------------------------------------------------------------------
# phase 6 helpers: time and bound
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(picks: np.ndarray, N1: int, Nr: int, k: int):
    """Least time (ms) for this data's work and what bounds it. Operations:
    the norms init (2Nk), per live step the scan and search (2N) and CGS2
    (8k²), and per downdated step (all but a row's last) 2Nk + 3N. Bytes:
    us, k_eff, G1 and Gr read once, picks written once."""
    N = N1 * Nr
    B = picks.shape[0]
    flops = 0.0
    for row in picks:
        s = int((row >= 0).sum())
        flops += 2.0 * N * k + s * (2.0 * N + 8.0 * k * k) \
            + max(s - 1, 0) * (2.0 * N * k + 3.0 * N)
    nbytes = 4.0 * (B * k + B + B * N1 * k + B * Nr * k) + 4.0 * B * k
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phases 7-11 helpers: partial traces and learning
# ---------------------------------------------------------------------------

PT_SHAPES = ((100, 100), (64, 150), (7, 13))


def pt_bound(N1: int, N2: int):
    """Least time (ms) of one partial trace and what bounds it. Bytes: Θ
    (N x N), the factor and the output, each once. Operations: one
    multiply and one add per element of Θ."""
    N = N1 * N2
    nbytes = 4.0 * (N * N + N1 * N1 + N2 * N2)
    t_ops, t_bytes = 2.0 * N * N / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_pt(got, want, tol, label: str) -> float:
    """Elementwise ``|got - want| <= tol``; returns max |got - want|."""
    err = (got - want).abs()
    bad = int((err > tol).sum())
    check(bad == 0, f"{label}: {bad} entries beyond tolerance, max |Δ| "
          f"{float(err.max())!r}")
    return float(err.max())


def check_partial_traces(gen, dev) -> dict:
    """Phase 7: both kernels against their plain versions on random
    non-symmetric inputs; returns max |Δ| per kernel and the main-shape
    inputs for timing."""
    from repro_torch.kernels import partial_trace as pt
    err = {"A": 0.0, "C": 0.0}
    main = None
    for N1, N2 in PT_SHAPES:
        N = N1 * N2
        t4 = torch.randn((N, N), generator=gen, device=dev).reshape(
            N1, N2, N1, N2)
        L1 = torch.randn((N1, N1), generator=gen, device=dev)
        L2 = torch.randn((N2, N2), generator=gen, device=dev)
        A = pt.partial_trace_A_cuda(t4, L2)
        C = pt.partial_trace_C_cuda(t4, L1)
        torch.cuda.synchronize()
        a4 = t4.abs()
        eA = check_pt(A, pt.partial_trace_A_plain(t4, L2),
                      1e-4 * pt.partial_trace_A_plain(a4, L2.abs()) + 1e-7,
                      f"partial_trace_A {N1}x{N2}")
        eC = check_pt(C, pt.partial_trace_C_plain(t4, L1),
                      1e-4 * pt.partial_trace_C_plain(a4, L1.abs()) + 1e-7,
                      f"partial_trace_C {N1}x{N2}")
        del a4
        print(f"  partial traces {N1}x{N2}: max |kernel - plain| A {eA!r}, "
              f"C {eC!r}")
        err["A"], err["C"] = max(err["A"], eA), max(err["C"], eC)
        if main is None:
            main = (t4, L1, L2)
    return {"err": err, "main": main}


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.obs as obs
    from repro_torch import dpp
    from repro_torch.core.dpp import marginal_kernel
    from repro_torch.kernels import _build
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.sampling.batched import (gather_factor_columns,
                                              sample_krondpp_batched)
    from repro_torch.sampling.spectral import SpectralCache

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    power_limit = smi.split(",")[-1].strip()
    dev = torch.device("cuda", 0)

    # -- 2. build: one nvcc per source, started together --------------------
    t0 = time.perf_counter()
    sources = ("phase2_select", "partial_trace")
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. kernel vs plain -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = SpectralCache()
    model = dpp.random_kron(gen, (100, 100), device=dev).rescale(20.0,
                                                                 cache)
    spec = model.spectrum(cache)
    k_max = spec.suggested_k_max()
    print(f"main shapes: N = 100 x 100, E|Y| = {spec.expected_size()!r}, "
          f"k_max = {k_max}")
    inputs = {B: phase1_inputs(spec, k_max, B, gen) for B in (1, 64)}
    agree = {}
    for B, (us, ke, G1, Gr) in inputs.items():
        agree[B] = compare(us, ke, G1, Gr, f"kron 100x100 B={B}")
    edges = []
    dense = dpp.from_kernel(
        dpp.random_kron(gen, (400,), device=dev).factors[0],
        device=dev).rescale(20.0, cache)
    s1 = dense.spectrum(cache)
    edges.append(compare(*phase1_inputs(s1, s1.suggested_k_max(), 64, gen),
                         "dense m=1 N=400 B=64"))
    m3 = dpp.random_kron(gen, (20, 20, 25), device=dev).rescale(20.0, cache)
    s3 = m3.spectrum(cache)
    edges.append(compare(*phase1_inputs(s3, s3.suggested_k_max(), 64, gen),
                         "kron m=3 20x20x25 B=64"))
    # degenerate columns: one eigen-index twice per row, so the span is
    # one short of k_eff; each row must stop there with a -1 tail
    kd = 12
    sel = torch.stack([torch.randperm(spec.N, generator=gen, device=dev)[:kd]
                       for _ in range(64)]).to(torch.int32)
    sel[:, 5] = sel[:, 4]
    valid = torch.ones((64, kd), dtype=torch.bool, device=dev)
    G1d, Grd = gather_factor_columns(spec.vecs, spec.sizes, sel, valid)
    usd = torch.rand((64, kd), generator=gen, device=dev)
    ked = torch.full((64,), kd, dtype=torch.int32, device=dev)
    edges.append(compare(usd, ked, G1d.contiguous(), Grd.contiguous(),
                         "degenerate columns B=64", span=kd - 1))

    # -- 4. statistics on the kernel path -----------------------------------
    small = dpp.random_kron(gen, (2, 3), device=dev)
    K = marginal_kernel(small.dense_kernel().double().cpu().numpy())
    picks, _, _ = sample_krondpp_batched(gen, small.spectrum(cache),
                                         num_samples=3000, backend="cuda")
    mem = np.zeros((3000, 6))
    for b, row in enumerate(picks.cpu().numpy()):
        mem[b, row[row >= 0]] = 1.0
    err = float(np.abs(mem.mean(0) - np.diag(K)).max())
    print(f"marginals (2,3), 3000 kernel draws: max |freq - K_ii| = {err!r}")
    check(err <= 0.05, f"marginals off by {err} > 0.05")

    # -- 5. the main path ---------------------------------------------------
    tracker = obs.InMemoryTracker()
    p2.launches = 0
    with obs.use(tracker):
        gen_main = torch.Generator(device=dev).manual_seed(1)
        main = dpp.random_kron(gen_main, (100, 100)).rescale(20.0)
        svc = main.service(seed=0)
        tickets = [svc.submit(n) for n in (1, 4, 16, 64, 200)]
        with svc._lock:                 # the flush's uniforms, replayed below
            flush_state = svc._generator.get_state()
        svc.flush()
        torch.cuda.synchronize()
    launches = p2.launches
    cuda_count = int(tracker.counter_value("kernels.phase2_select.cuda"))
    rows = [r for t in tickets for r in t.result()]
    e_size = svc.spectrum.expected_size()
    print(f"main path: {len(rows)} rows, k_max {svc.k_max}, E|Y| "
          f"{e_size!r}, launches {launches}, kernels.phase2_select.cuda "
          f"{cuda_count}, stats {svc.stats()}")
    check(len(rows) == 285, f"service returned {len(rows)} rows, not 285")
    for r in rows:
        check(len(set(r)) == len(r), f"service row repeats an item: {r}")
        check(all(0 <= i < main.N for i in r), "service row out of range")
        check(len(r) <= svc.k_max, "service row longer than k_max")
    mean_size = float(np.mean([len(r) for r in rows]))
    print(f"main path: mean |Y| {mean_size!r} vs E|Y| {e_size!r}")
    check(abs(mean_size - e_size) <= 1.0, "mean |Y| is not within 1 of E|Y|")
    check(launches > 0, "the main path never launched the phase-2 kernel")
    check(cuda_count > 0, "kernels.phase2_select.cuda was not counted")
    # the main path's own launch against the plain version: replay the
    # flush's draw (one call at the rounded-up batch) from the saved
    # generator state, run phase 1 and the plain phase 2 on it, and hold
    # the served rows against the plain rows of the same uniforms
    stats = svc.stats()
    check(stats["device_calls"] == 1, f"the flush made {stats} calls, not 1")
    B_main = stats["samples_drawn"]
    replay = torch.Generator(device=dev)
    replay.set_state(flush_state)
    us_m, ke_m, G1_m, Gr_m = phase1_inputs(svc.spectrum, svc.k_max, B_main,
                                           replay)
    pp_m = p2.phase2_select_plain(us_m, ke_m, G1_m, Gr_m)[:len(rows)]
    pk_m = np.full((len(rows), svc.k_max), -1, dtype=np.int32)
    for b, r in enumerate(rows):
        pk_m[b, :len(r)] = r
    n = len(rows)
    agree_main = compare_picks(pk_m, pp_m.cpu().numpy(), us_m[:n], ke_m[:n],
                               G1_m[:n], Gr_m[:n],
                               f"main path B={B_main} (rows served)")

    # -- 6. times -----------------------------------------------------------
    times = {}
    for B, (us, ke, G1, Gr) in inputs.items():
        picks_k = p2.phase2_select_cuda(us, ke, G1, Gr).cpu().numpy()
        plain1 = cuda_ms(lambda: p2.phase2_select_plain(us, ke, G1, Gr),
                         reps=5, warmup=1)
        kern = cuda_ms(lambda: p2.phase2_select_cuda(us, ke, G1, Gr),
                       reps=20, warmup=3)
        plain2 = cuda_ms(lambda: p2.phase2_select_plain(us, ke, G1, Gr),
                         reps=5, warmup=0)
        b_ms, b_by = bound(picks_k, int(G1.shape[1]), int(Gr.shape[1]),
                           k_max)
        times[B] = {"ms": kern, "plain_ms": min(plain1, plain2),
                    "plain_runs_ms": [plain1, plain2], "bound_ms": b_ms,
                    "bound_by": b_by,
                    "live_steps": int((picks_k >= 0).sum()),
                    "max_row_steps": int((picks_k >= 0).sum(axis=1).max())}
        print(f"  phase2_select B={B}: {json.dumps(times[B])}")
    svc.sample(16)                              # warm the request path
    req = []
    for _ in range(5):
        t0 = time.perf_counter()
        svc.sample(16)
        torch.cuda.synchronize()
        req.append((time.perf_counter() - t0) * 1e3)

    # -- 7. partial-trace kernels vs plain ----------------------------------
    from repro_torch.core.dpp import (SubsetBatch, identity_padded,
                                      masked_inv_and_logdet, scatter_theta)
    from repro_torch.core.krk_picard import (AC_from_dense_theta,
                                             _subset_blocks, accumulate_AC,
                                             theta_matrix_kron)
    from repro_torch.learning.objective import log_likelihood_factored
    from repro_torch.kernels import partial_trace as pt
    from repro_torch.learning import schedules
    pt_check = check_partial_traces(gen, dev)

    # -- 8. data for the fit ------------------------------------------------
    fit_rows = [r for r in main.service(seed=2).sample(1000) if r]
    batch = SubsetBatch.from_lists(fit_rows, device=dev)
    init = dpp.random_kron(torch.Generator(device=dev).manual_seed(2),
                           (100, 100))
    L1, L2 = init.factors
    print(f"fit data: n = {batch.n} subsets, k_max {batch.k_max}, mean "
          f"|Y| {float(batch.sizes().float().mean())!r}")

    # -- 9. the routes agree at the init -------------------------------------
    theta = theta_matrix_kron(L1, L2, batch)
    A_k, C_k = AC_from_dense_theta(theta, L1, L2)
    A_r, C_r = AC_from_dense_theta(theta, L1, L2, backend="reference")
    A_s, C_s = accumulate_AC(L1, L2, batch)
    torch.cuda.synchronize()
    N1, N2 = init.sizes
    t4a = theta.abs().reshape(N1, N2, N1, N2)
    pt_check["err"]["A"] = max(pt_check["err"]["A"], check_pt(
        A_k, A_r, 1e-4 * pt.partial_trace_A_plain(t4a, L2.abs()) + 1e-7,
        "init A: kernel vs plain"))
    pt_check["err"]["C"] = max(pt_check["err"]["C"], check_pt(
        C_k, C_r, 1e-4 * pt.partial_trace_C_plain(t4a, L1.abs()) + 1e-7,
        "init C: kernel vs plain"))
    del t4a
    routes = {"A_kernel_vs_subset": max_rel(A_k, A_s),
              "C_kernel_vs_subset": max_rel(C_k, C_s),
              "A_plain_vs_subset": max_rel(A_r, A_s),
              "C_plain_vs_subset": max_rel(C_r, C_s)}
    print(f"routes at init (max |Δ| / max |ref|): {json.dumps(routes)}")
    for k, v in routes.items():
        check(v <= 1e-4, f"routes at init: {k} {v!r} > 1e-4")

    # -- 10. the learning main path ------------------------------------------
    fit_kw = dict(algorithm="krk", use_dense_theta=True,
                  schedule=schedules.armijo(a0=1.5), iters=5, log_every=5)
    init.fit(batch, **dict(fit_kw, iters=1))   # warm-up: cuSOLVER, caches
    fit_tracker = obs.InMemoryTracker()
    pt.partial_trace_A_cuda.launches = 0
    pt.partial_trace_C_cuda.launches = 0
    with obs.use(fit_tracker):
        rep = init.fit(batch, **fit_kw)
        torch.cuda.synchronize()
    fit_launches = {"A": pt.partial_trace_A_cuda.launches,
                    "C": pt.partial_trace_C_cuda.launches}
    fit_counts = {k: int(fit_tracker.counter_value(
        f"kernels.partial_trace_{k}.cuda")) for k in ("A", "C")}
    lls = rep.log_likelihoods
    print(f"fit: LL {lls}, accepted a {float(rep.state.sched.a)!r}, "
          f"backtracks {int(rep.state.sched.backtracks)}, launches "
          f"{fit_launches}, counters {fit_counts}, health "
          f"{rep.health and rep.health['verdict']}, sweep times "
          f"{rep.sweep_times}")
    check(fit_launches == {"A": 5, "C": 10}, f"the fit launched the "
          f"partial traces {fit_launches} times, not A 5 and C 10")
    check(fit_counts == fit_launches, f"kernels.partial_trace_*.cuda "
          f"{fit_counts} do not match the launches {fit_launches}")
    check(not any(fit_tracker.counter_value(
        f"kernels.partial_trace_{k}.reference") for k in ("A", "C")),
        "the fit took a plain partial trace on the card")
    from repro_torch.learning.schedules import _ASCENT_TOL
    steps = np.diff(lls)
    check(len(lls) == 6 and np.isfinite(lls).all(), f"LL track {lls}")
    check(bool((steps >= -_ASCENT_TOL).all()), f"the LL fell by more than "
          f"{_ASCENT_TOL} in a sweep: {lls}")
    check(lls[-1] > lls[0], f"final LL {lls[-1]} not above init {lls[0]}")
    min_eigs = [float(torch.linalg.eigvalsh(f)[0]) for f in
                rep.model.factors]
    check(min(min_eigs) > 0, f"a learned factor is not PD: {min_eigs}")
    check(rep.health is not None, "FitReport.health is missing")
    rep_p = init.fit(batch, backend="reference", **fit_kw)
    torch.cuda.synchronize()
    fit_agree = {"lls_plain": rep_p.log_likelihoods,
                 "a": [float(rep.state.sched.a), float(rep_p.state.sched.a)],
                 "backtracks": [int(rep.state.sched.backtracks),
                                int(rep_p.state.sched.backtracks)],
                 "factor_max_rel": [max_rel(f, g) for f, g in
                                    zip(rep.model.factors,
                                        rep_p.model.factors)]}
    print(f"fit with plain partial traces: {json.dumps(fit_agree)}")
    check(fit_agree["a"][0] == fit_agree["a"][1]
          and fit_agree["backtracks"][0] == fit_agree["backtracks"][1],
          f"kernel and plain fits accepted other steps: {fit_agree}")
    check(np.allclose(lls, rep_p.log_likelihoods, rtol=1e-4, atol=0.0),
          f"kernel and plain fits' LLs differ: {lls} vs "
          f"{rep_p.log_likelihoods}")
    check(max(fit_agree["factor_max_rel"]) <= 1e-3,
          f"kernel and plain fits' factors differ: {fit_agree}")

    # -- 11. times ------------------------------------------------------------
    t4, L1r, L2r = pt_check["main"]
    pt_times = {}
    for k, kern, plain, lib, L in (
            ("A", pt.partial_trace_A_cuda, pt.partial_trace_A_plain,
             "kulv,vu->kl", L2r),
            ("C", pt.partial_trace_C_cuda, pt.partial_trace_C_plain,
             "iujv,ij->uv", L1r)):
        plain1 = cuda_ms(lambda: plain(t4, L), reps=5, warmup=1)
        kern_ms = cuda_ms(lambda: kern(t4, L), reps=20, warmup=3)
        lib_ms = cuda_ms(lambda: torch.einsum(lib, t4, L), reps=5, warmup=1)
        plain2 = cuda_ms(lambda: plain(t4, L), reps=5, warmup=0)
        b_ms, b_by = pt_bound(*PT_SHAPES[0])
        pt_times[k] = {"ms": kern_ms, "plain_ms": min(plain1, plain2),
                       "plain_runs_ms": [plain1, plain2],
                       "library_ms": lib_ms, "bound_ms": b_ms,
                       "bound_by": b_by}
        print(f"  partial_trace_{k} {PT_SHAPES[0]}: "
              f"{json.dumps(pt_times[k])}")
    theta_ms = cuda_ms(lambda: theta_matrix_kron(L1, L2, batch), reps=5,
                       warmup=1)
    # where a sweep's time goes: the Θ build's steps, a factor eigh, and
    # one log-likelihood (each Armijo trial evaluates one)
    _, _, B1, B2 = _subset_blocks(L1, L2, batch)
    sub = identity_padded(B1 * B2, batch.mask)
    chol, _ = torch.linalg.cholesky_ex(sub)
    eye = torch.eye(batch.k_max, device=dev).expand_as(sub)
    inv, _ = masked_inv_and_logdet(sub)
    parts = {
        "gather": lambda: identity_padded(
            torch.mul(*_subset_blocks(L1, L2, batch)[2:]), batch.mask),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(sub),
        "cholesky_solve": lambda: torch.cholesky_solve(eye, chol),
        "scatter": lambda: scatter_theta(L1.shape[0] * L2.shape[0],
                                         batch.indices, batch.mask, inv),
        "factor_eigh": lambda: torch.linalg.eigh(L1),
        "log_likelihood": lambda: log_likelihood_factored((L1, L2), batch)}
    breakdown = {k: cuda_ms(f, reps=5, warmup=1) for k, f in parts.items()}
    print(f"  breakdown (ms): {json.dumps(breakdown)}")
    learn_timing = {
        "theta_build_ms": theta_ms, "breakdown_ms": breakdown,
        "sweep_ms_kernel": rep.sweep_times[0] * 1e3 / 5,
        "sweep_ms_plain": rep_p.sweep_times[0] * 1e3 / 5,
        "fit_n": batch.n, "fit_k_max": batch.k_max,
        "backtracks": int(rep.state.sched.backtracks),
        "pt_shape": PT_SHAPES[0], "partial_trace_A": pt_times["A"],
        "partial_trace_C": pt_times["C"]}

    row = {"name": "phase2_select", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/phase2_select.cu",
           "replaces": "src/repro/kernels/phase2_select.py:172",
           "launches": launches,
           "max_abs_err": max(a["max_boundary_gap"] for a in
                              [*agree.values(), *edges, agree_main]),
           "ms": times[64]["ms"], "plain_ms": times[64]["plain_ms"],
           "bound_ms": times[64]["bound_ms"],
           "bound_by": times[64]["bound_by"], "library_ms": None,
           "agree_rows": agree[64]["agree_rows"],
           "kernel_ms": times[64]["ms"],
           "shapes": {"N1": 100, "Nr": 100, "k_max": k_max, "B": 64},
           "b1": times[1], "agree_rows_b1": agree[1]["agree_rows"],
           "agree_rows_main_path": agree_main["agree_rows"],
           "card": card, "power_limit": power_limit}
    pt_rows = [{"name": f"partial_trace_{k}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/partial_trace.cu",
                "replaces": f"src/repro/kernels/partial_trace.py:{line}",
                "launches": fit_launches[k],
                "max_abs_err": pt_check["err"][k],
                "ms": pt_times[k]["ms"], "plain_ms": pt_times[k]["plain_ms"],
                "bound_ms": pt_times[k]["bound_ms"],
                "bound_by": pt_times[k]["bound_by"],
                "library_ms": pt_times[k]["library_ms"],
                "shapes": {"N1": PT_SHAPES[0][0], "N2": PT_SHAPES[0][1]},
                "card": card, "power_limit": power_limit}
               for k, line in (("A", 51), ("C", 72))]
    print(json.dumps({"learning_timing": learn_timing, "card": card,
                      "power_limit": power_limit}))
    print(json.dumps({"kernels": [row, *pt_rows]}))
    print(json.dumps({"timing": {"svc_sample16_ms": req,
                                 "svc_sample16_median_ms":
                                     float(np.median(req)),
                                 "phase2_select_b64": times[64],
                                 "phase2_select_b1": times[1]},
                      "card": card, "power_limit": power_limit}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
