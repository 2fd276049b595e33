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
   ``svc.sample(16)`` request on the host clock.

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

The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the kernel table and the timing line as JSON, each with the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build("phase2_select")
    print(f"build: phase2_select in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line:
            print(f"  phase2_select: {line.strip()}")

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
    print(json.dumps({"kernels": [row]}))
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
