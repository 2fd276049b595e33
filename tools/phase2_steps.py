"""Where one step of the phase-2 kernels spends its time.

Builds a copy of ``src/repro_torch/kernels/csrc/phase2_select.cu`` with
``clock64()`` marks at the phase boundaries (read by thread 0, each right
after a barrier) into ``build/phase2_steps/`` and prints, for the sample
with the most steps, the SM cycles a step spends in each phase:

- ``downdate``: the downdate of the norms (from the end of a step's CGS2
  to the barrier that opens the next step);
- ``scan_sum``: the sum of each thread's chunk of the norms (on the
  global route it is summed in the downdate's pass), then the block scan
  of the partials, and on the cluster route the exchange of the CTAs'
  sums;
- ``walk_pick``: each thread walks its chunk for the CDF crossing, then
  the block's pick (and on the cluster route the exchange of the CTAs'
  picks);
- ``gather_cgs2``: the gathered row, two Gram-Schmidt passes, the norm and
  the new basis column (on the cluster route, three exchanges);
- ``init``: the factors' copy into shared memory (the on-chip and cluster
  routes) and the first norms.

Kernels and shapes:

- ``phase2_select_kernel_onchip`` at the main path's shape (N = 100 x
  100, E|Y| = 20, k_max 46) for B = 1 and B = 64;
- ``phase2_select_kernel`` (route "global") and
  ``phase2_select_kernel_cluster`` (route "cluster"; the marks of the
  rank-0 CTA) at a KV head's shape: m = 1, N = 1024, k = 192, B = 1, every
  step live (G1 has orthonormal columns, as a k-DPP's eigenvectors do).

The global route's marks add one barrier a step before the first mark
(its downdate and scan have none between them).

Needs one CUDA card and nvcc. Run from the root of the checkout:

    python3 tools/phase2_steps.py

Prints one JSON line per kernel and batch size and the card's name, power
limit and SM clock.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import phase1_inputs  # noqa: E402
from repro_torch import dpp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import phase2_select as p2  # noqa: E402
from repro_torch.sampling.spectral import SpectralCache  # noqa: E402

PHASES = ("downdate", "scan_sum", "walk_pick", "gather_cgs2", "init")

#: The instrumented kernels, in the order of their block of ``g_steps``.
KERNELS = ("on_chip", "global", "cluster")

#: A KV head's phase-2 shape (``chip_smoke.py`` phase 21): N1, Nr, k.
KV_SHAPE = (1024, 1, 192)

HEAD = (
    "namespace {\n",
    "__device__ unsigned long long g_steps[3][8 * 4096];\n"
    "#define MARK(i) if (threadIdx.x == 0) { const unsigned long long n_ = "
    "clock64(); p_acc[i] += n_ - p_last; p_last = n_; }\n"
    "#define MARKS_BEGIN unsigned long long p_last = clock64(), "
    "p_acc[5] = {0, 0, 0, 0, 0}; int p_steps = 0;\n"
    "#define MARKS_END(kern, row) if (threadIdx.x == 0) { for (int i_ = 0; "
    "i_ < 5; ++i_) g_steps[kern][(row) * 8 + i_] = p_acc[i_]; "
    "g_steps[kern][(row) * 8 + 5] = p_steps; }\n")

# (anchor in the kernel's source, text put after it), by kernel: each
# anchor occurs once in the file. MARK(i) adds the cycles since the
# previous mark to phase i.
MARKS = {
    "on_chip": (
        ("  // the factors, transposed and zero-padded, once (coalesced "
         "reads)\n",
         "  MARKS_BEGIN\n"),
        ("    __syncthreads();                  // the norms of this step are "
         "written\n",
         "    MARK(t == 0 ? 4 : 0);\n    ++p_steps;\n"),
        ("    const float off = block_exclusive_scan(part, red, &total);\n"
         "    if (!(total > kMassEps)) break;   // collapsed: this slot and "
         "later stay -1\n    const float r = u[t] * total;\n"
         "    int cand = INT_MAX;\n",
         "    MARK(1);\n"),
        ("    const int pick = block_pick(cand, lastpos, redi);   // a grid "
         "cell\n",
         "    MARK(2);\n"),
        ("    if (tid == 0) pk[t] = p1 * Nr + pr;\n    __syncthreads();\n",
         "    MARK(3);\n"),
        ("    tile_pass<TN, false>(g1t, grt, norms, q, k, g, pick);\n  }\n",
         "  MARKS_END(0, b)\n"),
    ),
    "global": (
        ("  const int ke = max(0, min(keff[b], k));\n\n"
         "  for (int j = tid; j < k; j += nt) pk[j] = -1;\n",
         "  MARKS_BEGIN\n"),
        ("  for (int t = 0; t < ke; ++t) {\n    float total;\n",
         "    __syncthreads();\n    MARK(t == 0 ? 4 : 0);\n    ++p_steps;\n"),
        ("    const float r = u[t] * total;\n"
         "    int cand = INT_MAX, lastpos = -1;\n",
         "    MARK(1);\n"),
        ("    const int pick = block_pick(cand, lastpos, redi);\n"
         "    const int p1 = pick / Nr, pr = pick - p1 * Nr;\n",
         "    MARK(2);\n"),
        ("    if (tid == 0) pk[t] = pick;\n    __syncthreads();\n",
         "    MARK(3);\n"),
        ("      norms[x] = v;\n      part += v;\n    }\n  }\n",
         "  MARKS_END(1, b)\n"),
    ),
    "cluster": (
        ("  // this CTA's slice of G1, transposed and zero-padded, once\n",
         "  MARKS_BEGIN\n"),
        ("    __syncthreads();                  // this step's norms are "
         "written\n",
         "    MARK(t == 0 ? 4 : 0);\n    ++p_steps;\n"),
        ("    const float r = u[t] * total;   // the same bits in every CTA\n",
         "    MARK(1);\n"),
        ("    const int item = pc != INT_MAX ? pc : pl;   // an item of the "
         "sample\n",
         "    MARK(2);\n"),
        ("    if (rank == 0 && tid == 0) pk[t] = item;\n    __syncthreads();\n",
         "    MARK(3);\n"),
        ("  }\n  cluster.sync();                     // no CTA leaves while "
         "others read it\n",
         "  if (rank == 0) MARKS_END(2, b)\n"),
    ),
}


def instrumented_source() -> str:
    src = _build.source_path("phase2_select").read_text()
    edits = [HEAD] + [m for kern in KERNELS for m in MARKS[kern]]
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src + ('\nextern "C" int steps_read(unsigned long long* h, int n) '
                  '{\n  return static_cast<int>(cudaMemcpyFromSymbol(h, '
                  'g_steps, n * 8));\n}\n')


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "phase2_steps"
    out.mkdir(parents=True, exist_ok=True)
    (out / "phase2_steps.cu").write_text(instrumented_source())
    lib = out / "libphase2_steps.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "phase2_steps.cu")], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    p2.bind(so)
    so.steps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def kv_head_inputs(dev, gen):
    """Phase 2's inputs at a KV head's shape: G1 (1, N, k) with orthonormal
    columns, Gr a ones column, every step live."""
    N, _, k = KV_SHAPE
    a = torch.randn((N, k), generator=gen, device=dev, dtype=torch.float64)
    G1 = torch.linalg.qr(a)[0].float()[None].contiguous()
    Gr = torch.ones((1, 1, k), device=dev)
    us = torch.rand((1, k), generator=gen, device=dev)
    ke = torch.full((1,), k, dtype=torch.int32, device=dev)
    return us, ke, G1, Gr


def run(lib, kern: str, inputs, stream) -> dict:
    """Launch ``kern`` on ``inputs`` three times, read the last launch's
    marks and return the per-step cycles of its longest sample."""
    us, ke, G1, Gr = inputs
    B, k = int(us.shape[0]), int(us.shape[1])
    N1, Nr = int(G1.shape[1]), int(Gr.shape[1])
    route = p2.ROUTES.index(kern)
    scratch = None
    if kern == "global":
        scratch = torch.empty(B * N1 * Nr, dtype=torch.float32,
                              device=us.device)
    picks = torch.empty((B, k), dtype=torch.int32, device=us.device)
    for _ in range(3):             # the last launch's marks are read
        rc = lib.phase2_select_launch(
            us.data_ptr(), ke.data_ptr(), G1.data_ptr(), Gr.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            picks.data_ptr(), B, N1, Nr, k, p2.THREADS, route, stream)
        if rc != 0:
            sys.exit(f"{kern} launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
    want = p2.phase2_select_plain(us, ke, G1, Gr)
    h = np.zeros(3 * 8 * 4096, np.uint64)
    if lib.steps_read(h.ctypes.data, h.size) != 0:
        sys.exit("reading the marks failed")
    h = h.reshape(3, 4096, 8)[KERNELS.index(kern), :B].astype(np.float64)
    b = int(np.argmax(h[:, 5]))
    steps = int(h[b, 5])
    total = float(h[b, :5].sum())
    # a row's last step downdates nothing; init runs once
    per_step = {n: float(h[b, i]) / max(steps - (n == "downdate"), 1)
                for i, n in enumerate(PHASES[:4])}
    return {"kernel": kern, "shape": [N1, Nr, k], "B": B, "block": b,
            "steps": steps, "cycles": total, "cycles_per_step": per_step,
            "init_cycles": float(h[b, 4]),
            "share": {n: float(h[b, i]) / total
                      for i, n in enumerate(PHASES)},
            "rows_equal_to_plain": int((picks == want).all(1).sum())}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/phase2_steps.py needs a CUDA card")
    lib = build()
    limit = ctypes.c_int(0)
    if lib.phase2_select_prepare(ctypes.byref(limit)) != 0:
        sys.exit("phase2_select_prepare failed")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = SpectralCache()
    spec = dpp.random_kron(gen, (100, 100), device=dev).rescale(
        20.0, cache).spectrum(cache)
    k_max = spec.suggested_k_max()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B in (1, 64):
        print(json.dumps(run(lib, "on_chip",
                             phase1_inputs(spec, k_max, B, gen), stream)))
    kv = kv_head_inputs(dev, gen)
    for kern in ("global", "cluster"):
        print(json.dumps(run(lib, kern, kv, stream)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
