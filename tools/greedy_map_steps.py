"""Where one step of the fused greedy-MAP kernel spends its time.

Builds a copy of ``src/repro_torch/kernels/csrc/greedy_map.cu`` with
``clock64()`` marks at the phase boundaries of ``greedy_map_kdpp_kernel``
(read by thread 0 of every CTA) into ``build/greedy_map_steps/``, runs it at
the shapes of the main paths (an LM unit of 4 heads, N = 512, k = 120; one
matrix of N = 10^4 at k = 20 and k = 200, random PSD kernels from a seed),
and prints, for CTA 0 of matrix 0 and as the mean over all CTAs, the SM
cycles a step spends in each phase:

- ``cta_best``: the warps' bests, one block barrier, warp 0's reduction and
  the candidate's stores into every CTA's inbox (it also absorbs the wait
  for the slowest thread of the previous step's update);
- ``cluster_barrier``: the cluster barrier;
- ``winner``: the CTAs' candidates read from the inbox and reduced;
- ``gather``: L[:, j] of the CTA's items (cp.async) and C[j, :t], then a
  block barrier;
- ``update``: the dot over the live prefix and the items' update (to the
  top of the next step);
- ``init``: the diagonal's maximum, the first d and the start barrier.

Needs one CUDA card and nvcc. Run from the root of the checkout:

    python3 tools/greedy_map_steps.py

Prints one JSON line per shape and the card's name, power limit and SM
clock.
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import greedy_map as gm  # noqa: E402

PHASES = ("cta_best", "cluster_barrier", "winner", "gather", "update",
          "init")
SHAPES = ((512, 120, 4), (10_000, 20, 1), (10_000, 200, 1))   # N, k, H

# (text of the kernel's source, the text that replaces it): each occurs
# once. MARK(i) adds the cycles since the previous mark to phase i.
MARKS = (
    ("constexpr int kMapStaticSmem = 1024;",
     "constexpr int kMapStaticSmem = 1024;\n"
     "__device__ unsigned long long g_steps[8 * 4096];\n"
     "#define MARK(i) if (threadIdx.x == 0) { const unsigned long long n_ = "
     "clock64(); p_acc[i] += n_ - p_last; p_last = n_; }"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  unsigned long long p_last = clock64(), p_acc[6] = {0, 0, 0, 0, 0, "
     "0};\n  int p_steps = 0;\n"),
    ("    // 1. this CTA's candidate\n",
     "    // 1. this CTA's candidate\n    MARK(t == 0 ? 5 : 4);\n"
     "    ++p_steps;\n"),
    ("    // 2. the cluster's winner, in every warp, from this CTA's inbox\n",
     "    // 2. the cluster's winner, in every warp, from this CTA's inbox\n"
     "    MARK(0);\n"),
    ("    Cand w = {0ull, 0.f, 0.f};\n    if (lane < cs)",
     "    MARK(1);\n    Cand w = {0ull, 0.f, 0.f};\n    if (lane < cs)"),
    ("    if (rank == 0 && tid == 0) ph[t] = j;\n",
     "    if (rank == 0 && tid == 0) ph[t] = j;\n    MARK(2);\n"),
    ("    // 4. the update of this CTA's items, and their next best\n",
     "    // 4. the update of this CTA's items, and their next best\n"
     "    MARK(3);\n"),
    ("  cluster.sync();                     // no CTA leaves while others "
     "read it\n",
     "  MARK(4);\n  if (tid == 0) {\n    for (int i = 0; i < 6; ++i) "
     "g_steps[blockIdx.x * 8 + i] = p_acc[i];\n"
     "    g_steps[blockIdx.x * 8 + 6] = p_steps;\n  }\n"
     "  cluster.sync();                     // no CTA leaves while others "
     "read it\n"),
)


def instrumented_source() -> str:
    src = _build.source_path("greedy_map").read_text()
    for old, new in MARKS:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + ('\nextern "C" int steps_read(unsigned long long* h, int n) '
                  '{\n  return static_cast<int>(cudaMemcpyFromSymbol(h, '
                  'g_steps, n * 8));\n}\n')


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "greedy_map_steps"
    out.mkdir(parents=True, exist_ok=True)
    (out / "greedy_map_steps.cu").write_text(instrumented_source())
    lib = out / "libgreedy_map_steps.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "greedy_map_steps.cu")], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    gm.bind(so)
    so.steps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/greedy_map_steps.py needs a CUDA card")
    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for N, k, H in SHAPES:
        r = min(N, k + 8)
        X = torch.randn((H, N, r), generator=gen, device=dev)
        L = torch.baddbmm(0.1 * torch.eye(N, device=dev).expand(H, N, N), X,
                          X.transpose(1, 2), alpha=1.0 / r)
        plan = (ctypes.c_int * 8)()
        if lib.greedy_map_kdpp_plan(N, k, plan) != 0:
            sys.exit(f"no plan at N = {N}, k = {k}")
        cs, c_smem, stride = plan[0], plan[1], plan[7]
        C = None if c_smem else torch.empty((H, k, stride), device=dev)
        picks = torch.empty((H, k), dtype=torch.int32, device=dev)
        for _ in range(3):             # the last launch's marks are read
            rc = lib.greedy_map_kdpp_launch(
                L.data_ptr(), None if C is None else C.data_ptr(),
                picks.data_ptr(), H, N, k, cs, c_smem, stream)
            if rc != 0:
                sys.exit(f"launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
        n = 8 * cs * H
        h = np.zeros(n, np.uint64)
        if lib.steps_read(h.ctypes.data, n) != 0:
            sys.exit("reading the marks failed")
        h = h.reshape(cs * H, 8).astype(np.float64)
        same = bool(torch.equal(picks, gm.greedy_map_kdpp_plain(L, k)))
        step = {name: float(h[0, i]) / k
                for i, name in enumerate(PHASES[:5])}
        mean = {name: float(h[:, i].mean()) / k
                for i, name in enumerate(PHASES[:5])}
        print(json.dumps({"N": N, "k": k, "H": H, "cluster": cs,
                          "c_in_smem": bool(c_smem),
                          "steps": int(h[0, 6]),
                          "cycles_per_step_cta0": step,
                          "cycles_per_step_mean": mean,
                          "step_cycles_cta0": sum(step.values()),
                          "init_cycles_cta0": float(h[0, 5]),
                          "picks_equal_plain": same}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
