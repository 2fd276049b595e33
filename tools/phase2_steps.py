"""Where one step of the on-chip phase-2 kernel spends its time.

Builds a copy of ``src/repro_torch/kernels/csrc/phase2_select.cu`` with
``clock64()`` marks at the phase boundaries of
``phase2_select_kernel_onchip`` (read by thread 0, each right after a
barrier) into ``build/phase2_steps/``, runs it at the main path's shape
(N = 100 x 100, E|Y| = 20, k_max 46) for B = 1 and B = 64, and prints, for
the block with the most steps, the SM cycles a step spends in each phase:

- ``downdate``: the register-tiled downdate of the norms (from the end of
  a step's CGS2 to the barrier that opens the next step);
- ``scan_sum``: each thread sums its chunk of the norms, then the block
  scan of the partials;
- ``walk_pick``: each thread walks its chunk for the CDF crossing, then
  the block's pick;
- ``gather_cgs2``: the gathered row, two Gram-Schmidt passes, the norm and
  the new basis column;
- ``init``: the factors' copy into shared memory and the first norms.

Needs one CUDA card and nvcc. Run from the root of the checkout:

    python3 tools/phase2_steps.py

Prints one JSON line per batch size and the card's name, power limit and
SM clock.
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

# (anchor in the kernel's source, text put after it): each anchor occurs
# once. MARK(i) adds the cycles since the previous mark to phase i.
MARKS = (
    ("namespace {\n",
     "__device__ unsigned long long g_steps[8 * 4096];\n"
     "#define MARK(i) if (threadIdx.x == 0) { const unsigned long long n_ = "
     "clock64(); p_acc[i] += n_ - p_last; p_last = n_; }\n"),
    ("  // the factors, transposed and zero-padded, once (coalesced reads)\n",
     "  unsigned long long p_last = clock64(), p_acc[5] = {0, 0, 0, 0, 0};\n"
     "  int p_steps = 0;\n"),
    ("    __syncthreads();                  // the norms of this step are "
     "written\n",
     "    MARK(t == 0 ? 4 : 0);\n    ++p_steps;\n"),
    ("    const float off = block_exclusive_scan(part, red, &total);\n"
     "    if (!(total > kMassEps)) break;   // collapsed: this slot and later "
     "stay -1\n    const float r = u[t] * total;\n    int cand = INT_MAX;\n",
     "    MARK(1);\n"),
    ("    const int pick = block_pick(cand, lastpos, redi);   // a grid "
     "cell\n",
     "    MARK(2);\n"),
    ("    if (tid == 0) pk[t] = p1 * Nr + pr;\n    __syncthreads();\n",
     "    MARK(3);\n"),
    ("    tile_pass<TN, false>(g1t, grt, norms, q, k, g, pick);\n  }\n",
     "  if (tid == 0) {\n    for (int i = 0; i < 5; ++i) "
     "g_steps[b * 8 + i] = p_acc[i];\n    g_steps[b * 8 + 5] = p_steps;\n"
     "  }\n"),
)


def instrumented_source() -> str:
    src = _build.source_path("phase2_select").read_text()
    for anchor, text in MARKS:
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
        us, ke, G1, Gr = phase1_inputs(spec, k_max, B, gen)
        picks = torch.empty((B, k_max), dtype=torch.int32, device=dev)
        for _ in range(3):             # the last launch's marks are read
            rc = lib.phase2_select_launch(
                us.data_ptr(), ke.data_ptr(), G1.data_ptr(), Gr.data_ptr(),
                None, picks.data_ptr(), B, 100, 100, k_max, p2.THREADS,
                p2.ROUTES.index("on_chip"), stream)
            if rc != 0:
                sys.exit(f"launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
        h = np.zeros(8 * B, np.uint64)
        if lib.steps_read(h.ctypes.data, 8 * B) != 0:
            sys.exit("reading the marks failed")
        h = h.reshape(B, 8).astype(np.float64)
        b = int(np.argmax(h[:, 5]))
        steps = int(h[b, 5])
        total = float(h[b, :5].sum())
        # a row's last step downdates nothing; init runs once
        per_step = {n: float(h[b, i]) / max(steps - (n == "downdate"), 1)
                    for i, n in enumerate(PHASES[:4])}
        print(json.dumps({"B": B, "block": b, "steps": steps,
                          "cycles": total, "cycles_per_step": per_step,
                          "init_cycles": float(h[b, 4]),
                          "share": {n: float(h[b, i]) / total
                                    for i, n in enumerate(PHASES)}}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
