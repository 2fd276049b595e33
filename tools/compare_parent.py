"""A parent commit's phase-2 and Kronecker-matvec kernels against this
checkout's, on one card, in one process.

The parent's two sources go into a directory first, so that the script
needs no git where it runs; e.g. from the root of the checkout:

    mkdir -p build/parent
    git show HEAD~1:src/repro_torch/kernels/csrc/phase2_select.cu \
        > build/parent/phase2_select.cu
    git show HEAD~1:src/repro_torch/kernels/csrc/kron_matvec.cu \
        > build/parent/kron_matvec.cu
    python3 tools/compare_parent.py build/parent

Both are built with nvcc beside them. At the main path's shapes (phase 2
at N = 100 x 100, E|Y| = 20, k_max 46, B = 64 and 1; ``kron_matvec`` at
100 x 100, batch 64, float32 and bfloat16, and the eigenvector path's
one-hot batch of 46) each pair runs in turns, parent, change, change,
parent, and ``chip_smoke.device_ms`` takes the device time of each turn.
The parent's phase-2 launcher takes no route (it has the global route
only). Prints one JSON line with every turn's time, the card's name and
its power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import device_ms, km_inputs, phase1_inputs  # noqa: E402
from repro_torch import dpp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import kron_matvec as km  # noqa: E402
from repro_torch.kernels import phase2_select as p2  # noqa: E402
from repro_torch.sampling.spectral import SpectralCache  # noqa: E402


def build(src: Path) -> ctypes.CDLL:
    lib = src.with_name(f"lib{src.stem}_parent.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def turns(parent, change, reps: int, expect: str) -> dict:
    t = [device_ms(f, reps, 3, expect=expect)
         for f in (parent, change, change, parent)]
    return {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]]}


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage, on a CUDA card: python3 tools/compare_parent.py "
                 "DIR (the parent's phase2_select.cu and kron_matvec.cu)")
    parent = Path(sys.argv[1])
    km_par = build(parent / "kron_matvec.cu")
    km.bind(km_par)
    p2_par = build(parent / "phase2_select.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    p2_par.phase2_select_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            p]
    p2_par.phase2_select_launch.restype = i
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def km_parent(A, B, X, route):
        Y = torch.empty_like(X)
        rc = km_par.kron_matvec_launch(
            A.data_ptr(), B.data_ptr(), X.data_ptr(), None, Y.data_ptr(),
            A.shape[0], B.shape[0], X.shape[0],
            0 if X.dtype == torch.float32 else 1, route,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            sys.exit(f"parent kron_matvec launch failed: CUDA error {rc}")
        return Y

    for name, dtype, pattern, batch in (
            ("float32", torch.float32, "dense", 64),
            ("bfloat16", torch.bfloat16, "dense", 64),
            ("onehot46", torch.float32, "onehot", 46)):
        A, B, X = km_inputs(100, 100, batch, pattern, dtype, gen, dev)
        route = ctypes.c_int(-1)
        code = 0 if dtype == torch.float32 else 1
        if km_par.kron_matvec_route(100, 100, code, ctypes.byref(route)):
            sys.exit("parent kron_matvec_route failed")
        par = partial(km_parent, A, B, X, route.value)
        new = partial(km.kron_matvec_cuda, A, B, X)
        if not torch.equal(par(), new()):
            sys.exit(f"kron_matvec {name}: parent and change differ")
        out[f"kron_matvec_{name}"] = turns(par, new, 200,
                                           "kron_matvec_fused_kernel")

    cache = SpectralCache()
    spec = dpp.random_kron(gen, (100, 100), device=dev).rescale(
        20.0, cache).spectrum(cache)
    k_max = spec.suggested_k_max()
    for B in (64, 1):
        us, ke, G1, Gr = phase1_inputs(spec, k_max, B, gen)

        def par(us=us, ke=ke, G1=G1, Gr=Gr, B=B):
            picks = torch.empty((B, k_max), dtype=torch.int32, device=dev)
            norms = torch.empty((B, 10_000), dtype=torch.float32,
                                device=dev)
            rc = p2_par.phase2_select_launch(
                us.data_ptr(), ke.data_ptr(), G1.data_ptr(), Gr.data_ptr(),
                norms.data_ptr(), picks.data_ptr(), B, 100, 100, k_max,
                p2.THREADS, torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                sys.exit(f"parent phase2_select launch failed: CUDA error "
                         f"{rc}")
            return picks

        new = partial(p2.phase2_select_cuda, us, ke, G1, Gr)
        out[f"phase2_select_b{B}"] = turns(par, new, 10,
                                           "phase2_select_kernel")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"compare_parent": out, "card": card}))


if __name__ == "__main__":
    main()
