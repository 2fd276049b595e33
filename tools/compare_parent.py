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

    python3 tools/compare_parent.py --serving PARENT_ROOT

times the service of the main path on the parent's whole tree (unpacked at
PARENT_ROOT beforehand, e.g. ``git archive HEAD~1 | tar -x -C
build/parent_tree``) against this checkout's: one process per turn, parent,
change, change, parent, each importing ``repro_torch`` from its tree's
``src/`` and building its kernels there. A turn builds the phase-5 model of
``chip_smoke.py`` (``random_kron`` of a seeded generator, 100 x 100,
E|Y| = 20) and ``service(seed=0)``, warms the path, then takes on the host
clock, each call ending in a device sync, 20 ``svc.sample(16)`` requests
and 10 flushes of tickets of 1, 4, 16, 64 and 200 rows (285 rows, one call
at B = 512). Prints one JSON line with every turn's times and medians, the
card's name and its power limit.
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
SERVING_SIZES = (1, 4, 16, 64, 200)


def serving_turn(root: Path) -> dict:
    """One turn of ``--serving``, in a process of its own: the service of
    the main path from the tree at ``root``, timed on the host clock."""
    import time

    import numpy as np
    sys.path.insert(0, str(root / "src"))
    from repro_torch import dpp
    dev = torch.device("cuda", 0)
    main = dpp.random_kron(torch.Generator(device=dev).manual_seed(1),
                           (100, 100)).rescale(20.0)
    svc = main.service(seed=0)

    def flush():
        tickets = [svc.submit(n) for n in SERVING_SIZES]
        svc.flush()
        return tickets

    def clock(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(3):
        svc.sample(16)
        flush()
    sample16, flush285 = clock(lambda: svc.sample(16), 20), clock(flush, 10)
    return {"sample16_ms": sample16,
            "sample16_median_ms": float(np.median(sample16)),
            "flush285_ms": flush285,
            "flush285_median_ms": float(np.median(flush285))}


def serving(parent: Path) -> dict:
    """``--serving``: the turns parent, change, change, parent, each a
    process of its own."""
    out = {"parent": [], "change": []}
    for name, root in (("parent", parent), ("change", ROOT),
                       ("change", ROOT), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--turn",
             str(root)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"serving turn on {root} failed:\n{proc.stdout}\n"
                     f"{proc.stderr}")
        out[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for name in ("parent", "change"):
        for k in ("sample16_median_ms", "flush285_median_ms"):
            out[f"{name}_{k}"] = [t[k] for t in out[name]]
    return out


def build(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = src.with_name(f"lib{src.stem}_parent.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def turns(parent, change, reps: int, expect: str) -> dict:
    from chip_smoke import device_ms
    t = [device_ms(f, reps, 3, expect=expect)
         for f in (parent, change, change, parent)]
    return {"parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]]}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> None:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or len(args) not in (1, 2) or (
            len(args) == 2 and args[0] not in ("--serving", "--turn")):
        sys.exit("usage, on a CUDA card: python3 tools/compare_parent.py "
                 "DIR (the parent's phase2_select.cu and kron_matvec.cu), "
                 "or --serving PARENT_ROOT (the parent's whole tree)")
    if args[0] == "--turn":
        print(json.dumps(serving_turn(Path(args[1]).resolve())))
        return
    if args[0] == "--serving":
        print(json.dumps({"compare_parent_serving": serving(
            Path(args[1]).resolve()), "card": card()}))
        return
    kernels(Path(args[0]))


def kernels(parent: Path) -> None:
    """The parent's phase-2 and ``kron_matvec`` kernels against this
    checkout's (the first form of the command)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import km_inputs, phase1_inputs
    from repro_torch import dpp
    from repro_torch.kernels import kron_matvec as km
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.sampling.spectral import SpectralCache
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
    print(json.dumps({"compare_parent": out, "card": card()}))


if __name__ == "__main__":
    main()
