"""The families' sharded steps over four cards: ``chip_smoke.py``'s phase
28 on (data, model) meshes of four NCCL ranks, one process a card.

    python3 tools/sharded_families_cards.py

mixtral-8x7b at full width (4 of its 32 layers; the train step 1),
mamba2-2.7b (64 layers; the train step 16) and whisper-tiny, float32
compute, from ``init_params(PRNGKey(0))``, on the meshes (2, 2) and
(1, 4). On each mesh each family runs ``chip_smoke.lp_family``: a
prefill of 2 prompts of 256 tokens and 4 greedy decode steps, sharded
(outputs placed by ``ShardingPolicy``) and unsharded on the rank's own
card, logits and caches within ``LF_F32_TOL`` of max(1, |one card|);
then one train step of each, loss and grad norm within ``LT_F32_TOL``,
params by ``lt_check_gap``. mixtral's 8 experts divide "model" on both
meshes, so its experts are sharded (EP): 2 a rank on (1, 4); mamba2's 80
SSD heads split 20 a rank there; whisper's 6 heads do not divide 4, so on
(1, 4) they are whole on every rank and its decode caches shard their
sequence over "model" (the softmax combined across the shards).

Prints one ``sharded_families_cards`` JSON line (each mesh and family:
the sharded and unsharded prefill, decode-step and train-step times, the
host clock around synchronized work; the peaks of
``max_memory_allocated``; the errors) beside the cards' ``nvidia-smi
--query-gpu=name,power.limit`` lines. Exits non-zero on any failed check,
a rank that fails or hangs past ``DEADLINE_S``, or with fewer than four
cards. The ranks start and end as ``tools/sharded_train_cards.py``'s
(``spawn_ranks``: one ``PYTHONHASHSEED``, a deadline), and rendezvous
through a ``FileStore`` under ``build/``.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from sharded_train_cards import (COLLECTIVE_TIMEOUT_S, WORLD,  # noqa: E402
                                 spawn_ranks)

MESHES = ((2, 2), (1, 4))
CONFIGS = [c for c in cs.LP_CONFIGS if c[0] in ("mixtral-8x7b",
                                                "mamba2-2.7b",
                                                "whisper-tiny")]
FAILED: list = []


def check(cond: bool, msg: str) -> None:
    if not cond:
        FAILED.append(msg)
        print(f"rank {dist.get_rank()}: FAILED {msg}", file=sys.stderr,
              flush=True)


def run(rank: int, dev, smoke: bool) -> dict:
    from repro_torch.launch.mesh import make_mesh_from_devices
    configs = CONFIGS
    if smoke:
        # the CPU rehearsal: the smoke configs
        from repro_torch import configs as C
        smoke_cfgs = {a: C.smoke_config(a) for a, *_ in CONFIGS}
        C.get_config = smoke_cfgs.__getitem__
        configs = [(a, {}, {}, r) for a, _, _, r in CONFIGS]
    out = {}
    for shape in MESHES:
        mesh = make_mesh_from_devices(range(WORLD), shape,
                                      ("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        out[tag] = {arch: cs.lp_family(arch, sov, tov, red, mesh, dev)
                    for arch, sov, tov, red in configs}
    return out


def worker(rank: int, work: str, backend: str, smoke: bool) -> None:
    work = Path(work)
    cs.check = check
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        # the rehearsal has no card: its memory and clock calls do nothing
        for name in ("synchronize", "reset_peak_memory_stats",
                     "empty_cache"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    dist.init_process_group(
        backend, store=dist.FileStore(str(work / "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = run(rank, dev, smoke)
        if rank == 0:
            (work / "result.json").write_text(json.dumps(out))
    except Exception:
        FAILED.append(traceback.format_exc())
        print(f"rank {rank}: {FAILED[-1]}", file=sys.stderr, flush=True)
    finally:
        dist.destroy_process_group()
    sys.exit(1 if FAILED else 0)


def main(backend: str = "nccl", smoke: bool = False) -> None:
    """Spawn the 4 ranks and wait for them (``backend`` "gloo" and
    ``smoke`` rehearse the control flow on the CPU)."""
    smi = []
    if backend == "nccl":
        n = torch.cuda.device_count()
        if n < WORLD:
            cs.fail(f"{n} cards visible: this tool needs {WORLD}")
        from repro_torch.kernels import _build
        _build.build("threefry")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    codes, out = spawn_ranks(worker, ROOT / "build" /
                             "sharded_families_cards", backend, smoke)
    print(json.dumps({"sharded_families_cards": out, "exit_codes": codes,
                      "wall_s": time.perf_counter() - t0, "cards": smi}))
    if codes != [0] * WORLD or out is None:
        cs.fail(f"ranks exited {codes}")


if __name__ == "__main__":
    main()
