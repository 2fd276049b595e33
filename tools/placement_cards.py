"""``chip_smoke.py``'s placement phase (22) over a ``Mesh`` of distinct
cards: every visible card a shard (four on a four-card machine), against
``Local`` on the first card.

    python3 tools/placement_cards.py

Phase 22 itself cuts a batch into four shards on one card; here each shard
runs on its own card, so a mapped draw copies the spectrum to each card
once (``Mesh.replicate_pinned``), runs under that card's context (phase
2's route is the card's), and gathers on the first card; the learner sums
the shards' statistics there. Builds the kernels, makes the GENES model of
phase 5, phase 8's batch and init and a 5-sweep fit's state for the
checkpoint, then runs ``chip_smoke.placement_path`` with
``devices=[cuda:0, ..., cuda:{n-1}]`` (every check of the phase applies)
and prints its ``placement`` line and the cards' names and power limits.
Exits non-zero on any failed check or with fewer than two cards.
"""

from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> None:
    n = torch.cuda.device_count()
    if n < 2:
        chip_smoke.fail(f"{n} cards visible: this tool needs two or more")
    from repro_torch import dpp
    from repro_torch.core.dpp import SubsetBatch
    from repro_torch.kernels import _build
    sources = ("phase2_select", "threefry")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    main_model = dpp.random_kron(torch.Generator(device=dev).manual_seed(1),
                                 (100, 100), device=dev).rescale(20.0)
    rows = [r for r in main_model.service(seed=2, device=dev).sample(1000)
            if r]
    batch = SubsetBatch.from_lists(rows, device=dev)
    init = dpp.random_kron(torch.Generator(device=dev).manual_seed(2),
                           (100, 100), device=dev)
    rep = init.fit(batch, iters=5, device=dev)
    devices = [torch.device("cuda", i) for i in range(n)]
    chip_smoke.PL_SHARDS = n
    out = chip_smoke.placement_path(main_model, batch, init, rep, dev,
                                    devices=devices)
    print(json.dumps({"placement_cards": out, "cards": smi}))


if __name__ == "__main__":
    main()
