"""Start a test's gloo ranks and wait for them: the module fixtures of
``tests/test_torch_sharded_train.py`` and
``tests/test_torch_sharded_families.py``."""

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(worker: Path, work: Path, world: int, deadline_s: float,
              meanwhile=None):
    """Run ``python worker RANK WORLD WORK`` for every rank, one thread
    each, and return what ``meanwhile()`` (work of the test process, run
    while the ranks run) returns. Every rank gets one ``PYTHONHASHSEED``:
    DTensor breaks ties between sharding strategies in an order that
    follows string hashes, and ranks that choose apart wait on different
    collectives. Kills them all past the deadline or when one fails;
    asserts that all exited 0 and none wrote ``rank<r>.err``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", PYTHONHASHSEED="0")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), str(work)],
        env=env, stdout=subprocess.DEVNULL,
        stderr=open(work / f"rank{r}.log", "w")) for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        result = meanwhile() if meanwhile is not None else None
        while time.monotonic() < end:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = [(work / f"rank{r}.err").read_text()
              for r in range(world) if (work / f"rank{r}.err").exists()]
    codes = [p.returncode for p in procs]
    assert codes == [0] * world and not errors, (
        codes, errors or (work / "rank0.log").read_text()[-3000:])
    return result
