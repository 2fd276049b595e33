"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check of what the window produced, and the result line.

Everything that belongs to one cell is found by name from its entry in
``BENCHMARK.json``: the configuration ``configs/<config>.json``, the
traffic mix ``traffic/<traffic>.json`` (parameters, among them ``kind``,
which names the module ``kinds/<kind>.py`` that drives the program), the
end-to-end metrics ``end_to_end/<metric>.py`` and the per-layer metrics
``metrics/<metric>.py`` (or, for a name split by cell such as
``mfu.learn``, the file of its part before the first dot). Each metric
module has ``read(window)``, which returns a number, or None where it
finds nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Host sleep at each edge of a traced window, and the marks that keep the
#: device busy into it: the profiler can miss the first device events after
#: the card has idled without them.
TRACE_MARGIN_S = 0.02
LEAD_MARKS = 64
MARK_CYCLES = 100_000
#: The longest traced window: the trace of a longer one takes minutes to
#: read.
TRACE_SECONDS = 3.0
#: Top-level module names that may not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Window:
    """What the end-to-end metrics read."""
    seconds: float
    setup_s: float
    latencies_ms: List[float]
    units: int
    requests: int


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclass
class Span:
    """The benchmark's host spans: ``torch.profiler`` user annotations in a
    traced run, nothing otherwise."""
    on: bool = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    span: Span = field(default_factory=Span)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = [w for w in spec["workloads"] if w["name"] == workload]
    if len(cells) != 1:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[0]
    cfg = [c for c in spec["configs"] if c["name"] == w["config"]][0]

    def ours(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if ours(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(workload, _json(root / cfg["file"]),
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                int(w["chips"]), e2e, layer)


def _reader(folder: str, name: str) -> Callable:
    """``read`` of ``<folder>/<name>.py``, or, where no file has the whole
    name, of the file named by its part before the first dot: one reader
    serves a quantity split by cell (``mfu.draw`` and ``mfu.learn`` are
    both ``mfu.py``)."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        path = HERE / folder / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_of(traffic: dict):
    return importlib.import_module(f"bench.kinds.{traffic['kind']}")


def peaks() -> dict:
    return _json(HERE / "roofline" / "peaks.json")


class Clock:
    """A request's latency: CUDA events on the card (the device's clock,
    recorded as the host issues the request and after its result is in
    host memory), the host's clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return float(self.e0.elapsed_time(self.e1))
        return (time.perf_counter() - self.t0) * 1e3


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from a
    seeded generator."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        elif self.size:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _mark(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(MARK_CYCLES)
    torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, process_start: float, out=sys.stdout,
        err=sys.stderr) -> int:
    """One run of ``cell``; prints the result line on ``out`` and returns
    the exit code."""
    kind = kind_of(cell.traffic)
    ctx = Context(cell.config, cell.traffic, int(seed), device)
    cuda = device.type == "cuda"
    work = kind.Workload(ctx)
    work.warm_up()
    if cuda:
        torch.cuda.synchronize(device)
    kept = Reservoir(int(cell.traffic.get("checked", 0)), seed)
    records: List[dict] = []
    clock = Clock(device)
    window_len = min(seconds, TRACE_SECONDS) if trace else seconds
    prof = None
    if trace:
        ctx.span.on = True
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        time.sleep(TRACE_MARGIN_S)
        if cuda:
            _mark(LEAD_MARKS)
    latencies: List[float] = []
    units = i = 0
    last = None
    with ctx.span("bench.window"):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_len:
            clock.start()
            with ctx.span("bench.request"):
                rec = work.call(i)
            latencies.append(clock.stop_ms())
            with ctx.span("bench.client"):
                units += rec["units"]
                if trace:
                    records.append(rec)
                kept.offer(rec)
                last = rec
                i += 1
        t1 = time.perf_counter()
    if trace:
        if cuda:
            _mark(1)
        time.sleep(TRACE_MARGIN_S)
        prof.__exit__(None, None, None)
    window = Window(t1 - t0, t0 - process_start, latencies, units, i)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
           if cuda else 0}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    metrics, breakdown = {}, None
    if trace:
        from .trace import Trace
        tr = Trace(prof.events(), records,
                   sum(work.flops(r) for r in records), units, peaks(),
                   cell.config.get("precision", "fp32"))
        prof = None
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        dev["trace_marks"] = tr.marks
        for m in cell.per_layer:
            v = _reader("metrics", m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        for m in cell.end_to_end:
            v = _reader("end_to_end", m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    work.release()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    checks = work.check(kept.items, last)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"bench: the run loaded {forbidden}, which the port may not "
              "use", file=err)
        return 3
    correct = all(c.ok for c in checks)
    result = {"correct": correct, "attempted": i,
              "failed": 0 if correct else sum(not c.ok for c in checks),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # JSON has no infinity or NaN: such a reading shows as 1e308
    result["checks"] = {c.name: {"value": float(c.value)
                                 if math.isfinite(c.value) else 1e308,
                                 "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
