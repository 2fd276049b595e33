"""What a traced window recorded, read from ``torch.profiler``'s events.

The traced window is the benchmark's own ``bench.window`` span. Device
events (kernels, copies, fills) count when they start inside it. The
benchmark's spans (``bench.*``) and the program's CPU operations are kept
to say what the host was doing in each idle gap of the device.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
#: ``torch.cuda._sleep``'s kernel: the marks at the window's edges.
MARK = "spin_kernel"


class Trace:
    def __init__(self, events, records: List[dict], flops: float,
                 units: int, peaks: dict, precision: str):
        from torch.autograd import DeviceType
        win = [e for e in events if e.name == WINDOW]
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} {WINDOW} spans")
        self.start = win[0].time_range.start
        self.end = win[0].time_range.end
        self.records = records
        self.flops = flops
        self.units = units
        self.peaks = peaks
        self.precision = precision
        dev, cpu = [], []
        self.marks = 0
        for e in events:
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith("bench."):
                    continue        # the spans' shadows on the device's row
                if MARK in e.name:
                    self.marks += 1
                elif self.start <= t0 <= self.end:
                    dev.append((t0, t1, e.name))
            elif self.start <= t0 <= self.end and e.name != WINDOW:
                cpu.append((t0, t1, e.name, e))
        self.device = sorted(dev)
        self.cpu = sorted(cpu, key=lambda c: c[0])
        self._spans = [c for c in self.cpu if c[2].startswith("bench.")]
        self._ops = [c for c in self.cpu if not c[2].startswith("bench.")]
        self._span_starts = [c[0] for c in self._spans]
        self._op_starts = [c[0] for c in self._ops]

    # -- the window --------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, clipped to the
        window, in µs."""
        out: List[Tuple[float, float]] = []
        for t0, t1, _ in self.device:
            t1 = min(t1, self.end)
            if out and t0 <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], t1))
            else:
                out.append((t0, t1))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> List[Tuple[float, float, str]]:
        """Device events that are kernels (not copies or fills)."""
        return [d for d in self.device if not d[2].startswith(("Memcpy",
                                                                "Memset"))]

    def device_seconds(self, name_part: str) -> float:
        return sum(t1 - t0 for t0, t1, n in self.device
                   if name_part in n) / 1e6

    # -- shares of the peak ------------------------------------------------
    def least_seconds(self, flops: float, nbytes: float) -> float:
        peak = self.peaks["flops"][self.precision]
        return max(flops / peak, nbytes / self.peaks["hbm_bytes_per_s"])

    def roofline(self, name_part: str,
                 work: List[Tuple[float, float]]) -> Optional[float]:
        """A kernel's share (%) of its roofline: the least time that
        ``work``, the (operations, bytes) that the window's records need of
        it, takes at the card's peaks, over the device time of the kernels
        whose names hold ``name_part``."""
        t = self.device_seconds(name_part)
        if t <= 0 or not work:
            return None
        return 100.0 * sum(self.least_seconds(f, b) for f, b in work) / t

    def mfu(self) -> Optional[float]:
        """The window's algorithmic FLOPs over its time at the peak (%)."""
        if self.flops <= 0:
            return None
        peak = self.peaks["flops"][self.precision]
        return 100.0 * self.flops / (self.window_s * peak)

    # -- the program's CPU operations ---------------------------------------
    def op_device_seconds(self, op_name: str) -> float:
        """Device time of the kernels launched under CPU operations named
        ``op_name`` and their children (outermost such operations only)."""
        total = 0.0
        for _, _, name, e in self.cpu:
            if name != op_name:
                continue
            p = e.cpu_parent
            while p is not None and p.name != op_name:
                p = p.cpu_parent
            if p is None:
                total += _device_total_us(e)
        return total / 1e6

    # -- the breakdown ------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for t0, t1, name in self.device:
            by[name] = by.get(name, 0.0) + (t1 - t0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    @staticmethod
    def _innermost(items, starts, t: float, reach: int) -> str:
        j = bisect.bisect_right(starts, t)
        best, best_len = "", float("inf")
        for k in range(j - 1, max(-1, j - 1 - reach), -1):
            t0, t1, name, _ = items[k]
            if t1 >= t and t1 - t0 < best_len:
                best, best_len = name, t1 - t0
        return best

    def _host_at(self, t: float) -> str:
        """The benchmark's innermost span and the innermost other CPU
        operation open at time t."""
        span = self._innermost(self._spans, self._span_starts, t, 8)
        op = self._innermost(self._ops, self._op_starts, t, 400)
        return f"{span or 'outside any bench span'} / {op or 'no operation'}"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by what the
        host was doing at the middle of each gap."""
        by: Dict[str, float] = {}
        edge = self.start
        for a, b in self.busy_intervals() + [(self.end, self.end)]:
            if a > edge:
                label = self._host_at(0.5 * (edge + a))
                by[label] = by.get(label, 0.0) + (a - edge) / 1e6
            edge = max(edge, b)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _device_total_us(e) -> float:
    total = getattr(e, "device_time_total", None)
    if total is None:
        total = e.cuda_time_total
    return float(total)
