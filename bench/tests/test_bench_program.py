"""The program's own spans in a traced window (``bench/program.py`` and
the readers that use it): on a synthetic trace, and in the tiny traced
cells on the CPU."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import bench_tiny
from bench import harness, program
from bench.trace import Trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, t0, t1, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev, cpu_parent=None,
                           time_range=SimpleNamespace(start=t0, end=t1))


def _trace(sync=True):
    """A window of 0..100 µs and one request: kernels at 10–20 and 60–70;
    the program's draw 6–80 holds its phase 1 30–50, in which a sync runs
    at 40–45 (with ``sync``) and nothing else at 30–40."""
    events = [
        _ev("bench.window", 0, 100), _ev("bench.request", 2, 90),
        _ev("repro_torch.dpp.sample", 6, 80),
        _ev("repro_torch.sampling.phase1", 30, 50), _ev("cudaFree", 52, 58),
        _ev("cudaLaunchKernel", 8, 9), _ev("cudaLaunchKernel", 58, 59),
        _ev("kernel_a", 10, 20, CUDA), _ev("kernel_b", 60, 70, CUDA)]
    if sync:
        events.append(_ev("cudaStreamSynchronize", 40, 45))
    return Trace(events, [{"units": 1}], 0.0, 1, harness.peaks(), "fp32")


def test_program_spans_on_the_cpu_row_leave_the_device_alone():
    """Function-scope regions lie on the CPU row: the device's busy time,
    kernels and top operations are those of its kernels alone."""
    t = _trace()
    assert t.busy_s == pytest.approx(20e-6)
    assert [k[2] for k in t.kernels()] == ["kernel_a", "kernel_b"]
    assert not any(n.startswith(program.PREFIX)
                   for n, _ in t.top_device_ops())


def test_readers_of_the_program_spans():
    t = _trace()
    assert [s[2] for s in program.spans(t)] == [
        "repro_torch.dpp.sample", "repro_torch.sampling.phase1"]
    assert [s[2] for s in program.spans(t, "sampling.phase1")] == [
        "repro_torch.sampling.phase1"]
    # idle gaps 0–10, 20–60, 70–100; middles 5, 40, 85: only 40 is inside
    assert program.idle_in_spans_s(t) == pytest.approx(40e-6)
    assert program.count_inside(t, program.SYNCS) == 1
    assert program.count_inside(t, program.SYNCS, "dpp.map") is None
    assert program.seconds_inside(t, program.ALLOCS) == pytest.approx(6e-6)
    assert program.seconds_inside(t, program.ALLOCS,
                                  "sampling.phase1") == 0.0
    read = lambda name: harness._reader("metrics", name)(t)
    assert read("sample_host_ms") == pytest.approx(74e-3)
    assert read("idle_in_program_ms.draw") == pytest.approx(40e-3)
    assert read("program_syncs.draw") == 1.0
    assert read("sweep_alloc_wait_ms") is None      # no learning.sweep span
    assert read("theta_build_ms") is None


def test_an_idle_gap_inside_a_program_span_carries_its_name():
    t = _trace()
    labels = dict(program.idle_labels(t))
    assert labels["bench.request / repro_torch.sampling.phase1 / "
                  "cudaStreamSynchronize"] == pytest.approx(40e-6)
    # the gaps 0–10 and 70–100 fall outside the program
    assert labels["bench.request / - / -"] == pytest.approx(40e-6)
    # the benchmark's own label names the program's span where no other
    # operation is open at a gap's middle
    gaps = dict(_trace(sync=False).idle_gaps())
    assert gaps["bench.request / repro_torch.sampling.phase1"] == \
        pytest.approx(40e-6)


def test_without_program_spans_every_reader_is_silent():
    """An older program traces no ``repro_torch.*`` span: each new reader
    returns None and raises nothing."""
    events = [_ev("bench.window", 0, 100), _ev("bench.request", 2, 90),
              _ev("cudaStreamSynchronize", 40, 45),
              _ev("kernel_a", 10, 20, CUDA)]
    t = Trace(events, [{"units": 1}], 0.0, 1, harness.peaks(), "fp32")
    for name in ("sample_host_ms", "idle_in_program_ms.draw",
                 "program_syncs.learn", "theta_build_ms",
                 "sweep_alloc_wait_ms"):
        assert harness._reader("metrics", name)(t) is None, name


@pytest.mark.parametrize("name,read", [
    ("genes-sample", ("sample_host_ms", "idle_in_program_ms.draw",
                      "program_syncs.draw")),
    ("genes-learn", ("idle_in_program_ms.learn", "program_syncs.learn",
                     "sweep_alloc_wait_ms"))])
def test_tiny_traced_cells_read_the_program_metrics(name, read):
    cell = bench_tiny.cells()[name]
    rc, res, err = bench_tiny.run(cell, trace=True)
    assert rc == 0 and res["correct"] is True, err
    for m in read:
        assert res["metrics"][m]["value"] >= 0.0, m
    # a CPU run has no device time to put under the Θ build
    assert "theta_build_ms" not in res["metrics"]
