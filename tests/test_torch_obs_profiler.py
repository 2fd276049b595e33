"""The port's spans on the profiler's clock (``repro_torch.obs.spans``).

One gate, two sinks: a span is live when its tracker is enabled or
``torch.profiler`` records. The tracker gets its ``event("span", ...)``
record as before; the profiler gets a ``repro_torch.<name>`` region
nested in its parent's. With neither, ``start_span`` and every span site
of the sampling, learning and MAP paths hand back ``NULL_SPAN`` and open
no region. All on the CPU.
"""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax  # noqa: F401  (imported beside torch, as in every port test)

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro_torch import dpp, obs
from repro_torch import random as prng
from repro_torch.core import SubsetBatch
from repro_torch.kernels import ops
from repro_torch.obs import spans
from repro_torch.sampling import SpectralCache

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _paths(prof) -> set:
    """Each ``repro_torch.*`` event of a trace as the path of program spans
    from the outermost down to it, e.g. ``"dpp.sample/sampling.phase1"``."""
    out = set()
    for e in prof.events():
        if not e.name.startswith(spans.PROFILER_PREFIX):
            continue
        chain, p = [], e
        while p is not None:
            if p.name.startswith(spans.PROFILER_PREFIX):
                chain.append(p.name[len(spans.PROFILER_PREFIX):])
            p = p.cpu_parent
        out.add("/".join(reversed(chain)))
    return out


@pytest.fixture
def regions(monkeypatch):
    """Counts the profiler regions the spans open."""
    opened = []
    real = spans._record_function

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(spans, "_record_function", counted)
    return opened


def _kron():
    g = torch.Generator().manual_seed(0)
    fs = []
    for n in (4, 3):
        x = torch.rand((n, n), generator=g)
        fs.append(x @ x.T + 0.1 * torch.eye(n))
    return dpp.Kron(tuple(fs), device="cpu")


def _batch():
    idx = torch.tensor([[0, 5, 7], [1, 2, 0], [3, 11, 0], [4, 6, 9]],
                       dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1], [1, 1, 0], [1, 1, 0], [1, 1, 1]],
                        dtype=torch.bool)
    return SubsetBatch(idx, mask)


def _fit(model):
    return model.fit(_batch(), algorithm="krk", use_dense_theta=True,
                     iters=2, log_every=2, ll_mode="chunk", device="cpu")


def _map():
    L = torch.from_numpy(np.diag(np.arange(1.0, 7.0))).float()
    return dpp.from_kernel(L, device="cpu").map(3)


def test_span_is_a_profiler_region_nested_in_its_parent(regions):
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with spans.start_span("outer") as outer:
            with spans.start_span("inner") as inner:
                torch.ones(2).add_(1)
    assert outer.span_id is None and inner.trace_id is None
    assert _paths(prof) == {"outer", "outer/inner"}
    assert regions == ["outer", "inner"]


def test_nothing_listening_gives_null_span_and_no_region(regions):
    assert not obs.enabled(obs.current_tracker())
    assert not spans.profiling()
    assert spans.start_span("dpp.sample") is obs.NULL_SPAN
    assert ops._dispatch_span("phase2_select", "reference") is obs.NULL_SPAN
    model = _kron()
    model.sample(prng.PRNGKey(1, "cpu"), 8, device="cpu")
    _fit(model)
    _map()
    assert regions == []


def test_tracker_alone_keeps_its_records(regions):
    with obs.use(obs.InMemoryTracker(keep_records=True)) as t:
        with spans.start_span("outer", kind="x"):
            with spans.start_span("inner"):
                pass
    recs = [r for r in t.records if r["name"] == "span"]
    assert [r["tags"]["op"] for r in recs] == ["inner", "outer"]
    inner, outer = (r["tags"] for r in recs)
    assert set(inner) == {"op", "trace", "span", "parent", "ts", "dur_s"}
    assert set(outer) == set(inner) | {"kind"} and outer["kind"] == "x"
    assert inner["parent"] == outer["span"] and outer["parent"] is None
    assert inner["trace"] == outer["trace"]
    assert regions == []


def test_tracker_and_profiler_both_get_the_span(regions):
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        with obs.use(obs.InMemoryTracker()) as t:
            with spans.start_span("outer"):
                with spans.start_span("inner"):
                    pass
    assert sorted(e["op"] for e in t.events if e["name"] == "span") == \
        ["inner", "outer"]
    assert _paths(prof) == {"outer", "outer/inner"}
    assert regions == ["outer", "inner"]


def test_kron_sample_spans():
    model = _kron()
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        model.sample(prng.PRNGKey(1, "cpu"), 8, device="cpu")
    assert _paths(prof) == {
        "dpp.sample", "dpp.sample/sampling.spectrum",
        "dpp.sample/sampling.k_max", "dpp.sample/sampling.keys",
        "dpp.sample/sampling.keys/kernels.threefry2x32",
        "dpp.sample/sampling.uniforms",
        "dpp.sample/sampling.uniforms/kernels.threefry2x32",
        "dpp.sample/sampling.phase1", "dpp.sample/kernels.phase2_select"}


def test_dense_theta_fit_spans():
    model = _kron()
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        _fit(model)
    paths = _paths(prof)
    sweep = "learning.fit/learning.chunk/learning.sweep"
    build = sweep + "/learning.theta_build"
    assert {"learning.setup", "learning.setup/learning.log_likelihood",
            "learning.setup/learning.host_sync", "learning.fit",
            "learning.fit/learning.chunk", sweep, build,
            build + "/learning.subset_inverse",
            build + "/learning.theta_scatter",
            sweep + "/kernels.partial_trace_A",
            sweep + "/kernels.partial_trace_C",
            sweep + "/learning.factor_eigh",
            "learning.fit/learning.chunk/learning.log_likelihood",
            "learning.fit/learning.chunk/learning.host_sync"} <= paths
    # the setup ends where the fit starts: nothing of it runs inside
    assert not any(p.startswith("learning.fit/learning.setup")
                   for p in paths)


def test_map_spans():
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        picks = _map()
    assert picks.tolist() == [5, 4, 3]
    assert _paths(prof) == {"dpp.map", "dpp.map/kernels.greedy_map_kdpp"}


def test_dispatch_counters_unchanged_under_a_tracker(regions):
    """The ``kernels.<op>`` site keeps each dispatch counter's name and
    count (the greedy MAP's keeps the step's name); its span is the
    profiler's alone, so the tracker gets no record of it."""
    model = _kron()
    with obs.use(obs.InMemoryTracker()) as t:
        model.sample(prng.PRNGKey(1, "cpu"), 8, cache=SpectralCache(),
                     device="cpu")
        _map()
    assert t.counters["kernels.threefry2x32.reference"] == 2
    assert t.counters["kernels.phase2_select.reference"] == 1
    assert t.counters["kernels.greedy_map_update.reference"] == 1
    assert not any(k.startswith("kernels.greedy_map_kdpp")
                   for k in t.counters)
    assert sorted(e["op"] for e in t.events if e["name"] == "span") == [
        "dpp.map", "dpp.sample", "sampling.k_max", "sampling.keys",
        "sampling.phase1", "sampling.spectrum", "sampling.uniforms",
        "spectral_cache.eigh", "spectral_cache.eigh"]
    assert regions == []
