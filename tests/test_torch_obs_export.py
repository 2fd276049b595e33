"""The port's run-log exporters (``repro_torch.obs.export``,
``repro_torch.obs.report``) against the JAX package's ``repro.obs.export``
and ``repro.obs.report``.

One JSONL run log is written with the port's ``JsonlTracker`` (a service
flush with its span trees, an async tier's tenant-tagged flush, scoped
spans, counters, gauges, timers and a health report); both packages'
``ChromeTraceExporter`` read it and give equal JSON, with and without a
tag filter or counters; ``render`` and ``main`` give the same text. The
contracts of ``tests/test_obs_spans.py``'s export and report section are
mirrored on the port. Everything is exact: the trace JSON and the text
are compared as they are."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import pytest

from repro.obs import export as jax_export
from repro.obs import report as jax_report
from repro_torch import dpp, obs
from repro_torch import random as tr
from repro_torch.obs import export, report, spans
from repro_torch.serving import AsyncSamplingService, ServingConfig

ROOT = Path(__file__).resolve().parents[1]


def _model():
    return dpp.random_kron(tr.PRNGKey(0, "cpu"), (4, 5),
                           device="cpu").rescale(4.0)


def _service_run_log(tmp_path):
    """``tests/test_obs_spans.py``'s log on the port: one flush of two
    tickets under ``configure(jsonl=...)``."""
    path = tmp_path / "run.jsonl"
    prev = obs.configure(jsonl=str(path))
    try:
        svc = _model().service(seed=0, device="cpu")
        svc.submit(3)
        svc.submit(2)
        svc.flush()
    finally:
        obs.configure(prev)
    return path


@pytest.fixture(scope="module")
def run_log(tmp_path_factory):
    """A richer log: the sync flush, an async flush of two tenants, scoped
    spans of two benches, a timer, a gauge, a health report, a blank line
    and a corrupt line."""
    path = tmp_path_factory.mktemp("log") / "run.jsonl"
    t = obs.JsonlTracker(str(path))
    prev = obs.configure(t)
    try:
        svc = _model().service(seed=0, device="cpu")
        svc.submit(3)
        svc.submit(2)
        svc.flush()
        tier = AsyncSamplingService(
            _model(), ServingConfig(max_batch=4096, deadline_ms=10.0),
            tenants={"a": 2, "b": 1}, seed=1, device="cpu")
        ta, tb = tier.submit(2, tenant="a"), tier.submit(1, tenant="b")
        ta.result(timeout=120.0)
        tb.result(timeout=120.0)
        tier.close()
        with t.scope(bench="alpha"):
            with spans.start_span("alpha", tracker=t, n=1):
                with spans.start_span("inner", tracker=t):
                    pass
            t.gauge("g.depth", 3)
        with t.scope(bench="beta"):
            with spans.start_span("beta", tracker=t):
                pass
            with t.timer("beta.step_s"):
                pass
    finally:
        obs.configure(prev)
        t.close()
    with open(path, "a") as f:
        f.write("\n{not json\n")
    return path


# ---------------------------------------------------------------------------
# the same JSON and the same text as the reference
# ---------------------------------------------------------------------------

def test_read_run_log_matches_jax(run_log):
    got = export.read_run_log(str(run_log))
    assert got == jax_export.read_run_log(str(run_log))
    assert obs.read_run_log is export.read_run_log
    assert [export.is_span_record(r) for r in got] == \
        [jax_export.is_span_record(r) for r in got]
    assert sum(map(export.is_span_record, got)) >= 20


@pytest.mark.parametrize("kw", [
    {}, {"include_counters": False}, {"tag_filter": {"bench": "alpha"}},
    {"tag_filter": {"tenant": "a"}}, {"tag_filter": {"bench": "nobody"}},
    {"tag_filter": {"bench": "beta"}, "include_counters": False}], ids=str)
def test_chrome_trace_matches_jax(run_log, kw, tmp_path):
    records = export.read_run_log(str(run_log))
    got = export.ChromeTraceExporter(**kw).convert(records)
    assert got == jax_export.ChromeTraceExporter(**kw).convert(records)
    out, jout = tmp_path / "t.json", tmp_path / "j.json"
    assert obs.ChromeTraceExporter(**kw).export(str(run_log), str(out)) \
        == got
    jax_export.ChromeTraceExporter(**kw).export(str(run_log), str(jout))
    assert out.read_text() == jout.read_text()


@pytest.mark.parametrize("traces,top", [(3, 10), (1, 2), (50, 50)])
def test_render_matches_jax(run_log, traces, top):
    records = export.read_run_log(str(run_log))
    got, want = io.StringIO(), io.StringIO()
    report.render(records, traces=traces, top=top, out=got)
    jax_report.render(records, traces=traces, top=top, out=want)
    assert got.getvalue() == want.getvalue()
    assert "== health ==" in got.getvalue()


def test_main_matches_jax(run_log, tmp_path, capsys):
    out, jout = tmp_path / "t.json", tmp_path / "j.json"
    assert report.main([str(run_log), "--traces", "2", "--top", "4",
                        "--trace", str(out)]) == 0
    text = capsys.readouterr().out
    assert jax_report.main([str(run_log), "--traces", "2", "--top", "4",
                            "--trace", str(jout)]) == 0
    jtext = capsys.readouterr().out
    assert text.replace(str(out), "OUT") == jtext.replace(str(jout), "OUT")
    assert out.read_text() == jout.read_text()


def test_report_runs_as_a_module(run_log):
    """``python -m repro_torch.obs.report run_log.jsonl``: the reference
    module's text, importing no jax."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import runpy, sys; sys.argv = ['report', %r, '--traces', '1'];"
            " exit_code = None\n"
            "try:\n"
            "    runpy.run_module('repro_torch.obs.report',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    exit_code = e.code\n"
            "assert exit_code == 0, exit_code\n"
            "bad = [m for m in sys.modules if m == 'jax' or"
            " m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n" % str(run_log))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    want = io.StringIO()
    jax_report.render(jax_export.read_run_log(str(run_log)), traces=1,
                      out=want)
    assert r.stdout == want.getvalue()


# ---------------------------------------------------------------------------
# tests/test_obs_spans.py's export and report contracts, on the port
# ---------------------------------------------------------------------------

def test_chrome_trace_export_is_valid_and_well_formed(tmp_path):
    run_log = _service_run_log(tmp_path)
    out = tmp_path / "trace.json"
    obs.ChromeTraceExporter().export(str(run_log), str(out))
    trace = json.loads(out.read_text())         # valid JSON end to end
    events = trace["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) >= 10                  # 2 tickets x 5 spans
    for e in complete:
        assert isinstance(e["name"], str) and e["name"]
        assert e["ts"] >= 0 and e["dur"] >= 0   # µs, anchored at file start
        assert e["pid"] == 1 and isinstance(e["tid"], int)
        assert "trace" in e["args"]
    # every ticket trace renders as its own labelled lane
    lanes = {e["tid"] for e in complete
             if e["args"].get("parent") is None
             and e["name"] == "service.request"}
    assert len(lanes) == 2
    meta = [e for e in events if e["ph"] == "M"]
    assert {m["tid"] for m in meta} >= lanes


def test_chrome_trace_export_tag_filter_splits_benches(tmp_path):
    path = tmp_path / "run.jsonl"
    with obs.JsonlTracker(str(path)) as t:
        with t.scope(bench="a"):
            with spans.start_span("alpha", tracker=t):
                pass
        with t.scope(bench="b"):
            with spans.start_span("beta", tracker=t):
                pass
    only_a = obs.ChromeTraceExporter(tag_filter={"bench": "a"}).convert(
        obs.read_run_log(str(path)))
    names = {e["name"] for e in only_a["traceEvents"] if e["ph"] == "X"}
    assert names == {"alpha"}


def test_report_cli_prints_counters_spans_and_latency_breakdown(
        tmp_path, capsys):
    run_log = _service_run_log(tmp_path)
    out = tmp_path / "trace.json"
    rc = report.main([str(run_log), "--traces", "2", "--trace", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "== counters ==" in text
    assert "service.device_calls" in text
    assert "== top spans (by total duration) ==" in text
    assert "traces ==" in text                  # per-trace latency breakdown
    assert "service.request" in text
    for op in ("queue-wait", "device-call", "scatter"):
        assert op in text
    assert "100.0%" in text                     # root share of itself
    json.loads(out.read_text())                 # --trace export also valid


def test_report_cli_on_spanless_log(tmp_path, capsys):
    path = tmp_path / "flat.jsonl"
    with obs.JsonlTracker(str(path)) as t:
        t.counter("c", 2)
    assert report.main([str(path)]) == 0
    assert "(no spans in log)" in capsys.readouterr().out


def test_empty_log_exports_no_events(tmp_path):
    path = tmp_path / "empty.jsonl"
    path.write_text("")
    assert obs.ChromeTraceExporter().export(
        str(path), str(tmp_path / "t.json")) == {"traceEvents": []}
    assert jax_export.ChromeTraceExporter().convert([]) == \
        export.ChromeTraceExporter().convert([])
