"""What the benchmark loads: no JAX, no JAX package, and a reference that
loads nothing of the port. Top-level module names are compared whole
(``repro_torch`` is not ``repro``)."""

import json
import subprocess
import sys

import bench_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_CELLS = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
import bench_tiny
for name, cell in sorted(bench_tiny.cells().items()):
    for trace in (False, True):
        rc, res, err = bench_tiny.run(cell, seconds=0.1, trace=trace)
        assert rc == 0, err
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys, pkgutil, importlib
sys.path[:0] = [{root!r}]
import bench.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("bench.reference." + m.name)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    root = bench_tiny.ROOT
    src = code.format(src=str(root / "src"), root=str(root),
                      tests=str(root / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax():
    mods = _top_level(RUN_CELLS)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _top_level(LOAD_REFERENCE)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_harness_refuses_a_loaded_jax_package(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro", object())
    assert harness.loaded_forbidden() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert harness.loaded_forbidden() == []
