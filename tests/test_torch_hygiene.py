"""Import and device hygiene of the PyTorch port: it never pulls in jax or
the JAX package, its entry points never fall back to the CPU silently,
and its dtype/precision policy holds."""

import ast
import os
import subprocess
import sys
from pathlib import Path

# the JAX reference runs on the CPU, never on the card
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: F401  (imported beside torch, as in every port test)
import numpy as np
import pytest
import torch

from repro_torch import FLOAT, INDEX, dpp
from repro_torch.convert import (kron_from_numpy, spectrum_from_numpy,
                                  subset_batch_from_numpy)
from repro_torch.core import SubsetBatch, random_krondpp
from repro_torch.learning import LearningEngine, fit, schedules
from repro_torch.sampling import SamplingService

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    code = ("import sys, repro_torch, repro_torch.dpp, "
            "repro_torch.sampling.service, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.partial_trace, repro_torch.core.krk_picard, "
            "repro_torch.learning, repro_torch.learning.api\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", r.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import_in_port_sources(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {mod}"


@pytest.mark.parametrize("call", [
    lambda: random_krondpp(torch.Generator(), (3, 3)),
    lambda: dpp.random_kron(torch.Generator(), (3, 3)),
    lambda: dpp.Kron((np.eye(3), np.eye(2))),
    lambda: dpp.from_kernel(np.eye(3)),
    lambda: dpp.from_factors(np.eye(3), np.eye(2)),
    lambda: dpp.Kron((np.eye(3),), device="cpu").sample(torch.Generator(),
                                                        2),
    lambda: dpp.Kron((np.eye(3),), device="cpu").service(),
    lambda: SamplingService(dpp.Kron((np.eye(3),), device="cpu")),
    lambda: kron_from_numpy([np.eye(3)]),
    lambda: spectrum_from_numpy([np.ones(3)], [np.eye(3)]),
    lambda: SubsetBatch.from_lists([[0, 1]]),
    lambda: subset_batch_from_numpy(np.zeros((1, 2), np.int32),
                                    np.ones((1, 2), bool)),
    lambda: schedules.init_state(schedules.armijo()),
    lambda: LearningEngine().init_state((np.eye(2), np.eye(3))),
    lambda: fit((np.eye(2), np.eye(3)),
                SubsetBatch.from_lists([[0, 1]], device="cpu")),
    lambda: dpp.Kron((np.eye(2), np.eye(3)), device="cpu").fit(
        SubsetBatch.from_lists([[0, 1]], device="cpu")),
])
def test_entry_points_without_a_card_raise(call):
    """Every entry point defaults to device="cuda"; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_dtype_and_precision_policy():
    assert FLOAT == torch.float32 and INDEX == torch.int32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    m = dpp.Kron((np.eye(3, dtype=np.float64), np.eye(2)), device="cpu")
    assert all(f.dtype == torch.float32 for f in m.factors)
    picks = m.sample(torch.Generator(), 3, device="cpu").indices
    assert picks.dtype == torch.int32


def test_kernel_build_is_deferred_to_first_launch():
    """Importing the kernel modules builds and loads nothing: the build
    directory and nvcc are touched only by a launch on a card."""
    from repro_torch.kernels import _build
    assert _build._LIBS == {}
    assert _build.source_path("phase2_select").is_file()
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        ["partial_trace", "phase2_select"]
    assert _build.library_path("phase2_select").parent == _build.BUILD_DIR
