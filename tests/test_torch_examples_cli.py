"""The PyTorch port's example scripts run as scripts on the CPU
(``--device cpu``), at their smallest sizes: ``serve_kv_compaction``
coalesces both streams' KV heads into fewer device calls than heads, and
``train_dpp_selection`` reaches its final step after a calibration whose
log-likelihood does not drop. Without ``--device`` every example asks for
a card and raises here, where there is none."""

import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (imported beside torch, as in every port test)

jax.config.update("jax_platforms", "cpu")

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "port"
SCRIPT_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """Both scripts started together; {name: (exit code, stdout+stderr)}."""
    ck = tmp_path_factory.mktemp("examples_cli") / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    argv = {"serve_kv_compaction": ["--device", "cpu"],
            "train_dpp_selection": ["--steps", "8", "--docs", "64",
                                    "--batch", "8", "--device", "cpu",
                                    "--checkpoint-dir", str(ck)]}
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py"), *args], env=env,
        cwd=str(ck.parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, args in argv.items()}
    out = {}
    for name, p in procs.items():
        try:
            text, _ = p.communicate(timeout=SCRIPT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
        out[name] = (p.returncode, text)
    out["checkpoint_dir"] = ck
    return out


def test_serve_kv_compaction_coalesces_the_streams_heads(scripts):
    code, text = scripts["serve_kv_compaction"]
    assert code == 0, text[-3000:]
    assert "compacted decode:   cache 48 -> 24 slots/layer" in text, text
    m = re.search(r"device_calls=(\d+) for (\d+) kv-heads", text)
    assert m, text
    calls, heads = int(m.group(1)), int(m.group(2))
    # 2 streams x 4 rows x 2 layers x 2 KV heads of the smoke config
    assert heads == 32 and 1 <= calls < heads, (calls, heads)
    for tenant in ("interactive", "batch"):
        assert re.search(rf"{tenant}\s+tokens \(4, 12\)", text), text
    assert "== slowest 2 of 2 traces ==" in text, text


def test_train_dpp_selection_calibrates_then_trains_to_the_end(scripts):
    code, text = scripts["train_dpp_selection"]
    assert code == 0, text[-3000:]
    m = re.search(r"kernel calibration: ll (\S+) -> (\S+) over 32 observed",
                  text)
    assert m, text
    assert float(m.group(2)) >= float(m.group(1)), m.group(0)
    m = re.search(r"done at step (\d+); loss (\S+) -> (\S+)", text)
    assert m and int(m.group(1)) == 8, text
    assert sorted(p.name for p in scripts["checkpoint_dir"].iterdir()), \
        "no checkpoint written"


@pytest.mark.parametrize("name", ["quickstart", "prune_ffn_dpp",
                                  "serve_kv_compaction",
                                  "train_dpp_selection"])
def test_example_without_a_card_raises(name, tmp_path):
    """The default ``--device`` is "cuda": with no card the script raises
    ``RuntimeError`` instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        f"port_example_cli_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--checkpoint-dir", str(tmp_path)] \
        if name == "train_dpp_selection" else []
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
