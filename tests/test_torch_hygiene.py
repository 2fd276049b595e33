"""Import and device hygiene of the PyTorch port: it never pulls in jax or
the JAX package, its entry points never fall back to the CPU silently,
and its dtype/precision policy holds."""

import ast
import os
import subprocess
import sys
from pathlib import Path

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax  # noqa: F401  (imported beside torch, as in every port test)

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

from repro_torch import FLOAT, INDEX, dpp
from repro_torch import random as prng
from repro_torch.convert import (dual_spectrum_from_numpy, key_from_numpy,
                                  kron_from_numpy, lowrank_from_numpy,
                                  spectrum_from_numpy,
                                  subset_batch_from_numpy)
from repro_torch.core import SubsetBatch, fit_picard, random_krondpp
from repro_torch.learning import LearningEngine, fit, schedules
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.optim import OptState
from repro_torch.data import DPPBatchSelector
from repro_torch.launch.learn import main as learn_main
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.lowrank.learn import fit_lowrank
from repro_torch.models import LM
from repro_torch.serve import ServeEngine
from repro_torch.sampling import SamplingService
from repro_torch.serving import (AsyncSamplingService, ContinuousBatcher,
                                 KVCompactionClient, TenantKeyring)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples" / "port").glob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    code = ("import sys, repro_torch, repro_torch.dpp, "
            "repro_torch.sampling.service, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.partial_trace, repro_torch.core.krk_picard, "
            "repro_torch.learning, repro_torch.learning.api, "
            "repro_torch.dpp.functional, repro_torch.sampling.kdpp, "
            "repro_torch.core.sampling, repro_torch.kernels.greedy_map, "
            "repro_torch.kernels.kron_matvec, repro_torch.core.kron, "
            "repro_torch.core.clustering, repro_torch.core.dpp, "
            "repro_torch.random, repro_torch.serving, "
            "repro_torch.kernels.threefry, repro_torch.checkpoint, "
            "repro_torch.checkpoint.manager, repro_torch.core.em, "
            "repro_torch.core.picard, repro_torch.core.joint_picard, "
            "repro_torch.lowrank, repro_torch.lowrank.dual, "
            "repro_torch.lowrank.sample, repro_torch.lowrank.model, "
            "repro_torch.lowrank.learn, repro_torch.lowrank.features, "
            "repro_torch.serving.service, repro_torch.serving.batcher, "
            "repro_torch.serving.queues, repro_torch.serving.kv, "
            "repro_torch.serve.kv_compaction, repro_torch.obs.export, "
            "repro_torch.obs.report, repro_torch.dpp.runtime, "
            "repro_torch.core.distributed, repro_torch.config, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.common, repro_torch.models.attention, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.transformer, repro_torch.serve, "
            "repro_torch.serve.engine, repro_torch.launch, "
            "repro_torch.launch.serve, repro_torch.launch.learn, "
            "repro_torch.launch.train, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.data.dpp_selection, "
            "repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.train, repro_torch.train.steps, "
            "repro_torch.train.trainer, repro_torch.distributed, "
            "repro_torch.distributed.sharding, "
            "repro_torch.distributed.constraints, "
            "repro_torch.distributed.elastic, "
            "repro_torch.distributed.shard_ops, repro_torch.launch.mesh, "
            "repro_torch.optim.compression, repro_torch.launch.dryrun\n"
            "import repro_torch.configs as c\n"
            "[c.get_config(a) for a in c.list_archs()]\n"
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
    lambda: dpp.Kron((np.eye(3),), device="cpu").sample(torch.Generator(),
                                                        2, k=2),
    lambda: dpp.Kron((np.eye(2), np.eye(3))).map(2),
    lambda: SamplingService(dpp.Kron((np.eye(3),), device="cpu")
                            ).sample_kdpp(2),
    lambda: prng.PRNGKey(0),
    lambda: key_from_numpy(np.zeros(2, np.uint32)),
    lambda: TenantKeyring(0),
    lambda: random_krondpp(prng.PRNGKey(0, "cpu"), (3, 3)),
    lambda: dpp.Kron((np.eye(3),), device="cpu").sample(
        prng.PRNGKey(0, "cpu"), 2),
    lambda: fit(np.eye(6), SubsetBatch.from_lists([[0, 1]], device="cpu"),
                algorithm="em"),
    lambda: fit((np.eye(2), np.eye(3)),
                SubsetBatch.from_lists([[0, 1]], device="cpu"),
                algorithm="joint"),
    lambda: dpp.Dense(np.eye(3), device="cpu").fit(
        SubsetBatch.from_lists([[0, 1]], device="cpu")),
    lambda: fit_picard(np.eye(3), SubsetBatch.from_lists([[0, 1]],
                                                         device="cpu")),
    lambda: dpp.LowRank(np.ones((4, 2))),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").fit(
        SubsetBatch.from_lists([[0, 1]], device="cpu")),
    lambda: fit((np.ones((4, 2)), np.ones(4)),
                SubsetBatch.from_lists([[0, 1]], device="cpu"),
                algorithm="lowrank"),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").sample(
        prng.PRNGKey(0, "cpu"), 2, k=1),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").spectrum().to("cuda"),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").sample(
        prng.PRNGKey(0, "cpu"), 2),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").service(),
    lambda: lowrank_from_numpy(np.ones((4, 2)), np.ones(4)),
    lambda: dual_spectrum_from_numpy(np.ones((4, 2)), np.ones(2), np.eye(2)),
    lambda: fit_lowrank((np.ones((4, 2)), np.ones(4)),
                        SubsetBatch.from_lists([[0, 1]], device="cpu")),
    lambda: dpp.Kron((np.eye(3),), device="cpu").serving(),
    lambda: AsyncSamplingService(dpp.Kron((np.eye(3),), device="cpu")),
    lambda: dpp.LowRank(np.ones((4, 2)), device="cpu").serving(
        tenant_models={"a": dpp.LowRank(np.ones((4, 2)), device="cpu")}),
    lambda: KVCompactionClient(4, 1),
    lambda: ContinuousBatcher(),
    lambda: dpp.Mesh(axes={"data": 2}, devices=["cuda"] * 2).mesh,
    lambda: dpp.Kron((np.eye(3),), device="cpu").sample(
        prng.PRNGKey(0, "cpu"), 2, runtime=dpp.Host()),
    lambda: dpp.Kron((np.eye(2), np.eye(3)), device="cpu").fit(
        SubsetBatch.from_lists([[0, 1]], device="cpu"),
        runtime=dpp.Mesh(axes={"data": 1}, devices=["cpu"])),
    lambda: LM(smoke_config("qwen2-0.5b")),
    lambda: ServeEngine(LM(smoke_config("qwen2-0.5b"), device="cpu"), {}),
    lambda: serve_main(["--arch", "qwen2-0.5b", "--smoke"]),
    lambda: lm_params_from_numpy({"w": np.zeros(2, np.float32)}),
    lambda: DPPBatchSelector.from_features(np.ones((6, 2)), 2, 3),
    lambda: DPPBatchSelector.from_features(np.ones((6, 2)), 2, 3,
                                           method="lowrank", rank=2),
    lambda: DPPBatchSelector(dpp.Kron((np.eye(2), np.eye(3)), device="cpu"),
                             2, 3),
    lambda: LM(smoke_config("qwen2-0.5b")).loss_fn({}, {}),
    lambda: opt_state_from_numpy(OptState(np.zeros((), np.int32), {}, {})),
    lambda: train_main(["--arch", "qwen2-0.5b", "--smoke"]),
    lambda: learn_main(["--n1", "3", "--n2", "3"]),
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
        ["greedy_map", "kron_matvec", "partial_trace", "phase2_select",
         "threefry"]
    assert _build.library_path("phase2_select").parent == _build.BUILD_DIR


TEST_FILES = sorted((ROOT / "tests").glob("test_torch_*.py"))


@pytest.mark.parametrize("path", TEST_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_tests_pin_the_jax_reference_to_the_cpu(path):
    """Every port test file stops jax's preallocation before jax's first
    import and forces jax onto the CPU before any use of it, so that on a
    machine whose environment offers jax a card the reference neither runs
    there nor takes its memory."""
    src = path.read_text()
    prealloc = src.index('os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = '
                         '"false"')
    first_import = src.index("\nimport jax")
    pin = src.index('\njax.config.update("jax_platforms", "cpu")\n')
    assert prealloc < first_import < pin
    later = [src.find(m, first_import + 1)
             for m in ("\nimport jax.", "\nfrom jax", "\nfrom repro ",
                       "\nfrom repro.", "\nimport repro.")]
    assert all(i < 0 or pin < i for i in later), path.name
    assert "JAX_PLATFORMS\", \"cpu\")" not in src    # no setdefault left


def test_the_jax_reference_computes_on_the_cpu():
    """In a port test process the JAX package's results live on the CPU
    device."""
    import jax.numpy as jnp
    from repro import dpp as jdpp
    cpu = jax.devices("cpu")[0]
    assert jax.default_backend() == "cpu"
    model = jdpp.from_kernel(jnp.eye(3) * 2.0)
    assert model.log_prob(model.sample(jax.random.PRNGKey(0), 2)).devices() \
        == {cpu}


# The JAX package's public names with no counterpart in the port, each with
# its reason: a module path (a whole module, or every module under a
# directory ending in "/") or "module:name".
UNPORTED = {
    "analysis/": "a lint engine over the JAX package's own sources (its "
                 "rules check jax.shard_map, Pallas and PRNG use); it has "
                 "nothing to check in the port, whose import hygiene this "
                 "file pins",
    "kernels/ref.py": "the Pallas kernels' jnp oracles: each CUDA kernel's "
                      "plain PyTorch version beside it plays that role",
    "kernels/phase2_select.py:phase2_select_pallas":
        "a Pallas TPU kernel: ported as csrc/phase2_select.cu "
        "(phase2_select_cuda)",
    "kernels/partial_trace.py:partial_trace_A_pallas":
        "a Pallas TPU kernel: ported as csrc/partial_trace.cu "
        "(partial_trace_A_cuda)",
    "kernels/partial_trace.py:partial_trace_C_pallas":
        "a Pallas TPU kernel: ported as csrc/partial_trace.cu "
        "(partial_trace_C_cuda)",
    "kernels/greedy_map.py:greedy_map_update_pallas":
        "a Pallas TPU kernel: ported as csrc/greedy_map.cu "
        "(greedy_map_update_cuda; greedy_map_kdpp_cuda for the whole "
        "selection)",
    "kernels/kron_matvec.py:kron_matvec_pallas":
        "a Pallas TPU kernel: ported as csrc/kron_matvec.cu "
        "(kron_matvec_cuda)",
    "core/distributed.py:shard_map_compat":
        "a shim over jax.shard_map's moving API; the port's sharded sweep "
        "runs over dpp.runtime.Mesh and needs no shard_map",
    "launch/dryrun.py:SDS": "jax.ShapeDtypeStruct; the port's planner "
                            "takes shapes as meta and fake tensors",
    "launch/dryrun.py:parse_collectives":
        "reads XLA's compiled HLO text; the port's planner counts "
        "collectives as they run (CommDebugMode and its dispatch mode)",
}


def _public_surface(path: Path):
    """(a module's own top-level public definitions and ``__all__``, every
    name it binds at top level): functions, classes, assigned names and
    imports."""
    tree = ast.parse(path.read_text())
    own, bound, exported = set(), set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            own.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                own.add(t.id)
                if t.id == "__all__":
                    exported |= {e.value for e in node.value.elts
                                 if isinstance(e, ast.Constant)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound |= {(a.asname or a.name).split(".")[0] for a in node.names}
    public = {n for n in own | exported if not n.startswith("_")}
    return public, own | bound | exported


def test_every_public_name_of_the_reference_has_a_counterpart():
    """Walk ``src/repro/**`` against ``src/repro_torch/**`` file by file:
    every top-level public name and export of the JAX package is defined,
    imported or exported by the port's module of the same path, or is on
    ``UNPORTED`` with its reason — and everything on ``UNPORTED`` is
    still missing."""
    ref_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing = set()
    for ref in sorted(ref_root.rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        port = port_root / rel
        if not port.is_file():
            top = rel.split("/")[0] + "/"
            missing.add(top if f"{top}" in UNPORTED else rel)
            continue
        public, _ = _public_surface(ref)
        _, have = _public_surface(port)
        missing |= {f"{rel}:{n}" for n in public - have}
    assert missing == set(UNPORTED), (
        sorted(missing - set(UNPORTED)), sorted(set(UNPORTED) - missing))
    assert all(reason.strip() for reason in UNPORTED.values())
