"""The port's planner (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) at smoke size, and its accounting.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices
in ``os.environ``, which would change jax's device count for every later
test of this process and for its children; so the reference runs in one
subprocess (``tests/_dryrun_reference.py``), started first and read when
the port's records are done. There the production mesh takes the port's
shapes, (32, 8) and (2, 32, 8), so that both plan on one layout.

The cells are the smoke configs (``configs.smoke_config``) with one
attention query chunk a cell (``attn_chunk`` = the cell's sequence),
SSD chunks of 4096, and, for attention archs, 8 heads of 8 (they divide
the model axis, as the full configs' heads mostly do): the reference's
depth probes unroll every chunk, and one chunk keeps its compile short.

* ``_unit_size`` and ``microbatches_for`` (at the reference's 6 GiB) for
  every cell and data-parallel size: equal.
* ``input_specs``: the shape and dtype of every leaf for every cell:
  equal.
* records: ``params``, ``active_params``, ``microbatches``, ``mesh``,
  ``chips`` equal; ``argument_size_in_bytes`` equal where no input is
  sharded unevenly (``uneven_shards`` 0; where one is, the reference
  pads every block to rank 0's size).
* ``flops_per_device`` within a factor ``FLOP_TOL`` = 2 of the
  reference's depth-extrapolated count: the port counts matrix products
  only, XLA every elementwise op as well, a large share at smoke widths
  (measured ratios in the docstring of the test). The control, the
  global count (x the mesh's ranks), fails that tolerance.
"""

import dataclasses
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
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import cells, get_config, get_shape, smoke_config
from repro_torch.distributed.sharding import map_with_path
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models import LM

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = Path(__file__).with_name("_dryrun_reference.py")
GIB6 = 6 * 2 ** 30
FLOP_TOL = 2.0
N_DATA = (1, 8, 16, 32, 64)
# (arch, shape, multi_pod): every family and kind, both meshes
CELLS = [("qwen2-0.5b", "train_4k", False),
         ("mixtral-8x7b", "decode_32k", False),
         ("mixtral-8x7b", "decode_32k", True),
         ("mamba2-2.7b", "prefill_32k", True),
         ("jamba-1.5-large-398b", "long_500k", False),
         ("whisper-tiny", "decode_32k", True)]
CELL_IDS = [f"{a}-{s}-{512 if mp else 256}" for a, s, mp in CELLS]
# the cells whose FLOPs are held against the reference's depth probes
FLOP_CELLS = [c for c in CELLS if not c[2]]


def overrides(arch: str, shape: str) -> dict:
    """The smoke config of ``arch`` as overrides of the full one, with one
    attention chunk a cell, SSD chunks of 4096 and 8 heads of 8."""
    full, smoke = get_config(arch), smoke_config(arch)
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
          if f.name != "name"
          and getattr(smoke, f.name) != getattr(full, f.name)}
    ov.update(attn_chunk=get_shape(shape).seq_len, ssm_chunk=4096)
    if full.n_heads:
        ov.update(n_heads=8, n_kv_heads=8, head_dim=8)
    return ov


def _json_overrides(ov: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in ov.items()}


def flat_specs(tree) -> dict:
    """{path: [shape, dtype name]} of every tensor leaf."""
    out = {}
    map_with_path(lambda path, leaf: out.__setitem__(
        path, [list(leaf.shape), str(leaf.dtype).replace("torch.", "")]),
        tree)
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(port records, port records with depth probes, reference output):
    the reference's subprocess runs while the port plans."""
    work = tmp_path_factory.mktemp("dryrun")
    spec = {"records": [dict(arch=a, shape=s, multi_pod=mp,
                             overrides=_json_overrides(overrides(a, s)))
                        for a, s, mp in CELLS],
            "microbatches": [[a, s, n] for a, s in cells() for n in N_DATA],
            "specs": [[a, s] for a, s in cells()]}
    spec["extrapolated"] = [r for r in spec["records"] if not r["multi_pod"]]
    (work / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, str(REFERENCE), str(work / "spec.json"),
         str(work / "ref.json")], env=env, stdout=subprocess.DEVNULL,
        stderr=open(work / "ref.log", "w"))
    try:
        port, probed = [], {}
        for arch, shape, mp in CELLS:
            with dryrun.fake_world():
                if mp:
                    rec, _ = dryrun.compile_once(
                        arch, shape, mp, cfg_overrides=overrides(arch, shape),
                        device="cpu", budget=GIB6)
                else:
                    rec = dryrun.lower_cell(
                        arch, shape, mp, cfg_overrides=overrides(arch, shape),
                        device="cpu", budget=GIB6)
                    probed[(arch, shape)] = rec
            port.append(rec)
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    return port, probed, json.loads((work / "ref.json").read_text())


@pytest.mark.parametrize("arch", sorted({a for a, _ in cells()}))
def test_unit_size_and_microbatches_match_the_reference(records, arch):
    """``_unit_size`` of the full config, and ``microbatches_for`` of every
    cell at data-parallel sizes 1, 8, 16, 32, 64 with the reference's
    6 GiB budget, equal the reference's."""
    _, _, ref = records
    cfg = get_config(arch)
    assert dryrun._unit_size(cfg) == ref["unit_size"][arch]
    rows = [r for r in ref["microbatches"] if r[0] == arch]
    assert len(rows) == len(N_DATA) * sum(a == arch for a, _ in cells())
    for _, shape, n_data, want in rows:
        got = dryrun.microbatches_for(cfg, get_shape(shape), n_data, GIB6)
        assert got == want, (shape, n_data, got, want)


@pytest.mark.parametrize("cell", cells(), ids=[f"{a}-{s}" for a, s in
                                                cells()])
def test_input_specs_match_the_references_eval_shape(records, cell):
    """``input_specs`` of the full config (meta tensors, no values): every
    leaf's shape and dtype as the reference's ``eval_shape``, the decode
    state's caches and whisper's encoder states included."""
    _, _, ref = records
    arch, shape = cell
    cfg = get_config(arch)
    got = flat_specs(dryrun.input_specs(cfg, get_shape(shape),
                                        LM(cfg, device="meta")))
    assert all(leaf[0] is not None for leaf in got.values())
    assert got == ref["specs"][f"{arch}/{shape}"]


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_records_match_the_reference(records, cell):
    """``params``, ``active_params``, ``microbatches``, ``mesh`` and
    ``chips`` equal the reference's record; ``argument_size_in_bytes``
    equals it where no input is sharded unevenly."""
    port, _, ref = records
    i = CELLS.index(cell)
    got, want = port[i], ref["records"][i]
    for key in ("params", "active_params", "microbatches", "mesh", "chips",
                "kind", "seq_len", "global_batch"):
        assert got.get(key) == want.get(key), key
    assert got["device"] == "cpu" and "error" not in got
    if got["uneven_shards"] == 0:
        assert got["argument_size_in_bytes"] == \
            want["argument_size_in_bytes"]
    assert got["temp_size_in_bytes"] > 0 and got["flops_per_device"] > 0


def test_argument_bytes_compared_on_every_cell(records):
    """With 8 heads of 8 every input of these cells divides over its mesh
    dims, so the exact argument-bytes check above runs on every cell."""
    port, _, _ = records
    assert all(r["uneven_shards"] == 0 for r in port)


@pytest.mark.parametrize("cell", FLOP_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in FLOP_CELLS])
def test_flops_per_rank_within_tolerance_of_the_reference(records, cell):
    """The port's per-rank FLOPs (matrix products, counted on local shards
    over the full depth) within a factor ``FLOP_TOL`` of the reference's
    ``flops_extrapolated`` (measured ratios, 256-card mesh: 0.68 for
    jamba's ``long_500k``, 0.88 for qwen2's ``train_4k``, 1.55 for
    mixtral's ``decode_32k``, whose capacity slots the port multiplies
    whole);
    the control, the same count times the mesh's 256 ranks (a count of
    the global op), is outside it."""
    _, probed, ref = records
    arch, shape, _ = cell
    got = probed[(arch, shape)]["flops_per_device"]
    want = next(r for r in ref["extrapolated"] if r["arch"] == arch
                and r["shape"] == shape)["flops_extrapolated"]
    assert 1 / FLOP_TOL <= got / want <= FLOP_TOL, (got, want, got / want)
    assert not 1 / FLOP_TOL <= 256 * got / want <= FLOP_TOL


@pytest.mark.parametrize("cell", FLOP_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in FLOP_CELLS])
def test_depth_probes_extrapolate_to_the_full_depth_count(records, cell):
    """At smoke size every unit does the same work, so the depth-1 and
    depth-2 probes extrapolate (the reference's formula) to the
    full-depth run's FLOPs and collective bytes and counts exactly."""
    _, probed, _ = records
    rec = probed[(cell[0], cell[1])]
    assert rec["flops_extrapolated"] == rec["flops_per_device"]
    for key in ("bytes_by_op", "counts"):
        assert rec["collectives_extrapolated"][key] == \
            rec["collectives"][key], key


def test_flop_count_is_a_ranks_share_of_a_known_product():
    """(256 x 4096) @ (4096 x 4096) on a (2, 16, 16) fake mesh, rows over
    (pod, data) and columns over "model": ``LocalCounter`` counts one
    rank's 2·8·4096·256, the global 2·256·4096·4096 over 512.
    ``FlopCounterMode`` entered outside DTensor's dispatch counts the
    global product, the control."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with dryrun.fake_world():
        mesh = make_mesh_from_devices(range(512), (2, 16, 16),
                                      ("pod", "data", "model"))
        fake = FakeTensorMode()
        with fake:
            a = torch.empty(8, 4096)
            w = torch.empty(4096, 256)
        A = DTensor.from_local(a, mesh, [Shard(0), Shard(0), Replicate()],
                               run_check=False)
        W = DTensor.from_local(w, mesh, [Replicate(), Replicate(), Shard(1)],
                               run_check=False)
        counter, control = dryrun.LocalCounter(), FlopCounterMode(
            display=False)
        with fake, counter:
            y = A @ W
        with fake, control:
            A @ W
    assert tuple(y.to_local().shape) == (8, 256)
    assert counter.flops == 2 * 8 * 4096 * 256 == 2 * 256 * 4096 * 4096 // 512
    assert control.get_total_flops() == 2 * 256 * 4096 * 4096
    assert not dist.is_initialized()


def test_planner_refuses_a_running_group_and_removes_its_own(tmp_path):
    """With a process group up the planner refuses to start; after a plan
    no process group is left."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world():
                pass
    finally:
        dist.destroy_process_group()
    with dryrun.fake_world():
        assert dist.get_world_size() == 512
    assert not dist.is_initialized()


def _wrappers():
    from repro_torch.kernels import (greedy_map, kron_matvec, partial_trace,
                                     phase2_select, theta_scatter, threefry)
    f32 = torch.float32
    return {
        "phase2_select": lambda m: phase2_select.phase2_select_cuda(
            m((2, 4), f32), m((2,), torch.int32), m((4, 4), f32),
            m((4, 4), f32)),
        "partial_trace_A": lambda m: partial_trace.partial_trace_A_cuda(
            m((2, 3, 2, 3), f32), m((3, 3), f32)),
        "partial_trace_C": lambda m: partial_trace.partial_trace_C_cuda(
            m((2, 3, 2, 3), f32), m((2, 2), f32)),
        "greedy_map_update": lambda m: greedy_map.greedy_map_update_cuda(
            m((4,), f32), m((4, 2), f32), m((2,), f32), m((1,), f32),
            m((4,), f32)),
        "greedy_map_kdpp": lambda m: greedy_map.greedy_map_kdpp_cuda(
            m((4, 4), f32), 2),
        "kron_matvec": lambda m: kron_matvec.kron_matvec_cuda(
            m((2, 2), f32), m((3, 3), f32), m((1, 6), f32)),
        "threefry2x32": lambda m: threefry.threefry2x32_cuda(
            m((4, 2), torch.int64), 8, "uniform"),
        "theta_scatter": lambda m: theta_scatter.theta_scatter_cuda(
            6, m((2, 3), torch.int32), m((2, 3), torch.bool),
            m((2, 3, 3), f32)),
    }


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_kernel_wrappers_raise_on_fake_and_meta_tensors(name):
    """Every ctypes kernel wrapper raises ``ValueError`` on a meta tensor
    and on a fake tensor (the planner's), before it builds or launches
    anything, whatever the tensor's device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    call = _wrappers()[name]
    with pytest.raises(ValueError, match="meta tensor"):
        call(lambda shape, dt: torch.empty(shape, dtype=dt, device="meta"))
    fake = FakeTensorMode()

    def make(shape, dt):
        with fake:
            return torch.empty(shape, dtype=dt)
    with pytest.raises(ValueError, match="fake tensor"):
        call(make)


def test_cli_wants_a_budget_or_a_card():
    """``--device cpu`` without ``--budget-gib``, and ``--device cuda``
    without a card, stop before planning anything."""
    with pytest.raises(SystemExit):
        dryrun.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--out",
                     os.devnull])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "qwen2-0.5b", "--out", os.devnull])
    assert not dist.is_initialized()


def test_planned_argument_bytes_of_a_one_rank_step_equal_the_real_trees():
    """``plan_step`` on a fake group of one rank and a (1, 1) mesh (phase
    28's check on the card, here at smoke size on the CPU): the planned
    ``argument_size_in_bytes`` of a train step equals the bytes of the real
    params, both AdamW moments, the step and an int32 batch."""
    from repro_torch.config import ShapeConfig
    cfg = smoke_config("qwen2-0.5b")
    params = LM(cfg, device="cpu").init_params(torch.zeros(2, dtype=torch
                                                           .int64))
    real = sum(3 * a.numel() * 4 for a in map_with_path_leaves(params))
    real += 4 + 8 * 33 * 4              # the step; tokens (8, 33) int32
    with dryrun.fake_world(1):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        rec = dryrun.plan_step(cfg, ShapeConfig("t", 32, 8, "train"), mesh,
                               device="cpu", microbatches=1)
    assert rec["argument_size_in_bytes"] == real
    assert rec["temp_size_in_bytes"] > 0 and rec["microbatches"] == 1
    assert sum(rec["collectives"]["counts"].values()) == 0


def map_with_path_leaves(tree) -> list:
    out = []
    map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out
