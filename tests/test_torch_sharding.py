"""The sharding rules and tables of the PyTorch port
(``repro_torch.distributed``, ``repro_torch.launch.mesh``,
``repro_torch.optim.compression``) against the JAX package's, in one
process.

The reference's rule table reads only the mesh's axis sizes, so both
packages get the same ``jax.sharding.AbstractMesh`` (a ``shape`` mapping
and ``axis_names``, no devices). Specs are compared as tuples, one entry a
tensor dim: exact equality. The elastic plans and the production meshes
are built over an in-process ``fake`` process group (no collective runs),
destroyed after each test. ``_quantize`` is compared bit for bit. The
multi-process cases (gloo ranks running the sharded step) are in
``tests/test_torch_sharded_train.py``.
"""

import functools
import os

# the JAX reference runs on the CPU and takes none of a card's memory, even
# where the environment offers jax a card (JAX_PLATFORMS=cuda,cpu)
os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro import configs as jconfigs
from repro.config import ParallelConfig as JaxParallelConfig
from repro.distributed.elastic import elastic_remesh as jax_elastic_remesh
from repro.distributed.sharding import ShardingPolicy as JaxPolicy
from repro.distributed.sharding import _path_str
from repro.models import LM as JaxLM
from repro.optim.compression import _quantize as jax_quantize
from repro_torch import configs as tconfigs
from repro_torch import random as tr
from repro_torch.config import ParallelConfig
from repro_torch.distributed import ShardingPolicy
from repro_torch.distributed.constraints import (constrain, constrain_bsd,
                                                 constrain_heads,
                                                 constrain_params,
                                                 current_mesh, use_mesh)
from repro_torch.distributed.elastic import elastic_remesh
from repro_torch.distributed.sharding import path_leaves, spec_to_placements
from repro_torch.launch.mesh import (data_axes, make_mesh_from_devices,
                                     make_production_mesh, model_axis)
from repro_torch.models import LM
from repro_torch.optim.compression import _quantize

ARCHS = tconfigs.list_archs()
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x16x8": ((2, 16, 8), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}
PARALLEL = [(fsdp, tp) for fsdp in (True, False) for tp in (True, False)]


def abstract(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def reference_shapes(arch: str, smoke: bool = False):
    """{path: shape} of the JAX ``init_params`` (``jax.eval_shape``)."""
    get = jconfigs.smoke_config if smoke else jconfigs.get_config
    tree = jax.eval_shape(JaxLM(get(arch)).init_params,
                          jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(kp): tuple(leaf.shape) for kp, leaf in flat}


def port_params(arch: str, smoke: bool = False):
    """The port's ``init_params`` on the meta device (shapes only)."""
    get = tconfigs.smoke_config if smoke else tconfigs.get_config
    return LM(get(arch), device="meta").init_params(tr.PRNGKey(0, "meta"))


def port_shapes(arch: str, smoke: bool = False):
    """{path: shape} of the port's ``init_params``."""
    return {path: tuple(leaf.shape)
            for path, leaf in path_leaves(port_params(arch, smoke))}


@pytest.fixture
def fake_group():
    """An in-process ``fake`` process group of ``world`` ranks (this
    process rank ``rank``, 0 unless given), destroyed after the test."""
    def start(world, rank=0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references_at_full_size(arch, mesh_name):
    """Every leaf of the full config: ``ShardingPolicy.param_spec`` of the
    port equals the reference's, with fsdp and tp each on and off."""
    mesh = abstract(mesh_name)
    want_shapes = reference_shapes(arch)
    got_shapes = port_shapes(arch)
    assert got_shapes == want_shapes
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for fsdp, tp in PARALLEL:
        ref = JaxPolicy(mesh, jcfg, JaxParallelConfig(fsdp=fsdp, tp=tp))
        port = ShardingPolicy(mesh, tcfg, ParallelConfig(fsdp=fsdp, tp=tp))
        for path, shape in want_shapes.items():
            assert port.param_spec(path, shape) == \
                tuple(ref.param_spec(path, shape)), (path, fsdp, tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_paths_equal_the_references_at_smoke_size(arch):
    """The port's smoke-size params carry the reference's paths and
    shapes, so the rule table sees the same leaves; ``params_shardings``
    maps each to its ``param_spec``."""
    got = port_shapes(arch, smoke=True)
    assert got == reference_shapes(arch, smoke=True)
    mesh = abstract("4x2")
    policy = ShardingPolicy(mesh, tconfigs.smoke_config(arch))
    shardings = dict(path_leaves(policy.params_shardings(
        port_params(arch, smoke=True))))
    assert set(shardings) == set(got)
    for path, sh in shardings.items():
        assert sh.spec == policy.param_spec(path, got[path])
        assert sh.mesh is mesh


def test_mixtral_expert_and_attention_specs_as_the_reference_tests():
    """``tests/test_distributed.py::test_sharding_policy_specs`` on the
    port: experts over model and their last dim over data, wq's out dim
    over model."""
    shapes = port_shapes("mixtral-8x7b")
    policy = ShardingPolicy(abstract("4x2"),
                            tconfigs.get_config("mixtral-8x7b"))
    path = "blocks/head/layer0/moe/w_gate"
    spec = policy.param_spec(path, shapes[path])
    assert spec[1] == "model" and spec[3] in ("data", ("data",)), spec
    path = "blocks/head/layer0/attn/wq"
    assert policy.param_spec(path, shapes[path])[2] == "model"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-1.5-large-398b",
                                  "whisper-tiny", "mamba2-2.7b"])
def test_batch_decode_and_logits_specs_equal_the_references(arch,
                                                            mesh_name):
    """``batch_shardings`` (a batch of 256 and of 3 rows, and a scalar),
    ``decode_state_shardings`` of the reference's decode state at 128
    rows and at 1 row (the long-context SP case), ``logits_shardings``
    and ``replicated``: the port's specs equal the reference's, with
    every ParallelConfig toggle."""
    mesh = abstract(mesh_name)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jlm = JaxLM(jcfg)
    enc = None
    params = jax.eval_shape(jlm.init_params, jax.random.PRNGKey(0)) \
        if jcfg.encoder_layers else None
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4097), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 8), jnp.int32),
             "scalar": jax.ShapeDtypeStruct((), jnp.float32)}
    for fsdp, tp in PARALLEL:
        for seq_shard in (True, False):
            ref = JaxPolicy(mesh, jcfg, JaxParallelConfig(
                fsdp=fsdp, tp=tp, seq_shard_decode=seq_shard))
            port = ShardingPolicy(mesh, tcfg, ParallelConfig(
                fsdp=fsdp, tp=tp, seq_shard_decode=seq_shard))
            want = ref.batch_shardings(batch)
            got = port.batch_shardings(batch)
            for k in batch:
                assert got[k].spec == tuple(want[k].spec), k
            for rows in (128, 1):
                if jcfg.encoder_layers:
                    enc = jax.ShapeDtypeStruct(
                        (rows, jcfg.encoder_seq, jcfg.d_model), jnp.float32)
                state = jax.eval_shape(
                    lambda p, e: jlm.init_decode_state(
                        rows, 32768, enc_embeds=e, params=p), params, enc)
                w_flat = jax.tree_util.tree_leaves(
                    ref.decode_state_shardings(state))
                g_flat = [s for _, s in _leaves(
                    port.decode_state_shardings(state))]
                assert [s.spec for s in g_flat] == \
                    [tuple(s.spec) for s in w_flat], (rows, fsdp, tp)
            for rows in (256, 3):
                assert port.logits_shardings(rows).spec == \
                    tuple(ref.logits_shardings(rows).spec)
            assert port.replicated().spec == tuple(ref.replicated().spec)


def _leaves(tree, prefix=""):
    """(path, leaf) of nested dicts and tuples in the JAX pytree order (a
    dict's keys sorted), a ``NamedSharding`` a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def test_spec_to_placements_pod_major():
    """A tuple entry ("pod", "data") shards its tensor dim on both mesh
    dims (pod major, the mesh's order); unused mesh dims replicate; a
    mesh axis on two dims is refused."""
    mesh = abstract("2x16x8")
    assert spec_to_placements((("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert spec_to_placements((None, ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Replicate())
    assert spec_to_placements(("model", None, "data"), mesh) == \
        (Replicate(), Shard(2), Shard(0))
    assert spec_to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        spec_to_placements(("data", "data"), mesh)


def test_constraints_return_their_input_without_a_mesh():
    """No mesh, or a plain tensor under a mesh: every hint returns the very
    object it was given (so single-device paths are untouched)."""
    x = torch.randn(4, 6, 8)
    h = torch.randn(4, 6, 2, 4)
    params = {"blocks": {"head": {"layer0": {"attn": {
        "wq": torch.randn(1, 8, 8)}}}}, "embed": torch.randn(16, 8)}
    assert current_mesh() is None
    for mesh in (None, abstract("4x2")):
        ctx = use_mesh(mesh) if mesh is not None else _null()
        with ctx:
            assert current_mesh() is mesh
            assert constrain(x, "batch", None, "model") is x
            assert constrain_bsd(x) is x
            assert constrain_heads(h) is h
            out = constrain_params(params)
            assert out is params if mesh is None else \
                out["embed"] is params["embed"]
    assert current_mesh() is None


def test_the_mesh_is_seen_from_other_threads():
    """Autograd runs a card's backward (and a checkpointed unit's
    recompute) in its own thread: ``use_mesh`` holds for every thread of
    the process, and ends with its block."""
    import threading
    mesh = abstract("4x2")
    seen = []
    with use_mesh(mesh):
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [mesh]
    assert current_mesh() is None


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# meshes and the elastic plan
# ---------------------------------------------------------------------------

def test_production_mesh_shapes_and_refusals(fake_group):
    """256 ranks: (data, model) = (32, 8); 512 ranks across two pods:
    (pod, data, model) = (2, 32, 8); a larger group gives the single-pod
    mesh over its first 256 ranks, as the reference takes the first 256
    of 512 devices; fewer ranks, or no process group, raise
    ``RuntimeError``."""
    with pytest.raises(RuntimeError):
        make_production_mesh()
    fake_group(8)
    with pytest.raises(RuntimeError):
        make_production_mesh()
    with pytest.raises(RuntimeError):
        make_production_mesh(multi_pod=True)
    fake_group(256)
    mesh = make_production_mesh()
    assert mesh.shape == (32, 8) and mesh.mesh_dim_names == ("data", "model")
    assert mesh.device_type == "cpu"
    assert data_axes(mesh) == ("data",) and model_axis(mesh) == "model"
    with pytest.raises(RuntimeError):
        make_production_mesh(multi_pod=True)
    fake_group(512)
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == (2, 32, 8)
    assert data_axes(mesh) == ("pod", "data")
    assert sorted(mesh.mesh.flatten().tolist()) == list(range(512))
    mesh = make_production_mesh()
    assert mesh.shape == (32, 8)
    assert mesh.mesh.flatten().tolist() == list(range(256))


@pytest.mark.parametrize("rank", [0, 1])
def test_checkpoint_save_copies_to_host_on_the_writer_only(
        fake_group, tmp_path, monkeypatch, rank):
    """A DTensor tree saved on a (1, 2) mesh: the mesh's first rank copies
    each leaf to the host and writes the step; the other rank joins the
    gathers and keeps no host copy (it writes nothing)."""
    import repro_torch.checkpoint.manager as manager
    from torch.distributed.tensor import distribute_tensor
    fake_group(2, rank)
    mesh = make_mesh_from_devices(range(2), (1, 2), ("data", "model"))
    tree = {"w": distribute_tensor(torch.zeros(4, 6), mesh,
                                   [Replicate(), Shard(1)]),
            "b": distribute_tensor(torch.zeros(6), mesh,
                                   [Replicate(), Replicate()])}
    copies = []
    to_host = manager._to_host
    monkeypatch.setattr(manager, "_to_host",
                        lambda leaf: copies.append(leaf) or to_host(leaf))
    ckpt = manager.CheckpointManager(manager.CheckpointConfig(
        directory=str(tmp_path), async_save=False))
    ckpt.save(1, tree, blocking=True)
    assert len(copies) == (2 if rank == 0 else 0)
    assert ckpt.latest_step() == (1 if rank == 0 else None)


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_elastic_plan_equals_the_references(fake_group, model_parallel):
    """For 1..8 survivors and old data parallel 1..8: data parallel,
    model parallel and the microbatch multiplier equal the reference's,
    None where it is None; the mesh is a (dp, mp) ``DeviceMesh`` over the
    survivors' first ranks."""
    fake_group(8)
    devs = jax.devices() * 8
    for n in range(1, 9):
        survivors = list(range(n))
        for old_dp in range(1, 9):
            want = jax_elastic_remesh(devs[:n], model_parallel, old_dp)
            got = elastic_remesh(survivors, model_parallel, old_dp)
            if want is None:
                assert got is None, (n, old_dp)
                continue
            assert (got.data_parallel, got.model_parallel,
                    got.microbatch_multiplier) == \
                (want.data_parallel, want.model_parallel,
                 want.microbatch_multiplier), (n, old_dp)
            assert got.mesh.shape == (want.data_parallel, model_parallel)
            assert got.mesh.mesh_dim_names == ("data", "model")
            assert got.mesh.mesh.flatten().tolist() == \
                survivors[:want.data_parallel * model_parallel]
    mesh = make_mesh_from_devices([0, 3, 5, 6], (2, 2), ("data", "model"))
    assert mesh.mesh.tolist() == [[0, 3], [5, 6]]


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def _quantize_cases():
    rng = np.random.default_rng(0)
    f32 = np.finfo(np.float32)
    yield "normal", rng.standard_normal(4097).astype(np.float32)
    yield "zeros", np.zeros(300, np.float32)
    yield "ties", (np.arange(-300, 301, dtype=np.float32) * 0.5)
    yield "huge", (rng.uniform(-1, 1, 513) * f32.max).astype(np.float32)
    yield "max", np.array([f32.max, -f32.max, 1.0, 0.0], np.float32)
    yield "tiny", (rng.uniform(-1, 1, 257) * f32.tiny).astype(np.float32)
    yield "subnormal", np.array([f32.smallest_subnormal, 0.0,
                                 -3 * f32.smallest_subnormal], np.float32)
    yield "spread", (rng.standard_normal((7, 64)) *
                     np.logspace(-30, 30, 64)).astype(np.float32)


@pytest.mark.parametrize("name,g", list(_quantize_cases()),
                         ids=[c[0] for c in _quantize_cases()])
def test_quantize_equals_jax_bit_for_bit(name, g):
    """int8 codes and the float32 scale of the port's ``_quantize`` equal
    the reference's on seeded inputs, an all-zero tensor, exact .5 ties
    and values at both ends of float32's range."""
    q, s = _quantize(torch.from_numpy(g))
    jq, js = jax_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes(), name


def test_int8_compression_error_feedback():
    """``tests/test_distributed.py::test_int8_compression_error_feedback``
    on the port: the residual-corrected stream converges to the true mean
    over steps (bias cancellation)."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal(512).astype(np.float32)
    resid = np.zeros_like(g)
    errs = []
    acc = np.zeros_like(g)
    for t in range(20):
        q, s = _quantize(torch.from_numpy(g + resid))
        deq = q.numpy().astype(np.float32) * float(s)
        resid = (g + resid) - deq
        acc += deq
        errs.append(np.abs(acc / (t + 1) - g).mean())
    assert errs[-1] < errs[0] * 0.25          # error feedback shrinks bias
