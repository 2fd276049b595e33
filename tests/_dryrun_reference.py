"""The JAX package's planner for ``tests/test_torch_dryrun.py``, run in a
process of its own (``python _dryrun_reference.py SPEC.json OUT.json``):
importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host
devices, which must not reach the test process or its other children.

The production mesh is taken at the port's shapes, (data, model) = (32,
8) and (pod, data, model) = (2, 32, 8), over the first 256 or all 512
devices, so that both packages plan on the same layout. SPEC holds the
cells to compile (each with its config overrides), those to lower with
the depth probes (``lower_cell``), the (arch, shape,
n_data) triples for ``microbatches_for`` and the cells whose
``input_specs`` to shape. OUT gets the records, the factors, the unit
sizes and the specs' shapes and dtypes.
"""

import json
import sys

import repro.launch.dryrun as dr  # sets XLA_FLAGS before jax loads

import jax
import numpy as np


def port_mesh(*, multi_pod: bool = False):
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             axes)


def shapes(tree):
    """{path: [shape, dtype]} of every leaf."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                     getattr(p, "idx", p))))
                       for p in path)
        out[key] = [list(leaf.shape), str(leaf.dtype)]
    return out


def main(spec_path: str, out_path: str):
    with open(spec_path) as f:
        spec = json.load(f)
    dr.make_production_mesh = port_mesh
    out = {"records": [], "extrapolated": [], "microbatches": [],
           "unit_size": {}, "specs": {}}
    for cell in spec["records"]:
        rec, _ = dr.compile_once(cell["arch"], cell["shape"],
                                 cell["multi_pod"],
                                 cfg_overrides=cell["overrides"])
        out["records"].append(rec)
    for cell in spec["extrapolated"]:
        out["extrapolated"].append(dr.lower_cell(
            cell["arch"], cell["shape"], cell["multi_pod"],
            cfg_overrides=cell["overrides"]))
    for arch, shape, n_data in spec["microbatches"]:
        cfg = dr.get_config(arch)
        out["microbatches"].append(
            [arch, shape, n_data,
             dr.microbatches_for(cfg, dr.get_shape(shape), n_data)])
        out["unit_size"][arch] = dr._unit_size(cfg)
    for arch, shape in spec["specs"]:
        cfg = dr.get_config(arch)
        specs = dr.input_specs(cfg, dr.get_shape(shape), dr.LM(cfg))
        out["specs"][f"{arch}/{shape}"] = shapes(specs)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
