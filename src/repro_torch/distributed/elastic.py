"""Elastic scaling: rebuild the mesh from surviving ranks and re-shard
training state from the last committed checkpoint (port of
``repro/distributed/elastic.py``).

Flow on failure (coordinator view):
  1. a step raises / a host misses heartbeat -> drop to `survivors`.
  2. `elastic_remesh` picks the largest (data', model) grid that fits the
     survivor count while keeping `model` fixed (TP degree is a property of
     the model partitioning; DP shrinks elastically).
  3. state is restored from the checkpoint manager with the NEW shardings —
     `CheckpointManager.restore(..., shardings=...)` places the saved
     arrays onto the new mesh (``distribute_tensor``).
  4. the train step runs on the new placements; global batch is kept by
     raising grad-accumulation microbatches (tokens/step invariant).

A ``DeviceMesh`` is over ranks of the process group, so ``survivors`` are
ranks; every rank of the group calls ``elastic_remesh`` (a mesh is built
collectively).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

from ..launch.mesh import make_mesh_from_devices


@dataclasses.dataclass
class ElasticPlan:
    mesh: Any                       # DeviceMesh over the survivors
    data_parallel: int
    model_parallel: int
    microbatch_multiplier: int      # x grad-accum to keep global batch


def elastic_remesh(survivors: List[int], model_parallel: int,
                   old_data_parallel: int) -> Optional[ElasticPlan]:
    """Largest usable mesh from survivors, or None if < one model group."""
    n = len(survivors)
    dp = n // model_parallel
    if dp < 1:
        return None
    mesh = make_mesh_from_devices(survivors, (dp, model_parallel),
                                  ("data", "model"))
    mult = max(1, math.ceil(old_data_parallel / dp))
    return ElasticPlan(mesh=mesh, data_parallel=dp,
                       model_parallel=model_parallel,
                       microbatch_multiplier=mult)
