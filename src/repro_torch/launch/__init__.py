"""Launchers (port of ``repro/launch``): ``serve``, ``train``, ``learn``
and ``dryrun`` (the planner of the 256- and 512-card meshes on fake
shards), each a ``main(argv=None)`` run with ``python -m
repro_torch.launch.<name>``; ``mesh`` builds the production
``DeviceMesh`` over a process group, and its two constructors are exported
here as in the JAX package. Importing this package touches no process
group."""
from .mesh import make_mesh_from_devices, make_production_mesh

__all__ = ["make_production_mesh", "make_mesh_from_devices"]
