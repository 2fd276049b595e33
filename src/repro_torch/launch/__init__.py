"""Launchers (port of ``repro/launch``): ``serve``, ``train``, ``learn``
and ``dryrun`` (the planner of the 256- and 512-card meshes on fake
shards), each a ``main(argv=None)`` run with ``python -m
repro_torch.launch.<name>``; ``mesh`` builds the production
``DeviceMesh`` over a process group. Nothing is exported."""

__all__: list = []
