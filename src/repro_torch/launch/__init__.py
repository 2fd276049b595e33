"""Launchers (port of ``repro/launch``): ``serve``, ``train`` and
``learn`` are ported, each a ``main(argv=None)`` run with ``python -m
repro_torch.launch.<name>``; ``mesh`` builds the production
``DeviceMesh`` over a process group. ``dryrun``, the reference's planner
of the 256- and 512-chip meshes, is not ported yet (ROADMAP.md), and
nothing is exported."""

__all__: list = []
