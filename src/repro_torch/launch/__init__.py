"""Launchers (port of ``repro/launch``): ``serve``, ``train`` and
``learn`` are ported, each a ``main(argv=None)`` run with ``python -m
repro_torch.launch.<name>``. The reference's package exports its JAX
meshes (``launch/mesh.py``); they arrive with the process-group ``Mesh``
together with ``dryrun`` (ROADMAP.md, queue 1 #8.4), so nothing is
exported yet."""

__all__: list = []
