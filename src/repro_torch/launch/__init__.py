"""Launchers (port of ``repro/launch``). ``serve`` is ported; the
reference's package exports its JAX meshes (``launch/mesh.py``), which
arrive with the process-group ``Mesh`` together with ``dryrun``, ``train``
and ``learn`` (ROADMAP.md, queue 1), so nothing is exported yet."""

__all__: list = []
