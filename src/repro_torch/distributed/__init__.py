"""Distribution of LM training over a ``torch.distributed`` process group
(port of ``repro/distributed``): the sharding policy and its DTensor
placements, the activation constraints, elastic re-meshing."""

from .sharding import ShardingPolicy

__all__ = ["ShardingPolicy"]
