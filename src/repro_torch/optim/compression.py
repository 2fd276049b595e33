"""int8 gradient compression for the data-parallel all-reduce, with error
feedback (port of ``repro/optim/compression.py``).

Each worker quantizes its local gradient to int8 with a per-tensor scale;
``int8_psum`` all-reduces the codes in int32 (no overflow for <= 2^23
workers) and the mean scale over a ``torch.distributed`` group (the data
axis of a ``DeviceMesh``: ``mesh.get_group("data")``). The quantization
residual stays local for the next step (error feedback keeps
convergence). Halves DP-gradient collective bytes vs bf16 (x4 vs fp32).

``int8_allreduce_grads`` keeps the reference's behaviour as written: it
all-reduces the dequantized float32 values over ``axis_names`` and
divides by their size. Neither package wires it into a train step
(``ParallelConfig.grad_compression`` is read nowhere). The arithmetic is
plain PyTorch and the reduction NCCL's (gloo's on the CPU), as the
reference's is XLA ops outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from .adamw import tree_leaves, tree_unflatten


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale): scale = max|g| / 127 + 1e-12, codes =
    clip(round half to even(g / scale), -127, 127), float32 throughout as
    the reference's ``jnp`` arithmetic."""
    g = g.float()
    # a tensor divisor: a true division on every device (a Python scalar
    # may become a multiply by its reciprocal)
    scale = torch.amax(torch.abs(g)) / torch.tensor(
        127.0, dtype=torch.float32, device=g.device) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """Quantized sum of one tensor over ``group``: the int32 sum of every
    worker's codes times the mean of their scales (the error from the
    scales' spread is absorbed by error feedback)."""
    q, scale = _quantize(g)
    qs = q.to(torch.int32)
    dist.all_reduce(qs, group=group)
    s = scale.clone()
    dist.all_reduce(s, group=group)
    s = s / dist.get_world_size(group)
    return qs.float() * s


def int8_allreduce_grads(grads: Any, mesh, axis_names=("data",),
                         residual: Any = None) -> Tuple[Any, Any]:
    """All-reduce a gradient tree in int8 with error feedback.

    grads are plain tensors, REPLICATED over ``axis_names`` semantically
    but holding per-worker values (microbatch grads). Returns (mean grads,
    new residual): every leaf's quantize-dequantize of g + residual,
    summed over the axes' groups and divided by their size, and the
    residual g + residual - dequantized.
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for a in axis_names:
        n *= sizes[a]
    leaves = tree_leaves(grads)
    res = [torch.zeros_like(g, dtype=torch.float32) for g in leaves] \
        if residual is None else tree_leaves(residual)
    reduced, new_res = [], []
    for g, r in zip(leaves, res):
        g = g.float() + r
        q, scale = _quantize(g)
        deq = q.float() * scale
        new_res.append(g - deq)
        total = deq.clone()
        for a in axis_names:
            dist.all_reduce(total, group=mesh.get_group(a))
        reduced.append(total / n)
    return tree_unflatten(grads, reduced), tree_unflatten(grads, new_res)
