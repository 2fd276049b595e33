"""repro_torch — the Kronecker DPP library in PyTorch for one NVIDIA H100.

A port of the JAX package ``repro`` (which stays the reference). Module
names follow the JAX package's, so each file has an obvious counterpart:
``repro_torch/sampling/batched.py`` ports ``repro/sampling/batched.py``.

Policy (``repro_torch._device``):

* every public entry point takes ``device=`` and defaults to ``"cuda"``;
  without a card it raises ``RuntimeError`` unless ``device="cpu"`` was
  passed — there is no silent CPU path;
* float32 values and int32 picks;
* ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` are set to False on import, so
  float32 products run in full float32;
* randomness comes from explicit ``torch.Generator`` objects, never the
  global RNG; every sampler has a ``*_from_uniforms`` core that takes its
  uniforms as tensors.

This package imports torch, numpy and the standard library only — never
jax and never the JAX package. The hand-written Hopper kernels (phase 2 of
the sampler, the partial traces of KrK-Picard's dense-Θ route) live in
``repro_torch/kernels/csrc`` and are built with ``nvcc`` at first use
(``repro_torch.kernels._build``).
"""

from ._device import FLOAT, INDEX, resolve_device

__all__ = ["FLOAT", "INDEX", "resolve_device"]
