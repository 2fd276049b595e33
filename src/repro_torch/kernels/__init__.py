"""Kernels of the port: hand-written Hopper kernels (``csrc/``), their
plain PyTorch versions, and the ``ops`` dispatch seam.

phase2_select.py   fused phase-2 projection-DPP selection (sampling)
partial_trace.py   Appendix-B contractions A and C of the dense Θ (KrK)
theta_scatter.py   the dense Θ of a subset batch, padded slots skipped
                   (no Pallas counterpart)
greedy_map.py      fast greedy k-DPP MAP: one update step, and the whole
                   selection of a batch of matrices in one launch
                   (``map``, "map" KV compaction)
kron_matvec.py     batched (A ⊗ B) x by the vec-trick (explicit
                   eigenvectors)
threefry.py        the threefry2x32 counter hash of ``jax.random`` (every
                   keyed draw; no Pallas counterpart)

``ops.py`` holds the dispatchers: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version. ``_build.py`` compiles a kernel with nvcc at
its first launch.
"""
