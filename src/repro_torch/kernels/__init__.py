"""Kernels of the port: hand-written Hopper kernels (``csrc/``), their
plain PyTorch versions, and the ``ops`` dispatch seam."""
