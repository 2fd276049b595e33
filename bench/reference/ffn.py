"""The unit kernel of an FFN's hidden units on a probe batch (Mariet & Sra,
"Diversity Networks", ICLR 2016), plain.

    h   = x / sqrt(mean(x²) + eps) · scale             (RMSNorm)
    a   = silu(h W_gate) · (h W_up)                    (SwiGLU units)
    Â   = a / (‖a_col‖ + 1e-6)                         (unit columns)
    L   = Âᵀ Â + 1e-4 I                                (d_ff x d_ff)

computed in ``dtype`` with every matrix product at ``precision``
(``precision.matmul``), the probe's positions in blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import matmul


def unit_kernel(x: torch.Tensor, scale: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, eps: float, dtype=torch.float64,
                precision: str = "exact", block: int = 2048
                ) -> torch.Tensor:
    d_ff = w_gate.shape[1]
    x = x.reshape(-1, x.shape[-1])
    scale, w_gate, w_up = (t.to(dtype) for t in (scale, w_gate, w_up))
    acts = []
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block].to(dtype)
        h = xb * torch.rsqrt((xb * xb).mean(-1, keepdim=True) + eps) * scale
        acts.append(F.silu(matmul(h, w_gate, precision))
                    * matmul(h, w_up, precision))
    A = torch.cat(acts)
    An = A / (torch.linalg.norm(A, dim=0, keepdim=True) + 1e-6)
    L = matmul(An.T, An, precision)
    L.diagonal().add_(1e-4)
    return L.to(dtype)
