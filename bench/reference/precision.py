"""Dense linear algebra at a stated precision, for the reference and its
control.

``matmul(a, b, "tf32")`` rounds both operands to TF32 (10 mantissa bits,
round to nearest even) and multiplies in float32: what a TF32 tensor-core
product does to its inputs, done the same way on every device, so the
control reads alike on the CPU and on the card. ``eigh`` and ``inv`` at
"tf32" round their operand on the way in and their results on the way
out, as a TF32 solver would hold them. Any other precision computes in
the operands' dtype.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties to
    even), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "exact"
           ) -> torch.Tensor:
    if precision == "tf32":
        return round_tf32(a.float()) @ round_tf32(b.float())
    return a @ b


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    return round_tf32(x.float()) if precision == "tf32" else x


def eigh(x: torch.Tensor, precision: str = "exact"):
    lam, V = torch.linalg.eigh(rounded(x, precision))
    return rounded(lam, precision), rounded(V, precision)


def inv(x: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    return rounded(torch.linalg.inv(rounded(x, precision)), precision)
