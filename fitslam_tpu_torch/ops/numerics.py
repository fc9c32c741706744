"""Float32 arithmetic that rounds as the reference does, alike on the CPU and
on the card (ROADMAP faults F2, F13, F15). The port's ops import these
wherever a result's last bit decides a cell, a bin or an order.
"""

from __future__ import annotations

import numpy as np
import torch


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded as IEEE division. On CUDA, PyTorch divides by a
    Python scalar as a product with its reciprocal, which can differ in the
    last bit; a device-side 0-d divisor keeps the reference's rounding (the
    cell index of ``world_to_cell`` depends on it)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a configured constant c as the reference's compiler
    computes it inside a jitted function: x times float32(1 / c). The same
    product rounds alike on the CPU and the card."""
    return x * float(np.float32(1.0) / np.float32(c))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as the reference's CPU compiler
    contracts it into a fused multiply-add (ROADMAP F13): the float32
    product is exact in float64, and the sum is rounded from there. Separate
    float64 operations round the same way on the CPU and on the card."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on both devices: PyTorch's
    vectorized CPU sqrt is off by an ulp now and then, while the card's and
    the reference's are exact. The float64 root, rounded to float32, is."""
    return torch.sqrt(x.double()).to(torch.float32)


def top_k_stable(x: torch.Tensor, k: int):
    """Exact top-k with ``lax.top_k``'s tie order (lowest index first)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]
