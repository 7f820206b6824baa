"""The tiled Newton-Schulz path: 3 product launches per NS step.

Counterpart of ``repro/kernels/newton_schulz/ops.py``. One NS step is
``matmul`` (the Gram) plus two ``fma_matmul`` (the polynomial and the
update), each ONE launch over the whole stack: the reference unrolled the
stack in Python, one 3-launch chain per matrix (``ops.py:96-101``), where
here the stack is the kernel's grid axis. Intermediates stream through
device memory, so the path scales to units of any size; the dispatcher
sends units too large for the fused chain here.
"""

from __future__ import annotations

import torch

from repro_torch.core.newton_schulz import PAPER_COEFFS, on_small_side
from repro_torch.kernels.newton_schulz.newton_schulz import fma_matmul, matmul


def ns_iteration(x: torch.Tensor, coeffs=PAPER_COEFFS) -> torch.Tensor:
    """One NS step on ``(m, n)`` or ``(B, m, n)``: A = X X^T; P = bA + cA^2; Y = aX + PX."""
    a, b, c = (float(v) for v in coeffs)
    gram = matmul(x, x.transpose(-1, -2))
    poly = fma_matmul(gram, gram, gram, alpha=b, beta=c)
    return fma_matmul(poly, x, x, alpha=a, beta=1.0)


def orthogonalize(
    g: torch.Tensor,
    steps: int = 5,
    coeffs=PAPER_COEFFS,
    *,
    eps: float = 1e-7,
    normalize: bool = True,
) -> torch.Tensor:
    """Tiled-path NS over the trailing two dims of a matrix or a stack.

    Same semantics as ``core.newton_schulz.orthogonalize_plain``: iterate on
    the smaller side, Frobenius-normalise (skipped with ``normalize=False``),
    fp32 throughout, cast back at the end.
    """
    def iterate(x):
        for _ in range(steps):
            x = ns_iteration(x, coeffs)
        return x

    return on_small_side(g, iterate, eps=eps, normalize=normalize)
