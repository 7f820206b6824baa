"""Oracles for the Newton-Schulz kernels, under the reference's names.

Counterpart of ``repro/kernels/newton_schulz/ref.py``. Each name is the plain
PyTorch version that the kernels are held against (fp32 accumulation,
stacks over any leading dims), so the reference's oracles and the kernels
meet one plain version, not two.
"""

from __future__ import annotations

from repro_torch.core.newton_schulz import ns_steps_plain, orthogonalize_plain
from repro_torch.kernels.newton_schulz.newton_schulz import fma_matmul_plain, matmul_plain

matmul_ref = matmul_plain
newton_schulz_ref = batched_newton_schulz_ref = orthogonalize_plain


def fma_matmul_ref(a, b, c, alpha: float, beta: float):
    """alpha * c + beta * (a @ b), fp32 accumulation."""
    return fma_matmul_plain(a, b, c, alpha=alpha, beta=beta)


def ns_iteration_ref(x, coeffs):
    """One Newton-Schulz step on a small-side fp32 matrix or stack."""
    return ns_steps_plain(x, coeffs, 1)


batched_ns_iteration_ref = ns_iteration_ref
