"""Newton-Schulz orthogonalization (paper Algorithm 2).

Counterpart of ``repro/core/newton_schulz.py``. ``Orth(G) = (G G^T)^{-1/2} G``
is approximated with K iterations of ``X <- a X + (b A + c A^2) X`` where
``A = X X^T``, batched over any leading dims.

``orthogonalize_plain`` is the plain PyTorch chain (the reference's
``orthogonalize_jnp``) and the numerics oracle of every kernel strategy;
``orthogonalize`` routes through ``repro_torch.kernels.dispatch``.
``spectral_norm_est`` is the spectral pre-scale of Turbo-Muon and Dion.
"""

from __future__ import annotations

import numpy as np
import torch

PAPER_COEFFS = (2.0, -1.5, 0.5)
JORDAN_COEFFS = (3.4445, -4.7750, 2.0315)


def orthogonalize(
    g: torch.Tensor,
    steps: int = 5,
    coeffs=PAPER_COEFFS,
    eps: float = 1e-7,
    strategy: str | None = None,
    normalize: bool = True,
) -> torch.Tensor:
    """Approximate ``Orth(g)`` through the kernel strategy ``strategy``.

    ``strategy=None`` lets ``dispatch.plan_strategy`` pick from the shape.
    """
    from repro_torch.kernels import dispatch

    return dispatch.orthogonalize(
        g, steps=steps, coeffs=coeffs, eps=eps, strategy=strategy, normalize=normalize
    )


def on_small_side(g: torch.Tensor, iterate, *, eps: float = 1e-7,
                  normalize: bool = True) -> torch.Tensor:
    """Run ``iterate`` on ``g`` as the NS chains see it, and map the result back.

    ``iterate`` gets a contiguous fp32 ``(B, m, n)`` stack with ``m <= n``
    (each matrix transposed to its smaller side), Frobenius-normalised with
    ``eps`` unless ``normalize=False``; its result is transposed back,
    reshaped to ``g``'s shape and cast to ``g``'s dtype.
    """
    if g.dim() < 2:
        raise ValueError(f"orthogonalize expects a matrix, got shape {tuple(g.shape)}")
    m, n = g.shape[-2], g.shape[-1]
    x = g.to(torch.float32).reshape(-1, m, n)
    transpose = m > n
    if transpose:
        x = x.transpose(-1, -2)
    if normalize:
        x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    x = iterate(x.contiguous())
    if transpose:
        x = x.transpose(-1, -2)
    return x.reshape(g.shape).to(g.dtype)


def ns_steps_plain(x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
    """``steps`` NS iterations on a small-side fp32 stack, plain PyTorch."""
    a, b, c = (float(v) for v in coeffs)
    for _ in range(steps):
        gram = x @ x.transpose(-1, -2)
        poly = b * gram + c * (gram @ gram)
        x = a * x + poly @ x
    return x


def orthogonalize_plain(
    g: torch.Tensor,
    steps: int = 5,
    coeffs=PAPER_COEFFS,
    eps: float = 1e-7,
    normalize: bool = True,
) -> torch.Tensor:
    """``Orth(g)`` over the trailing two dims, plain PyTorch in fp32.

    Iterates on the smaller side (transposing when m > n), Frobenius
    normalises with ``eps`` unless ``normalize=False``, runs ``steps`` fp32
    iterations and casts back to the input dtype.
    """
    return on_small_side(g, lambda x: ns_steps_plain(x, coeffs, steps), eps=eps,
                         normalize=normalize)


def spectral_norm_est(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Spectral-norm estimate over the trailing two dims (power iteration).

    Counterpart of the reference's ``spectral_norm_est``: ``iters`` power
    iterations from the uniform start vector ``1/sqrt(n)``, batched over the
    leading dims, returning shape ``(..., 1, 1)``. The estimate converges to
    sigma_max from below. Callers run it on the packed stack as the update
    program hands it over (before any transpose to the small side), as the
    reference does: iterating on ``X`` and on ``X^T`` rounds differently.
    """
    x = x.to(torch.float32)
    n = x.shape[-1]
    # fp32 1/sqrt(n), rounded as the reference forms it.
    start = float(np.float32(1.0) / np.sqrt(np.float32(n)))
    v = torch.full(x.shape[:-2] + (n, 1), start, dtype=torch.float32, device=x.device)
    xt = x.transpose(-1, -2)
    for _ in range(iters):
        w = x @ v
        v = xt @ w
        v = v / (torch.linalg.vector_norm(v, dim=(-2, -1), keepdim=True) + 1e-20)
    w = x @ v
    return torch.linalg.vector_norm(w, dim=(-2, -1), keepdim=True)


def orthogonality_error(x: torch.Tensor) -> torch.Tensor:
    """``|| X X^T - I ||_F / sqrt(m)`` over trailing dims, on the smaller side."""
    x = x.to(torch.float32)
    if x.shape[-2] > x.shape[-1]:
        x = x.transpose(-1, -2)
    m = x.shape[-2]
    gram = x @ x.transpose(-1, -2)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    return torch.linalg.vector_norm(gram - eye, dim=(-2, -1)) / m ** 0.5
