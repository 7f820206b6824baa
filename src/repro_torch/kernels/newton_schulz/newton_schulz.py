"""Tiled Newton-Schulz products: ``matmul`` and ``fma_matmul`` on Hopper.

Counterpart of ``repro/kernels/newton_schulz/newton_schulz.py``. The wrappers
replace the TPU kernels ``_matmul_kernel`` (``X @ Y``) and
``_fma_matmul_kernel`` (``alpha*C + beta*(X @ Y)``) with one hand-written
CUDA kernel, ``csrc/ns_matmul.cu``: an exact-fp32 (FFMA, no TF32)
shared-memory-tiled GEMM whose grid's z axis is the stack dimension, so one
launch covers a whole bucket. Bound on the H100: the 67 TFLOP/s fp32 rate
at the full-phase shapes; this design is simple rather than fast (see
the source's note).

Each wrapper takes ``(m, k) @ (k, n)`` or stacked ``(B, m, k) @ (B, k, n)``
operands. ``y`` may be a transposed view of a contiguous tensor (the Gram
``X @ X^T``): the kernel then reads it in place. On a CPU tensor the wrapper
runs its plain PyTorch version (fp32 accumulation, output in ``x.dtype``, as
the reference); on a CUDA tensor it launches the kernel or raises. Each
wrapper counts its launches in a plain integer attribute, ``.launches``.
"""

from __future__ import annotations

import torch


def matmul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """fp32-accumulating ``x @ y``, output in ``x.dtype``."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)


def fma_matmul_plain(x, y, c, *, alpha: float, beta: float) -> torch.Tensor:
    """``alpha * c + beta * (x @ y)`` in fp32, output in ``x.dtype``."""
    prod = torch.matmul(x.to(torch.float32), y.to(torch.float32))
    return (alpha * c.to(torch.float32) + beta * prod).to(x.dtype)


def _stack3(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA NS kernels take float32, got {t.dtype}")
    if t.dim() == 2:
        t = t.unsqueeze(0)
    if t.dim() != 3:
        raise ValueError(f"{name}: expected (m, n) or (B, m, n), got {tuple(t.shape)}")
    return t


def _row_major(t: torch.Tensor) -> bool:
    """Whether a 3-D tensor is densely packed row-major per stacked matrix."""
    return (
        t.stride(-1) == 1
        and t.stride(-2) == t.shape[-1]
        and (t.shape[0] == 1 or t.stride(0) == t.shape[-1] * t.shape[-2])
    )


def _launch(x, y, c, alpha: float, beta: float) -> torch.Tensor:
    from repro_torch.kernels import build

    if not (x.is_cuda and y.is_cuda and (c is None or c.is_cuda)):
        raise ValueError("matmul operands must all lie on the same CUDA device")
    squeeze = x.dim() == 2
    a = _stack3(x, "x")
    if not _row_major(a):
        a = a.contiguous()
    b = _stack3(y, "y")
    # The transposed view of a row-major tensor (the Gram's X^T) is read in
    # place; any other layout is packed first.
    b_t = not _row_major(b) and _row_major(b.transpose(-1, -2))
    if b_t:
        b = b.transpose(-1, -2)
    elif not _row_major(b):
        b = b.contiguous()
    batch, m, k = a.shape
    n = b.shape[-2] if b_t else b.shape[-1]
    kb = b.shape[-1] if b_t else b.shape[-2]
    if kb != k or b.shape[0] != batch:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} @ {tuple(y.shape)}")
    lda, ldb = k, b.shape[-1]
    c3 = None
    if c is not None:
        c3 = _stack3(c, "c").contiguous()
        if tuple(c3.shape) != (batch, m, n):
            raise ValueError(f"c has shape {tuple(c.shape)}, expected {(batch, m, n)}")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = build.load("ns_matmul").ns_gemm_batched(
        a.data_ptr(), b.data_ptr(), None if c3 is None else c3.data_ptr(), out.data_ptr(),
        batch, m, n, k,
        m * k, b.shape[-1] * b.shape[-2], m * n, m * n,
        lda, ldb, n, n, int(b_t), float(alpha), float(beta), stream,
    )
    build.check(rc, "ns_gemm_batched")
    return out[0] if squeeze else out


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with fp32 accumulation (kernel #1, ``_matmul_kernel``)."""
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    out = _launch(x, y, None, 0.0, 1.0)
    matmul.launches += 1
    return out


def fma_matmul(x, y, c, *, alpha: float, beta: float) -> torch.Tensor:
    """``alpha * c + beta * (x @ y)`` (kernel #2, ``_fma_matmul_kernel``)."""
    if x.device.type == "cpu":
        return fma_matmul_plain(x, y, c, alpha=alpha, beta=beta)
    out = _launch(x, y, c, alpha, beta)
    fma_matmul.launches += 1
    return out


matmul.launches = 0
fma_matmul.launches = 0
