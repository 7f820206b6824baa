"""Tiled Newton-Schulz products: ``matmul`` and ``fma_matmul`` on Hopper.

Counterpart of ``repro/kernels/newton_schulz/newton_schulz.py``. The wrappers
replace the TPU kernels ``_matmul_kernel`` (``X @ Y``) and
``_fma_matmul_kernel`` (``alpha*C + beta*(X @ Y)``) with one hand-written
CUDA kernel, ``csrc/ns_matmul.cu``: a 3xTF32 tensor-core GEMM (``wgmma`` on
TMA-fed tiles, fp32-grade accuracy) whose grid's z axis is the stack
dimension, so one launch covers a whole bucket. Bound on the H100: tensor-core
operations, three TF32 products at 495 TFLOP/s.

Each wrapper takes ``(m, k) @ (k, n)`` or stacked ``(B, m, k) @ (B, k, n)``
operands. ``y`` may be a transposed view of a contiguous tensor (the Gram
``X @ X^T``): the kernel then reads it in place. ``symmetric=True`` declares
a symmetric product with a symmetric ``c`` (the Gram, and ``bA + cA^2`` with
``A`` symmetric): the kernel computes the upper tiles only and mirrors them,
and ``fma_matmul`` reads ``y`` as its own transpose. The wrapper checks the
shapes and, for ``matmul``, that ``y`` is ``x``'s transposed view, on every
device; the plain versions accept the flag and compute the full product.

On a CPU tensor the wrapper runs its plain PyTorch version (fp32
accumulation, output in ``x.dtype``, as the reference); on a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in
``.launches``, and in ``.packed_launches`` those for which it first copied
an operand into a scratch that TMA can read (16-byte-aligned base and
rows: ``k % 4 == 0``, and ``n % 4 == 0`` for a row-major ``y``).
"""

from __future__ import annotations

import torch


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """fp32-accumulating ``x @ y``, output in ``x.dtype`` (``symmetric`` is
    accepted and the full product computed)."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)


def fma_matmul_plain(x, y, c, *, alpha: float, beta: float, symmetric: bool = False) -> torch.Tensor:
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


def _tma_operand(t: torch.Tensor):
    """``(t, ld, batch stride, packed)``: a row-major 3-D operand as TMA reads
    it. One whose rows or base are off the 16-byte grid is copied into a
    scratch with rows padded to 4 floats; the kernel's tensor map keeps the
    true width, so the pad is never read."""
    rows, cols = t.shape[-2], t.shape[-1]
    if cols % 4 == 0 and t.data_ptr() % 16 == 0:
        return t, cols, rows * cols, False
    ld = -(-cols // 4) * 4
    scratch = torch.empty((t.shape[0], rows, ld), dtype=t.dtype, device=t.device)
    scratch[..., :cols].copy_(t)
    return scratch, ld, rows * ld, True


def _same_storage(x, y) -> bool:
    """Whether two tensors view one storage (read without the data pointer,
    which a fake tensor has not)."""
    return x.untyped_storage()._cdata == y.untyped_storage()._cdata


def _check_symmetric(x, y, fma: bool) -> None:
    """What ``symmetric=True`` needs that the shapes can show."""
    if x.dim() < 2 or y.dim() < 2 or x.shape[-2] != y.shape[-1]:
        raise ValueError(f"symmetric needs a square product, got {tuple(x.shape)} @ {tuple(y.shape)}")
    if fma:
        if y.shape[-2] != y.shape[-1]:
            raise ValueError(f"symmetric fma_matmul reads y as its own transpose; y is {tuple(y.shape)}")
    elif not (_same_storage(x, y) and y.storage_offset() == x.storage_offset()
              and y.shape == x.mT.shape and y.stride() == x.mT.stride()):
        raise ValueError("symmetric matmul is the Gram x @ x^T: y must be x's transposed view")


def _launch(wrapper, x, y, c, alpha: float, beta: float, symmetric: bool) -> torch.Tensor:
    from repro_torch.kernels import build

    if not (x.is_cuda and y.is_cuda and (c is None or c.is_cuda)):
        raise ValueError("matmul operands must all lie on the same CUDA device")
    squeeze = x.dim() == 2
    a = _stack3(x, "x")
    b = _stack3(y, "y")
    packed = False
    if not _row_major(a):
        a, packed = a.contiguous(), True
    # op(B) = b^T for a K-major b: the Gram's X^T is read in place, and a
    # symmetric y (the polynomial's A) as its own transpose; any other
    # layout is packed row-major first.
    if symmetric and c is not None:
        b_kmajor = True
    else:
        b_kmajor = not _row_major(b) and _row_major(b.transpose(-1, -2))
        if b_kmajor:
            b = b.transpose(-1, -2)
    if not _row_major(b):
        b, packed = b.contiguous(), True
    batch, m, k = a.shape
    n = b.shape[-2] if b_kmajor else b.shape[-1]
    kb = b.shape[-1] if b_kmajor else b.shape[-2]
    if kb != k or b.shape[0] != batch:
        raise ValueError(f"shape mismatch: {tuple(x.shape)} @ {tuple(y.shape)}")
    a, lda, stride_a, pa = _tma_operand(a)
    b, ldb, stride_b, pb = _tma_operand(b)
    c3 = None
    if c is not None:
        c3 = _stack3(c, "c").contiguous()
        if tuple(c3.shape) != (batch, m, n):
            raise ValueError(f"c has shape {tuple(c.shape)}, expected {(batch, m, n)}")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = build.load("ns_matmul").ns_tc_gemm(
        a.data_ptr(), b.data_ptr(), None if c3 is None else c3.data_ptr(), out.data_ptr(),
        batch, m, n, k, lda, stride_a, ldb, stride_b, int(b_kmajor),
        n, m * n, n, m * n, int(symmetric), float(alpha), float(beta), stream,
    )
    build.check(rc, "ns_tc_gemm")
    wrapper.launches += 1
    wrapper.packed_launches += int(packed or pa or pb)
    return out[0] if squeeze else out


def matmul(x: torch.Tensor, y: torch.Tensor, *, symmetric: bool = False) -> torch.Tensor:
    """``x @ y`` with fp32 accumulation (kernel #1, ``_matmul_kernel``)."""
    if symmetric:
        _check_symmetric(x, y, fma=False)
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    return _launch(matmul, x, y, None, 0.0, 1.0, symmetric)


def fma_matmul(x, y, c, *, alpha: float, beta: float, symmetric: bool = False) -> torch.Tensor:
    """``alpha * c + beta * (x @ y)`` (kernel #2, ``_fma_matmul_kernel``)."""
    if symmetric:
        _check_symmetric(x, y, fma=True)
    if x.device.type == "cpu":
        return fma_matmul_plain(x, y, c, alpha=alpha, beta=beta)
    return _launch(fma_matmul, x, y, c, alpha, beta, symmetric)


matmul.launches = matmul.packed_launches = 0
fma_matmul.launches = fma_matmul.packed_launches = 0
