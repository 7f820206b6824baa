"""NorMuon neuron-wise second-moment normalization, the NS epilogue.

Counterpart of ``repro/kernels/normuon.py``. NorMuon keeps one second-moment
statistic per output neuron (row) of each matrix leaf and divides the
orthogonalized update by its bias-corrected root. Under MuonBP's schedule
the statistic refreshes only on full steps; every step applies it.

  * :func:`neuron_norm` -- the wrapper of the hand-written CUDA kernel
    ``csrc/normuon.cu``, which replaces the TPU kernel ``_neuron_norm_kernel``:
    one block a row, nothing padded (the TPU kernel padded to 8 x 128 and
    carried ``v`` in a 128-lane block; here ``v`` stays ``(B, m, 1)``). On a
    CPU tensor it runs :func:`neuron_norm_plain`; on a CUDA tensor it launches
    the kernel or raises. Launches are counted in ``neuron_norm.launches``.
  * :func:`neuron_norm_plain` -- the plain PyTorch version, the counterpart of
    ``neuron_norm_reference``: the same math in the same fp32 rounding.
  * :func:`apply_neuron_norm` -- the leaf-level epilogue ``muon.update``
    calls: lead-padded state, the bias correction, the RMS-preserving rescale
    and the first-steps guard, in plain PyTorch around the kernel as in the
    reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# Additive guard for the RMS-preserving rescale's means (exact-zero updates).
_TINY = 1e-30


def _check_shapes(x: torch.Tensor, v: torch.Tensor) -> None:
    if x.dim() != 3 or tuple(v.shape) != (*x.shape[:-1], 1):
        raise ValueError(
            f"expected (B, m, n) + (B, m, 1), got {tuple(x.shape)}/{tuple(v.shape)}")


def neuron_norm_plain(x: torch.Tensor, v: torch.Tensor, corr: float, *, beta2: float,
                      eps: float, refresh: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, v_new)`` of a stack ``x (B, m, n)`` with row statistics ``v (B, m, 1)``.

    On ``refresh``: ``v_new = beta2 v + (1 - beta2) sum(x^2)/n`` per row, else
    ``v_new = v``; then ``y = x / (sqrt(v_new / corr) + eps)``. fp32 throughout,
    each constant rounded to fp32 as the reference rounds it.
    """
    _check_shapes(x, v)
    x = x.to(torch.float32)
    v = v.to(torch.float32)
    if refresh:
        row = torch.sum(x * x, dim=-1, keepdim=True) * (1.0 / float(x.shape[-1]))
        v = beta2 * v + (1.0 - beta2) * row
    # A tensor divisor: PyTorch divides by a Python scalar through its
    # reciprocal on the card, which would round otherwise than the kernel.
    corr_t = torch.tensor(corr, dtype=torch.float32, device=x.device)
    denom = torch.sqrt(v / corr_t) + eps
    return x / denom, v


def _launch(x: torch.Tensor, v: torch.Tensor, corr: float, *, beta2: float, eps: float,
            refresh: bool) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels import build

    if not (x.is_cuda and v.is_cuda and x.device == v.device):
        raise ValueError("the NorMuon kernel takes x and v on one CUDA device")
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the NorMuon kernel takes float32, got {x.dtype}/{v.dtype}")
    _check_shapes(x, v)
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("the NorMuon kernel takes contiguous x and v")
    rows, n = x.shape[0] * x.shape[1], x.shape[2]
    y = torch.empty_like(x)
    v_out = torch.empty_like(v) if refresh else v
    vec = n % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    f32 = lambda value: float(np.float32(value))
    rc = build.load("normuon").normuon_rows(
        x.data_ptr(), v.data_ptr(), y.data_ptr(), v_out.data_ptr(), rows, n,
        int(refresh), int(vec), f32(beta2), f32(1.0 - beta2), f32(1.0 / float(n)),
        f32(corr), f32(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(rc, "normuon_rows")
    return y, v_out


def neuron_norm(x: torch.Tensor, v: torch.Tensor, corr: float, *, beta2: float,
                eps: float, refresh: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Neuron normalization of a stack (kernel #5, ``_neuron_norm_kernel``).

    ``x`` is ``(B, m, n)`` and ``v`` the standing row second moments
    ``(B, m, 1)``, both contiguous fp32 on a CUDA device; ``corr`` the bias
    correction ``1 - beta2**count`` as a host float. Returns ``(y, v_new)``;
    without ``refresh``, ``v_new`` is ``v`` itself.
    """
    if x.device.type == "cpu":
        return neuron_norm_plain(x, v, corr, beta2=beta2, eps=eps, refresh=refresh)
    out = _launch(x, v, corr, beta2=beta2, eps=eps, refresh=refresh)
    if x.numel():
        neuron_norm.launches += 1
    return out


neuron_norm.launches = 0


def bias_correction(count: int, beta2: float) -> float:
    """``max(1 - beta2**count, 1e-12)`` computed in fp32, as the reference does."""
    return float(max(np.float32(1.0) - np.float32(beta2) ** np.float32(count),
                     np.float32(1e-12)))


class ShardReduce(NamedTuple):
    """NorMuon's sums over a leaf split across ranks (``muon(comm=...)``).

    ``rows(t)`` sums per-row partial sums over the ranks that share the rows
    (None where the rows are whole on each rank); ``total(t)`` sums partial
    sums over every rank holding a piece of the leaf; ``n`` is the global
    row length and ``numel`` the global (unpadded) element count.
    """

    rows: Optional[Callable[[torch.Tensor], torch.Tensor]]
    total: Callable[[torch.Tensor], torch.Tensor]
    n: int
    numel: int


def apply_neuron_norm(o: torch.Tensor, v: torch.Tensor, count: int, *, beta2: float,
                      eps: float, refresh: bool,
                      reduce: Optional[ShardReduce] = None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Leaf-level NorMuon epilogue: ``(o, v, count) -> (o', v', count')``.

    ``o`` is the orthogonalized update (any leading dims), ``v`` its row
    second moments, possibly lead-padded (more leading rows than ``o``, as
    the reference's ZeRO-1 flatten fallback keeps them): the head is
    normalized and refreshed, the pad rows come back as zeros. ``count`` is
    the host-integer refresh counter. Before any refresh the statistics are
    all zero and the reference passes the raw update through; the counter is
    a host integer here, so that guard skips the kernel instead.

    ``reduce`` is given for a rank's shard of a leaf split across ranks:
    where the rows are split, a refresh sums the row partial sums over the
    ranks before the kernel divides (the kernel's own refresh sums one
    rank's columns only); the RMS rescale's two means are global sums over
    the global element count, the pad rows contributing zeros.
    """
    new_count = count + 1 if refresh else count
    if new_count == 0:
        return o, v, new_count
    orig_dtype = o.dtype
    x = o.to(torch.float32)
    lead_pad = v.shape[0] - x.shape[0]
    head = v[: x.shape[0]] if lead_pad else v
    m, n = x.shape[-2], x.shape[-1]
    x3 = x.reshape(-1, m, n).contiguous()
    v3 = head.to(torch.float32).reshape(-1, m, 1).contiguous()
    kernel_refresh = refresh
    if refresh and reduce is not None and reduce.rows is not None:
        row = reduce.rows(torch.sum(x3 * x3, dim=-1, keepdim=True)) * (1.0 / float(reduce.n))
        v3 = beta2 * v3 + (1.0 - beta2) * row
        kernel_refresh = False
    y3, vn3 = neuron_norm(x3, v3, bias_correction(new_count, beta2), beta2=beta2, eps=eps,
                          refresh=kernel_refresh)
    y = y3.reshape(x.shape)
    if refresh:
        v_new = vn3.reshape(head.shape)
        if lead_pad:
            v_new = torch.cat([v_new, torch.zeros((lead_pad, *v_new.shape[1:]),
                                                  dtype=v_new.dtype, device=v_new.device)])
    else:
        v_new = v
    # RMS-preserving rescale: the per-row division changes the update's
    # magnitude, which the two-stepsize rule was tuned for, so restore the
    # leaf's global RMS.
    if reduce is None:
        num = torch.mean(torch.square(x)) + _TINY
        den = torch.mean(torch.square(y)) + _TINY
    else:
        sums = reduce.total(torch.stack([torch.sum(torch.square(x)), torch.sum(torch.square(y))]))
        num, den = sums / float(reduce.numel) + _TINY
    y = y * torch.sqrt(num / den)
    return y.to(orig_dtype), v_new, new_count
