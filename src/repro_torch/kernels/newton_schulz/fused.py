"""Fused, batched Newton-Schulz: the whole chain (or one step) per launch.

Counterpart of ``repro/kernels/newton_schulz/fused.py``. One hand-written
CUDA kernel, ``csrc/ns_fused.cu``, replaces both TPU kernels:

  * ``ns_chain`` -- ``_fused_ns_chain_kernel``: all K NS steps of every unit
    of a bucket in ONE launch (strategy ``fused_chain``);
  * ``ns_iteration`` -- ``_fused_ns_kernel``: one step per launch
    (strategy ``fused_iter``, the A/B point: K launches against 1).

Design: each stacked unit is split over a thread-block cluster of
:func:`cluster_parts` blocks, which loops over the steps; the Gram, the
polynomial and the X/Y ping-pong live in a per-unit fp32 workspace
allocated here (``2 m^2 + m n`` floats a unit), the three stages separated
by cluster barriers; the symmetric Gram and ``A^2`` are computed from their
upper tiles and mirrored. Arithmetic is exact fp32 FFMA. The workspace is in
device memory and does not fit the 50 MB L2: a 768 x 1536 block unit holds
9.4 MB, and with two blocks an SM and two-block clusters 132 of the 192
units of that bucket are live at once, 1.25 GB, so the stages' operands
stream from HBM. Bound on the H100: the 67 TFLOP/s fp32 rate; this design
is simple rather than fast (workspace in HBM, no tensor cores), see the
source's note.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Launches are counted in
``ns_chain.launches`` and ``ns_iteration.launches``.

Fit gate. :func:`fits_budget` keeps the reference's working-set formula
``4 * (2 m_p n_p + 2 m_p^2)`` bytes (``fused.py:123-135``: fp32 X and Y plus
the Gram and the polynomial, on the TPU-padded small side ``m_p``) and
compares it with a budget for the H100 instead of the TPU's 12 MiB of
VMEM (``fused.py:61``): :data:`UNIT_BUDGET_BYTES` = 25 MB per unit. On the
card no unit is held on chip either way, so the budget is a cut in size,
not a fit in a memory. It says how much work one unit is. The fused chain
gives a unit one cluster of at most 8 blocks for the whole chain, which
fills the 132 SMs only when units are many; the tiled path spreads each
product's 128 x 128 tiles over every SM (a 1536^2 Gram alone has 144).
The units under 25 MB come in buckets of 96-192 (block phase) or are
small (the 384 x 1536 full-phase k/v); those above it are the 12-24
large full-phase units, where 8 blocks a unit would leave SMs idle. At
full-width ``muonbp-960m`` with an 8-way block grid this sends:

  * every block-phase unit to ``fused_chain``: small sides 48, 192, 768
    against n = 1536, and the 12 x 1536 norms; the largest is the
    768 x 1536 MLP block, 4 * (2*768*1536 + 2*768^2) = 14.2 MB;
  * in the full phase, the 384 x 1536 k/v units (5.9 MB) and the norms to
    ``fused_chain``;
  * in the full phase, the 1536 x 1536 q/o units (4 * 4 * 1536^2 = 37.7 MB)
    and the 1536 x 6144 MLP units (4 * (2*1536*6144 + 2*1536^2) = 94.4 MB)
    to ``tiled``.

So both kernel families lie on the training step's path.
"""

from __future__ import annotations

import torch

from repro_torch.core.newton_schulz import PAPER_COEFFS, ns_steps_plain, on_small_side

DEFAULT_GRAM_TILE = 128
UNIT_BUDGET_BYTES = 25 * 10**6


def round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _padded_dims(m: int, n: int, tm: int = DEFAULT_GRAM_TILE) -> tuple[int, int, int]:
    """(tile, m_p, n_p) as the reference pads (rows to the tile, columns to 128).

    The CUDA kernel masks ragged edges and pads nothing; the padded dims
    only feed the reference's working-set formula in :func:`fits_budget`.
    """
    tm_ = min(tm, round_up(m, 8))
    return tm_, round_up(m, tm_), round_up(n, 128)


def fits_budget(shape, *, budget: int = UNIT_BUDGET_BYTES) -> bool:
    """Whether one unit of ``shape`` belongs on the fused chain (see module doc)."""
    m, n = int(shape[-2]), int(shape[-1])
    m, n = min(m, n), max(m, n)
    _, mp, np_ = _padded_dims(m, n)
    return 4 * (2 * mp * np_ + 2 * mp * mp) <= budget


def ns_chain_plain(x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
    """``steps`` NS iterations on a ``(B, m, n)`` fp32 stack, plain PyTorch."""
    return ns_steps_plain(x, coeffs, steps)


def cluster_parts(units: int, sms: int) -> int:
    """Blocks a unit is split over (a thread-block cluster of 1, 2, 4 or 8).

    A unit is the kernel's grain of work, so with one block a unit the SMs
    that get one unit more than the others set the launch's time: 192
    units on 132 SMs leave 60 SMs with twice the work of the other 72.
    Splitting each unit over ``parts`` blocks evens the load out: the
    busiest SM then holds ``ceil(units * parts / sms) / parts`` units'
    worth. A larger split is taken only where it cuts that by a tenth, since
    each split adds barriers and shortens the tile lists (192 units -> 2,
    96 -> 4, a 2-unit norm bucket -> 8, 1000 -> 1).
    """
    load = lambda p: -(-units * p // sms) / p
    best = 1
    for p in (2, 4, 8):
        if load(p) <= 0.9 * load(best):
            best = p
    return best


def _launch(x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
    from repro_torch.kernels import build

    if not x.is_cuda:
        raise ValueError(f"the fused NS kernel runs on a CUDA tensor, got one on {x.device}")
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError(
            f"fused NS kernel takes a float32 (B, m, n) stack, got {x.dtype} {tuple(x.shape)}"
        )
    x = x.contiguous()
    batch, m, n = x.shape
    if m > n:
        raise ValueError(f"fused NS kernel iterates on the small side; got m={m} > n={n}")
    a, b, c = (float(v) for v in coeffs)
    out = torch.empty_like(x)
    work = torch.empty(batch * (2 * m * m + m * n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = cluster_parts(batch, torch.cuda.get_device_properties(x.device).multi_processor_count)
    rc = build.load("ns_fused").ns_fused_chain(
        x.data_ptr(), out.data_ptr(), work.data_ptr(), batch, m, n, steps, parts, a, b, c, stream
    )
    build.check(rc, "ns_fused_chain")
    return out


def ns_chain(x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
    """All ``steps`` NS iterations of a ``(B, m, n)`` stack in one launch (kernel #3)."""
    if x.device.type == "cpu":
        return ns_chain_plain(x, coeffs, steps)
    out = _launch(x, coeffs, steps)
    ns_chain.launches += 1
    return out


def ns_iteration(x: torch.Tensor, coeffs) -> torch.Tensor:
    """One NS iteration of a ``(B, m, n)`` stack in one launch (kernel #4)."""
    if x.device.type == "cpu":
        return ns_chain_plain(x, coeffs, 1)
    out = _launch(x, coeffs, 1)
    ns_iteration.launches += 1
    return out


ns_chain.launches = 0
ns_iteration.launches = 0


def orthogonalize(
    g: torch.Tensor,
    steps: int = 5,
    coeffs=PAPER_COEFFS,
    *,
    eps: float = 1e-7,
    chain: bool = False,
    normalize: bool = True,
) -> torch.Tensor:
    """Fused-kernel NS over the trailing two dims (any leading stack dims).

    Same semantics as ``core.newton_schulz.orthogonalize_plain``.
    ``chain=True`` runs all ``steps`` in one launch; ``chain=False`` launches
    once per step (same numerics).
    """
    def iterate(x):
        if chain:
            return ns_chain(x, coeffs, steps)
        for _ in range(steps):
            x = ns_iteration(x, coeffs)
        return x

    return on_small_side(g, iterate, eps=eps, normalize=normalize)
