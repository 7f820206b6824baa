"""Fused, batched Newton-Schulz: the whole chain (or one step) per launch.

Counterpart of ``repro/kernels/newton_schulz/fused.py``. One hand-written
CUDA kernel, ``csrc/ns_fused.cu``, replaces both TPU kernels:

  * ``ns_chain`` -- ``_fused_ns_chain_kernel``: all K NS steps of every unit
    of a bucket in ONE launch (strategy ``fused_chain``);
  * ``ns_iteration`` -- ``_fused_ns_kernel``: one step per launch
    (strategy ``fused_iter``, the A/B point: K launches against 1).

Design: each stacked unit is split over a thread-block cluster of
:func:`cluster_parts` blocks (one block an SM), which loops over the steps
and the three stages of each (Gram, polynomial, update), dealing each
stage's 128 x 128 output tiles to its blocks. Every tile is the tiled
products' 3xTF32 ``wgmma`` tile on TMA-fed operands (``csrc/ns_tc_gemm.cuh``),
so the chain is fp32-grade, not bit-equal to its plain version, and is
bound by three TF32 products at 495 TFLOP/s. The symmetric Gram and ``A^2``
come from their upper tiles, mirrored. The Gram, the polynomial and the
X/Y ping-pong live in an fp32 workspace allocated here, its rows
(:func:`chain_layout`) a multiple of 4 floats apart, as TMA needs; an ``x``
whose rows are not (``n % 4 != 0``) or whose base is off the 16-byte grid
is first copied into such a layout, and the launch counted in
``.packed_launches``.

On a CPU tensor each wrapper runs its plain PyTorch version
(``ns_chain_plain``, the oracle); on a CUDA tensor it launches the kernel or
raises. Launches are counted in ``ns_chain.launches`` and
``ns_iteration.launches``.

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

    The CUDA kernel pads no tile (TMA zero-fills the ragged edge); the
    padded dims only feed the reference's working-set formula in
    :func:`fits_budget`.
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


TILE = 128      # the kernel's output tile, rows and columns (ns_tc_gemm.cuh)
K_SLICE = 32    # the depth of one TMA slice
CLUSTER_SIZES = (1, 2, 4, 8)


def chain_layout(m: int, n: int) -> tuple[int, int]:
    """``(ldx, ldg)``: the leading dims, in floats, of the kernel's ``m x n``
    buffers (x as it reads it, the output, the Y ping-pong) and of its
    ``m x m`` Gram and polynomial. TMA reads rows whose stride is a
    multiple of 16 bytes, so both round up to 4 floats."""
    return round_up(n, 4), round_up(m, 4)


def needs_packing(x: torch.Tensor) -> bool:
    """Whether a contiguous ``(B, m, n)`` stack must be copied into the
    :func:`chain_layout` before TMA can read it."""
    return x.shape[-1] % 4 != 0 or x.data_ptr() % 16 != 0


def stage_work(m: int, n: int) -> tuple[tuple[int, int], ...]:
    """``(tiles, K slices a tile)`` of one unit's Gram, polynomial and update."""
    mt, nt = -(-m // TILE), -(-n // TILE)
    upper = mt * (mt + 1) // 2
    return ((upper, -(-n // K_SLICE)), (upper, -(-m // K_SLICE)), (mt * nt, -(-m // K_SLICE)))


def cluster_parts(units: int, m: int, n: int, sms: int) -> int:
    """Blocks a unit is split over: a thread-block cluster of 1, 2, 4 or 8.

    One block fills an SM, so ``sms // p`` clusters of ``p`` run at once,
    and the units go in ``ceil(units / (sms // p))`` waves. A wave lasts
    as long as its busiest block: in each stage ``ceil(tiles / p)`` tiles
    of that stage's depth. The split that minimises waves x that path, in
    K slices, wins; a tie goes to the larger cluster, which keeps fewer
    units live and so more of each unit's operands in L2. The stages'
    tile counts are uneven (21, 21 and 72 at m = 768, n = 1536; 1, 1 and
    12 at m = 48), so the split is not a function of the units alone.
    """
    work = stage_work(m, n)

    def cost(p: int) -> int:
        waves = -(-units // (sms // p))
        return waves * sum(-(-tiles // p) * slices for tiles, slices in work)

    return min((p for p in CLUSTER_SIZES if p <= sms), key=lambda p: (cost(p), -p))


def _launch(wrapper, x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
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
    ldx, ldg = chain_layout(m, n)
    packed = needs_packing(x)
    if packed:
        xp = torch.empty((batch, m, ldx), dtype=x.dtype, device=x.device)
        xp[..., :n].copy_(x)
        x = xp
    out = torch.empty((batch, m, ldx), dtype=x.dtype, device=x.device)
    tmp = torch.empty_like(out) if steps > 1 else None
    gram = torch.empty((batch, m, ldg), dtype=x.dtype, device=x.device)
    poly = torch.empty_like(gram)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.load("ns_fused").ns_fused_chain(
        x.data_ptr(), out.data_ptr(), None if tmp is None else tmp.data_ptr(),
        gram.data_ptr(), poly.data_ptr(), batch, m, n, ldx, ldg, steps,
        cluster_parts(batch, m, n, sms), a, b, c, stream,
    )
    build.check(rc, "ns_fused_chain")
    wrapper.launches += 1
    wrapper.packed_launches += int(packed)
    return out if ldx == n else out[..., :n]


def ns_chain(x: torch.Tensor, coeffs, steps: int) -> torch.Tensor:
    """All ``steps`` NS iterations of a ``(B, m, n)`` stack in one launch (kernel #3)."""
    if x.device.type == "cpu":
        return ns_chain_plain(x, coeffs, steps)
    return _launch(ns_chain, x, coeffs, steps)


def ns_iteration(x: torch.Tensor, coeffs) -> torch.Tensor:
    """One NS iteration of a ``(B, m, n)`` stack in one launch (kernel #4)."""
    if x.device.type == "cpu":
        return ns_chain_plain(x, coeffs, 1)
    return _launch(ns_iteration, x, coeffs, 1)


ns_chain.launches = ns_chain.packed_launches = 0
ns_iteration.launches = ns_iteration.packed_launches = 0


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
