"""The fused Newton-Schulz chain's host logic, on the CPU.

The CUDA kernel (``csrc/ns_fused.cu``) runs only on the card; what the
wrapper decides before it launches it is plain Python and is checked here:
the work split (tiles per stage, cluster size), the workspace's leading
dimensions, and when a stack must be packed for TMA. The wrapper's plain
path is held to the reference's Pallas chain in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.newton_schulz import PAPER_COEFFS as J_PAPER
from repro.kernels.newton_schulz import fused as j_fused
from repro_torch.core.newton_schulz import PAPER_COEFFS
from repro_torch.kernels.newton_schulz import fused

TOL = 1e-5  # fp32, the reference's own tolerance for its kernels


@pytest.mark.parametrize("m,n,work", [
    (768, 1536, ((21, 48), (21, 24), (72, 24))),   # mlp blocks
    (192, 1536, ((3, 48), (3, 6), (24, 6))),       # attention blocks
    (48, 1536, ((1, 48), (1, 2), (12, 2))),        # k/v blocks
    (12, 1536, ((1, 48), (1, 1), (12, 1))),        # norm gains
    (64, 6144, ((1, 192), (1, 2), (48, 2))),       # Dion's 6144-row factors
    (13, 150, ((1, 5), (1, 1), (2, 1))),           # ragged
])
def test_stage_work_counts_tiles_and_k_slices(m, n, work):
    """(tiles, K slices a tile) of the Gram and the polynomial (upper tiles)
    and of the update (every tile)."""
    assert fused.stage_work(m, n) == work


@pytest.mark.parametrize("units,m,n,sms", [(192, 48, 1536, 132), (12, 64, 6144, 132),
                                           (72, 64, 1536, 132), (5, 300, 900, 7)])
def test_cluster_parts_is_the_cheapest_split(units, m, n, sms):
    """The chosen split costs no more than any other size (waves x the
    busiest block's K slices), and a cluster never exceeds the SMs."""
    def cost(p):
        waves = -(-units // (sms // p))
        return waves * sum(-(-t // p) * k for t, k in fused.stage_work(m, n))

    parts = fused.cluster_parts(units, m, n, sms)
    assert parts in fused.CLUSTER_SIZES and parts <= sms
    assert all(cost(parts) <= cost(p) for p in fused.CLUSTER_SIZES if p <= sms)


@pytest.mark.parametrize("m,n,lds", [(768, 1536, (1536, 768)), (12, 1536, (1536, 12)),
                                     (13, 150, (152, 16)), (130, 200, (200, 132)),
                                     (1, 3, (4, 4))])
def test_chain_layout_rounds_rows_to_16_bytes(m, n, lds):
    """TMA reads rows whose stride is a multiple of 16 bytes: a 13 x 13 Gram
    (52-byte rows) lives in rows of 16 floats."""
    ldx, ldg = fused.chain_layout(m, n)
    assert (ldx, ldg) == lds
    assert ldx % 4 == 0 and ldg % 4 == 0 and ldx >= n and ldg >= m


def test_needs_packing_follows_row_width_and_base_alignment():
    aligned = torch.zeros(2, 8, 16)
    assert not fused.needs_packing(aligned)
    assert fused.needs_packing(torch.zeros(2, 8, 150))      # 600-byte rows
    offset = torch.zeros(2 * 8 * 16 + 1)[1:].view(2, 8, 16)  # base 4 bytes off
    assert fused.needs_packing(offset)


@pytest.mark.parametrize("shape,steps", [((2, 13, 150), 5), ((3, 24, 130), 3), ((2, 12, 64), 6)])
def test_chain_matches_pallas_chain_in_interpret_mode(shape, steps):
    """The wrapper's path on the CPU (the oracle the card's kernel is held to)
    against the reference's fused chain kernel, K = 3, 5 and 6."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    x = x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    out = fused.ns_chain(torch.from_numpy(x), PAPER_COEFFS, steps)
    expect = j_fused.orthogonalize(jnp.asarray(x), steps=steps, coeffs=J_PAPER, chain=True,
                                   normalize=False, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=0, atol=TOL)
