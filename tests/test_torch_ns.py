"""Newton-Schulz math and kernel wrappers of the port against the JAX package.

The same numpy inputs go through the reference (plain jnp, and the Pallas
kernels in interpret mode as ``tests/test_kernels.py`` runs them) and
through the port on the CPU, where every kernel wrapper runs its plain
PyTorch version. All fp32: max abs <= 1e-5, the reference's own tolerance
between its Pallas kernels and the jnp chain (test_kernels.py:74).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.core.newton_schulz import PAPER_COEFFS as J_PAPER
from repro.core.newton_schulz import orthogonality_error as j_orth_err
from repro.core.newton_schulz import orthogonalize_jnp
from repro.kernels import dispatch as j_dispatch
from repro.kernels.newton_schulz import fused as j_fused
from repro.kernels.newton_schulz import newton_schulz as j_ns
from repro.kernels.newton_schulz import ops as j_ops
from repro.kernels.newton_schulz import ref as j_ref
from repro_torch import kernels
from repro_torch.core.newton_schulz import (
    JORDAN_COEFFS,
    PAPER_COEFFS,
    orthogonality_error,
    orthogonalize,
    orthogonalize_plain,
)
from repro_torch.kernels import dispatch
from repro_torch.kernels.newton_schulz import fused, ops, ref
from repro_torch.kernels.newton_schulz import newton_schulz as tiled

TOL = 1e-5

# wide, tall, stacked, padded (m % 8 != 0, n % 128 != 0)
SHAPES = [(16, 48), (48, 16), (3, 2, 24, 40), (13, 150)]


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, expect, atol=TOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(expect), rtol=0, atol=atol)


def test_coefficients_match():
    assert PAPER_COEFFS == J_PAPER
    assert JORDAN_COEFFS == (3.4445, -4.7750, 2.0315)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_orthogonalize_matches_jnp(shape, normalize):
    g = _rand(shape, 1)
    if not normalize:
        g = g / (np.linalg.norm(g.reshape(-1, *g.shape[-2:]), axis=(-2, -1)).max() * 1.5)
    out = orthogonalize_plain(torch.from_numpy(g), steps=5, normalize=normalize)
    _close(out, orthogonalize_jnp(jnp.asarray(g), steps=5, normalize=normalize))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chain", [True, False])
def test_fused_strategy_matches_pallas(shape, chain):
    g = _rand(shape, 2)
    out = fused.orthogonalize(torch.from_numpy(g), steps=5, chain=chain)
    expect = j_fused.orthogonalize(jnp.asarray(g), steps=5, chain=chain, interpret=True)
    _close(out, expect)


@pytest.mark.parametrize("shape", [(16, 48), (48, 16), (13, 150)])
def test_tiled_strategy_matches_pallas(shape):
    g = _rand(shape, 3)
    _close(ops.orthogonalize(torch.from_numpy(g), steps=5),
           j_ops.orthogonalize(jnp.asarray(g), steps=5, interpret=True))


def test_tiled_strategy_stacked_matches_pallas_batched():
    g = _rand((2, 3, 24, 40), 4)
    _close(ops.orthogonalize(torch.from_numpy(g), steps=5),
           j_ops.orthogonalize_batched(jnp.asarray(g), steps=5, interpret=True))


@pytest.mark.parametrize("strategy", ["plain", "fused_chain", "fused_iter", "tiled", None])
def test_dispatch_strategies_agree(strategy):
    g = _rand((2, 20, 36), 5)
    out = orthogonalize(torch.from_numpy(g), steps=5, strategy=strategy)
    _close(out, orthogonalize_jnp(jnp.asarray(g), steps=5))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (100, 300, 50), (1, 128, 1)])
def test_matmul_matches_pallas(m, k, n):
    x, y = _rand((m, k), 6), _rand((k, n), 7)
    _close(tiled.matmul(torch.from_numpy(x), torch.from_numpy(y)),
           j_ns.matmul(jnp.asarray(x), jnp.asarray(y), interpret=True), atol=1e-4)


@pytest.mark.parametrize("alpha,beta", [(2.0, -1.5), (0.5, 1.0)])
def test_fma_matmul_matches_pallas(alpha, beta):
    x, y, c = _rand((100, 300), 8), _rand((300, 50), 9), _rand((100, 50), 10)
    out = tiled.fma_matmul(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(c),
                           alpha=alpha, beta=beta)
    expect = j_ns.fma_matmul(jnp.asarray(x), jnp.asarray(y), jnp.asarray(c),
                             alpha=alpha, beta=beta, interpret=True)
    _close(out, expect, atol=1e-4)


def test_batched_matmul_and_transposed_operand():
    x = _rand((3, 20, 70), 11)
    xt = torch.from_numpy(x)
    out = tiled.matmul(xt, xt.transpose(-1, -2))
    expect = np.stack([np.asarray(j_ref.matmul_ref(jnp.asarray(x[i]), jnp.asarray(x[i].T)))
                       for i in range(3)])
    _close(out, expect, atol=1e-4)


def test_ns_iteration_and_chain_match_pallas():
    x = _rand((3, 24, 130), 12)
    x = x / np.linalg.norm(x, axis=(-2, -1), keepdims=True)
    xt = torch.from_numpy(x)
    _close(fused.ns_iteration(xt, PAPER_COEFFS),
           j_fused.ns_iteration_batched(jnp.asarray(x), J_PAPER, interpret=True))
    _close(ops.ns_iteration(xt, PAPER_COEFFS),
           j_ref.batched_ns_iteration_ref(jnp.asarray(x), J_PAPER))
    _close(fused.ns_chain(xt, PAPER_COEFFS, 3), fused.ns_chain_plain(xt, PAPER_COEFFS, 3))


@pytest.mark.parametrize("name", ["matmul", "fma", "ns_iter", "newton_schulz",
                                  "batched_iter", "batched_ns"])
def test_ref_oracles_match(name):
    x, y, c = _rand((20, 36), 13), _rand((36, 12), 14), _rand((20, 12), 15)
    xj, yj, cj = map(jnp.asarray, (x, y, c))
    xt, yt, ct = map(torch.from_numpy, (x, y, c))
    s = _rand((2, 20, 36), 16)
    cases = {
        "matmul": (lambda: ref.matmul_ref(xt, yt), lambda: j_ref.matmul_ref(xj, yj)),
        "fma": (lambda: ref.fma_matmul_ref(xt, yt, ct, 0.5, 2.0),
                lambda: j_ref.fma_matmul_ref(xj, yj, cj, 0.5, 2.0)),
        "ns_iter": (lambda: ref.ns_iteration_ref(xt / 10, PAPER_COEFFS),
                    lambda: j_ref.ns_iteration_ref(xj / 10, J_PAPER)),
        "newton_schulz": (lambda: ref.newton_schulz_ref(xt, 5, PAPER_COEFFS),
                          lambda: j_ref.newton_schulz_ref(xj, 5, J_PAPER)),
        "batched_iter": (lambda: ref.batched_ns_iteration_ref(torch.from_numpy(s) / 10, PAPER_COEFFS),
                         lambda: j_ref.batched_ns_iteration_ref(jnp.asarray(s) / 10, J_PAPER)),
        "batched_ns": (lambda: ref.batched_newton_schulz_ref(torch.from_numpy(s), 5, PAPER_COEFFS),
                       lambda: j_ref.batched_newton_schulz_ref(jnp.asarray(s), 5, J_PAPER)),
    }
    port, reference = cases[name]
    _close(port(), reference(), atol=1e-4 if name in ("matmul", "fma") else TOL)


def test_orthogonality_error_matches():
    x = _rand((2, 16, 40), 17)
    _close(orthogonality_error(torch.from_numpy(x)), j_orth_err(jnp.asarray(x)), atol=1e-4)
    o = orthogonalize_plain(torch.from_numpy(x), steps=10)
    assert float(orthogonality_error(o).max()) < 0.1


def test_cpu_wrappers_launch_nothing_and_other_devices_raise():
    kernels.reset_launch_counts()
    x = torch.ones(4, 8)
    tiled.matmul(x, x.T)
    tiled.fma_matmul(x, x.T, torch.ones(4, 4), alpha=1.0, beta=1.0)
    fused.ns_chain(x[None], PAPER_COEFFS, 2)
    fused.ns_iteration(x[None], PAPER_COEFFS)
    fused.ns_chain(torch.ones(1, 3, 150), PAPER_COEFFS, 1)  # rows TMA could not read
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert kernels.packed_launches() == 0
    meta = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tiled.matmul(meta, meta.transpose(-1, -2))
    with pytest.raises(ValueError):
        fused.ns_chain(meta, PAPER_COEFFS, 1)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


# Full-width muonbp-960m units under an 8-way block grid (post-transpose).
GATE_CASES = [
    ((2, 12, 8, 1536, 48), "fused_chain"),    # block: wk/wv
    ((12, 8, 1536, 192), "fused_chain"),      # block: wq
    ((2, 12, 8, 1536, 768), "fused_chain"),   # block: mlp wi/wg
    ((12, 8, 768, 1536), "fused_chain"),      # block: mlp wo
    ((2, 12, 1536), "fused_chain"),           # both phases: norm gains
    ((24, 1536, 384), "fused_chain"),         # full: wk/wv
    ((24, 1536, 1536), "tiled"),              # full: wq/wo
    ((24, 1536, 6144), "tiled"),              # full: mlp wi/wg
    ((12, 6144, 1536), "tiled"),              # full: mlp wo
]


@pytest.mark.parametrize("shape,expect", GATE_CASES)
def test_fit_gate_routes_full_width_units(shape, expect):
    assert dispatch.plan_strategy(shape) == expect


def test_fit_gate_keeps_reference_working_set_formula():
    # 768 x 1536: 4 * (2*768*1536 + 2*768^2) = 14.2 MB, the reference formula.
    assert fused.fits_budget((768, 1536), budget=14_155_776)
    assert not fused.fits_budget((768, 1536), budget=14_155_775)
    for m, n in [(13, 150), (200, 72), (1536, 6144)]:
        assert fused.fits_budget((m, n), budget=12 * 2**20) == j_fused.fits_vmem((m, n))


def test_shared_launch_groups_match():
    keys = [(16, 32, "float32"), (16, 32, "bfloat16"), (8, 8, "float32")]
    assert dispatch.shared_launch_groups(keys) == j_dispatch.shared_launch_groups(keys)


def test_launch_hook_sees_every_dispatch():
    seen = []
    dispatch.set_launch_hook(lambda dev, strat, shape: seen.append((dev, strat, shape)))
    try:
        orthogonalize(torch.ones(3, 4, 8), steps=1)
        orthogonalize(torch.ones(4, 8), steps=1, strategy="tiled")
    finally:
        dispatch.set_launch_hook(None)
    assert seen == [("cpu", "fused_chain", (3, 4, 8)), ("cpu", "tiled", (4, 8))]


def _ns_property(case: str) -> None:
    g = lambda shape, seed: torch.from_numpy(_rand(shape, seed))
    svals = lambda o: torch.linalg.svdvals(o.to(torch.float32))
    if case == "wide":
        torch.testing.assert_close(svals(orthogonalize_plain(g((64, 128), 20), steps=12)),
                                   torch.ones(64), rtol=0, atol=0.05)
    elif case == "tall":
        torch.testing.assert_close(svals(orthogonalize_plain(g((128, 48), 21), steps=12)),
                                   torch.ones(48), rtol=0, atol=0.05)
    elif case == "error_decreases":
        x = g((64, 96), 22)
        errs = [float(orthogonality_error(orthogonalize_plain(x, steps=s))) for s in (1, 3, 6, 10)]
        assert errs == sorted(errs, reverse=True), errs
    elif case == "batched_matches_loop":
        x = g((4, 32, 64), 23)
        looped = torch.stack([orthogonalize_plain(x[i], steps=5) for i in range(4)])
        torch.testing.assert_close(orthogonalize_plain(x, steps=5), looped, rtol=0, atol=1e-6)
    elif case == "sign":
        x = g((32, 32), 24)
        assert float((orthogonalize_plain(x, steps=8) * x).sum()) > 0
    elif case == "jordan":
        x = g((64, 64), 25)
        o = orthogonalize_plain(x, steps=5, coeffs=JORDAN_COEFFS)
        assert float(orthogonality_error(o)) < 0.5
        _close(o, orthogonalize_jnp(jnp.asarray(x.numpy()), steps=5, coeffs=JORDAN_COEFFS),
               atol=1e-4)
    elif case == "bf16_roundtrip":
        x = g((64, 64), 26).to(torch.bfloat16)
        o = orthogonalize(x, steps=5)
        assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all())
    elif case == "scale_invariance":
        x = g((17, 23), 27)
        torch.testing.assert_close(orthogonalize_plain(37.5 * x, steps=5),
                                   orthogonalize_plain(x, steps=5), rtol=0, atol=2e-4)
    elif case == "zero_safe":
        for strategy in ("plain", "fused_chain", "tiled"):
            assert bool(torch.isfinite(orthogonalize(torch.zeros(16, 16), strategy=strategy)).all())


@pytest.mark.parametrize("case", ["wide", "tall", "error_decreases", "batched_matches_loop",
                                  "sign", "jordan", "bf16_roundtrip", "scale_invariance",
                                  "zero_safe"])
def test_newton_schulz_properties_of_the_reference_hold(case):
    """The cases of tests/test_newton_schulz.py, on the port."""
    _ns_property(case)


@pytest.mark.parametrize("units,m,n,parts", [
    (192, 768, 1536, 2),   # block: mlp wi/wg
    (96, 768, 1536, 8),    # block: mlp wo
    (96, 192, 1536, 4),    # block: wq/wo
    (24, 384, 1536, 4),    # full: wk/wv
    (2, 12, 1536, 8),      # both phases: norm gains
    (1000, 48, 1536, 1),   # a bucket of many small units
])
def test_fused_chain_cluster_split_evens_out_the_busiest_sm(units, m, n, parts):
    """On the H100's 132 SMs, one block an SM: the split that minimises
    waves x the busiest block's K slices, ties to the larger cluster."""
    assert fused.cluster_parts(units, m, n, 132) == parts
