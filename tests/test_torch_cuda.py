"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test asks the ``card`` fixture for the device, and the
fixture skips where there is none, so the CPU run collects the same tests
as a card run and skips them here. On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports JAX, which the machine with
the card need not have; this file imports none of it.)

Tolerances are relative to max|plain|, TF32 off on both sides: 1e-4 for one
product (fp32 FFMA in another summation order than cuBLAS's SGEMM) and
1e-3 for NS chains, whose cubic polynomial compounds the rounding of each
step.
"""

import pytest
import torch

from repro_torch import kernels
from repro_torch.core.newton_schulz import PAPER_COEFFS, orthogonalize, orthogonalize_plain
from repro_torch.kernels.newton_schulz import fused, ops
from repro_torch.kernels.newton_schulz import newton_schulz as tiled

pytestmark = pytest.mark.cuda

PRODUCT_TOL, CHAIN_TOL = 1e-4, 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _rand(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _assert_rel(out, ref, tol):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.is_cuda
    err = float((out.double() - ref.double()).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("b,m,k,n", [(1, 128, 128, 128), (3, 100, 300, 50), (2, 1, 9, 1),
                                     (2, 257, 130, 129)])
def test_matmul_and_fma_matmul_match_plain(card, b, m, k, n):
    x, y, c = _rand((b, m, k), 1, card), _rand((b, k, n), 2, card), _rand((b, m, n), 3, card)
    _assert_rel(tiled.matmul(x, y), tiled.matmul_plain(x, y), PRODUCT_TOL)
    _assert_rel(tiled.fma_matmul(x, y, c, alpha=2.0, beta=-1.5),
                tiled.fma_matmul_plain(x, y, c, alpha=2.0, beta=-1.5), PRODUCT_TOL)
    _assert_rel(tiled.matmul(x[0], y[0]), tiled.matmul_plain(x[0], y[0]), PRODUCT_TOL)
    assert (tiled.matmul.launches, tiled.fma_matmul.launches) == (2, 1)


def test_gram_reads_the_transposed_operand_in_place(card):
    x = _rand((3, 70, 200), 4, card)
    _assert_rel(tiled.matmul(x, x.transpose(-1, -2)),
                tiled.matmul_plain(x, x.transpose(-1, -2)), PRODUCT_TOL)
    strided = _rand((3, 200, 140), 5, card)[:, :, ::2]  # neither layout: packed first
    _assert_rel(tiled.matmul(x, strided), tiled.matmul_plain(x, strided), PRODUCT_TOL)


@pytest.mark.parametrize("shape", [(4, 13, 150), (2, 130, 200), (1, 48, 1536)])
def test_fused_chain_and_iteration_match_plain(card, shape):
    x = _rand(shape, 6, card)
    x = x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)
    ref = fused.ns_chain_plain(x, PAPER_COEFFS, 5)
    _assert_rel(fused.ns_chain(x, PAPER_COEFFS, 5), ref, CHAIN_TOL)
    y = x
    for _ in range(5):
        y = fused.ns_iteration(y, PAPER_COEFFS)
    _assert_rel(y, ref, CHAIN_TOL)
    assert (fused.ns_chain.launches, fused.ns_iteration.launches) == (1, 5)


@pytest.mark.parametrize("strategy", ["fused_chain", "fused_iter", "tiled", None])
@pytest.mark.parametrize("shape", [(2, 40, 24), (3, 2, 24, 40), (130, 66)])
def test_dispatch_strategies_match_plain_orthogonalize(card, strategy, shape):
    g = _rand(shape, 7, card)
    _assert_rel(orthogonalize(g, steps=5, strategy=strategy), orthogonalize_plain(g, steps=5),
                CHAIN_TOL)
    assert sum(kernels.launch_counts().values()) > 0


def test_tiled_chain_launches_three_products_per_step(card):
    g = _rand((4, 64, 96), 8, card)
    _assert_rel(ops.orthogonalize(g, steps=5), orthogonalize_plain(g, steps=5), CHAIN_TOL)
    assert (tiled.matmul.launches, tiled.fma_matmul.launches) == (5, 10)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    with pytest.raises(TypeError):
        tiled.matmul(_rand((4, 8), 9, card).double(), _rand((8, 4), 10, card).double())
    with pytest.raises(ValueError):
        fused.ns_chain(_rand((2, 16, 8), 11, card), PAPER_COEFFS, 1)  # m > n
    with pytest.raises(ValueError):
        tiled.matmul(_rand((4, 8), 12, card), _rand((8, 4), 13, card).cpu())
    assert sum(kernels.launch_counts().values()) == 0


def test_reduced_training_on_the_card_tracks_the_cpu(card):
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    base = init_params(get_config("muonbp-960m").reduced(), seed=0, device="cpu")
    argv = ["--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32"]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    gpu = train.run(argv + ["--device", "cuda"],
                    params=tree_lib.tree_map(lambda p: p.to("cuda"), base)).records
    assert kernels.launch_counts()["ns_fused_chain"] > 0
    # fp32 on both; cuBLAS and the CPU's BLAS sum in other orders, which six
    # NS-amplified updates carry into the loss (see chip_smoke.py).
    assert max(abs(g["loss"] - c["loss"]) for g, c in zip(gpu, cpu)) <= 1e-3
