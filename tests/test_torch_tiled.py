"""The tiled products' ``symmetric`` declaration, on the CPU.

``matmul`` and ``fma_matmul`` take ``symmetric=True`` for the Gram and the
polynomial of an NS step: the kernel then computes the upper tiles only.
The wrappers check what the shapes can show before they dispatch on the
device, so the check also runs here, where the plain versions compute the
full product. ``ops.ns_iteration``, which sets the flag, is held to the
reference's Pallas path in interpret mode at the reference's tolerance
(max abs 1e-5, fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.core.newton_schulz import PAPER_COEFFS as J_PAPER
from repro.kernels.newton_schulz import ops as j_ops
from repro_torch import kernels
from repro_torch.kernels.newton_schulz import ops
from repro_torch.kernels.newton_schulz import newton_schulz as tiled
from repro_torch.core.newton_schulz import PAPER_COEFFS

TOL = 1e-5


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", ["not_transpose", "other_tensor", "non_square", "copy_of_transpose"])
def test_symmetric_matmul_refuses_what_is_not_a_gram(case):
    x = _rand((2, 6, 10), 1)
    y = {
        "not_transpose": _rand((2, 10, 6), 2),
        "other_tensor": _rand((2, 6, 10), 3).transpose(-1, -2),
        "non_square": _rand((2, 10, 7), 4),
        "copy_of_transpose": x.transpose(-1, -2).contiguous(),
    }[case]
    with pytest.raises(ValueError):
        tiled.matmul(x, y, symmetric=True)


@pytest.mark.parametrize("shapes", [((6, 10), (10, 6), (6, 6)), ((3, 6, 6), (3, 6, 8), (3, 6, 8)),
                                    ((6, 8), (8, 6), (6, 6))])
def test_symmetric_fma_matmul_refuses_non_square_products(shapes):
    x, y, c = (_rand(s, i) for i, s in enumerate(shapes))
    with pytest.raises(ValueError):
        tiled.fma_matmul(x, y, c, alpha=1.0, beta=1.0, symmetric=True)


def test_symmetric_products_on_the_cpu_are_the_full_products():
    kernels.reset_launch_counts()
    x = _rand((3, 12, 40), 5)
    gram = tiled.matmul(x, x.transpose(-1, -2), symmetric=True)
    torch.testing.assert_close(gram, tiled.matmul_plain(x, x.transpose(-1, -2)), rtol=0, atol=0)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=-1.5, beta=0.5, symmetric=True)
    torch.testing.assert_close(poly, tiled.fma_matmul_plain(gram, gram, gram, alpha=-1.5, beta=0.5),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert kernels.packed_launches() == 0


@pytest.mark.parametrize("shape", [(16, 48), (24, 130), (13, 150)])
def test_ns_iteration_matches_pallas_interpret(shape):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    x = x / np.linalg.norm(x)
    out = ops.ns_iteration(torch.from_numpy(x), PAPER_COEFFS)
    expect = j_ops.ns_iteration(jnp.asarray(x), J_PAPER, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=0, atol=TOL)


def test_meta_tensors_are_checked_before_the_device_is():
    meta = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="square"):
        tiled.matmul(meta, torch.empty(1, 8, 5, device="meta"), symmetric=True)
    with pytest.raises(ValueError, match="CUDA"):
        tiled.matmul(meta, meta.transpose(-1, -2), symmetric=True)
