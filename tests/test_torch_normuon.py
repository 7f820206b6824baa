"""The NorMuon row normalization of the port against the JAX package.

The same numpy inputs go through the reference (its jnp twin
``neuron_norm_reference`` and its Pallas kernel in interpret mode, as
``tests/test_variants.py`` runs it) and through the port on the CPU, where
the kernel wrapper runs its plain PyTorch version. All fp32. The two sides
differ only in the order of the row sum of squares and of the RMS means, so
outputs agree to a relative 1e-6 (about 2e-7 measured).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.kernels import normuon as j_normuon
from repro_torch import kernels
from repro_torch.kernels import normuon

RTOL = 1e-6
BETA2, EPS = 0.95, 1e-8


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _stats(shape, seed):
    return np.abs(_rand((*shape[:-1], 1), seed))


def _close(out, expect, rtol=RTOL):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    expect = np.asarray(expect)
    assert out.shape == expect.shape
    np.testing.assert_allclose(out, expect, rtol=rtol, atol=0)


# (8, 128)-aligned, ragged in both dims, a lane-pad, and a main-path width
SHAPES = [(1, 8, 128), (2, 10, 17), (3, 16, 130), (2, 5, 1536)]


@pytest.mark.parametrize("refresh", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_the_kernel_and_its_jnp_twin(refresh, shape):
    x, v = _rand(shape, 1), _stats(shape, 2)
    corr = np.float32(1.0 - np.float32(BETA2) ** np.float32(3))
    y, v_new = normuon.neuron_norm_plain(torch.from_numpy(x), torch.from_numpy(v), float(corr),
                                         beta2=BETA2, eps=EPS, refresh=refresh)
    y_k, v_k = j_normuon.neuron_norm(jnp.asarray(x), jnp.asarray(v), corr, beta2=BETA2,
                                     eps=EPS, refresh=refresh, interpret=True)
    y_r, v_r = j_normuon.neuron_norm_reference(jnp.asarray(x), jnp.asarray(v), corr,
                                               beta2=BETA2, eps=EPS, refresh=refresh)
    for y_ref, v_ref in ((y_k, v_k), (y_r, v_r)):
        _close(y, y_ref)
        _close(v_new, v_ref)
    if not refresh:
        np.testing.assert_array_equal(v_new.numpy(), v)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    x, v = torch.from_numpy(_rand((2, 6, 40), 3)), torch.from_numpy(_stats((2, 6, 40), 4))
    kernels.reset_launch_counts()
    for refresh in (True, False):
        out = normuon.neuron_norm(x, v, 0.1, beta2=BETA2, eps=EPS, refresh=refresh)
        expect = normuon.neuron_norm_plain(x, v, 0.1, beta2=BETA2, eps=EPS, refresh=refresh)
        for a, b in zip(out, expect):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kernels.launch_counts()["normuon"] == 0
    with pytest.raises(ValueError, match="expected"):
        normuon.neuron_norm(x, v[:, :5], 0.1, beta2=BETA2, eps=EPS, refresh=True)


def test_bias_correction_rounds_in_fp32_as_the_reference():
    for count in range(0, 400, 7):
        ref = np.maximum(np.float32(1.0) - jnp.float32(BETA2) ** jnp.float32(count),
                         np.float32(1e-12))
        assert normuon.bias_correction(count, BETA2) == float(np.float32(ref)), count


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("refresh,count", [(True, 0), (True, 4), (False, 2)])
@pytest.mark.parametrize("shape", [(3, 8, 16), (24, 40), (2, 3, 10, 130)])
def test_apply_neuron_norm_matches_reference(backend, refresh, count, shape):
    o, v = _rand(shape, 5), _stats(shape, 6)
    y, v_new, c_new = normuon.apply_neuron_norm(
        torch.from_numpy(o), torch.from_numpy(v), count, beta2=BETA2, eps=EPS, refresh=refresh)
    y_r, v_r, c_r = j_normuon.apply_neuron_norm(
        jnp.asarray(o), jnp.asarray(v), jnp.asarray(count, jnp.int32), beta2=BETA2, eps=EPS,
        refresh=refresh, backend=backend, interpret=True)
    _close(y, y_r, rtol=1e-5)  # the rescale's two means add their own sum order
    _close(v_new, v_r)
    assert c_new == int(c_r) == count + int(refresh)


def test_apply_neuron_norm_lead_padded_state():
    """State rows beyond the update's lead dim are pad: the head is
    normalized and refreshed, the pad comes back as zeros, the RMS holds."""
    x = _rand((3, 8, 16), 7)
    v = np.concatenate([np.ones((3, 8, 1), np.float32), np.zeros((1, 8, 1), np.float32)])
    y, v_new, c_new = normuon.apply_neuron_norm(
        torch.from_numpy(x), torch.from_numpy(v), 2, beta2=BETA2, eps=EPS, refresh=True)
    y_r, v_r, c_r = j_normuon.apply_neuron_norm(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(2, jnp.int32), beta2=BETA2, eps=EPS,
        refresh=True, backend="jnp")
    assert tuple(y.shape) == x.shape and tuple(v_new.shape) == (4, 8, 1)
    assert c_new == int(c_r) == 3
    _close(y, y_r, rtol=1e-5)
    _close(v_new, v_r)
    np.testing.assert_array_equal(v_new[3:].numpy(), 0.0)
    rms = lambda t: float(torch.sqrt(torch.mean(torch.square(t))))
    assert rms(y) == pytest.approx(rms(torch.from_numpy(x)), rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_steps_guard_passes_the_update_through(dtype):
    """Before any refresh the statistics are zero: the raw update passes
    through unchanged, as the reference's ``where(new_count > 0, y, x)``."""
    o = torch.from_numpy(_rand((2, 8, 24), 8)).to(dtype)
    v = torch.zeros(2, 8, 1)
    kernels.reset_launch_counts()
    y, v_new, c_new = normuon.apply_neuron_norm(o, v, 0, beta2=BETA2, eps=EPS, refresh=False)
    y_r, v_r, c_r = j_normuon.apply_neuron_norm(
        jnp.asarray(o.to(torch.float32).numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(v.numpy()), jnp.asarray(0, jnp.int32), beta2=BETA2, eps=EPS,
        refresh=False, backend="jnp")
    assert y.dtype == dtype and c_new == int(c_r) == 0
    torch.testing.assert_close(y, o, rtol=0, atol=0)
    np.testing.assert_array_equal(y.to(torch.float32).numpy(),
                                  np.asarray(y_r.astype(jnp.float32)))
    assert v_new is v
    np.testing.assert_array_equal(np.asarray(v_r), 0.0)
