"""The port's Mamba2 layer (``repro_torch.models.ssm``) against the JAX
package's (``repro/models/ssm.py``), on the same numpy inputs.

Tolerances, each with its reason:

* fp32, 1e-5 absolute on values of order one: the chunked SSD sums the same
  products per chunk in another order than XLA's einsums (a few fp32 ulps
  a reduction of at most 128 terms);
* the reference's parameters are carried over by ``repro_torch.interop``;
  the port's own init is held to the reference's law (shapes and constants
  exactly, the N(0, 0.02) draws by their spread);
* dtypes exactly: the decode state's dtypes follow the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.models import ssm as j_ssm
from repro_torch import interop
from repro_torch.models import ssm

TOL = 1e-5
DIMS = dict(d_model=32, state_size=8, head_dim=8, expand=2)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(out.detach().to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(expect).astype(jnp.float32)),
                               rtol=0, atol=tol)


def _ssd_inputs(seed, bsz=2, seq=16, nh=3, hp=4, n=8):
    r = _rng(seed)
    x = r.standard_normal((bsz, seq, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((bsz, seq, nh)))).astype(np.float32)
    a = -np.exp(0.3 * r.standard_normal(nh)).astype(np.float32)
    b = r.standard_normal((bsz, seq, n)).astype(np.float32)
    c = r.standard_normal((bsz, seq, n)).astype(np.float32)
    h0 = 0.5 * r.standard_normal((bsz, nh, hp, n)).astype(np.float32)
    return x, dt, a, b, c, h0


def _layer(seed=0, **dims):
    jdims = j_ssm.make_dims(**{**DIMS, **dims})
    jp = j_ssm.init_ssm_params(jax.random.PRNGKey(seed), jdims)
    # Non-trivial per-head scalars and conv biases: the init's are constants.
    r = _rng(seed + 100)
    jp = {k: (v + 0.1 * r.standard_normal(v.shape).astype(np.float32)
              if k in ("dt_bias", "D", "conv_x_bias", "conv_b_bias", "gate_norm") else v)
          for k, v in jp.items()}
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jdims, jp, ssm.make_dims(**{**DIMS, **dims}), params


def test_make_dims_and_init_law_match_reference():
    jdims = j_ssm.make_dims(2048, 128, head_dim=64, expand=2)
    dims = ssm.make_dims(2048, 128, head_dim=64, expand=2)
    assert tuple(dims) == tuple(jdims) == (2048, 4096, 64, 64, 128, 4)
    dims = ssm.make_dims(**DIMS)
    ref = j_ssm.init_ssm_params(jax.random.PRNGKey(0), j_ssm.make_dims(**DIMS))
    gen = torch.Generator().manual_seed(0)
    port = ssm.init_ssm_params(gen, dims, device="cpu")
    stacked = ssm.init_ssm_params(gen, dims, lead=(3,), device="cpu", dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    assert {k: tuple(v.shape) for k, v in stacked.items()} == {
        k: (3, *v.shape) for k, v in ref.items()}
    assert all(v.dtype == torch.bfloat16 for v in stacked.values())
    # The constants: exact, but A_log = log(linspace(1, 16, H)) to an fp32
    # ulp (XLA's linspace and log round differently from torch's).
    for k in ("conv_x_bias", "conv_b_bias", "conv_c_bias", "A_log", "D", "dt_bias", "gate_norm"):
        tol = 2.4e-7 if k == "A_log" else 0.0
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=tol, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(stacked[k][2].float().numpy(), port[k].numpy(), rtol=4e-3,
                                   atol=0)
    for k in ("wz", "wx", "wb", "wc", "wdt", "conv_x", "conv_b", "conv_c", "out_proj"):
        assert float(port[k].std()) == pytest.approx(0.02, rel=0.25), k


def test_causal_conv_and_segsum_match_reference():
    r = _rng(1)
    x = r.standard_normal((2, 9, 5)).astype(np.float32)
    w = r.standard_normal((4, 5)).astype(np.float32)
    b = r.standard_normal(5).astype(np.float32)
    _close(ssm._causal_conv(*map(torch.from_numpy, (x, w, b))),
           j_ssm._causal_conv(*map(jnp.asarray, (x, w, b))))
    s = r.standard_normal((2, 3, 7)).astype(np.float32)
    got, want = ssm._segsum(torch.from_numpy(s)).numpy(), np.asarray(j_ssm._segsum(jnp.asarray(s)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=TOL)


# (seq, chunk): a dividing chunk, the whole sequence as one chunk, a chunk
# over the length (min(chunk, seq)), and the gcd rule (20 % 8 -> chunks of 4,
# 22 % 8 -> chunks of 2).
SSD_CASES = [(16, 4), (16, 16), (12, 128), (20, 8), (22, 8)]


@pytest.mark.parametrize("seq,chunk", SSD_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(seq, chunk, with_state):
    x, dt, a, b, c, h0 = _ssd_inputs(seq + chunk, seq=seq)
    init = h0 if with_state else None
    y, h = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk=chunk,
                           initial_state=None if init is None else torch.from_numpy(init))
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk=chunk,
                               initial_state=None if init is None else jnp.asarray(init))
    assert y.dtype == h.dtype == torch.float32
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunked_carries_the_state_across_a_split():
    """Two halves, the second from the first's state, equal one pass."""
    x, dt, a, b, c, _ = _ssd_inputs(7, bsz=1)
    t = lambda v: torch.from_numpy(v)
    y_all, h_all = ssm.ssd_chunked(t(x), t(dt), t(a), t(b), t(c), chunk=4)
    y1, h1 = ssm.ssd_chunked(t(x[:, :8]), t(dt[:, :8]), t(a), t(b[:, :8]), t(c[:, :8]), chunk=4)
    y2, h2 = ssm.ssd_chunked(t(x[:, 8:]), t(dt[:, 8:]), t(a), t(b[:, 8:]), t(c[:, 8:]),
                             chunk=4, initial_state=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, rtol=0, atol=1e-4)
    torch.testing.assert_close(h2, h_all, rtol=0, atol=1e-4)


@pytest.mark.parametrize("seq,chunk", [(12, 4), (136, 128)])
def test_ssm_forward_with_state_matches_reference(seq, chunk):
    """Output and prefill state; 136 tokens at the default chunk of 128 run
    the gcd path (chunks of 8)."""
    jdims, jp, dims, params = _layer()
    x = (0.5 * _rng(2).standard_normal((2, seq, 32))).astype(np.float32)
    out, state = ssm.ssm_forward(torch.from_numpy(x), params, dims, chunk=chunk,
                                 return_state=True)
    jout, jstate = j_ssm.ssm_forward(jnp.asarray(x), jp, jdims, chunk=chunk, return_state=True)
    _close(out, jout)
    assert set(state) == set(jstate)
    for k in state:
        assert state[k].dtype == torch.float32 and tuple(state[k].shape) == jstate[k].shape
        _close(state[k], jstate[k])
    torch.testing.assert_close(ssm.ssm_forward(torch.from_numpy(x), params, dims, chunk=chunk),
                               out, rtol=0, atol=0)


@pytest.mark.parametrize("start", ["init", "prefill"])
def test_ssm_decode_step_matches_reference(start):
    """Eight steps from the init state (bf16 conv windows, which the first
    step's fp32 input promotes to fp32, as in the reference) or from a
    prefill's state: outputs, states and their dtypes."""
    jdims, jp, dims, params = _layer(seed=3)
    x = (0.5 * _rng(4).standard_normal((2, 14, 32))).astype(np.float32)
    if start == "init":
        state = ssm.init_decode_state(2, dims, dtype=torch.bfloat16, device="cpu")
        jstate = j_ssm.init_decode_state(2, jdims, dtype=jnp.bfloat16)
        assert {k: v.dtype for k, v in state.items()} == {
            "h": torch.float32, "conv_x": torch.bfloat16, "conv_b": torch.bfloat16,
            "conv_c": torch.bfloat16}
        first = 0
    else:
        _, state = ssm.ssm_forward(torch.from_numpy(x[:, :6]), params, dims, chunk=4,
                                   return_state=True)
        _, jstate = j_ssm.ssm_forward(jnp.asarray(x[:, :6]), jp, jdims, chunk=4,
                                      return_state=True)
        first = 6
    for t in range(first, first + 8):
        given = {k: v.clone() for k, v in state.items()}
        out, new = ssm.ssm_decode_step(torch.from_numpy(x[:, t:t + 1]), state, params, dims)
        jout, jstate = j_ssm.ssm_decode_step(jnp.asarray(x[:, t:t + 1]), jstate, jp, jdims)
        _close(out, jout)
        for k in new:
            assert str(new[k].dtype).split(".")[-1] == str(jstate[k].dtype), k
            _close(new[k], jstate[k])
        # The given state is left as it was (a functional update).
        assert all(torch.equal(given[k], state[k]) for k in state)
        state = new


def test_forward_equals_token_by_token_decode():
    """The chunked forward equals the recurrent decode (the reference's own
    oracle, ``tests/test_ssm.py``), on the port alone."""
    _, _, dims, params = _layer(seed=5)
    x = torch.from_numpy((0.5 * _rng(6).standard_normal((2, 12, 32))).astype(np.float32))
    full = ssm.ssm_forward(x, params, dims, chunk=4)
    state = ssm.init_decode_state(2, dims, device="cpu")
    outs = []
    for t in range(12):
        y, state = ssm.ssm_decode_step(x[:, t:t + 1], state, params, dims)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=1e-4)


def test_softplus_matches_jax_across_torch_threshold():
    """torch's softplus returns its input past 20; jax.nn.softplus has no
    threshold. The difference, log1p(exp(-x)) < 2.1e-9 there, is under half
    an fp32 ulp of x, so the fp32 results agree to an ulp everywhere."""
    x = np.linspace(-40.0, 90.0, 20001, dtype=np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-30)
    past = x > 20
    np.testing.assert_array_equal(got[past], want[past])
