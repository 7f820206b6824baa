"""Prefill, KV-cache decode and generate of the port against the JAX package.

The five dense configs (the four of the reference registry and the paper's
``muonbp-960m``), reduced as ``conftest.tiny_cfg`` reduces them, plus
``gemma2-9b`` with ``window_size=4`` so that its even layers mask inside a
16-token sequence, at offset query positions in decode. Both packages start
from the reference's parameters, carried over by ``repro_torch.interop``,
and see the same numpy tokens.

Tolerance, fp32 throughout: 1e-4 absolute on logits of O(1) (the
reference's own bound in ``tests/test_decode_consistency.py``). The two
frameworks sum in other orders (the reference's prefill runs an online
softmax over KV blocks, the port a full softmax), a few fp32 ulps a
reduction. Greedy tokens are compared exactly: the reduced models' top-2
logit gaps are far above that rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.models.model import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.serving.serve_step import cache_from_prefill as j_cache_from_prefill
from repro.serving.serve_step import generate as j_generate
from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.model import decode_step, forward, init_cache, init_params, prefill
from repro_torch.serving import ServingEngine
from repro_torch.serving.serve_step import cache_from_prefill, generate, serve_step

TOL = 1e-4
# The dense configs; the MoE ones are held to the reference in
# tests/test_torch_moe_model.py (decode equals the forward there only when
# routing drops nothing).
CASES = sorted(n for n, c in ARCHS.items() if c.arch_type == "dense") + [
    "muonbp-960m", "gemma2-9b/window4"]
B, S = 2, 16


def _models(case):
    """(reference cfg, reference params, port cfg, port params on the CPU)."""
    name, _, variant = case.partition("/")
    over = {"window_size": 4} if variant == "window4" else {}
    jcfg = tiny_cfg(name, **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(out.detach().to(torch.float32).numpy(),
                               np.asarray(expect, dtype=np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("case", CASES)
def test_forward_and_prefill_cache_match_reference(case):
    jcfg, jparams, cfg, params = _models(case)
    tokens = _tokens(cfg)
    j_logits, _ = j_forward(jparams, jnp.asarray(tokens), jcfg)
    _close(forward(params, _t(tokens), cfg), j_logits)
    jl, _, jc = j_prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": _t(tokens)}, cfg)
    _close(logits, jl)
    k, v = cache["kv"]
    assert k.shape == (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim)
    _close(k, jc["kv"][0])
    _close(v, jc["kv"][1])
    # The padded decode buffer: bf16 by default, the prompt first, zeros after.
    buf_k, _ = cache_from_prefill(cache, cfg, S + 5)["kv"]
    j_buf_k, _ = j_cache_from_prefill(jc, jcfg, S + 5)["kv"]
    assert buf_k.dtype == torch.bfloat16 and buf_k.shape[2] == S + 5
    np.testing.assert_array_equal(buf_k[:, :, S:].to(torch.float32).numpy(), 0.0)
    _close(buf_k, np.asarray(j_buf_k.astype(jnp.float32)), tol=2e-2)  # one bf16 rounding


@pytest.mark.parametrize("case", CASES)
def test_incremental_decode_matches_reference_and_forward(case):
    """Token-by-token decode from an empty fp32 cache: each step's logits
    against the reference's decode_step and against the port's forward."""
    jcfg, jparams, cfg, params = _models(case)
    tokens = _tokens(cfg, seed=1)
    full = forward(params, _t(tokens), cfg)
    jcache = j_init_cache(jcfg, B, S, dtype=jnp.float32)
    cache = init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(S):
            jl, jcache = j_decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                       jnp.int32(t), jcfg)
            logits, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg)
            assert logits.shape == (B, 1, cfg.padded_vocab)
            _close(logits, jl)
            _close(logits, full[:, t:t + 1].detach().numpy())
    _close(cache["kv"][0], jcache["kv"][0])


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_forward(case):
    """prefill(prompt) -> decode continuation equals teacher forcing."""
    jcfg, jparams, cfg, params = _models(case)
    tokens = _tokens(cfg, seed=2)
    half = S // 2
    full = forward(params, _t(tokens), cfg).detach().numpy()
    with torch.no_grad():
        _, pcache = prefill(params, {"tokens": _t(tokens[:, :half])}, cfg)
        cache = cache_from_prefill(pcache, cfg, S, dtype=torch.float32)
        for t in range(half, S):
            logits, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg)
            _close(logits, full[:, t:t + 1])


@pytest.mark.parametrize("case", CASES)
def test_generate_tokens_match_reference(case):
    jcfg, jparams, cfg, params = _models(case)
    tokens = _tokens(cfg, seed=3, shape=(B, 8))
    expect = np.asarray(j_generate(jparams, jnp.asarray(tokens), jcfg, max_new_tokens=8))
    got = generate(params, _t(tokens), cfg, max_new_tokens=8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), expect)
    # A longer buffer than needed changes nothing but the masked tail.
    np.testing.assert_array_equal(
        generate(params, _t(tokens), cfg, max_new_tokens=8, max_len=40).numpy(), expect)


@pytest.mark.parametrize("case", ["granite-8b", "gemma2-9b/window4"])
def test_decode_at_per_row_positions_matches_forward(case):
    """One batched decode, each row at its own position, against the forward
    at those positions and against a decode of each row alone: the cache
    holds the whole sequence, so only q_offset and kv_len keep each row
    from seeing its future."""
    _, _, cfg, params = _models(case)
    tokens = _tokens(cfg, seed=4, shape=(3, S))
    pos = torch.tensor([5, 13, 2])
    full = forward(params, _t(tokens), cfg).detach()
    with torch.no_grad():
        _, pcache = prefill(params, {"tokens": _t(tokens)}, cfg)
        cache = cache_from_prefill(pcache, cfg, S, dtype=torch.float32)
        step_tokens = _t(tokens)[torch.arange(3), pos][:, None]
        logits, _ = decode_step(params, step_tokens, cache, pos, cfg)
        for r in range(3):
            p = int(pos[r])
            _close(logits[r, 0], full[r, p].numpy())
            one = cache_from_prefill(
                {"kv": tuple(t[:, r:r + 1] for t in pcache["kv"])}, cfg, S, dtype=torch.float32)
            alone, _ = decode_step(params, step_tokens[r:r + 1], one, p, cfg)
            _close(logits[r, 0], alone[0, 0].numpy(), tol=1e-5)


def test_window_masks_at_an_offset_query():
    """gemma2's local layers at window 4: a token more than 4 back changes
    the global layers' output only; with every layer local, nothing."""
    _, _, cfg, params = _models("gemma2-9b/window4")
    local = dataclasses.replace(cfg, attention_pattern="swa")
    tokens = _tokens(cfg, seed=5, shape=(1, 12))
    other = tokens.copy()
    other[0, 0] = (other[0, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        for c, changes in ((cfg, True), (local, False)):
            outs = []
            for tk in (tokens, other):
                _, pcache = prefill(params, {"tokens": _t(tk[:, :11])}, c)
                cache = cache_from_prefill(pcache, c, 12, dtype=torch.float32)
                outs.append(decode_step(params, _t(tk[:, 11:]), cache, 11, c)[0])
            diff = float((outs[0] - outs[1]).abs().max())
            assert (diff > 1e-3) if changes else (diff <= 1e-6), (c.attention_pattern, diff)


def test_init_cache_shapes_and_ring_cache_refusal():
    _, _, cfg, params = _models("granite-8b")
    cache = init_cache(cfg, 3, 10, device="cpu")
    for t in cache["kv"]:
        assert t.shape == (cfg.num_layers, 3, 10, cfg.num_kv_heads, cfg.head_dim)
        assert t.dtype == torch.bfloat16 and not t.any()
    tok = torch.zeros((3, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="ring_cache requires"):
        decode_step(params, tok, cache, 0, cfg, ring_cache=True)
    # A uniform sliding-window arch decodes on the ring (held to the
    # reference in tests/test_torch_moe_model.py).
    swa = dataclasses.replace(cfg, attention_pattern="swa")
    logits, ring = decode_step(params, tok, cache, 0, swa, ring_cache=True)
    assert logits.shape == (3, 1, cfg.padded_vocab) and ring is cache


def test_serve_step_samples_only_with_a_generator():
    _, _, cfg, params = _models("granite-8b")
    cache = init_cache(cfg, 1, 4, dtype=torch.float32, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="requires a generator"):
        serve_step(params, cache, tok, 0, cfg, temperature=0.7)
    nxt, logits, _ = serve_step(params, cache, tok, 0, cfg)
    assert nxt.shape == (1, 1) and int(nxt) == int(torch.argmax(logits[0, 0]))


def test_unported_archs_raise():
    """Every arch of the reference's registry is ported: an unknown name
    raises, as an unknown arch_type does, and the engine still serves only
    the dense and MoE archs, as the reference's."""
    with pytest.raises(KeyError, match="gemma2-9b"):
        get_config("mamba3-unknown")
    encoder = dataclasses.replace(get_config("granite-8b").reduced(), arch_type="encoder")
    with pytest.raises(NotImplementedError):
        init_params(encoder, device="cpu")
    _, _, cfg, params = _models("granite-8b")
    with pytest.raises(NotImplementedError, match="dense"):
        ServingEngine(params, dataclasses.replace(cfg, arch_type="ssm"))
