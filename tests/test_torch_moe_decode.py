"""Prefill, decode, generate and mixtral's ring cache of the port's MoE
models against the JAX package (reduced ``olmoe-1b-7b`` and
``mixtral-8x7b``): dropless decode against the forward, decode and generate
with the reference's batch-wide drops.

The setup, the reference's jitted calls and the tolerances are
``tests/test_torch_moe_model.py``'s: fp32 logits to 1e-4 absolute, greedy
tokens exactly; decode equals the forward only on a dropless config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.models.model import init_cache as j_init_cache
from repro.models.model import prefill as j_prefill
from repro.serving.serve_step import generate as j_generate
from repro_torch.models.model import decode_step, forward, init_cache, prefill
from repro_torch.serving.serve_step import cache_from_prefill, generate

from test_torch_moe_model import (
    ARCHS,
    B,
    S,
    _close,
    _dropless,
    _j_decode,
    _models,
    _t,
    _tokens,
)


# ---------------------------------------------------------------------------
# Prefill, decode, generate, the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_matches_forward_dropless(name):
    """prefill(prompt) -> decode continuation equals teacher forcing, and the
    prefill's logits and cache equal the reference's."""
    jcfg, jparams, cfg, params = _models(name, **_dropless(name))
    tokens = _tokens(cfg, seed=2)
    half = S // 2
    full = forward(params, _t(tokens), cfg).detach().numpy()
    jl, _, jc = jax.jit(lambda p, b: j_prefill(p, b, jcfg))(
        jparams, {"tokens": jnp.asarray(tokens[:, :half])})
    with torch.no_grad():
        logits, pcache = prefill(params, {"tokens": _t(tokens[:, :half])}, cfg)
        _close(logits, jl)
        _close(pcache["kv"][0], jc["kv"][0])
        cache = cache_from_prefill(pcache, cfg, S, dtype=torch.float32)
        for t in range(half, S):
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg)
            _close(lg, full[:, t:t + 1])


@pytest.mark.parametrize("name", ARCHS)
def test_incremental_decode_matches_reference_with_drops(name):
    """Token-by-token decode of a batch of two at the default capacity, where
    the batch-wide routing of each step can drop: every step's logits and
    the final cache against the reference's decode_step."""
    jcfg, jparams, cfg, params = _models(name)
    tokens = _tokens(cfg, seed=3)
    jcache = j_init_cache(jcfg, B, S, dtype=jnp.float32)
    cache = init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    j_step = _j_decode(jcfg)
    with torch.no_grad():
        for t in range(S):
            jl, jcache = j_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg)
            _close(lg, jl)
    _close(cache["kv"][0], jcache["kv"][0])


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_generate_matches_reference_with_batch_wide_drops(name, capacity_factor):
    """generate at B = 2 routes each decode step's batch as one group, as the
    reference does: at capacity factor 0.5 a decode step's capacity is one
    token an expert, so two rows sharing an expert drop one."""
    jcfg, jparams, cfg, params = _models(name, capacity_factor=capacity_factor)
    tokens = _tokens(cfg, seed=4, shape=(B, 8))
    expect = np.asarray(j_generate(jparams, jnp.asarray(tokens), jcfg, max_new_tokens=8))
    got = generate(params, _t(tokens), cfg, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_ring_cache_matches_reference_and_forward():
    """mixtral's ring cache (window 6, 20 tokens, so it wraps three times):
    each step's logits against the reference's ring decode and against the
    forward (``tests/test_perf_features.py:24``), dropless."""
    jcfg, jparams, cfg, params = _models("mixtral-8x7b", capacity_factor=100.0, window_size=6)
    tokens = _tokens(cfg, seed=5, shape=(1, 20))
    full = forward(params, _t(tokens), cfg).detach().numpy()
    jcache = j_init_cache(jcfg, 1, cfg.window_size, dtype=jnp.float32)
    cache = init_cache(cfg, 1, cfg.window_size, dtype=torch.float32, device="cpu")
    j_step = _j_decode(jcfg, ring_cache=True)
    with torch.no_grad():
        for t in range(20):
            jl, jcache = j_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg,
                                    ring_cache=True)
            _close(lg, jl)
            _close(lg, full[:, t:t + 1])
    assert cache["kv"][0].shape[2] == cfg.window_size
    _close(cache["kv"][0], jcache["kv"][0])
    # Per-row positions on the ring: row 0 runs on to position 19 over a
    # full ring, row 1 stops at position 3 (a fill of 4), rewriting it.
    two = init_cache(cfg, 2, cfg.window_size, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(20):
            rows = [t, min(t, 3)]
            lg, _ = decode_step(params, _t(tokens[0, rows])[:, None], two, torch.tensor(rows),
                                cfg, ring_cache=True)
    _close(lg[0], full[0, 19:20])
    _close(lg[1], full[0, 3:4])
