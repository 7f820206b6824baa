"""Prefill, decode, generate and hymba's ring cache of the port's SSM,
hybrid, VLM and audio architectures against the JAX package (reduced
``mamba2-1.3b``, ``hymba-1.5b``, ``internvl2-1b``, ``whisper-small``).

The setup, the reference's jitted calls and the tolerances are
``tests/test_torch_archs.py``'s: fp32 logits and decode states to 1e-4
absolute, greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.models.model import init_cache as j_init_cache
from repro.serving.serve_step import cache_from_prefill as j_cache_from_prefill
from repro.serving.serve_step import generate as j_generate
from repro_torch import tree as tree_lib
from repro_torch.models.model import decode_step, forward, init_cache, prefill
from repro_torch.serving.serve_step import cache_from_prefill, generate

from test_torch_archs import (
    ARCHS,
    B,
    S,
    _batch,
    _close,
    _dtype_name,
    _encoder_out,
    _j,
    _j_decode,
    _j_prefill,
    _kw,
    _models,
    _t,
    _tokens,
)


# ---------------------------------------------------------------------------
# Prefill, decode, generate, the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_matches_reference_and_forward(name):
    """prefill(prompt) then decode on an fp32 cache: every step's logits
    against the reference's and against the forward over the whole
    sequence (teacher forcing), and the final cache against the
    reference's."""
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(cfg, seed=2)
    tokens, half, V = batch["tokens"], S // 2, cfg.vision_tokens
    full = forward(params, _t(tokens), cfg, **_kw(cfg, batch)).detach().numpy()
    pre = {**batch, "tokens": tokens[:, :half]}
    jl, _, jc = _j_prefill(jcfg)(jparams, _j(pre))
    jcache = j_init_cache(jcfg, B, V + S, dtype=jnp.float32)
    jcache.update(j_cache_from_prefill(jc, jcfg, V + S, dtype=jnp.float32))
    enc, jenc = _encoder_out(params, jparams, cfg, jcfg, batch)
    j_step = _j_decode(jcfg, encoder_out=jenc)
    with torch.no_grad():
        logits, pcache = prefill(params, {k: _t(v) for k, v in pre.items()}, cfg)
        _close(logits, jl)
        cache = cache_from_prefill(pcache, cfg, V + S, dtype=torch.float32)
        other = cache_from_prefill(pcache, cfg, V + S, dtype=torch.float32)
        steps = []
        for t in range(half, S):
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, V + t, cfg,
                                    encoder_out=enc)
            jlg, jcache = j_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                 jnp.int32(V + t))
            _close(lg, jlg)
            _close(lg, full[:, V + t:V + t + 1])
            steps.append(lg)
        # A second cache from the same prefill decodes apart from the first.
        lg, _ = decode_step(params, _t(tokens[:, half:half + 1]), other, V + half, cfg,
                            encoder_out=enc)
        assert torch.equal(lg, steps[0])
    if "kv" in cache:
        _close(cache["kv"][0], jcache["kv"][0])
    for k, v in cache.get("ssm", {}).items():
        assert _dtype_name(v) == str(jcache["ssm"][k].dtype), k
        _close(v, jcache["ssm"][k])


@pytest.mark.parametrize("name", ARCHS)
def test_decode_from_init_cache_matches_reference(name):
    """Token by token from init_cache's bf16 buffers: each step's logits and
    the state's dtypes after it against the reference's decode_step (the
    bf16 conv windows become fp32 at the first step of an fp32 model)."""
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(cfg, seed=3)
    tokens = batch["tokens"]
    jcache = j_init_cache(jcfg, B, S)
    cache = init_cache(cfg, B, S, device="cpu")
    assert set(cache) == set(jcache)
    for path, want in tree_lib.flatten_with_path(jax.tree.map(np.asarray, {
            k: dict(enumerate(v)) if isinstance(v, tuple) else v for k, v in jcache.items()})):
        got = cache[path[0]][int(path[1])] if path[0] == "kv" else cache[path[0]][path[1]]
        assert tuple(got.shape) == want.shape and _dtype_name(got) == str(want.dtype), path
        assert not got.any()
    enc, jenc = _encoder_out(params, jparams, cfg, jcfg, batch)
    j_step = _j_decode(jcfg, encoder_out=jenc)
    with torch.no_grad():
        for t in range(S):
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg,
                                    encoder_out=enc)
            jlg, jcache = j_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
            _close(lg, jlg)
            for k, v in cache.get("ssm", {}).items():
                assert _dtype_name(v) == str(jcache["ssm"][k].dtype), (t, k)
            if "kv" in cache:
                assert _dtype_name(cache["kv"][0]) == str(jcache["kv"][0].dtype)
    for k, v in cache.get("ssm", {}).items():
        _close(v, jcache["ssm"][k])


@pytest.mark.parametrize("name", ARCHS)
def test_generate_tokens_match_reference(name):
    """Greedy generate (a VLM's decode from P + vision_tokens, whisper's
    audio encoded once) equals the reference's token for token."""
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(cfg, seed=4, shape=(B, 8))
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    max_len = 8 + cfg.vision_tokens + 8
    expect = np.asarray(j_generate(jparams, jnp.asarray(batch["tokens"]), jcfg,
                                   max_new_tokens=8, max_len=max_len,
                                   batch_extras=_j(extras) or None))
    got = generate(params, _t(batch["tokens"]), cfg, max_new_tokens=8, max_len=max_len,
                   batch_extras={k: _t(v) for k, v in extras.items()} or None)
    np.testing.assert_array_equal(got.numpy(), expect)
    if cfg.vision_tokens:
        # As in the reference, max_len must hold the vision tokens too.
        with pytest.raises(ValueError, match="max_len"):
            generate(params, _t(batch["tokens"]), cfg, max_new_tokens=8,
                     batch_extras={k: _t(v) for k, v in extras.items()})
    if cfg.arch_type == "audio":
        with pytest.raises(ValueError, match="encoder"):
            decode_step(params, _t(batch["tokens"][:, :1]), init_cache(cfg, B, 8, device="cpu"),
                        0, cfg)


def test_hymba_ring_cache_matches_reference_and_forward():
    """hymba's ring cache (window 6, 20 tokens, so it wraps three times):
    each step's logits against the reference's ring decode and against the
    forward, and the SSM state beside it against the reference's."""
    jcfg, jparams, cfg, params = _models("hymba-1.5b", window_size=6)
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
    _close(cache["ssm"]["h"], jcache["ssm"]["h"])
