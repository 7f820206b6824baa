"""The port's KV-blocked online-softmax attention against the JAX package's
``flash_attention``, and the models that run it with a small
``ShardCtx.flash_block_k``.

``layers.attention`` scans K/V in blocks of ``block_k`` for more than one
query, as the reference's ``flash_attention`` does, so the fp32 scores of
one block exist at a time. Held to the reference on the same numpy inputs,
fp32, the reference jitted:

* ``attention`` and ``attention_block``, forward and the gradients of a
  random projection of the output with respect to every input, max abs
  1e-5 of the largest magnitude of each: a block below the sequence that
  does not divide it (padded keys masked through ``kv_len``), a window
  that reaches past a whole block (rows whose leading blocks are all
  masked), softcap, GQA, a ``kv_len`` cut, the 'hd' head layout, the
  non-causal cross-attention over an encoder output, and queries at an
  offset against a cache;
* the blocked path against the port's direct softmax (one query's path)
  at ``block_k >= S``, max abs 1e-6 of the output's max;
* ``forward`` and ``prefill`` of the reduced muonbp-960m, hymba-1.5b (its
  window cut to 20 tokens, past a block of 16) and whisper-small with
  ``ShardCtx(flash_block_k=16)`` against the reference's with the same
  field: logits max abs 1e-5, the prefill cache (K/V and SSM state) max
  abs 1e-6; the loss gradients of the reduced muonbp-960m, max abs 1e-5 of
  the leaf's max|grad|.

The tolerances are fp32 reorderings: both sides sum the same terms in
other orders, a few ulps of each reduction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.models import layers as j_layers
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill as j_prefill
from repro.models.transformer import ShardCtx as JShardCtx
from repro.models.transformer import forward as j_forward
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.model import forward, prefill
from repro_torch.sharding.specs import ShardCtx
from repro_torch.training.train_step import loss_and_grads

TOL = 1e-5           # max abs over the largest magnitude, forward and gradients
DIRECT_TOL = 1e-6    # blocked path at block_k >= S against the direct softmax
CACHE_TOL = 1e-6     # the prefill cache, max abs
BLOCK = 16           # the models' flash_block_k
SEQ = 40             # 2.5 blocks of 16
B = 2


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# name: (Sq, Skv, Hq, Hkv, hd, keyword arguments of both, q_offset)
ATTN_CASES = {
    "block_below_seq_padded": (13, 13, 4, 2, 8, dict(block_k=4), 0),
    "window_past_a_block": (20, 20, 4, 2, 8, dict(block_k=4, window=6), 0),
    "softcap": (11, 11, 4, 4, 8, dict(block_k=3, attn_softcap=2.0), 0),
    "gqa_kv_len_cut": (12, 12, 6, 2, 8, dict(block_k=5, kv_len=9), 0),
    "window_softcap_gqa": (17, 17, 8, 2, 4, dict(block_k=4, window=5, attn_softcap=3.0), 0),
    "non_causal": (9, 14, 4, 2, 8, dict(block_k=4, causal=False), 0),
    "offset_against_cache": (6, 16, 4, 2, 8, dict(block_k=4, kv_len=11), 5),
}


def _attn_inputs(case):
    sq, skv, hq, hkv, hd, _, _ = ATTN_CASES[case]
    seed = sum(map(ord, case))
    return (_rand((B, sq, hq, hd), seed), _rand((B, skv, hkv, hd), seed + 1),
            _rand((B, skv, hkv, hd), seed + 2), _rand((B, sq, hq, hd), seed + 3))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference_flash_attention(case):
    """Forward and the gradients of <out, w> with respect to q, k and v."""
    _, _, _, _, _, kw, q_offset = ATTN_CASES[case]
    q, k, v, w = _attn_inputs(case)

    def j_fn(q, k, v):
        out = j_layers.flash_attention(q, k, v, q_offset=q_offset, **kw)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.jit(jax.value_and_grad(j_fn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = layers.attention(*t, q_offset=q_offset, **kw)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert _rel_err(out, j_out) <= TOL, case
    for name, got, want in zip("qkv", t, j_grads):
        assert _rel_err(got.grad, want) <= TOL, (case, name)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blocked_path_equals_the_direct_softmax_in_one_block(case):
    """At block_k >= S the online softmax runs one block: the port's direct
    softmax (its one-query path) on the same inputs."""
    _, skv, _, _, _, kw, q_offset = ATTN_CASES[case]
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(case))
    kw = {key: val for key, val in kw.items() if key != "block_k"}
    direct = layers._direct_attention(q, k, v, q_offset=q_offset, **kw)
    for block_k in (skv, 2 * skv):
        out = layers.attention(q, k, v, q_offset=q_offset, block_k=block_k, **kw)
        assert _rel_err(out, direct.numpy()) <= DIRECT_TOL, (case, block_k)


def test_one_query_runs_the_direct_softmax():
    """Sq == 1 takes the direct path whatever the block: per-row positions
    and KV lengths (the serving engine's slots), bitwise."""
    q, k, v = (torch.from_numpy(_rand(s, i)) for i, s in
               enumerate([(3, 1, 4, 8), (3, 12, 2, 8), (3, 12, 2, 8)]))
    pos, kv_len = torch.tensor([2, 7, 11]), torch.tensor([3, 8, 12])
    out = layers.attention(q, k, v, q_offset=pos, kv_len=kv_len, block_k=4)
    assert torch.equal(out, layers._direct_attention(q, k, v, q_offset=pos, kv_len=kv_len))


# attention_block cases: name -> (keyword arguments of both, the port's ctx layouts)
BLOCK_CASES = {
    "hd_layout": dict(q_layout="hd", kv_layout="hd", window=7),
    "cross_attention": dict(cross=True),
    "cache_at_offset": dict(cache=True),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_attention_block_matches_reference(case):
    """The sub-block with block_k=4: Q and K/V in 'hd' under a window; the
    non-causal cross-attention over an 11-frame encoder output; six queries
    at position 5 written into a 16-slot cache and attending over it."""
    spec = dict(BLOCK_CASES[case])
    cross, cache = spec.pop("cross", False), spec.pop("cache", False)
    q_layout, kv_layout = spec.pop("q_layout", "head"), spec.pop("kv_layout", "head")
    d, hq, hkv, hd, sq, block_k = 32, 4, 2, 8, 10, 4
    seed = sum(map(ord, case))
    x, enc = _rand((B, sq, d), seed), _rand((B, 11, d), seed + 1)
    p = {"wq": _rand((d, hq * hd), seed + 2, 0.2), "wk": _rand((d, hkv * hd), seed + 3, 0.2),
         "wv": _rand((d, hkv * hd), seed + 4, 0.2), "wo": _rand((hq * hd, d), seed + 5, 0.2)}
    ck, cv = _rand((B, 16, hkv, hd), seed + 6), _rand((B, 16, hkv, hd), seed + 7)
    w = _rand((B, sq, d), seed + 8)
    inv = layers.rope_frequencies(hd)
    start = 5 if cache else 0
    positions = np.arange(start, start + sq)
    common = dict(num_heads=hq, num_kv_heads=hkv, head_dim=hd, **spec)

    def j_fn(x, p, enc):
        out, new = j_layers.attention_block(
            x, p, positions=jnp.asarray(positions), inv_freq=jnp.asarray(inv.numpy()),
            cross_kv=enc if cross else None, block_k=block_k, q_layout=q_layout,
            kv_layout=kv_layout, kv_cache=(jnp.asarray(ck), jnp.asarray(cv)) if cache else None,
            cache_index=start if cache else None, **common)
        return jnp.sum(out * w), (out, new)

    (_, (j_out, j_new)), j_grads = jax.jit(jax.value_and_grad(
        j_fn, argnums=(0, 1, 2), has_aux=True))(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                                jnp.asarray(enc))
    tx, tenc = (torch.from_numpy(a).requires_grad_() for a in (x, enc))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in p.items()}
    kv_cache = layers.DenseKV(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    out, new = layers.attention_block(
        tx, tp, positions=torch.from_numpy(positions), inv_freq=inv,
        cross_kv=tenc if cross else None, kv_cache=kv_cache if cache else None,
        cache_index=start if cache else None, block_k=block_k,
        ctx=ShardCtx(q_layout=q_layout, kv_layout=kv_layout), **common)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert _rel_err(out, j_out) <= TOL, case
    for got, want in zip(new, j_new):
        assert _rel_err(got, want) <= TOL, case
    assert _rel_err(tx.grad, j_grads[0]) <= TOL, case
    for k in p:
        assert _rel_err(tp[k].grad, j_grads[1][k]) <= TOL, (case, k)
    if cross:
        assert _rel_err(tenc.grad, j_grads[2]) <= TOL, case


# ---------------------------------------------------------------------------
# The models with flash_block_k = 16
# ---------------------------------------------------------------------------

# name: (arch, overrides of its reduced config)
MODELS = {
    "muonbp-960m": ("muonbp-960m", {}),
    "hymba-1.5b": ("hymba-1.5b", dict(window_size=20)),
    "whisper-small": ("whisper-small", {}),
}


def _cfgs(name):
    arch, over = MODELS[name]
    return (dataclasses.replace(j_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


_MODELS: dict = {}


def _models(name):
    if name not in _MODELS:
        jcfg, cfg = _cfgs(name)
        jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
        params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        rng = np.random.default_rng(7)
        tokens = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
        batch = {"tokens": tokens,
                 "labels": np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)], 1)}
        if cfg.arch_type == "audio":
            batch["audio_frames"] = _rand((B, cfg.encoder_seq, cfg.d_model), 8, 0.1)
        _MODELS[name] = (jcfg, jparams, cfg, params, batch)
    return _MODELS[name]


def _frames(batch):
    f = batch.get("audio_frames")
    return None if f is None else torch.from_numpy(f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_with_small_blocks_matches_reference(name):
    jcfg, jparams, cfg, params, batch = _models(name)
    frames = batch.get("audio_frames")
    j_logits, _ = jax.jit(lambda p: j_forward(
        p, jnp.asarray(batch["tokens"]), jcfg, ctx=JShardCtx(flash_block_k=BLOCK),
        encoder_frames=None if frames is None else jnp.asarray(frames)))(jparams)
    with torch.no_grad():
        logits = forward(params, torch.from_numpy(batch["tokens"]).long(), cfg,
                         ctx=ShardCtx(flash_block_k=BLOCK), encoder_frames=_frames(batch))
    assert float(np.abs(logits.numpy() - np.asarray(j_logits)).max()) <= TOL, name


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_with_small_blocks_matches_reference(name):
    jcfg, jparams, cfg, params, batch = _models(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    j_logits, _, j_cache = jax.jit(lambda p, b: j_prefill(
        p, b, jcfg, ctx=JShardCtx(flash_block_k=BLOCK)))(jparams, jb)
    tb = {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
          for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        logits, cache = prefill(params, tb, cfg, ctx=ShardCtx(flash_block_k=BLOCK))
    assert float(np.abs(logits.numpy() - np.asarray(j_logits)).max()) <= TOL, name
    assert set(cache) == set(j_cache), name
    if "kv" in cache:
        for got, want in zip(cache["kv"], j_cache["kv"]):
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= CACHE_TOL, name
    for k, v in cache.get("ssm", {}).items():
        assert float(np.abs(v.numpy() - np.asarray(j_cache["ssm"][k])).max()) <= CACHE_TOL, k


def test_loss_gradients_with_small_blocks_match_reference():
    """The reduced muonbp-960m's loss gradients through the blocked loop
    (each block's scores kept for the backward, the layer recomputed under
    its checkpoint) against jax.grad of the reference's."""
    jcfg, jparams, cfg, params, batch = _models("muonbp-960m")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jb, jcfg, ctx=JShardCtx(flash_block_k=BLOCK)),
        has_aux=True))(jparams)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, _, grads = loss_and_grads(params, tb, cfg, torch.float32,
                                    ctx=ShardCtx(flash_block_k=BLOCK))
    assert abs(float(loss) - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    got = dict(tree_lib.flatten_with_path(interop.params_to_numpy(grads)))
    for k, want in tree_lib.flatten_with_path(jax.tree.map(np.asarray, j_grads)):
        assert _rel_err(got[k], want) <= TOL, k
