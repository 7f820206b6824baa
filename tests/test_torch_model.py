"""Configs, weights, layers and the dense model of the port against the JAX package.

Both packages start from the reference's own initial parameters, carried
over with ``repro_torch.interop``, and see the same numpy token batches.
Tolerances, each with its reason:

* layers and the model in fp32 compute: rtol 1e-4 / atol 1e-5. The two
  frameworks sum in other orders (both attentions are online softmaxes
  over KV blocks, here of other sizes), which costs a few fp32 ulps per
  reduction of ~256 terms;
* the model in bf16 compute: logits atol 0.1 on values of O(1) and loss
  atol 2e-2. bf16 keeps 8 bits of mantissa (a relative 4e-3 a rounding),
  and the two frameworks round the activations at other places.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as j_layers
from repro.models.model import cross_entropy as j_cross_entropy
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHS, PAPER_CONFIGS, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import layers
from repro_torch.models.model import cross_entropy, forward, init_params, loss_fn

RTOL, ATOL = 1e-4, 1e-5


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(out, expect, rtol=RTOL, atol=ATOL):
    out = out.detach().to(torch.float32).numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(np.asarray(out), np.asarray(expect, dtype=np.float32),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Configs, weights, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAPER_CONFIGS) + sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(name, reduced):
    port, ref = get_config(name), j_get_config(name)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    ref_fields = dataclasses.asdict(ref)
    for key, value in dataclasses.asdict(port).items():
        assert ref_fields[key] == value, key
    assert (port.padded_vocab, port.q_dim, port.kv_dim) == (ref.padded_vocab, ref.q_dim, ref.kv_dim)


def test_full_width_muonbp_960m_is_the_papers():
    cfg = get_config("muonbp-960m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (12, 1536, 16, 4, 96, 6144, 128256)
    with pytest.raises(KeyError):
        get_config("muonbp-961m")


def test_init_params_paths_shapes_and_law_match_reference():
    cfg = get_config("muonbp-960m").reduced()
    ref = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), j_get_config("muonbp-960m").reduced()))
    port = init_params(cfg, seed=3, device="cpu")
    ref_shapes = {p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(ref)}
    assert {p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(port)} == ref_shapes
    assert float(port["layers"]["attn"]["wq"].std()) == pytest.approx(0.02, rel=0.05)
    assert bool((port["layers"]["norms"]["attn_norm"] == 1).all())
    again = init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_lib.leaves(port), tree_lib.leaves(again)))


def test_interop_round_trip_is_exact_and_copies():
    tree = {"a": {"b": _rand((3, 4), 0)}, "c": np.arange(5, dtype=np.int32)}
    port = interop.params_from_numpy(tree, device="cpu")
    assert port["a"]["b"].dtype == torch.float32 and port["c"].dtype == torch.int32
    back = interop.params_to_numpy(port)
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["c"], tree["c"])
    port["a"]["b"].zero_()
    assert tree["a"]["b"].any()
    bf16 = {"w": port["c"].to(torch.bfloat16)}
    assert interop.params_to_numpy(bf16)["w"].dtype == np.float32


def test_synthetic_lm_matches_reference():
    cfg = get_config("muonbp-960m").reduced()
    port, ref = iter(SyntheticLM(cfg, 3, 16, seed=4)), iter(JSyntheticLM(cfg, 3, 16, seed=4))
    for _ in range(3):
        p, r = next(port), next(ref)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(p[key], r[key])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_softcap_and_mlps_match_reference():
    x, w = _rand((2, 5, 32), 1), _rand((32,), 2)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           j_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(layers.softcap(torch.from_numpy(x), 3.0), j_layers.softcap(jnp.asarray(x), 3.0))
    inv = layers.rope_frequencies(16, 500.0)
    _close(inv, j_layers.rope_frequencies(16, 500.0))
    q = _rand((2, 5, 3, 16), 3)
    pos = np.array([0, 1, 2, 7, 9])
    _close(layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), inv),
           j_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos), jnp.asarray(inv.numpy())))
    wi, wg, wo = _rand((32, 48), 4, 0.1), _rand((32, 48), 5, 0.1), _rand((48, 32), 6, 0.1)
    t = [torch.from_numpy(a) for a in (x, wi, wg, wo)]
    j = [jnp.asarray(a) for a in (x, wi, wg, wo)]
    _close(layers.swiglu(*t), j_layers.swiglu(*j))
    _close(layers.geglu(*t), j_layers.geglu(*j))


@pytest.mark.parametrize("window,softcap,kv_len", [
    (None, None, None), (4, None, None), (None, 5.0, None), (None, None, 9), (3, 2.0, 11),
])
def test_gqa_attention_matches_reference_flash_attention(window, softcap, kv_len):
    q, k, v = _rand((2, 12, 4, 8), 7), _rand((2, 12, 2, 8), 8), _rand((2, 12, 2, 8), 9)
    out = layers.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           window=window, attn_softcap=softcap, kv_len=kv_len)
    # block_k=5 runs the reference's online softmax over several padded blocks.
    expect = j_layers.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=window, attn_softcap=softcap, kv_len=kv_len,
                                      block_k=5)
    _close(out, expect)


def test_attention_block_matches_reference():
    d, hq, hkv, hd = 32, 4, 2, 8
    x = _rand((2, 6, d), 10)
    p = {"wq": _rand((d, hq * hd), 11, 0.2), "wk": _rand((d, hkv * hd), 12, 0.2),
         "wv": _rand((d, hkv * hd), 13, 0.2), "wo": _rand((hq * hd, d), 14, 0.2)}
    inv = layers.rope_frequencies(hd)
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=hd)
    out, (k, v) = layers.attention_block(
        torch.from_numpy(x), interop.params_from_numpy(p, device="cpu"),
        positions=torch.arange(6), inv_freq=inv, window=4, **kw)
    expect, (jk, jv) = j_layers.attention_block(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                                positions=jnp.arange(6),
                                                inv_freq=jnp.asarray(inv.numpy()), window=4, **kw)
    _close(out, expect)
    _close(k, jk)  # the post-RoPE K/V, what prefill caches
    _close(v, jv)


def test_cross_entropy_ignores_label_minus_one():
    logits = _rand((2, 5, 11), 15)
    labels = np.array([[1, 2, -1, 4, 0], [-1, -1, 3, 10, 7]], np.int32)
    out = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long())
    _close(out, j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# The reduced muonbp-960m: logits, loss and gradients
# ---------------------------------------------------------------------------

def _model_inputs(seq=16):
    jcfg = j_get_config("muonbp-960m").reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    batch = next(iter(SyntheticLM(get_config("muonbp-960m").reduced(), 2, seq, seed=5)))
    batch["labels"][0, -3:] = -1  # some ignored positions
    return jcfg, params, batch


def _port_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_forward_loss_and_grads_match_reference_fp32():
    jcfg, params, batch = _model_inputs()
    cfg = get_config("muonbp-960m").reduced()
    p = interop.params_from_numpy(params, device="cpu")
    logits = forward(p, torch.from_numpy(batch["tokens"]).long(), cfg)
    j_logits, _ = j_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(batch["tokens"]), jcfg)
    _close(logits, j_logits)

    leaves = [(k, v.requires_grad_(True)) for k, v in tree_lib.flatten_with_path(p)]
    loss, metrics = loss_fn(tree_lib.unflatten(leaves), _port_batch(batch), cfg)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    (j_loss, j_metrics), j_grads = jax.value_and_grad(
        lambda q: j_loss_fn(q, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    _close(loss, j_loss)
    _close(metrics["ce"], j_metrics["ce"])
    j_flat = dict(tree_lib.flatten_with_path(j_grads))
    for (path, _), g in zip(leaves, grads):
        _close(g, j_flat[path])


def test_loss_matches_reference_bf16_compute():
    from repro.training.train_step import cast_tree as j_cast_tree
    from repro_torch.training.train_step import cast_tree

    jcfg, params, batch = _model_inputs()
    cfg = get_config("muonbp-960m").reduced()
    p = cast_tree(interop.params_from_numpy(params, device="cpu"), torch.bfloat16)
    logits = forward(p, torch.from_numpy(batch["tokens"]).long(), cfg)
    assert logits.dtype == torch.bfloat16
    jp = j_cast_tree(jax.tree.map(jnp.asarray, params), jnp.bfloat16)
    j_logits, _ = j_forward(jp, jnp.asarray(batch["tokens"]), jcfg)
    _close(logits, np.asarray(j_logits, dtype=np.float32), rtol=0, atol=0.1)
    loss, _ = loss_fn(p, _port_batch(batch), cfg)
    j_loss, _ = j_loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    assert abs(float(loss) - float(j_loss)) <= 2e-2
