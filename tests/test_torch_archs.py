"""The port's SSM, hybrid, VLM and audio architectures against the JAX
package: reduced ``mamba2-1.3b`` (SSM), ``hymba-1.5b`` (attention and SSM in
one layer, sliding window), ``internvl2-1b`` (vision tokens ahead of the
text) and ``whisper-small`` (encoder-decoder, cross-attention, sinusoidal
positions).

Both packages start from the reference's parameters, carried over by
``repro_torch.interop``, and see the same numpy inputs. Tolerances, each
with its reason:

* fp32 compute: logits, losses and decode states to 1e-4 absolute. The
  frameworks sum in other orders (the reference's prefill runs an online
  softmax over KV blocks, its SSD einsums contract in XLA's order), a few
  fp32 ulps a reduction;
* bf16 compute: loss metrics to 2e-2 (bf16 keeps 8 mantissa bits, and the
  frameworks round activations at other places);
* greedy tokens, dtypes, label trees, block grids and bucket plans exactly;
* one MuonBP step: Muon-updated weights to 1e-5 (the update is O(lr)),
  AdamW's to 1e-4 (its first step is -lr g / (|g| + eps), so a rounding
  difference in a gradient entry near 0 moves a weight by up to lr).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import adamw as j_adamw
from repro.core import blocking as j_blocking
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import program as j_program
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.encdec import encode as j_encode
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.serving.serve_step import cache_from_prefill as j_cache_from_prefill
from repro.serving.serve_step import generate as j_generate
from repro.sharding import specs as j_specs
from repro.training import checkpoint as j_checkpoint
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import train_step as j_train_step
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, combine, label_tree, muon, program
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models.encdec import encode
from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.serve_step import cache_from_prefill, generate
from repro_torch.sharding import specs
from repro_torch.training import checkpoint
from repro_torch.training.train_step import init_train_state, train_step

TOL = 1e-4
ARCHS = ["mamba2-1.3b", "hymba-1.5b", "internvl2-1b", "whisper-small"]
B, S = 2, 16
LR, ADAM_LR, PERIOD, MODEL = 0.02, 0.008, 5, 4


def _models(name, **over):
    """(reference cfg, reference params, port cfg, port params on the CPU)."""
    jcfg = tiny_cfg(name, **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _extras(cfg, seed=0, bsz=B):
    """The arch's stub inputs, N(0, 0.1^2): vision embeddings or audio frames."""
    r = np.random.default_rng(seed + 50)
    if cfg.arch_type == "vlm":
        return {"vision_embeds": (0.1 * r.standard_normal(
            (bsz, cfg.vision_tokens, cfg.d_model))).astype(np.float32)}
    if cfg.arch_type == "audio":
        return {"audio_frames": (0.1 * r.standard_normal(
            (bsz, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}
    return {}


def _batch(cfg, seed=0, shape=(B, S)):
    tokens = _tokens(cfg, seed, shape)
    labels = np.concatenate([tokens[:, 1:], -np.ones((tokens.shape[0], 1), np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels, **_extras(cfg, seed, tokens.shape[0])}


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype.kind in "iu" else torch.from_numpy(a.copy())


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(out, expect, tol=TOL):
    out = out.detach().to(torch.float32).numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32),
                               np.asarray(jnp.asarray(expect).astype(jnp.float32)),
                               rtol=0, atol=tol)


def _kw(cfg, batch):
    """forward's keyword arguments for the batch's stub inputs."""
    return {"extra_embeds": _t(batch["vision_embeds"]) if "vision_embeds" in batch else None,
            "encoder_frames": _t(batch["audio_frames"]) if "audio_frames" in batch else None}


def _encoder_out(params, jparams, cfg, jcfg, batch):
    if cfg.arch_type != "audio":
        return None, None
    return (encode(params["encoder"], _t(batch["audio_frames"]), cfg),
            j_encode(jparams["encoder"], jnp.asarray(batch["audio_frames"]), jcfg))


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Parameters, forward, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_init_params_paths_shapes_and_law_match_reference(name):
    jcfg, _, cfg, _ = _models(name)
    ref = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    port = init_params(cfg, seed=1, device="cpu")
    assert ({p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(port)}
            == {p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(ref)})
    flat = {tree_lib.path_str(p): l for p, l in tree_lib.flatten_with_path(port)}
    assert all(l.dtype == torch.float32 for l in flat.values())
    assert float(flat["embed"].std()) == pytest.approx(0.02, rel=0.05)
    if "layers/ssm/A_log" in flat:
        np.testing.assert_allclose(flat["layers/ssm/A_log"][-1].numpy(),
                                   np.log(np.linspace(1.0, 16.0, cfg.d_model * 2
                                                      // cfg.ssm_head_dim)), rtol=1e-6)
        assert torch.equal(flat["layers/ssm/D"], torch.ones_like(flat["layers/ssm/D"]))
    if "layers/hybrid/attn_scale" in flat:
        assert torch.equal(flat["layers/hybrid/ssm_scale"],
                           torch.ones((cfg.num_layers, cfg.d_model)))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_prefill_cache_match_reference(name):
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(cfg)
    j_logits, _ = j_forward(jparams, jnp.asarray(batch["tokens"]), jcfg,
                            extra_embeds=(jnp.asarray(batch["vision_embeds"])
                                          if "vision_embeds" in batch else None),
                            encoder_frames=(jnp.asarray(batch["audio_frames"])
                                            if "audio_frames" in batch else None))
    logits = forward(params, _t(batch["tokens"]), cfg, **_kw(cfg, batch))
    assert logits.shape == (B, S + cfg.vision_tokens, cfg.padded_vocab)
    _close(logits, j_logits)
    jl, _, jc = j_prefill(jparams, _j(batch), jcfg)
    with torch.no_grad():
        pl, pc = prefill(params, {k: _t(v) for k, v in batch.items()}, cfg)
    _close(pl, jl)
    assert set(pc) == set(jc) == ({"ssm"} if cfg.arch_type == "ssm" else
                                  {"kv", "ssm"} if cfg.arch_type == "hybrid" else {"kv"})
    for path, want in tree_lib.flatten_with_path(jax.tree.map(np.asarray, {
            k: dict(enumerate(v)) if isinstance(v, tuple) else v for k, v in jc.items()})):
        got = pc[path[0]][int(path[1])] if path[0] == "kv" else pc[path[0]][path[1]]
        assert got.shape == want.shape and _dtype_name(got) == str(want.dtype), path
        _close(got, want)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_loss_fn_metrics_match_reference(name, dtype, tol):
    """The loss over the text positions only (a VLM's vision logits
    dropped), fp32 and bf16 parameters, fp32 stub inputs."""
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(cfg, seed=1)
    jp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    j_loss, j_metrics = j_loss_fn(jp, _j(batch), jcfg)
    p = tree_lib.tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    loss, metrics = loss_fn(p, {k: _t(v) for k, v in batch.items()}, cfg)
    assert set(metrics) == set(j_metrics) == {"ce", "loss"}
    for k in metrics:
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= tol, k
    assert float(loss) == float(metrics["loss"])


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
    jl, _, jc = j_prefill(jparams, _j(pre), jcfg)
    jcache = j_init_cache(jcfg, B, V + S, dtype=jnp.float32)
    jcache.update(j_cache_from_prefill(jc, jcfg, V + S, dtype=jnp.float32))
    enc, jenc = _encoder_out(params, jparams, cfg, jcfg, batch)
    with torch.no_grad():
        logits, pcache = prefill(params, {k: _t(v) for k, v in pre.items()}, cfg)
        _close(logits, jl)
        cache = cache_from_prefill(pcache, cfg, V + S, dtype=torch.float32)
        other = cache_from_prefill(pcache, cfg, V + S, dtype=torch.float32)
        steps = []
        for t in range(half, S):
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, V + t, cfg,
                                    encoder_out=enc)
            jlg, jcache = j_decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                        jnp.int32(V + t), jcfg, encoder_out=jenc)
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
    with torch.no_grad():
        for t in range(S):
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg,
                                    encoder_out=enc)
            jlg, jcache = j_decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                        jnp.int32(t), jcfg, encoder_out=jenc)
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
    with torch.no_grad():
        for t in range(20):
            jl, jcache = j_decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                       jnp.int32(t), jcfg, ring_cache=True)
            lg, cache = decode_step(params, _t(tokens[:, t:t + 1]), cache, t, cfg,
                                    ring_cache=True)
            _close(lg, jl)
            _close(lg, full[:, t:t + 1])
    assert cache["kv"][0].shape[2] == cfg.window_size
    _close(cache["kv"][0], jcache["kv"][0])
    _close(cache["ssm"]["h"], jcache["ssm"]["h"])


# ---------------------------------------------------------------------------
# Labels, block grids, bucket plans
# ---------------------------------------------------------------------------

def _stub_mesh(model: int):
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, model)))


def _shapes(name, full_width):
    jcfg = j_get_config(name) if full_width else j_get_config(name).reduced()
    cfg = get_config(name) if full_width else get_config(name).reduced()
    return jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg)), jcfg, cfg


def _shape_of(tree):
    return {p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(tree)}


def _grids(name, full_width, model):
    shapes, jcfg, cfg = _shapes(name, full_width)
    mesh = _stub_mesh(model)
    ref = j_specs.block_specs_for(shapes, j_specs.param_specs(shapes, jcfg, mesh), mesh)
    ref = {tuple(str(getattr(k, "key", k)) for k in path): b
           for path, b in jax.tree_util.tree_flatten_with_path(
               ref, is_leaf=lambda x: isinstance(x, j_blocking.BlockSpec2D))[0]}
    port = specs.block_specs_for(shapes, specs.param_specs(shapes, cfg, {"model": model}),
                                 {"model": model})
    return shapes, ref, dict(tree_lib.flatten_with_path(port))


GRID_CASES = [(n, False, 4) for n in ARCHS] + [(n, True, 8) for n in ARCHS]


@pytest.mark.parametrize("name,full_width,model", GRID_CASES)
def test_specs_labels_and_block_grids_match_reference(name, full_width, model):
    shapes, jcfg, cfg = _shapes(name, full_width)
    mesh = _stub_mesh(model)
    ref_specs = {tuple(str(getattr(k, "key", k)) for k in path): tuple(s)
                 for path, s in jax.tree_util.tree_flatten_with_path(
                     j_specs.param_specs(shapes, jcfg, mesh),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    port_specs = dict(tree_lib.flatten_with_path(specs.param_specs(shapes, cfg,
                                                                   {"model": model})))
    shape_of = _shape_of(shapes)
    assert {p: tuple(s) + (None,) * (len(shape_of[p]) - len(s))
            for p, s in ref_specs.items()} == port_specs
    _, ref, port = _grids(name, full_width, model)
    assert {p: (b.r, b.c) for p, b in port.items()} == {p: (b.r, b.c) for p, b in ref.items()}
    ref_labels = {tuple(str(getattr(k, "key", k)) for k in path): l
                  for path, l in jax.tree_util.tree_flatten_with_path(j_label_tree(shapes))[0]}
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    assert labels == ref_labels
    # The reference's caveat, matched: the SSM's per-head scalars and gate
    # norm, the norm gains and hymba's scales are 2-D and go to Muon; only
    # the convs (and the embeddings) go to AdamW.
    named = {tree_lib.path_str(p): l for p, l in labels.items()}
    for leaf in ("A_log", "D", "dt_bias", "gate_norm"):
        if f"layers/ssm/{leaf}" in named:
            assert named[f"layers/ssm/{leaf}"] == "muon"
    assert all(l == "adamw" for k, l in named.items() if "conv" in k)


def test_full_width_ssm_grids_shard_heads_and_d_inner():
    """mamba2 at 8-way: wdt and the per-head scalars split on the 64 heads
    (8 a block), wz/wx on d_inner; hymba's 50 heads do not divide by 8, so
    wdt and its scalars stay whole while wz/wx still split 3200."""
    _, _, port = _grids("mamba2-1.3b", True, 8)
    grid = {tree_lib.path_str(p): (b.r, b.c) for p, b in port.items()}
    assert grid["layers/ssm/wdt"] == grid["layers/ssm/A_log"] == (1, 8)
    assert grid["layers/ssm/wz"] == (1, 8) and grid["layers/ssm/out_proj"] == (8, 1)
    assert grid["layers/ssm/wb"] == grid["layers/ssm/gate_norm"] == (1, 1)
    _, _, port = _grids("hymba-1.5b", True, 8)
    grid = {tree_lib.path_str(p): (b.r, b.c) for p, b in port.items()}
    assert grid["layers/ssm/wdt"] == grid["layers/ssm/A_log"] == (1, 1)
    assert grid["layers/ssm/wx"] == (1, 8)
    assert grid["layers/hybrid/attn_scale"] == (1, 1)


def _leaf_specs(name, full_width, model):
    shapes, ref_g, port_g = _grids(name, full_width, model)
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    shape_of = _shape_of(shapes)
    keys = [k for k in shape_of if labels[k] == "muon"]
    ref = [j_program.LeafSpec(key=k, shape=shape_of[k], dtype="float32", block=ref_g[k])
           for k in keys]
    port = [program.LeafSpec(key=k, shape=shape_of[k], dtype="float32", block=port_g[k])
            for k in keys]
    return ref, port


@pytest.mark.parametrize("name,full_width,model", GRID_CASES)
@pytest.mark.parametrize("phase", ["block", "full"])
def test_program_matches_reference(name, full_width, model, phase):
    """Every Muon leaf stacks into the reference's buckets, op for op."""
    ref_ls, port_ls = _leaf_specs(name, full_width, model)
    ref = j_program.compile_program(ref_ls, backend="jnp").phase(phase)
    port = program.compile_program(port_ls, backend="cpu").phase(phase)
    assert [le.eff_dims for le in port.leaf_execs] == [le.eff_dims for le in ref.leaf_execs]
    assert [le.plan.key for le in port.leaf_execs] == [le.plan.key for le in ref.leaf_execs]
    assert [(op.bucket_key, op.packed_shape, op.mode) for op in port.ops] == \
        [(op.bucket_key, op.packed_shape, op.mode) for op in ref.ops]


def test_full_width_mamba2_program_shapes_and_kernels():
    """mamba2 at 24 layers and an 8-way grid (chip_smoke's train_ssm): the
    block phase sends every bucket to the fused chain, 2048 x 8 wdt blocks
    and 24 x 8 per-head scalar blocks among them; the full phase puts the
    2048 x 4096 wz/wx/out_proj units on the tiled products."""
    name = "mamba2-1.3b"
    cfg = dataclasses.replace(get_config(name), num_layers=24)
    jcfg = dataclasses.replace(j_get_config(name), num_layers=24)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    grids = dict(tree_lib.flatten_with_path(specs.block_specs_for(
        shapes, specs.param_specs(shapes, cfg, {"model": 8}), {"model": 8})))
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    ls = [program.LeafSpec(key=k, shape=s, dtype="float32", block=grids[k])
          for k, s in _shape_of(shapes).items() if labels[k] == "muon"]
    prog = program.compile_program(ls, backend="cuda")
    block = {op.packed_shape: op.kernel.strategy for op in prog.phase("block").ops}
    full = {op.packed_shape: op.kernel.strategy for op in prog.phase("full").ops}
    assert set(block.values()) == {"fused_chain"}
    assert block[(24, 8, 2048, 8)] == "fused_chain"         # wdt blocks
    assert block[(3, 8, 24, 8)] == "fused_chain"            # A_log / D / dt_bias blocks
    assert full[(48, 2048, 4096)] == full[(24, 4096, 2048)] == "tiled"  # wz/wx, out_proj
    assert full[(3, 24, 64)] == "fused_chain"               # the scalars whole


# ---------------------------------------------------------------------------
# Training: one MuonBP step a phase, the stream, the launcher, snapshots
# ---------------------------------------------------------------------------

def _optimizers(jparams, params, block_specs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    j_opt = j_combine({"muon": j_muon(LR, period=PERIOD, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR)}, j_label_tree(jparams))
    opt = combine({"muon": muon(LR, period=PERIOD, block_specs=block_specs),
                   "adamw": adamw(ADAM_LR)}, label_tree(params))
    return j_opt, opt


def _assert_params_close(port_params, j_state, params):
    """Muon leaves to 1e-5; AdamW leaves to 1e-4 where the reference's
    gradient is over 1e-6 (its first moment over 1e-7), and within the step's
    bound ``ADAM_LR`` where it is not: there the first step,
    -lr g / (|g| + 1e-8), turns a rounding difference of g into one of up to
    lr."""
    new = dict(tree_lib.flatten_with_path(interop.params_to_numpy(port_params)))
    labels = dict(tree_lib.flatten_with_path(label_tree(params)))
    mu = dict(tree_lib.flatten_with_path(jax.tree.map(
        np.asarray, j_state.opt_state.inner["adamw"].mu)))
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, j_state.params)):
        if labels[path] == "muon":
            np.testing.assert_allclose(new[path], ref, rtol=0, atol=1e-5, err_msg=str(path))
            continue
        err = np.abs(new[path] - ref)
        assert err.max() <= ADAM_LR, path
        assert err[np.abs(mu[path]) > 1e-7].max(initial=0.0) <= 1e-4, path


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("phase", ["full", "block"])
def test_one_muonbp_step_matches_reference(name, phase):
    """One fp32 step in each phase on the launcher's 4-way grid: metrics and
    every updated weight against the reference's train_step (ShardCtx())."""
    jcfg, jparams, cfg, params = _models(name)
    block_specs = train.matrix_block_specs(params, cfg, MODEL)
    batch = _batch(cfg, seed=6, shape=(4, S))
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = j_train_step(j_init_train_state(jparams, j_opt), _j(batch), cfg=jcfg,
                                      optimizer=j_opt, phase=phase, compute_dtype=jnp.float32)
    state, metrics = train_step(init_train_state(params, opt),
                                {k: _t(v) for k, v in batch.items()}, cfg=cfg, optimizer=opt,
                                phase=phase, compute_dtype=torch.float32)
    for k in ("ce", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-4)
    _assert_params_close(state.params, j_state, params)


@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_stream_with_extras_matches_reference(name):
    """The stream's tokens and stub inputs, drawn in the reference's order,
    equal the reference's for one seed, and so does the position after."""
    cfg, jcfg = get_config(name).reduced(), j_get_config(name).reduced()
    port, ref = SyntheticLM(cfg, 2, 16, seed=3), JSyntheticLM(jcfg, 2, 16, seed=3)
    pi, ri = iter(port), iter(ref)
    for _ in range(2):
        a, b = next(pi), next(ri)
        assert a.keys() == b.keys() == {"tokens", "labels", *_extras(cfg)}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert port.state() == ref.state()


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_runs_each_arch_on_the_cpu(name):
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--period", "2", "--mesh-model", "4", "--log-every", "1"]
    run = train.run(argv)
    assert [r["phase"] for r in run.records] == ["full", "block", "full"]
    assert np.isfinite([r["loss"] for r in run.records]).all()
    assert sum(v for k, v in run.counters.items() if k.startswith("ns_launch.cpu.")) > 0
    if name == "whisper-small":
        assert run.state.params["encoder"]["attn"]["wq"].shape[0] == 2


def test_mamba2_snapshot_crosses_the_reference_format(tmp_path):
    """The launcher's snapshot of reduced mamba2 (with its SSM leaves and
    their AdamW / Muon state) restores in the reference's checkpoint module
    leaf for leaf, and the reference's re-save of it restores in the port."""
    root = str(tmp_path / "ckpt")
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--period", "2", "--mesh-model", "4",
            "--checkpoint-every", "1", "--checkpoint-dir", root]
    run = train.run(argv)
    path, meta = checkpoint.latest_valid(root)
    assert meta["step"] == 1 and meta["run"]["arch"] == "mamba2-1.3b"
    jcfg = j_get_config("mamba2-1.3b").reduced()
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    j_bspecs = tree_lib.tree_map(
        lambda b: None if b is None else JBlockSpec2D(b.r, b.c), run.block_specs)
    j_opt = j_combine({"muon": j_muon(LR, LR, period=2, weight_decay=0.1, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR, weight_decay=0.1)}, j_label_tree(jparams))
    r_params, r_opt, step = j_checkpoint.restore(path, jparams, j_opt.init(jparams))
    assert step == 1
    for p, leaf in tree_lib.flatten_with_path(interop.params_to_numpy(run.state.params)):
        want = dict(tree_lib.flatten_with_path(jax.tree.map(np.asarray, r_params)))[p]
        np.testing.assert_array_equal(leaf, want, err_msg=str(p))
    momentum = r_opt.inner["muon"].momentum["layers"]["ssm"]["A_log"]
    np.testing.assert_array_equal(
        np.asarray(momentum),
        run.state.opt_state.inner["muon"].momentum[("layers", "ssm", "A_log")].numpy())
    back = str(tmp_path / "back")
    j_checkpoint.save(back, r_params, r_opt, step=step, extra={"run": meta["run"]})
    got_p, got_o, got_step = checkpoint.restore(back, run.state.params, run.state.opt_state,
                                                device="cpu")
    assert got_step == 1
    for (p, a), (_, b) in zip(tree_lib.flatten_with_path(got_p),
                              tree_lib.flatten_with_path(run.state.params)):
        assert torch.equal(a, b), p
    assert all(torch.equal(a, got_o.inner["adamw"].mu[k])
               for k, a in run.state.opt_state.inner["adamw"].mu.items())


@pytest.mark.parametrize("name", ARCHS)
def test_engine_refuses_the_arch_as_the_reference(name):
    """The continuous-batching engine serves dense and MoE only; these archs
    serve through generate (reference ``serving/engine.py:158``)."""
    cfg = get_config(name).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=repr(cfg.arch_type)):
        ServingEngine(params, cfg, EngineConfig(slots=1, block_size=8, max_model_len=32,
                                                num_blocks=4, max_prompt_len=16,
                                                max_new_tokens=8))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_need_a_card_unless_given_the_cpu():
    cfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(RuntimeError):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.run(["--arch", "whisper-small", "--reduced", "--steps", "1"])
