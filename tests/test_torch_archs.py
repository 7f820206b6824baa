"""The port's SSM, hybrid, VLM and audio architectures against the JAX
package: reduced ``mamba2-1.3b`` (SSM), ``hymba-1.5b`` (attention and SSM in
one layer, sliding window), ``internvl2-1b`` (vision tokens ahead of the
text) and ``whisper-small`` (encoder-decoder, cross-attention, sinusoidal
positions). Parameters, forward, loss, specs, grids and bucket plans here;
decode in ``tests/test_torch_archs_decode.py`` and training in
``tests/test_torch_archs_train.py``, on this module's setup.

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

The reference's calls run jitted: its eager op-by-op dispatch takes ~20x
longer on the CPU (a decode step of the reduced hymba: 0.74 s eager,
0.03 s jitted).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from conftest import tiny_cfg
from repro.configs import get_config as j_get_config
from repro.core import blocking as j_blocking
from repro.core import label_tree as j_label_tree
from repro.core import program as j_program
from repro.models.encdec import encode as j_encode
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.sharding import specs as j_specs
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, label_tree, muon, program
from repro_torch.models.encdec import encode
from repro_torch.models.model import decode_step, forward, init_params, loss_fn, prefill
from repro_torch.sharding import specs

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


def _j_prefill(jcfg):
    return jax.jit(lambda p, b: j_prefill(p, b, jcfg))


def _j_decode(jcfg, **kw):
    """The reference's decode_step, jitted, for ``jcfg`` and ``kw``."""
    return jax.jit(lambda p, tok, cache, pos: j_decode_step(p, tok, cache, pos, jcfg, **kw))


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
    j_logits, _ = jax.jit(lambda p, b: j_forward(
        p, b["tokens"], jcfg, extra_embeds=b.get("vision_embeds"),
        encoder_frames=b.get("audio_frames")))(jparams, _j(batch))
    logits = forward(params, _t(batch["tokens"]), cfg, **_kw(cfg, batch))
    assert logits.shape == (B, S + cfg.vision_tokens, cfg.padded_vocab)
    _close(logits, j_logits)
    jl, _, jc = _j_prefill(jcfg)(jparams, _j(batch))
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
    j_loss, j_metrics = jax.jit(lambda p, b: j_loss_fn(p, b, jcfg))(jp, _j(batch))
    p = tree_lib.tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    loss, metrics = loss_fn(p, {k: _t(v) for k, v in batch.items()}, cfg)
    assert set(metrics) == set(j_metrics) == {"ce", "loss"}
    for k in metrics:
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= tol, k
    assert float(loss) == float(metrics["loss"])


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
