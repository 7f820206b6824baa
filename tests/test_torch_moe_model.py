"""The port's MoE models against the JAX package: reduced ``olmoe-1b-7b``
(64 experts top-8, softmax-then-top-k; reduced to 4 experts top-2) and
``mixtral-8x7b`` (8 experts top-2, top-k-then-softmax, sliding window).

Both packages start from the reference's parameters, carried over by
``repro_torch.interop``, and see the same numpy tokens. Tolerances, each
with its reason:

* fp32 compute: logits, aux losses and loss metrics to 1e-4 absolute. The
  routing is identical (integer work); the frameworks sum in other orders
  (the reference's prefill runs an online softmax over KV blocks), a few
  fp32 ulps a reduction;
* bf16 compute: loss metrics to 2e-2. bf16 keeps 8 mantissa bits (4e-3 a
  rounding) and the frameworks round activations at other places;
* decode against the forward needs a dropless config: a full forward over
  ``t`` tokens drops other assignments than ``t`` decodes of one token.
  ``capacity_factor = E / top_k`` gives each expert a capacity of every
  token of the group;
* one MuonBP step: Muon-updated weights to 1e-5 (the update is O(lr)),
  AdamW's to 1e-4 (its first step is -lr g / (|g| + eps), so a rounding
  difference in a gradient entry near 0 moves a weight by up to lr);
* block grids and bucket plans: shape arithmetic, compared exactly.
"""

import dataclasses
import json
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
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_cache as j_init_cache
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import prefill as j_prefill
from repro.models.transformer import forward as j_forward
from repro.serving.serve_step import generate as j_generate
from repro.sharding import specs as j_specs
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import train_step as j_train_step
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, combine, label_tree, muon, program
from repro_torch.launch import train
from repro_torch.models.model import (
    LB_COEF,
    Z_COEF,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.obs.bus import read_jsonl
from repro_torch.serving.serve_step import cache_from_prefill, generate
from repro_torch.sharding import specs
from repro_torch.training.train_step import init_train_state, train_step

TOL = 1e-4
ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
B, S = 2, 16
LR, ADAM_LR, PERIOD, MODEL = 0.02, 0.008, 5, 4


def _models(name, **over):
    """(reference cfg, reference params, port cfg, port params on the CPU)."""
    jcfg = tiny_cfg(name, **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _dropless(name):
    cfg = get_config(name).reduced()
    return {"capacity_factor": cfg.num_experts / cfg.top_k}


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _batch(tokens):
    labels = np.concatenate([tokens[:, 1:], -np.ones((tokens.shape[0], 1), np.int32)], axis=1)
    return {"tokens": tokens, "labels": labels}


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _close(out, expect, tol=TOL):
    out = out.detach().to(torch.float32).numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(np.asarray(out, dtype=np.float32),
                               np.asarray(jnp.asarray(expect).astype(jnp.float32)),
                               rtol=0, atol=tol)


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
    assert "mlp" not in port["layers"]
    experts = port["layers"]["moe"]["wi"]
    assert experts.shape == (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert float(experts.std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_and_aux_match_reference(name):
    jcfg, jparams, cfg, params = _models(name)
    tokens = _tokens(cfg)
    j_logits, j_aux = j_forward(jparams, jnp.asarray(tokens), jcfg)
    logits, aux = forward(params, _t(tokens), cfg, return_aux=True)
    _close(logits, j_logits)
    for k in ("load_balance", "z_loss"):
        assert abs(float(aux[k]) - float(j_aux[k])) <= TOL, k
    assert float(aux["load_balance"]) > 0 and float(aux["z_loss"]) > 0
    # The default signature leaves the aux out; prefill returns it on request.
    assert torch.equal(forward(params, _t(tokens), cfg), logits)
    with torch.no_grad():
        p_logits, p_aux, _ = forward(params, _t(tokens), cfg, mode="prefill", return_aux=True)
    _close(p_logits, j_logits)
    assert float(p_aux["z_loss"]) == pytest.approx(float(aux["z_loss"]), abs=1e-6)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
def test_loss_fn_metrics_match_reference(name, dtype, tol):
    jcfg, jparams, cfg, params = _models(name)
    batch = _batch(_tokens(cfg, seed=1))
    jp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jparams)
    j_loss, j_metrics = j_loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    p = tree_lib.tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    loss, metrics = loss_fn(p, {k: _t(v) for k, v in batch.items()}, cfg)
    assert set(metrics) == set(j_metrics) == {"ce", "load_balance", "z_loss", "loss"}
    for k in metrics:
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= tol, k
    assert float(loss) == float(metrics["loss"])
    expect = metrics["ce"] + LB_COEF * metrics["load_balance"] + Z_COEF * metrics["z_loss"]
    assert float(metrics["loss"]) == pytest.approx(float(expect), rel=1e-6)


def test_dense_loss_has_no_aux_metrics():
    cfg = get_config("granite-8b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    _, metrics = loss_fn(params, {k: _t(v) for k, v in _batch(_tokens(cfg)).items()}, cfg)
    assert set(metrics) == {"ce", "loss"} and torch.equal(metrics["ce"], metrics["loss"])


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
    jl, _, jc = j_prefill(jparams, {"tokens": jnp.asarray(tokens[:, :half])}, jcfg)
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
    with torch.no_grad():
        for t in range(S):
            jl, jcache = j_decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                       jnp.int32(t), jcfg)
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


# ---------------------------------------------------------------------------
# Block grids, bucket plans
# ---------------------------------------------------------------------------

def _stub_mesh(model: int):
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, model)))


def _shapes(name, full_width):
    jcfg = j_get_config(name) if full_width else j_get_config(name).reduced()
    cfg = get_config(name) if full_width else get_config(name).reduced()
    return jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg)), jcfg, cfg


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
def test_moe_specs_and_block_grids_match_reference(name, full_width, model):
    shapes, jcfg, cfg = _shapes(name, full_width)
    mesh = _stub_mesh(model)
    ref_specs = {tuple(str(getattr(k, "key", k)) for k in path): tuple(s)
                 for path, s in jax.tree_util.tree_flatten_with_path(
                     j_specs.param_specs(shapes, jcfg, mesh),
                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    port_specs = dict(tree_lib.flatten_with_path(specs.param_specs(shapes, cfg, {"model": model})))
    assert {p: tuple(s) + (None,) * (len(shapes_of(shapes)[p]) - len(s))
            for p, s in ref_specs.items()} == port_specs
    _, ref, port = _grids(name, full_width, model)
    assert {p: (b.r, b.c) for p, b in port.items()} == {p: (b.r, b.c) for p, b in ref.items()}


def shapes_of(tree):
    return {p: tuple(l.shape) for p, l in tree_lib.flatten_with_path(tree)}


def test_full_width_olmoe_grid_splits_each_experts_d_ff():
    """wi/wg column-split and wo row-split on d_ff (1024 / 8 = 128), the
    router whole: the expert blocks are 2048 x 128 and 128 x 2048."""
    _, _, port = _grids("olmoe-1b-7b", True, 8)
    grid = {tree_lib.path_str(p): (b.r, b.c) for p, b in port.items()}
    assert grid["layers/moe/wi"] == grid["layers/moe/wg"] == (1, 8)
    assert grid["layers/moe/wo"] == (8, 1)
    assert grid["layers/moe/router"] == (1, 1)


def _leaf_specs(name, full_width, model):
    shapes, ref_g, port_g = _grids(name, full_width, model)
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    shape_of = shapes_of(shapes)
    keys = [k for k in shape_of if labels[k] == "muon"]
    ref = [j_program.LeafSpec(key=k, shape=shape_of[k], dtype="float32", block=ref_g[k])
           for k in keys]
    port = [program.LeafSpec(key=k, shape=shape_of[k], dtype="float32", block=port_g[k])
            for k in keys]
    return ref, port


@pytest.mark.parametrize("name,full_width,model", GRID_CASES)
@pytest.mark.parametrize("phase", ["block", "full"])
def test_moe_program_matches_reference(name, full_width, model, phase):
    """The router and the 4-D expert leaves reach Muon; their (L, E) lead
    dims stack as units, bucket for bucket as in the reference."""
    ref_ls, port_ls = _leaf_specs(name, full_width, model)
    assert {tree_lib.path_str(ls.key) for ls in port_ls} >= {
        "layers/moe/router", "layers/moe/wi", "layers/moe/wg", "layers/moe/wo"}
    ref = j_program.compile_program(ref_ls, backend="jnp").phase(phase)
    port = program.compile_program(port_ls, backend="cpu").phase(phase)
    assert [le.eff_dims for le in port.leaf_execs] == [le.eff_dims for le in ref.leaf_execs]
    assert [le.plan.key for le in port.leaf_execs] == [le.plan.key for le in ref.leaf_execs]
    assert [(op.bucket_key, op.packed_shape, op.mode) for op in port.ops] == \
        [(op.bucket_key, op.packed_shape, op.mode) for op in ref.ops]


def test_full_width_olmoe_program_shapes_and_kernels():
    """At 4 layers and an 8-way grid: 128 x 2048 expert blocks on the fused
    chain in the block phase, 1024 x 2048 expert units (25.2 MB, over the
    fused budget) on the tiled products in the full phase, and the
    64 x 2048 router units (under the tile's 128 rows) on the fused chain."""
    name = "olmoe-1b-7b"
    cfg = dataclasses.replace(get_config(name), num_layers=4)
    jcfg = dataclasses.replace(j_get_config(name), num_layers=4)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    grids = dict(tree_lib.flatten_with_path(specs.block_specs_for(
        shapes, specs.param_specs(shapes, cfg, {"model": 8}), {"model": 8})))
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    ls = [program.LeafSpec(key=k, shape=s, dtype="float32", block=grids[k])
          for k, s in shapes_of(shapes).items() if labels[k] == "muon"]
    prog = program.compile_program(ls, backend="cuda")
    units = lambda shape: int(np.prod(shape[:-2]))
    block = [(op.packed_shape, op.kernel.strategy) for op in prog.phase("block").ops]
    full = {op.packed_shape: op.kernel.strategy for op in prog.phase("full").ops}
    expert_blocks = [(s, k) for s, k in block if sorted(s[-2:]) == [128, 2048]]
    assert sum(units(s) for s, _ in expert_blocks) == 3 * 4 * 64 * 8
    assert {k for _, k in block} == {"fused_chain"} and len(block) == 6
    assert full == {
        (16, 2048, 2048): "tiled",           # attention wq, wk, wv, wo
        (4, 2048, 64): "fused_chain",        # the router
        (512, 2048, 1024): "tiled",          # experts wi + wg
        (4, 64, 1024, 2048): "tiled",        # experts wo
        (2, 4, 2048): "fused_chain",         # norm gains
    }


# ---------------------------------------------------------------------------
# Training: one MuonBP step a phase, accumulation, interop, the launcher
# ---------------------------------------------------------------------------

def _optimizers(jparams, params, block_specs):
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), block_specs)
    j_opt = j_combine({"muon": j_muon(LR, period=PERIOD, block_specs=j_bspecs),
                       "adamw": j_adamw(ADAM_LR)}, j_label_tree(jparams))
    opt = combine({"muon": muon(LR, period=PERIOD, block_specs=block_specs),
                   "adamw": adamw(ADAM_LR)}, label_tree(params))
    return j_opt, opt


def _assert_params_close(port_params, ref_params, params):
    new = dict(tree_lib.flatten_with_path(interop.params_to_numpy(port_params)))
    labels = dict(tree_lib.flatten_with_path(label_tree(params)))
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, ref_params)):
        atol = 1e-5 if labels[path] == "muon" else 1e-4
        np.testing.assert_allclose(new[path], ref, rtol=0, atol=atol, err_msg=str(path))


def _step_inputs(name):
    jcfg, jparams, cfg, params = _models(name)
    block_specs = train.matrix_block_specs(params, cfg, MODEL)
    batch = _batch(_tokens(cfg, seed=6, shape=(4, 16)))
    return jcfg, jparams, cfg, params, block_specs, batch


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("phase", ["full", "block"])
def test_one_muonbp_step_matches_reference(name, phase):
    """One fp32 step in each phase on the launcher's 4-way grid: metrics and
    every updated weight against the reference's train_step (ShardCtx())."""
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    grid = block_specs["layers"]["moe"]["wi"]
    assert (grid.r, grid.c) == (1, MODEL)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = j_train_step(
        j_init_train_state(jparams, j_opt), {k: jnp.asarray(v) for k, v in batch.items()},
        cfg=jcfg, optimizer=j_opt, phase=phase, compute_dtype=jnp.float32)
    state, metrics = train_step(
        init_train_state(params, opt), {k: _t(v) for k, v in batch.items()}, cfg=cfg,
        optimizer=opt, phase=phase, compute_dtype=torch.float32)
    for k in ("ce", "load_balance", "z_loss", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["grad_norm"]) == pytest.approx(float(j_metrics["grad_norm"]), rel=1e-4)
    _assert_params_close(state.params, j_state.params, params)


@pytest.mark.parametrize("name", ARCHS)
def test_accumulation_averages_every_metric_as_the_reference(name):
    """accum_steps = 2: every metric is the mean over the microbatches. The
    MoE loss is not its CE, so a metric tree of {ce: loss, loss: loss}
    fails here."""
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    j_state, j_metrics = j_train_step(
        j_init_train_state(jparams, j_opt), {k: jnp.asarray(v) for k, v in batch.items()},
        cfg=jcfg, optimizer=j_opt, phase="full", compute_dtype=jnp.float32, accum_steps=2)
    state, metrics = train_step(
        init_train_state(params, opt), {k: _t(v) for k, v in batch.items()}, cfg=cfg,
        optimizer=opt, phase="full", compute_dtype=torch.float32, accum_steps=2)
    assert set(metrics) == set(j_metrics)
    for k in ("ce", "load_balance", "z_loss", "loss"):
        assert abs(float(metrics[k]) - float(j_metrics[k])) <= TOL, k
    assert float(metrics["ce"]) != float(metrics["loss"])
    _assert_params_close(state.params, j_state.params, params)


def test_interop_carries_moe_params_and_optimizer_state():
    """Parameters round-trip exactly; the reference's optimizer state after a
    full step, carried over, gives the port's next (block) step the
    reference's next step."""
    name = "olmoe-1b-7b"
    jcfg, jparams, cfg, params, block_specs, batch = _step_inputs(name)
    back = interop.params_to_numpy(params)
    for path, ref in tree_lib.flatten_with_path(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_array_equal(dict(tree_lib.flatten_with_path(back))[path], ref)
    j_opt, opt = _optimizers(jparams, params, block_specs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state, _ = j_train_step(j_init_train_state(jparams, j_opt), jbatch, cfg=jcfg,
                              optimizer=j_opt, phase="full", compute_dtype=jnp.float32)
    inner = {label: jax.tree.map(np.asarray, sub._asdict())
             for label, sub in j_state.opt_state.inner.items()}
    carried = interop.combined_state_from_numpy(inner, device="cpu")
    momentum = carried.inner["muon"].momentum
    assert momentum[("layers", "moe", "wi")].shape == (cfg.num_layers, cfg.num_experts,
                                                       cfg.d_model, cfg.d_ff)
    j_state2, _ = j_train_step(j_state, jbatch, cfg=jcfg, optimizer=j_opt, phase="block",
                               compute_dtype=jnp.float32)
    state = init_train_state(interop.params_from_numpy(jax.tree.map(np.asarray, j_state.params),
                                                       device="cpu"), opt)
    state = state._replace(opt_state=carried, step=1)
    state2, _ = train_step(state, {k: _t(v) for k, v in batch.items()}, cfg=cfg, optimizer=opt,
                           phase="block", compute_dtype=torch.float32)
    _assert_params_close(state2.params, j_state2.params, params)
    again = interop.combined_state_to_numpy(carried)
    np.testing.assert_array_equal(again["muon"]["momentum"]["layers"]["moe"]["router"],
                                  inner["muon"]["momentum"]["layers"]["moe"]["router"])


@pytest.mark.parametrize("name", ARCHS)
def test_launcher_runs_moe_archs_and_records_aux(name, tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    argv = ["--arch", name, "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--period", "2", "--mesh-model", "4", "--log-every", "1",
            "--log-file", str(log)]
    run = train.run(argv)
    assert [r["phase"] for r in run.records] == ["full", "block", "full"]
    for r in run.records:
        assert np.isfinite([r["loss"], r["load_balance"], r["z_loss"]]).all()
        assert r["load_balance"] > 0 and r["z_loss"] > 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    steps = [l for l in lines if "loss" in l and "event" not in l]
    assert [round(r["load_balance"], 6) for r in run.records] == [l["load_balance"] for l in steps]
    end = [r for r in read_jsonl(str(log)) if r.get("event") == "run_end"]
    assert end[0]["load_balance"] == run.records[-1]["load_balance"]
    assert end[0]["z_loss"] == run.records[-1]["z_loss"]
    # A cut in depth through cfg=, which the reference has no flag for.
    shallow = dataclasses.replace(get_config(name).reduced(), num_layers=1)
    one = train.run(argv[:-2] + ["--steps", "1"], cfg=shallow)
    assert one.state.params["layers"]["moe"]["wi"].shape[0] == 1
