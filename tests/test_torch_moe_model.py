"""The port's MoE models against the JAX package: reduced ``olmoe-1b-7b``
(64 experts top-8, softmax-then-top-k; reduced to 4 experts top-2) and
``mixtral-8x7b`` (8 experts top-2, top-k-then-softmax, sliding window).
Parameters, forward, loss, grids and bucket plans here; decode in
``tests/test_torch_moe_decode.py`` and training in
``tests/test_torch_moe_train.py``, on this module's setup.

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

The reference's calls run jitted (``_jit``): its eager op-by-op dispatch
takes ~20x longer on the CPU.
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
from repro.core import program as j_program
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro.sharding import specs as j_specs
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import label_tree, muon, program
from repro_torch.models.model import (
    LB_COEF,
    Z_COEF,
    decode_step,
    forward,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.sharding import specs

TOL = 1e-4
ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
B, S = 2, 16
LR, ADAM_LR, PERIOD, MODEL = 0.02, 0.008, 5, 4


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` of the reference, jitted over the pytrees
    ``args`` (the configs, flags and optimizers bound in ``kw``)."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _j_decode(jcfg, **kw):
    """The reference's decode_step, jitted, for ``jcfg`` and ``kw``."""
    return jax.jit(lambda p, tok, cache, pos: j_decode_step(p, tok, cache, pos, jcfg, **kw))


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
    j_logits, j_aux = jax.jit(lambda p, t: j_forward(p, t, jcfg))(jparams, jnp.asarray(tokens))
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
    j_loss, j_metrics = jax.jit(lambda p, b: j_loss_fn(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
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
