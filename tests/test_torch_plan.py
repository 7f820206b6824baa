"""Block grids, bucketing and the compiled update program against the JAX package.

The reference's ``param_specs``/``block_specs_for`` read only a mesh's axis
names and sizes, so a stub mesh object with ``devices`` of shape (1, N)
gives its N-way tensor-parallel block grids without devices. The port
derives the same grids from a declared ``{"model": N}``. Everything here is
shape arithmetic or exact data movement, so comparisons are exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.core import blocking as j_blocking
from repro.core import bucketing as j_bucketing
from repro.core import program as j_program
from repro.core.combine import label_tree as j_label_tree
from repro.models.model import init_params as j_init_params
from repro.sharding import specs as j_specs
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import blocking, bucketing, program
from repro_torch.core.combine import label_tree
from repro_torch.sharding import specs


def _stub_mesh(model: int):
    return types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((1, model)))


def _ref_shapes(full_width: bool):
    cfg = j_get_config("muonbp-960m")
    if not full_width:
        cfg = cfg.reduced()
    return jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg)), cfg


def _grids(full_width: bool, model: int):
    shapes, jcfg = _ref_shapes(full_width)
    mesh = _stub_mesh(model)
    ref = j_specs.block_specs_for(shapes, j_specs.param_specs(shapes, jcfg, mesh), mesh)
    cfg = get_config("muonbp-960m")
    if not full_width:
        cfg = cfg.reduced()
    port = specs.block_specs_for(shapes, specs.param_specs(shapes, cfg, {"model": model}),
                                 {"model": model})
    return shapes, ref, port


CASES = [(False, 4), (False, 1), (True, 8)]


@pytest.mark.parametrize("full_width,model", CASES)
def test_block_grids_match_reference(full_width, model):
    _, ref, port = _grids(full_width, model)
    ref_flat = {tuple(str(getattr(k, "key", k)) for k in path): (b.r, b.c)
                for path, b in jax.tree_util.tree_flatten_with_path(
                    ref, is_leaf=lambda x: isinstance(x, j_blocking.BlockSpec2D))[0]}
    port_flat = {path: (b.r, b.c) for path, b in tree_lib.flatten_with_path(port)}
    assert port_flat == ref_flat


def test_full_width_tp8_grids_are_the_papers():
    _, _, port = _grids(True, 8)
    grid = {tree_lib.path_str(p): (b.r, b.c) for p, b in tree_lib.flatten_with_path(port)}
    for name in ("attn/wq", "attn/wk", "attn/wv", "mlp/wi", "mlp/wg"):
        assert grid[f"layers/{name}"] == (1, 8), name
    for name in ("attn/wo", "mlp/wo"):
        assert grid[f"layers/{name}"] == (8, 1), name
    assert grid["layers/norms/attn_norm"] == (1, 1)


@pytest.mark.parametrize("full_width", [False, True])
def test_labels_match_reference_including_norm_gains(full_width):
    shapes, _ = _ref_shapes(full_width)
    ref = dict((tuple(str(k.key) for k in p), l) for p, l in
               jax.tree_util.tree_flatten_with_path(j_label_tree(shapes))[0])
    port = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    assert port == ref
    # Reference quirk kept: the stacked (L, D) norm gains go to Muon.
    assert port[("layers", "norms", "attn_norm")] == "muon"
    assert port[("embed",)] == port[("lm_head",)] == port[("final_norm",)] == "adamw"


def _leaf_specs(full_width: bool, model: int):
    shapes, ref_grids, port_grids = _grids(full_width, model)
    labels = dict(tree_lib.flatten_with_path(label_tree(shapes)))
    ref_g = {tuple(str(getattr(k, "key", k)) for k in path): b
             for path, b in jax.tree_util.tree_flatten_with_path(
                 ref_grids, is_leaf=lambda x: isinstance(x, j_blocking.BlockSpec2D))[0]}
    port_g = dict(tree_lib.flatten_with_path(port_grids))
    keys = [k for k, _ in tree_lib.flatten_with_path(shapes) if labels[k] == "muon"]
    shape_of = dict(tree_lib.flatten_with_path(shapes))
    ref_ls = [j_program.LeafSpec(key=k, shape=tuple(shape_of[k].shape), dtype="float32",
                                 block=ref_g[k]) for k in keys]
    port_ls = [program.LeafSpec(key=k, shape=tuple(shape_of[k].shape), dtype="float32",
                                block=port_g[k]) for k in keys]
    return ref_ls, port_ls


@pytest.mark.parametrize("full_width,model", CASES)
@pytest.mark.parametrize("phase", ["block", "full"])
@pytest.mark.parametrize("bucketing_on", [True, False])
def test_compiled_program_matches_reference(full_width, model, phase, bucketing_on):
    ref_ls, port_ls = _leaf_specs(full_width, model)
    ref = j_program.compile_program(ref_ls, bucketing=bucketing_on, backend="jnp").phase(phase)
    port = program.compile_program(port_ls, bucketing=bucketing_on, backend="cpu").phase(phase)
    assert [le.eff_dims for le in port.leaf_execs] == [le.eff_dims for le in ref.leaf_execs]
    assert [le.plan.key for le in port.leaf_execs] == [le.plan.key for le in ref.leaf_execs]
    assert len(port.ops) == len(ref.ops)
    for p_op, r_op in zip(port.ops, ref.ops):
        assert p_op.bucket_key == r_op.bucket_key
        assert p_op.packed_shape == r_op.packed_shape
        assert p_op.mode == r_op.mode
        assert [le.index for le in p_op.leaves] == [le.index for le in r_op.leaves]


def test_full_width_program_puts_both_kernel_families_on_the_path():
    _, port_ls = _leaf_specs(True, 8)
    prog = program.compile_program(port_ls, backend="cuda")
    block = {op.packed_shape: op.kernel.strategy for op in prog.phase("block").ops}
    full = {op.packed_shape: op.kernel.strategy for op in prog.phase("full").ops}
    assert set(block.values()) == {"fused_chain"} and len(block) == 6
    assert full == {
        (24, 1536, 1536): "tiled",        # wq + attn wo
        (24, 1536, 384): "fused_chain",   # wk + wv
        (24, 1536, 6144): "tiled",        # mlp wi + wg
        (12, 6144, 1536): "tiled",        # mlp wo
        (2, 12, 1536): "fused_chain",     # norm gains
    }


@pytest.mark.parametrize("shape,grid", [((4, 6, 8), (2, 4)), ((2, 3, 12, 20), (3, 1)), ((6, 10), (1, 5))])
def test_partition_blocks_match_reference(shape, grid):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = j_blocking.partition_blocks(jnp.asarray(x), j_blocking.BlockSpec2D(*grid))
    out = blocking.partition_blocks(torch.from_numpy(x), blocking.BlockSpec2D(*grid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = blocking.unpartition_blocks(out, blocking.BlockSpec2D(*grid))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("spec,shape", [
    ((None, "model"), (8, 16)), (("model", None), (8, 16)), ((None, None, "model"), (2, 8, 12)),
    ((None, ("data", "model")), (8, 16)), ((None, "model"), (8, 15)), (None, (8, 16)),
])
def test_block_spec_from_partition_matches(spec, shape):
    sizes = {"data": 2, "model": 4}
    jspec = None if spec is None else jax.sharding.PartitionSpec(*spec)
    ref = j_blocking.block_spec_from_partition(jspec, shape, sizes)
    port = blocking.block_spec_from_partition(spec, shape, sizes)
    assert (port.r, port.c) == (ref.r, ref.c)


@pytest.mark.parametrize("mode", ["concat", "stack"])
def test_pack_unpack_match_reference(mode):
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal((2, 8, 12)).astype(np.float32) for _ in range(3)]
    grid = (2, 3)
    r_plans = [j_bucketing.plan_leaf(l.shape, jnp.float32, j_blocking.BlockSpec2D(*grid), mode)
               for l in leaves]
    p_plans = [bucketing.plan_leaf(l.shape, torch.float32, blocking.BlockSpec2D(*grid), mode)
               for l in leaves]
    assert [p.key for p in p_plans] == [p.key for p in r_plans]
    assert [p.units for p in p_plans] == [p.units for p in r_plans]
    r_packed = j_bucketing.pack_bucket(
        [j_bucketing.partition_leaf(jnp.asarray(l), p) for l, p in zip(leaves, r_plans)], mode)
    p_packed = bucketing.pack_bucket(
        [bucketing.partition_leaf(torch.from_numpy(l), p) for l, p in zip(leaves, p_plans)], mode)
    np.testing.assert_array_equal(p_packed.numpy(), np.asarray(r_packed))
    for out, leaf in zip(bucketing.unpack_bucket(p_packed, p_plans, mode), leaves):
        np.testing.assert_array_equal(out.numpy(), leaf)


@pytest.mark.parametrize("phase", ["block", "full"])
def test_ns_dispatch_count_equals_reference_bucket_count(phase):
    """One NS chain per shape bucket, not per leaf (test_ns_engine.py's acceptance)."""
    from repro_torch.core import adamw, combine, muon
    from repro_torch.kernels import dispatch

    shapes, _ = _ref_shapes(False)
    params = tree_lib.tree_map(lambda s: torch.zeros(s.shape), shapes)
    grads = tree_lib.tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(0)),
                              params)
    labels = label_tree(params)
    _, _, grids = _grids(False, 4)
    grids = tree_lib.tree_map(lambda b, l: b if l == "muon" else None, grids, labels)
    opt = combine({"muon": muon(1e-3, block_specs=grids), "adamw": adamw(1e-3)}, labels)
    calls = []
    dispatch.set_launch_hook(lambda dev, strategy, shape: calls.append(shape))
    try:
        opt.update(grads, opt.init(params), params, phase)
    finally:
        dispatch.set_launch_hook(None)
    ref_ls, _ = _leaf_specs(False, 4)
    expected = len(j_program.compile_program(ref_ls, backend="jnp").phase(phase).ops)
    assert len(calls) == expected < len(ref_ls)
