"""The port's communication plan, spec rules and engine-mode program against
the JAX package, on abstract meshes (no ranks: pure math on axis sizes).

The reference's ``plan_comm`` runs on its own test's ``fake_mesh`` (a JAX
mesh of repeated CPU devices), the port's on the same ``{axis: size}``
dict, both over the same parameter shapes (the reference's ``eval_shape``
tree, handed to the port as meta tensors). Every comparison is exact:
collectives leaf for leaf (kind, axes, bytes, link), every phase total, the
per-link and per-axes sums and the summary text; ``momentum_spec``,
``zero1_flatten_info`` and ``parse_mesh_spec`` case by case; and the
engine-mode program the reference compiles on an abstract mesh without
running it (bucket keys, local packed shapes, gather and apply CommOps,
pipeline stages). The kernel strategies are not compared: each package
plans its own kernels.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import label_tree as j_label_tree
from repro.core import program as j_program
from repro.distributed import make_engine as j_make_engine
from repro.distributed import plan_comm as j_plan_comm
from repro.launch.mesh import parse_mesh_spec as j_parse_mesh_spec
from repro.models.model import init_params as j_init_params
from repro.sharding import specs as j_sh
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import bucketing, label_tree
from repro_torch.core import program
from repro_torch.core.blocking import BlockSpec2D
from repro_torch.distributed import make_engine, plan_comm
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.sharding import specs as sh


def fake_mesh(sizes: dict) -> Mesh:
    shape = tuple(sizes.values())
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), tuple(sizes))


def _to_meta(tree):
    """The reference's shape tree as nested dicts of meta tensors."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


def _tuple_spec(spec) -> tuple:
    return tuple(spec)


@dataclasses.dataclass
class Case:
    arch: str
    mesh: dict
    zero1: bool = False
    zero1_flatten: bool = False
    reduced: bool = False


CASES = {
    "granite16x16": Case("granite-8b", {"data": 16, "model": 16}),
    "granite16x16_zero1": Case("granite-8b", {"data": 16, "model": 16}, zero1=True),
    "granite16x16_flatten": Case("granite-8b", {"data": 16, "model": 16}, zero1=True,
                                 zero1_flatten=True),
    "muonbp960m_model8_hd": Case("muonbp-960m", {"model": 8}),
    "granite_pod2_data2_model2": Case("granite-8b", {"pod": 2, "data": 2, "model": 2},
                                      zero1=True),
    "olmoe_reduced": Case("olmoe-1b-7b", {"data": 2, "model": 4}, zero1=True, reduced=True),
    "mamba2_reduced": Case("mamba2-1.3b", {"data": 2, "model": 2}, zero1=True,
                           zero1_flatten=True, reduced=True),
    # hymba's 50 SSM heads on axes that do not divide them: d_inner splits,
    # wdt and the per-head scalars stay whole (their grids, momentum specs
    # and flatten fallback included).
    "hymba16x16_zero1": Case("hymba-1.5b", {"data": 16, "model": 16}, zero1=True),
    "hymba_data2_model4_flatten": Case("hymba-1.5b", {"data": 2, "model": 4}, zero1=True,
                                       zero1_flatten=True),
}


def _setup(case: Case):
    jcfg = j_get_config(case.arch)
    cfg = get_config(case.arch)
    if case.reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    a_params = jax.eval_shape(lambda k: j_init_params(k, jcfg), jax.random.PRNGKey(0))
    mesh = fake_mesh(case.mesh)
    j_specs = j_sh.param_specs(a_params, jcfg, mesh)
    params = _to_meta(a_params)
    specs = sh.param_specs(params, cfg, case.mesh)
    return jcfg, cfg, a_params, mesh, j_specs, params, specs


@pytest.fixture(scope="module", params=sorted(CASES))
def plans(request):
    case = CASES[request.param]
    jcfg, cfg, a_params, mesh, j_specs, params, specs = _setup(case)
    kw = dict(zero1=case.zero1, zero1_flatten=case.zero1_flatten)
    j_bspecs = j_sh.block_specs_for(a_params, j_specs, mesh)
    bspecs = sh.block_specs_for(params, specs, case.mesh)
    ref = j_plan_comm(a_params, j_specs, mesh, labels=j_label_tree(a_params), **kw)
    port = plan_comm(params, specs, case.mesh, labels=label_tree(params), **kw)
    ref_b = j_plan_comm(a_params, j_specs, mesh, block_specs=j_bspecs, **kw)
    port_b = plan_comm(params, specs, case.mesh, block_specs=bspecs, **kw)
    return case, ref, port, ref_b, port_b


def _leaf_record(leaf):
    return dict(
        path=leaf.path, shape=tuple(leaf.shape), spec=_tuple_spec(leaf.spec), label=leaf.label,
        zero1_factor=leaf.zero1_factor,
        flatten=None if leaf.flatten is None else dataclasses.astuple(leaf.flatten),
        **{ph: [(c.op, tuple(c.axes), c.bytes, c.link) for c in leaf.collectives(ph)]
           for ph in ("block", "full", "apply")},
    )


def test_plan_comm_leaf_for_leaf(plans):
    case, ref, port, ref_b, port_b = plans
    for r, p in ((ref, port), (ref_b, port_b)):
        assert len(r.leaves) == len(p.leaves)
        for rl, pl in zip(r.leaves, p.leaves):
            assert _leaf_record(pl) == _leaf_record(rl), rl.path
        assert p.axis_sizes == dict(r.axis_sizes)


def test_plan_comm_totals_links_axes(plans):
    case, ref, port, ref_b, port_b = plans
    for r, p in ((ref, port), (ref_b, port_b)):
        for phase in ("block", "full", "apply"):
            assert p.predicted_bytes(phase) == r.predicted_bytes(phase)
            for link in ("ici", "dcn"):
                assert p.predicted_bytes(phase, link) == r.predicted_bytes(phase, link)
            assert p.predicted(phase) == r.predicted(phase)
            assert p.predicted_by_link(phase) == r.predicted_by_link(phase)
            assert p.predicted_by_axes(phase) == r.predicted_by_axes(phase)
        assert p.summary() == r.summary()
    # The paper's claim on every mesh: block steps move nothing.
    assert port_b.predicted_bytes("block") == 0


def test_plan_comm_stagger_pricing(plans):
    """The stagger offsets and per-residue bytes the plan carries."""
    case, ref, port, _, _ = plans
    assert port.stagger_offsets(5) == ref.stagger_offsets(5)
    assert port.staggered_bytes_by_residue(5) == ref.staggered_bytes_by_residue(5)
    assert port.max_staggered_dcn_bytes(4) == ref.max_staggered_dcn_bytes(4)
    assert (port.predicted_by_axes("staggered", period=5, residue=2)
            == ref.predicted_by_axes("staggered", period=5, residue=2))


def test_hd_layout_at_model8():
    """muonbp-960m's 4 KV heads do not divide model=8: wk/wv shard head_dim,
    so their local shards are 1536 x 48."""
    _, cfg, _, _, _, params, specs = _setup(CASES["muonbp960m_model8_hd"])
    assert sh.attn_layouts(cfg, 8) == ("head", "hd")
    wk = tree_lib.flatten_with_path(params)
    shapes = {p: tuple(x.shape) for p, x in wk}
    local = sh.local_shape(specs["layers"]["attn"]["wk"], shapes[("layers", "attn", "wk")],
                           {"model": 8})
    assert local == (12, 1536, 48)


MOMENTUM_CASES = [
    # (spec, shape, sizes, zero1, zero1_axis, label)
    ((None, None, "model"), (12, 1536, 1536), {"data": 2, "model": 2}, True, None, "muon"),
    ((None, None, "model"), (36, 64, 64), {"data": 16, "model": 16}, True, None, "muon"),
    ((None, None, "model"), (48, 64, 64), {"pod": 2, "data": 16, "model": 4}, True, None, "muon"),
    ((None, None, "model"), (3, 64, 64), {"data": 2, "model": 2}, True, "data", "muon"),
    ((None, "model"), (256, 512), {"data": 2, "model": 2}, True, None, "adamw"),
    ((None, "model"), (256, 512), {"data": 2, "model": 2}, True, None, "muon"),
    (("model", None), (512, 256), {"data": 2, "model": 2}, True, None, "adamw"),
    ((None,), (256,), {"data": 2, "model": 2}, True, None, "adamw"),
    ((None, None, None), (8, 32, 32), {"pod": 2, "data": 2, "model": 2}, True, None, "muon"),
    ((None, None, None), (8, 32, 32), {"pod": 2, "data": 2, "model": 2}, True, ("pod", "data"),
     "muon"),
    ((None, None, "model"), (12, 32, 32), {"data": 2, "model": 2}, False, None, "muon"),
]


@pytest.mark.parametrize("case", MOMENTUM_CASES, ids=[str(i) for i in range(len(MOMENTUM_CASES))])
def test_momentum_spec_and_flatten_info_match_reference(case):
    spec, shape, sizes, zero1, axis, label = case
    got = sh.momentum_spec(spec, shape, sizes, zero1=zero1, zero1_axis=axis, label=label)
    ref = j_sh.momentum_spec(P(*spec), shape, sizes, zero1=zero1, zero1_axis=axis, label=label)
    assert got == tuple(ref)
    fl = sh.zero1_flatten_info(spec, shape, sizes, zero1_axis=axis, label=label)
    j_fl = j_sh.zero1_flatten_info(P(*spec), shape, sizes, zero1_axis=axis, label=label)
    assert (fl is None) == (j_fl is None)
    if fl is not None:
        assert dataclasses.astuple(fl) == dataclasses.astuple(j_fl)
        assert sh.flatten_momentum_spec(spec, shape, fl) == tuple(
            j_sh.flatten_momentum_spec(P(*spec), shape, j_fl))


@pytest.mark.parametrize("spec", ["pod=2,data=2,model=2", "model=4,data=2", "data=8",
                                  "2,2,2", "4,2", "8", "model=2,pod=2", "bogus=2",
                                  "data=2,data=2", "1,2,3,4", ""])
def test_parse_mesh_spec_matches_reference(spec):
    try:
        ref = j_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            parse_mesh_spec(spec)
        return
    assert parse_mesh_spec(spec) == ref


def test_batch_and_cache_specs_match_reference():
    from repro.configs import SHAPES as J_SHAPES
    from repro_torch.configs import SHAPES

    for arch, sizes in (("granite-8b", {"data": 4, "model": 4}),
                        ("mamba2-1.3b", {"pod": 2, "data": 2, "model": 2}),
                        ("internvl2-1b", {"data": 2, "model": 2})):
        jcfg, cfg = j_get_config(arch), get_config(arch)
        mesh = fake_mesh(sizes)
        for name in SHAPES:
            assert sh.batch_axes_for(SHAPES[name].global_batch, sizes) == \
                j_sh.batch_axes_for(J_SHAPES[name].global_batch, mesh)
            got = sh.input_batch_specs(cfg, SHAPES[name], sizes)
            ref = j_sh.input_batch_specs(jcfg, J_SHAPES[name], mesh)
            assert got == {k: tuple(v) for k, v in ref.items()}
            for seq_shard in (False, True):
                got = sh.cache_specs(cfg, SHAPES[name], sizes, kv_seq_shard=seq_shard)
                ref = j_sh.cache_specs(jcfg, J_SHAPES[name], mesh, kv_seq_shard=seq_shard)
                ref = jax.tree.map(tuple, ref, is_leaf=lambda x: isinstance(x, P))
                assert got == ref


# ---------------------------------------------------------------------------
# The engine-mode program, compiled on an abstract mesh without running it
# ---------------------------------------------------------------------------

def _leaf_specs(params, bspecs, labels, engine, LeafSpec, BS):
    out = []
    for path, p in tree_lib.flatten_with_path(params):
        if tree_lib.flatten_with_path(labels) and dict(tree_lib.flatten_with_path(labels))[path] != "muon":
            continue
        b = dict(tree_lib.flatten_with_path(bspecs)).get(path)
        out.append(LeafSpec(key=path, shape=engine.state_shape_for(path, tuple(p.shape)),
                            dtype="float32", block=None if b is None else BS(b.r, b.c)))
    return tuple(out)


def _commop(c):
    return None if c is None else (c.kind, tuple(c.axes), tuple(
        (o, tuple(a), b) for o, a, b in c.collectives))


@pytest.mark.parametrize("name", ["granite16x16_flatten", "muonbp960m_model8_hd",
                                  "granite_pod2_data2_model2", "hymba16x16_zero1"])
@pytest.mark.parametrize("schedule", ["pipelined", "barrier"])
def test_engine_program_matches_reference(name, schedule):
    from repro.core.blocking import BlockSpec2D as JBS

    case = CASES[name]
    jcfg, cfg, a_params, mesh, j_specs, params, specs = _setup(case)
    kw = dict(zero1=case.zero1, zero1_flatten=case.zero1_flatten)
    j_engine = j_make_engine(a_params, j_specs, mesh, **kw)
    engine = make_engine(params, specs, case.mesh, **kw)
    labels = label_tree(params)
    bspecs = sh.block_specs_for(params, specs, case.mesh)
    ls = _leaf_specs(params, bspecs, labels, engine, program.LeafSpec, BlockSpec2D)
    j_ls = tuple(j_program.LeafSpec(key=l.key, shape=l.shape, dtype=l.dtype,
                                    block=None if l.block is None else JBS(l.block.r, l.block.c))
                 for l in ls)
    prog = program.compile_program(ls, engine=engine, full_schedule=schedule, backend="cpu")
    ref = j_program.compile_program(j_ls, engine=j_engine, full_schedule=schedule)
    for phase in ("block", "full"):
        p, r = prog.phase(phase), ref.phase(phase)
        assert [op.bucket_key for op in p.ops] == [op.bucket_key for op in r.ops]
        assert [tuple(op.packed_shape) for op in p.ops] == [tuple(op.packed_shape) for op in r.ops]
        assert [op.mode for op in p.ops] == [op.mode for op in r.ops] == ["concat"] * len(p.ops)
        assert [[le.index for le in op.leaves] for op in p.ops] == \
            [[le.index for le in op.leaves] for op in r.ops]
        for pl, rl in zip(p.leaf_execs, r.leaf_execs):
            assert pl.plan.key == rl.plan.key and pl.plan.block_shape == rl.plan.block_shape
            assert pl.eff_dims == rl.eff_dims
            assert pl.spec == tuple(rl.spec)
            assert _commop(pl.gather) == _commop(rl.gather)
            assert _commop(pl.apply) == _commop(rl.apply)
            assert pl.out_spec == (None if rl.out_spec is None else tuple(rl.out_spec))
            assert pl.lead == rl.lead
        assert p.predicted_comm_bytes() == r.predicted_comm_bytes()
        assert p.predicted_apply_bytes() == r.predicted_apply_bytes()
        assert (p.schedule is None) == (r.schedule is None)
        if p.schedule is not None:
            assert p.schedule.order == r.schedule.order
            fields = [f.name for f in dataclasses.fields(program.PipelineStage)]
            assert [[getattr(s, f) for f in fields] for s in p.schedule.stages] == \
                [[getattr(s, f) for f in fields] for s in r.schedule.stages]
            assert all(s.compute_comm_bytes == 0 for s in r.schedule.stages)
            assert p.schedule.describe() == r.schedule.describe()
    # The block phase gathers nothing on these grids; the full phase's
    # gathers equal the plan's full-step bytes for the Muon leaves.
    assert prog.phase("block").predicted_comm_bytes() == 0
    plan = plan_comm(params, specs, case.mesh, block_specs=bspecs, **kw)
    assert prog.phase("full").predicted_comm_bytes() == plan.predicted_bytes("full")
    assert "predicted comm" in prog.summary()


def test_layer_shard_and_staggered_raise():
    """layer_shard compiles the engine's fold (and raises only where the
    reference's does: an axis the engine lacks); the staggered schedule
    raises only where the reference's does (no period), its mixed phases
    compiled beside 'block' and 'full'."""
    engine = make_engine({"w": torch.empty(4, 8, 8, device="meta")},
                         {"w": (None, None, "model")}, {"model": 2})
    ls = (program.LeafSpec(key=("w",), shape=(4, 8, 8), dtype="float32"),)
    with pytest.raises(ValueError, match="stagger_period >= 2"):
        program.compile_program(ls, engine=engine, full_schedule="staggered")
    prog = program.compile_program(ls, engine=engine, full_schedule="staggered",
                                   stagger_period=2)
    assert set(prog.phases) == {"block", "full", "stagger:0", "stagger:1"}
    assert prog.phase("stagger:0").due == (0,) and prog.phase("stagger:1").due == ()
    folded = program.compile_program(ls, engine=engine, layer_shard=(None, "model"))
    (op,) = folded.phase("full").ops
    assert op.comm.kind == "layer_shard" and op.packed_shape == (2, 8, 8)
    assert op.comm.collectives == (("all-gather", ("model",), 4 * 8 * 8 * 4),)
    assert all(o.comm is None for o in folded.phase("block").ops)
    with pytest.raises(ValueError, match="axis"):
        program.compile_program(ls, engine=engine, layer_shard=(None, "data"))


# ---------------------------------------------------------------------------
# bucketing.plan_buckets / bucketed_orthogonalize against the reference
# ---------------------------------------------------------------------------

def test_plan_buckets_and_bucketed_orthogonalize_match_reference():
    import jax.numpy as jnp
    from repro.core import bucketing as j_bucketing
    from repro.core.blocking import BlockSpec2D as JBS
    from repro.core.newton_schulz import orthogonalize_jnp

    from repro_torch.core.newton_schulz import orthogonalize_plain

    rng = np.random.default_rng(3)
    shapes = [(2, 32, 64), (32, 64), (3, 64, 32), (2, 32, 64), (16, 16)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grids = [BlockSpec2D(2, 2), None, BlockSpec2D(1, 2), None, BlockSpec2D(2, 1)]
    j_grids = [None if g is None else JBS(g.r, g.c) for g in grids]
    for mode in ("concat", "stack"):
        got = bucketing.plan_buckets([torch.from_numpy(x) for x in leaves], grids, mode)
        ref = j_bucketing.plan_buckets([jnp.asarray(x) for x in leaves], j_grids, mode)
        assert got == ref
        outs = bucketing.bucketed_orthogonalize([torch.from_numpy(x) for x in leaves], grids,
                                                orthogonalize_plain, mode)
        j_outs = j_bucketing.bucketed_orthogonalize([jnp.asarray(x) for x in leaves], j_grids,
                                                    orthogonalize_jnp, mode)
        for o, r in zip(outs, j_outs):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["granite_pod2_data2_model2", "olmoe_reduced"])
def test_opt_specs_match_reference(name):
    """ZeRO-1 specs of a whole optimizer state (Muon momentum, NorMuon's row
    statistics, AdamW's moments, the counters), leaf for leaf by the
    snapshot key both packages share."""
    from repro.core import adamw as j_adamw
    from repro.core import combine as j_combine
    from repro.core import muon as j_muon
    from repro.distributed import zero1 as j_zero1
    from repro_torch.core import adamw, combine, muon
    from repro_torch.distributed import zero1
    from repro_torch.training.checkpoint import map_leaves

    case = CASES[name]
    _, _, a_params, mesh, j_specs, params, specs = _setup(case)
    j_opt = j_combine({"muon": j_muon(0.02, variant="normuon"), "adamw": j_adamw(0.01)},
                      j_label_tree(a_params))
    a_opt = jax.eval_shape(j_opt.init, a_params)
    ref = j_zero1.opt_specs(a_opt, a_params, mesh, pspecs=j_specs, zero1=True)
    ref_by_key = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
        for path, spec in jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: isinstance(x, P))[0]}
    opt = combine({"muon": muon(0.02, variant="normuon"), "adamw": adamw(0.01)},
                  label_tree(params))
    got = zero1.opt_specs(opt.init(params), params, case.mesh, pspecs=specs, zero1=True)
    got_by_key: dict = {}
    map_leaves(lambda key, spec: got_by_key.__setitem__(key, spec), got)
    assert got_by_key == ref_by_key
