"""The layer_shard fold of the full step (``muon(layer_shard=(mesh, axis))``).

Held:

* ``compile_program(layer_shard=)`` against the reference's on the same
  engine shapes: the rank's share of a padded stack, the fold's collectives
  (``layer_shard_collectives(mode='engine')``), no fold of a 2-D leaf or of
  the block phase, the ZeRO-1 skip, the unknown axis, the pipeline stages'
  ``compute_comm_bytes``; without an engine an axis of size one compiles as
  the reference's does and a larger one raises, naming the engine;
* one rank: the fold on an axis of size one against ``muon_full`` and the
  reference's one-device fold (max abs 1e-5);
* one gloo world of four ranks on ``data=2,model=2`` and ``data=4``
  (reduced muonbp-960m at 3 layers, so that stacks of 3 pad to 4): the
  folded full update, pipelined and barrier, against the reference's
  single-device update (max abs 1e-5) and against the port's update
  without the fold (1e-5 of each leaf's max; the ranks report whether it
  is bitwise), and its trace: the 'full' gathers equal the plan plus the
  fold's ``layer_shard_collectives``, stage by stage.
"""

import dataclasses
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import adamw as j_adamw
from repro.core import combine as j_combine
from repro.core import label_tree as j_label_tree
from repro.core import muon as j_muon
from repro.core import program as j_program
from repro.models.model import init_params as j_init_params
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, combine, label_tree, muon, muon_full, program
from repro_torch.distributed import layer_shard_collectives, plan_comm
from repro_torch.sharding import specs as sh

ARCH = "muonbp-960m"
LAYERS = 3           # stacks of 3 (and 6) layers pad over 2 and 4 ranks
MESHES = ("data=2,model=2", "data=4")
REF_TOL = 1e-5       # port vs reference, max abs (tests/test_torch_optim.py)
FOLD_TOL = 1e-5      # folded vs unfolded, of each leaf's max|update|


class _Engine:
    """The duck-typed engine the compiler reads (replicated specs, or the
    lead dim over 'data' as ZeRO-1 lays it)."""

    def __init__(self, sizes, lead=None):
        self.axis_sizes = sizes
        self.lead = lead

    def spec_for(self, key, ndim):
        return (self.lead,) + (None,) * (ndim - 1)

    def flatten_for(self, key):
        return None


class _JEngine(_Engine):
    def spec_for(self, key, ndim):
        return P(*super().spec_for(key, ndim))


def _specs(mod):
    return (mod.LeafSpec(key=("w",), shape=(6, 16, 32), dtype="float32"),
            mod.LeafSpec(key=("v",), shape=(24, 24), dtype="float32"))


def test_compile_program_fold_matches_reference():
    prog = program.compile_program(_specs(program), engine=_Engine({"data": 4}),
                                   layer_shard=(None, "data"))
    ref = j_program.compile_program(_specs(j_program), backend="jnp",
                                    engine=_JEngine({"data": 4}), layer_shard=(object(), "data"))
    full = {op.leaves[0].index: op for op in prog.phase("full").ops}
    j_full = {op.leaves[0].index: op for op in ref.phase("full").ops}
    # 6 layers pad to 8 over 4 ranks: each rank orthogonalizes 2.
    assert full[0].packed_shape == j_full[0].packed_shape == (2, 16, 32)
    assert full[0].comm.kind == j_full[0].comm.kind == "layer_shard"
    assert full[0].comm.collectives == j_full[0].comm.collectives == layer_shard_collectives(
        (6, 16, 32), "data", 4, mode="engine")
    # A 2-D leaf has no layer dim to split; the block phase never folds.
    assert full[1].comm is None and j_full[1].comm is None
    assert all(op.comm is None for op in prog.phase("block").ops)
    assert prog.phase("full").predicted_comm_bytes() == ref.phase("full").predicted_comm_bytes()
    stages = [(s.gathers, s.compute, s.writeback, s.gather_bytes, s.compute_comm_bytes)
              for s in prog.phase("full").schedule.stages]
    j_stages = [(s.gathers, s.compute, s.writeback, s.gather_bytes, s.compute_comm_bytes)
                for s in ref.phase("full").schedule.stages]
    assert stages == j_stages and any(s[-1] for s in stages)
    assert prog.phase("full").schedule.describe() == ref.phase("full").schedule.describe()
    assert "comm=layer_shard" in prog.summary()

    # ZeRO-1 already splits the lead dim over 'data': no fold, either side.
    zero1 = program.compile_program(_specs(program)[:1], engine=_Engine({"data": 2}, "data"),
                                    layer_shard=(None, "data"))
    j_zero1 = j_program.compile_program(_specs(j_program)[:1], backend="jnp",
                                        engine=_JEngine({"data": 2}, "data"),
                                        layer_shard=(object(), "data"))
    assert all(op.comm is None for op in zero1.phase("full").ops)
    assert all(op.comm is None for op in j_zero1.phase("full").ops)

    for compile_fn, specs, eng in ((program.compile_program, _specs(program), _Engine),
                                   (j_program.compile_program, _specs(j_program), _JEngine)):
        with pytest.raises(ValueError, match="axis"):
            compile_fn(specs, engine=eng({"data": 4}), layer_shard=(object(), "pod"))

    # Without an engine: an axis of one compiles as the reference's (inert,
    # the stack flattened); a larger one raises, naming the engine.
    one = program.compile_program(_specs(program), layer_shard=({"data": 1}, "data"))
    j_one = j_program.compile_program(_specs(j_program), backend="jnp",
                                      layer_shard=(jax.make_mesh((1,), ("data",)), "data"))
    for phase in ("block", "full"):
        got = [(op.packed_shape, op.comm and (op.comm.kind, op.comm.collectives))
               for op in one.phase(phase).ops]
        want = [(op.packed_shape, op.comm and (op.comm.kind, op.comm.collectives))
                for op in j_one.phase(phase).ops]
        assert got == want
    with pytest.raises(ValueError, match="engine"):
        program.compile_program(_specs(program), layer_shard=({"data": 2}, "data"))


def test_one_rank_fold_matches_muon_full():
    g_np = np.random.default_rng(0).standard_normal((3, 16, 24)).astype(np.float32)
    g = torch.from_numpy(g_np)
    zeros = {"w": torch.zeros_like(g)}
    plain = muon_full(0.1, rms_match=False)
    folded = muon(0.1, 0.1, period=1, rms_match=False, layer_shard=({"data": 1}, "data"))
    u1, _ = plain.update({"w": g}, plain.init({"w": g}), zeros, "full")
    u2, _ = folded.update({"w": g}, folded.init({"w": g}), zeros, "full")
    assert float((u1["w"] - u2["w"]).abs().max()) <= REF_TOL
    # The reference re-shards with with_sharding_constraint, which this JAX
    # takes on an Auto axis only (jax.make_mesh's default is Explicit: the
    # reference's own tests/test_perf_features.py case fails on it here).
    mesh = jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    j_opt = j_muon(0.1, 0.1, period=1, rms_match=False, layer_shard=(mesh, "data"))
    jg = {"w": jnp.asarray(g_np)}
    ju, _ = jax.jit(lambda gr, st: j_opt.update(gr, st, {"w": jnp.zeros_like(gr["w"])},
                                                "full"))(jg, j_opt.init(jg))
    assert float(np.abs(np.asarray(ju["w"]) - u2["w"].numpy()).max()) <= REF_TOL


# ---------------------------------------------------------------------------
# One gloo world of four ranks: data=2,model=2 and data=4
# ---------------------------------------------------------------------------

def _cfg(jax_side: bool = False):
    cfg = (j_get_config if jax_side else get_config)(ARCH).reduced()
    return dataclasses.replace(cfg, num_layers=LAYERS)


def _optimizer(params, comm=None, layer_shard=None, schedule="pipelined"):
    return combine({"muon": muon(0.02, 0.02, period=5, weight_decay=0.1, comm=comm,
                                 layer_shard=layer_shard, full_schedule=schedule),
                    "adamw": adamw(0.008, weight_decay=0.1, comm=comm)}, label_tree(params))


def _rank_main(rank, port, params_np, grads_np, queue):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=4)
        try:
            out = {spec: _rank_case(rank, spec, params_np, grads_np) for spec in MESHES}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_case(rank, spec, params_np, grads_np) -> dict:
    from repro_torch.distributed import assert_pipelined_matches_plan, make_engine
    from repro_torch.launch.mesh import make_mesh_from_spec

    cfg = _cfg()
    mesh = make_mesh_from_spec(spec)
    sizes = sh.mesh_axis_sizes(mesh)
    params = interop.params_from_numpy(params_np, device="cpu")
    grads = interop.params_from_numpy(grads_np, device="cpu")
    pspecs = sh.param_specs(params, cfg, sizes)
    plan = plan_comm(params, pspecs, sizes)
    labels = dict(tree_lib.flatten_with_path(label_tree(params)))
    leaf_specs = tuple(program.LeafSpec(key=k, shape=tuple(p.shape), dtype="float32")
                       for k, p in tree_lib.flatten_with_path(params) if labels[k] == "muon")
    engine = make_engine(params, pspecs, mesh)
    trace = engine.comm.trace
    if engine.tensor_parallel:
        cut = lambda tree: tree_lib.map_with_path(
            lambda k, p: engine.cut(p, engine.pspec_by_path[k]), tree)
        params, grads = cut(params), cut(grads)
    fold = (mesh, "data")
    folded = program.compile_program(leaf_specs, engine=engine, layer_shard=fold)
    unfolded = program.compile_program(leaf_specs, engine=engine)
    out: dict = {"errors": [], "bitwise": {}, "padded": [], "full_bytes": {}}
    # Each folded bucket is the unfolded one's packed stack, split.
    for op, base in zip(folded.phase("full").ops, unfolded.phase("full").ops):
        want = layer_shard_collectives(base.packed_shape, "data", sizes["data"], mode="engine")
        if (op.comm.collectives if op.comm else ()) != want:
            out["errors"].append(f"{op.bucket_key}: {op.comm} against {want}")
        stack = int(np.prod(base.packed_shape[:-2]))
        if len(base.packed_shape) >= 3 and stack % sizes["data"]:
            out["padded"].append(base.packed_shape)
    updates = {}
    for name, ls in (("fold", fold), ("plain", None)):
        for schedule in ("pipelined", "barrier"):
            trace.step = (name, schedule)
            opt = _optimizer(params, engine, ls, schedule)
            upd, _ = opt.update(grads, opt.init(params), params, "full")
            updates[(name, schedule)] = {k: engine.to_param_layout(k, u)
                                         for k, u in tree_lib.flatten_with_path(upd)}
            prog = folded if ls else unfolded
            try:
                out["full_bytes"][(name, schedule)] = assert_pipelined_matches_plan(
                    trace, prog.phase("full") if schedule == "pipelined" else dataclasses.replace(
                        prog.phase("full"), schedule=None), plan, step=(name, schedule))
            except AssertionError as e:
                out["errors"].append(f"{name}/{schedule}: {e}")
    for schedule in ("pipelined", "barrier"):
        a, b = updates[("fold", schedule)], updates[("plain", schedule)]
        out["bitwise"][schedule] = all(torch.equal(a[k], b[k]) for k in a)
    if rank == 0:
        join = ((lambda k, t: engine.join(t, engine.pspec_by_path[k], phase="check"))
                if engine.tensor_parallel else (lambda k, t: t))
        for key, upd in updates.items():
            out[key] = {"/".join(k): join(k, u).numpy().copy() for k, u in upd.items()}
    else:
        for upd in updates.values():
            for k, u in upd.items():
                if engine.tensor_parallel:
                    engine.join(u, engine.pspec_by_path[k], phase="check")
    return out


@pytest.fixture(scope="module")
def world():
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), _cfg(True)))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    queue = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank_main, args=(port, params, grads, queue), nprocs=4,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(4))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    # The reference's single-device full update on the whole tree.
    j_params = jax.tree.map(jnp.asarray, params)
    j_grads = jax.tree.map(jnp.asarray, grads)
    j_opt = j_combine({"muon": j_muon(0.02, 0.02, period=5, weight_decay=0.1),
                       "adamw": j_adamw(0.008, weight_decay=0.1)}, j_label_tree(j_params))
    j_upd, _ = jax.jit(lambda g, s, p: j_opt.update(g, s, p, "full"))(
        j_grads, j_opt.init(j_params), j_params)
    ref = {"/".join(k): np.asarray(v) for k, v in tree_lib.flatten_with_path(
        jax.tree.map(np.asarray, j_upd))}
    return results, ref


@pytest.mark.parametrize("spec", MESHES)
def test_folded_full_update_matches_reference_and_unfolded(world, spec):
    results, ref = world
    r0 = results[0][spec]
    assert r0["padded"], "no packed stack pads at this depth"
    for schedule in ("pipelined", "barrier"):
        got, plain = r0[("fold", schedule)], r0[("plain", schedule)]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            assert float(np.abs(got[k] - v).max()) <= REF_TOL, (schedule, k)
            scale = float(np.abs(plain[k]).max())
            assert float(np.abs(got[k] - plain[k]).max()) <= FOLD_TOL * scale, (schedule, k)
    # The ranks report the fold against the unfolded update, bitwise or not;
    # every rank sees the same.
    assert len({tuple(sorted(r[spec]["bitwise"].items())) for r in results.values()}) == 1


@pytest.mark.parametrize("spec", MESHES)
def test_fold_trace_is_plan_plus_layer_shard_collectives(world, spec):
    results, _ = world
    for rank, res in results.items():
        r = res[spec]
        assert r["errors"] == [], (rank, r["errors"])
        fold = sum(r["full_bytes"][("fold", "pipelined")].values())
        plain = sum(r["full_bytes"][("plain", "pipelined")].values())
        # data=4 holds whole leaves: its plain full step gathers nothing.
        assert fold > plain >= 0 and (plain > 0) == ("model" in spec)
        assert sum(r["full_bytes"][("fold", "barrier")].values()) == fold
        # Barrier steps gather outside any stage.
        assert set(r["full_bytes"][("fold", "barrier")]) == {None}
