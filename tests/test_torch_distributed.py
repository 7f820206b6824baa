"""The distributed MuonBP engine on multi-process ``gloo`` worlds on the CPU.

Each world runs once per module (a fixture spawns its ranks, which run
every case and hand back results): ``model=2`` (2 ranks) and
``data=2,model=2`` with ZeRO-1 here; ``data=2,model=2`` with the ZeRO-1
flatten fallback at 3 layers (NorMuon, padded row statistics) and
``pod=2,model=2`` with ZeRO-1 over ``pod`` (Turbo-Muon) in
``tests/test_torch_distributed_fallback.py``, whose one world of four ranks
runs both meshes with these checks. Everything runs the reduced muonbp-960m from the
reference's weights, fp32, on the kernels' plain versions.

Held:

* the engine's update (gathered to full on rank 0) against the single-process
  port's update on the same gradients and block grid, both phases: bitwise
  for the baseline (block units are the same matrices, every product
  batch-independent on these shapes), to a relative 1e-6 of max|update|
  where the epilogue reduces over ranks (NorMuon's sums, Turbo-Muon's
  batched power iteration); on ``model=2``, both phases also against the
  reference's single-device ``muon(block_specs=...)`` at the port's update
  tolerance (``tests/test_torch_optim.py``, max abs 1e-5);
* pipelined against barrier (``torch.equal``);
* the collective trace against ``plan_comm``, to the byte: no optimizer
  collective on block steps, the full-step gathers and the 'apply' gathers
  per axis set as planned; the gradient reduce and the checks' joins kept
  apart (the launcher runs the dense model tensor-parallel: its trace has
  the ``tp`` collectives and none of a class the port does not record);
* momentum shards and the flatten fallback's pad layers (exactly zero);
* the launcher under ``--mesh`` (fp32 compute) against the single-process
  launcher on the same global batch: losses to 1e-5 relative;
* snapshots: one written on a mesh restores on one process, and one written
  on one process restores into a mesh's shards, bitwise, the same shards
  ``zero1.shard_state`` cuts from the whole restored state;
* a gather or cut over several axes at once (a spec entry naming both
  axes) against the layout it must reproduce;
* Dion builds under ``--mesh`` and raises on the staggered schedule.
"""

import dataclasses
import os
import socket
import traceback

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import muon as j_muon
from repro.models.model import init_params as j_init_params
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import label_tree, muon
from repro_torch.distributed import plan_comm
from repro_torch.distributed.audit import PHASES as TRACE_PHASES
from repro_torch.sharding import specs as sh
from repro_torch.training import checkpoint

ARCH = "muonbp-960m"
PHASES = ("full", "block", "full")
REL_TOL = 1e-6       # engine vs single process where the epilogue reduces over ranks
REF_TOL = 1e-5       # port vs reference, max abs (tests/test_torch_optim.py)
LOSS_TOL = 1e-5      # launcher on a mesh vs one process, relative, fp32 compute
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
          "--period", "2", "--compute-dtype", "float32", "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    zero1: bool = False
    flatten: bool = False
    layers: int = 0
    variants: tuple = (None,)


WORLDS = {
    "model2": World("model=2"),
    "data2_model2_zero1": World("data=2,model=2", zero1=True, variants=(None, "normuon")),
    "data2_model2_flatten": World("data=2,model=2", zero1=True, flatten=True, layers=3,
                                  variants=("normuon",)),
    "pod2_model2": World("pod=2,model=2", zero1=True, variants=("turbo_muon",)),
}


def _cfg(world: World, jax_side: bool = False):
    cfg = (j_get_config if jax_side else get_config)(ARCH).reduced()
    return dataclasses.replace(cfg, num_layers=world.layers) if world.layers else cfg


def _case(world: World):
    """(numpy params from the reference's init, numpy gradients)."""
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), _cfg(world, True)))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    return params, grads


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _block_specs(params, cfg, sizes):
    labels = label_tree(params)
    bspecs = sh.block_specs_for(params, sh.param_specs(params, cfg, sizes), sizes)
    return tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)


def _muon_only(tree, labels):
    return tree_lib.tree_map(lambda x, l: x if l == "muon" else None, tree, labels)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_argv(world: World) -> list:
    argv = LAUNCH + ["--mesh", world.spec]
    if world.zero1:
        argv.append("--zero1")
    if world.flatten:
        argv.append("--zero1-flatten")
    return argv


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, port, names, cases, queue):
    """One rank of a world that runs the cases of the worlds ``names`` (one
    spec each, all of ``world_size`` ranks), one after the other."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world_size)
        try:
            out = {name: _rank_cases(rank, WORLDS[name], *cases[name]) for name in names}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world, params_np, grads_np, tmp) -> dict:
    from repro_torch.core import adamw, combine
    from repro_torch.distributed import make_engine
    from repro_torch.distributed import zero1 as zero1_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh, make_mesh_from_spec
    from repro_torch.obs import MemorySink

    out: dict = {}
    mesh = make_mesh_from_spec(world.spec)
    sizes = sh.mesh_axis_sizes(mesh)
    if "pod" not in sizes:   # the same mesh over the whole world
        local = make_local_mesh(model=sizes["model"])
        out["local_mesh"] = sh.mesh_axis_sizes(local) == {"data": 1, **sizes}
    cfg = _cfg(world)
    params = interop.params_from_numpy(params_np, device="cpu")
    grads = interop.params_from_numpy(grads_np, device="cpu")
    labels = label_tree(params)
    pspecs = sh.param_specs(params, cfg, sizes)
    bspecs = _block_specs(params, cfg, sizes)
    kw = dict(zero1=world.zero1, zero1_flatten=world.flatten)
    engine = make_engine(params, pspecs, mesh, **kw)
    trace = engine.comm.trace
    # On a model split each rank holds its param-layout shards.
    cut = lambda tree: tree_lib.map_with_path(
        lambda k, p: engine.cut(p, engine.pspec_by_path[k]), tree)
    params, grads = cut(params), cut(grads)

    # The update, both schedules, every variant of the world.
    for variant in world.variants:
        for schedule in ("pipelined", "barrier"):
            opt = combine({"muon": muon(0.02, 0.02, period=5, weight_decay=0.1,
                                        block_specs=bspecs, comm=engine,
                                        full_schedule=schedule, variant=variant),
                           "adamw": adamw(0.008, weight_decay=0.1, comm=engine)}, labels)
            state = opt.init(params)
            shapes = {k: tuple(v.shape) for k, v in state.inner["muon"].momentum.items()}
            for step, phase in enumerate(PHASES):
                trace.step = (variant, schedule, step)
                upd, state = opt.update(grads, state, params, phase)
                full = {k: engine.join(engine.to_param_layout(k, u), engine.pspec_by_path[k],
                                       phase="check")
                        for k, u in tree_lib.flatten_with_path(upd)}
                if rank == 0:
                    out[("update", variant, schedule, step)] = {
                        k: v.numpy().copy() for k, v in full.items()}
            pad_zero = True
            for k, m in state.inner["muon"].momentum.items():
                fl = engine.flatten_for(k)
                if fl is not None:   # this rank's rows past the true lead
                    start = engine.comm.index(fl.axes) * m.shape[0]
                    pad_zero &= not bool(m[max(0, fl.lead - start):].any())
            out[("momentum", variant)] = (shapes, pad_zero)
    out["trace"] = list(trace.events)

    # A gather and a cut over both axes at once, each dim in turn.
    names = tuple(sizes)
    base = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    for dim in range(3):
        spec = [None, None, None]
        spec[dim] = names
        piece = engine.cut(base, tuple(spec))
        whole = engine.join(piece, tuple(spec), phase="check")
        out[("roundtrip", dim)] = bool(torch.equal(whole, base))
        joint = engine.comm.all_gather(piece, names, dim=dim, phase="check")
        out[("joint", dim)] = bool(torch.equal(joint, base))

    # Dion builds on the mesh and refuses the staggered schedule there.
    train.build_optimizer("dion", params, lr=0.02, adam_lr=0.008, period=5, comm=engine)
    try:
        train.build_optimizer("dion", params, lr=0.02, adam_lr=0.008, period=5,
                              comm=engine, full_schedule="staggered")
        out["dion"] = None
    except ValueError as e:
        out["dion"] = str(e)

    # The launcher on the mesh, a snapshot every 2 steps.
    ckpt = os.path.join(tmp, "mesh_ckpt")
    argv = _launch_argv(world) + ["--checkpoint-every", "2", "--checkpoint-dir", ckpt]
    sink = MemorySink()
    run = train.run(argv, cfg=cfg, sinks=[sink])
    out["losses"] = [r["loss"] for r in run.records]
    out["launch_trace"] = list(run.engine.comm.trace.events)
    full_state = zero1_lib.gather_state(run.state.opt_state, run.state.params, run.engine,
                                        phase="check")
    # The dense model runs tensor-parallel: each rank holds its shards.
    full_params = zero1_lib.gather_params(run.state.params, run.engine, phase="check")
    if rank == 0:
        out["final_state"] = checkpoint._flatten(full_state)
        out["final_params"] = checkpoint._flatten(full_params)
    out["spans"] = sorted({r["name"] for r in sink.records if r.get("event") == "span"})

    # A snapshot written on one process, cut into this rank's shards
    # (the run's own state is the template).
    snap = checkpoint.list_snapshots(os.path.join(tmp, "single_ckpt"))[-1][1]
    opt_t = run.state.opt_state
    shardings = zero1_lib.opt_shardings(opt_t, run.state.params, run.engine)
    _, r_opt, _ = checkpoint.restore(snap, run.state.params, opt_t,
                                     opt_shardings=shardings, engine=run.engine)
    flat_disk = dict(np.load(os.path.join(snap, "opt_state.npz")))
    back = checkpoint._flatten(zero1_lib.gather_state(r_opt, run.state.params, run.engine,
                                                     phase="check"))
    out["restore_into_mesh"] = all(
        np.array_equal(arr, checkpoint._fit_lead(flat_disk[k], arr.shape, k))
        for k, arr in back.items())
    # The same snapshot restored whole, then cut by zero1.shard_state:
    # the shards restore cut.
    full_t = zero1_lib.gather_state(opt_t, run.state.params, run.engine, phase="check")
    _, full_r, _ = checkpoint.restore(snap, full_params, full_t)
    cut = checkpoint._flatten(zero1_lib.shard_state(full_r, run.state.params, run.engine))
    restored = checkpoint._flatten(r_opt)
    out["shard_state_is_restore"] = cut.keys() == restored.keys() and all(
        np.array_equal(cut[k], restored[k]) for k in cut)
    return out


def run_worlds(names, tmp_path_factory) -> dict:
    """Spawn one gloo world of the worlds ``names`` (their meshes of one
    size) whose ranks run every name's cases in turn; each name's results
    as ``world_run`` gives them. Before it, each name's single-process
    launcher run, which the launcher on its mesh is held to, with the
    snapshot its ranks restore."""
    from repro_torch.launch import train

    cases, singles = {}, {}
    for name in names:
        world = WORLDS[name]
        params_np, grads_np = _case(world)
        tmp = str(tmp_path_factory.mktemp(name))
        singles[name] = train.run(LAUNCH + ["--mesh-model", str(_sizes(world).get("model", 1)),
                                            "--checkpoint-every", "2", "--checkpoint-dir",
                                            os.path.join(tmp, "single_ckpt")], cfg=_cfg(world))
        cases[name] = (params_np, grads_np, tmp)
    sizes = {int(np.prod(list(_sizes(WORLDS[name]).values()))) for name in names}
    assert len(sizes) == 1, f"{names}: one world runs meshes of one size"
    n = sizes.pop()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(n, _free_port(), tuple(names), cases, queue),
                               nprocs=n, start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(n))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return {name: (name, WORLDS[name], *cases[name][:2],
                   {rank: res[name] for rank, res in results.items()}, cases[name][2],
                   [r["loss"] for r in singles[name].records])
            for name in names}


# The worlds of this module; tests/test_torch_distributed_fallback.py runs
# the others, with these checks.
NAMES = ("data2_model2_zero1", "model2")


@pytest.fixture(scope="module", params=NAMES)
def world_run(request, tmp_path_factory):
    return run_worlds((request.param,), tmp_path_factory)[request.param]


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def _single_process_updates(world, params_np, grads_np, variant):
    cfg = _cfg(world)
    params = interop.params_from_numpy(params_np, device="cpu")
    grads = interop.params_from_numpy(grads_np, device="cpu")
    from repro_torch.core import adamw, combine

    labels = label_tree(params)
    opt = combine({"muon": muon(0.02, 0.02, period=5, weight_decay=0.1,
                                block_specs=_block_specs(params, cfg, _sizes(world)),
                                variant=variant),
                   "adamw": adamw(0.008, weight_decay=0.1)}, labels)
    state = opt.init(params)
    outs = []
    for phase in PHASES:
        upd, state = opt.update(grads, state, params, phase)
        outs.append({k: v.numpy() for k, v in tree_lib.flatten_with_path(upd)})
    return outs


def test_engine_update_matches_single_process(world_run):
    name, world, params_np, grads_np, results, _, _ = world_run
    r0 = results[0]
    for variant in world.variants:
        ref = _single_process_updates(world, params_np, grads_np, variant)
        for step in range(len(PHASES)):
            got = r0[("update", variant, "pipelined", step)]
            assert sorted(got) == sorted(ref[step])
            scale = max(float(np.abs(v).max()) for v in ref[step].values())
            for k, v in ref[step].items():
                if variant is None:
                    assert np.array_equal(got[k], v), (variant, PHASES[step], k)
                else:
                    err = float(np.abs(got[k] - v).max())
                    assert err <= REL_TOL * scale, (variant, PHASES[step], k, err / scale)


def test_pipelined_equals_barrier(world_run):
    _, world, _, _, results, _, _ = world_run
    r0 = results[0]
    for variant in world.variants:
        for step in range(len(PHASES)):
            a = r0[("update", variant, "pipelined", step)]
            b = r0[("update", variant, "barrier", step)]
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_trace_matches_plan_to_the_byte(world_run):
    from repro_torch.distributed.audit import (CollectiveTrace, assert_matches_plan_by_axes,
                                               bytes_by_link)

    _, world, params_np, _, results, _, _ = world_run
    params = interop.params_from_numpy(params_np, device="cpu")
    cfg = _cfg(world)
    sizes = _sizes(world)
    plan = plan_comm(params, sh.param_specs(params, cfg, sizes), sizes,
                     block_specs=_block_specs(params, cfg, sizes), zero1=world.zero1,
                     zero1_flatten=world.flatten)
    assert plan.predicted_bytes("block") == 0
    assert plan.predicted_bytes("full") > 0
    for rank, res in results.items():
        trace = CollectiveTrace()
        trace.events = res["trace"]
        for variant in world.variants:
            for schedule in ("pipelined", "barrier"):
                for step, phase in enumerate(PHASES):
                    key = (variant, schedule, step)
                    assert_matches_plan_by_axes(trace, plan, phase, step=key)
                    assert_matches_plan_by_axes(trace, plan, "apply", step=key)
                    other = {e.phase for e in trace.select(None, step=key)}
                    assert other <= {phase, "apply", "check", "normuon", "norm"}, other
                    # AdamW's clipping norm over the vocab-split embedding
                    # and head: one fp32 scalar summed over the model axis.
                    assert [(e.kind, e.bytes) for e in trace.select("norm", step=key)] == [
                        ("all-reduce", 4)]
                    if phase == "block":
                        assert not trace.select("block", step=key)
                    assert bytes_by_link(trace, phase, step=key) == plan.predicted_by_link(phase)
                    if schedule == "pipelined" and phase == "full":
                        assert all(e.stage is not None for e in trace.select("full", step=key))
        if "launch_trace" in res:
            trace.events = res["launch_trace"]
            for step in range(3):
                phase = "full" if step % 2 == 0 else "block"
                assert_matches_plan_by_axes(trace, plan, (phase, "apply"), step=step)
                if any(s > 1 for a, s in sizes.items() if a in ("pod", "data")):
                    assert trace.select("grad_reduce", step=step)
                # The dense model runs tensor-parallel; every collective is
                # of a class the port records.
                assert trace.select("tp", step=step)
                assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


def test_momentum_shards_and_pad_layers(world_run):
    _, world, params_np, _, results, _, _ = world_run
    params = interop.params_from_numpy(params_np, device="cpu")
    sizes = _sizes(world)
    specs = sh.param_specs(params, _cfg(world), sizes)
    labels = label_tree(params)
    for rank, res in results.items():
        for variant in world.variants:
            shapes, pad_zero = res[("momentum", variant)]
            assert pad_zero
            for path, shape in shapes.items():
                p = dict(tree_lib.flatten_with_path(params))[path]
                spec = dict(tree_lib.flatten_with_path(specs))[path]
                fl = (sh.zero1_flatten_info(spec, p.shape, sizes, zero1_axis=None)
                      if world.flatten else None)
                full = fl.padded_shape(p.shape) if fl else tuple(p.shape)
                uspec = (sh.flatten_momentum_spec(spec, p.shape, fl) if fl else
                         sh.momentum_spec(spec, p.shape, sizes, zero1=world.zero1,
                                          zero1_axis=None, label="muon"))
                assert shape == sh.local_shape(uspec, full, sizes), path
                if world.zero1 and len(shape) >= 3:
                    assert shape[0] < full[0], path   # the lead dim is split


def test_multi_axis_gather_and_cut(world_run):
    _, _, _, _, results, _, _ = world_run
    for res in results.values():
        for dim in range(3):
            assert res[("roundtrip", dim)] and res[("joint", dim)]


def test_make_local_mesh_spans_the_world(world_run):
    _, world, _, _, results, _, _ = world_run
    for res in results.values():
        assert res.get("local_mesh", "pod" in world.spec) is True


def test_dion_on_a_mesh_raises(world_run):
    """Dion builds on a mesh (``tests/test_torch_dion_mesh.py`` holds its
    steps there) and still raises on the staggered schedule, as the
    reference does."""
    _, _, _, _, results, _, _ = world_run
    for res in results.values():
        assert "no per-leaf full-step gathers to stagger" in res["dion"]


def test_launcher_on_a_mesh_matches_one_process(world_run):
    _, _, _, _, results, _, ref = world_run
    for rank, res in results.items():
        np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_TOL, atol=0)
        assert res["losses"] == results[0]["losses"]
    assert {"train.grad_reduce", "train.apply", "muonbp.full.s1.ns"} <= set(results[0]["spans"])


def test_snapshots_cross_between_mesh_and_one_process(world_run):
    from repro_torch.core import adamw, combine
    from repro_torch.training.train_step import init_train_state

    _, world, params_np, _, results, tmp, _ = world_run
    # Mesh -> one process: the last snapshot restores into single-process
    # templates equal to the mesh's final state gathered on rank 0.
    snap = checkpoint.list_snapshots(os.path.join(tmp, "mesh_ckpt"))[-1][1]
    params = interop.params_from_numpy(params_np, device="cpu")
    labels = label_tree(params)
    variant = None
    opt = combine({"muon": muon(0.02, 0.02, period=2, weight_decay=0.1, variant=variant),
                   "adamw": adamw(0.008, weight_decay=0.1)}, labels)
    tpl = init_train_state(params, opt)
    r_params, r_opt, step = checkpoint.restore(snap, tpl.params, tpl.opt_state)
    assert step == 2
    saved = results[0]["final_state"]
    for k, arr in checkpoint._flatten(r_opt).items():
        assert np.array_equal(arr, checkpoint._fit_lead(saved[k], arr.shape, k)), k
    for k, arr in checkpoint._flatten(r_params).items():
        assert np.array_equal(arr, results[0]["final_params"][k]), k
    # One process -> mesh: every rank's shards gather back to the file's leaves,
    # and zero1.shard_state of the whole restored state gives the same shards.
    assert all(res["restore_into_mesh"] for res in results.values())
    assert all(res["shard_state_is_restore"] for res in results.values())


def test_engine_update_matches_reference_single_device(world_run):
    """The engine's Muon updates against the reference's single-device
    ``muon(block_specs=..., variant=...)`` on the same weights and grads."""
    name, world, params_np, grads_np, results, _, _ = world_run
    cfg = _cfg(world)
    labels = label_tree(params_np)
    bspecs = _block_specs(params_np, cfg, _sizes(world))
    j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), bspecs)
    p = _muon_only(params_np, labels)
    g = _muon_only(grads_np, labels)
    for variant in world.variants:
        ref = j_muon(0.02, 0.02, period=5, weight_decay=0.1, block_specs=j_bspecs,
                     variant=variant)
        state = ref.init(p)
        for step, phase in enumerate(PHASES):
            upd, state = ref.update(g, state, p, phase)
            got = results[0][("update", variant, "pipelined", step)]
            for path, r in tree_lib.flatten_with_path(upd):
                np.testing.assert_allclose(got[path], np.asarray(r), rtol=0, atol=REF_TOL,
                                           err_msg=f"{variant} {phase} {path}")


def test_launcher_refusals(monkeypatch):
    """No card without --device cpu; nccl with more ranks than cards; gspmd;
    --zero1 without a mesh."""
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.run(["--reduced", "--mesh", "model=2", "--steps", "1"])
    monkeypatch.setenv("WORLD_SIZE", str(torch.cuda.device_count() + 1))
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="nccl needs a card a rank"):
        train.run(["--reduced", "--device", "cpu", "--mesh", "model=2", "--dist-backend",
                   "nccl", "--steps", "1"])
    with pytest.raises(ValueError, match="gspmd"):
        train.run(["--reduced", "--device", "cpu", "--mesh", "model=2", "--comm-engine",
                   "gspmd", "--steps", "1"])
    with pytest.raises(ValueError, match="--mesh"):
        train.run(["--reduced", "--device", "cpu", "--zero1", "--steps", "1"])
