"""The staggered full-step schedule on one four-rank ``gloo`` world on the CPU.

One world a module runs both meshes in turn, every case on the reduced
muonbp-960m from the reference's weights, fp32, on the kernels' plain
versions, the model's Muon leaves in the rank's param-layout shards
(tensor-parallel, as the launcher holds them):

* ``data=2,model=2`` with ZeRO-1 (``muon`` and ``normuon``), and with the
  ZeRO-1 flatten fallback at 3 layers;
* ``pod=2,model=2`` with ZeRO-1 over ``pod`` (the gathers over ``pod`` are
  the inter-pod link's, which the offsets balance first).

Held, as the reference's ``tests/test_stagger.py`` states them (its own
eight-device run fails on this tree, ROADMAP section 3):

* each residue's update, gathered on rank 0, per leaf against the
  reference's single-device synchronous update: the leaves due at the
  residue against its ``full`` update, every other against its ``block``
  update, max abs 1e-5 (``tests/test_torch_distributed.py``'s tolerance
  against the reference); NorMuon refreshes the due leaves only;
* each residue's traced bytes, per axis set and with the 'apply' gathers,
  equal ``plan.predicted_by_axes('staggered', period=, residue=)`` exactly
  (``audit.assert_staggered_matches_plan``), on every rank; the program's
  offsets are the plan's;
* after one period with constant gradients, weight decay 0 and constant
  LRs, the staggered parameters equal the synchronous ones to 1e-5 and the
  momentum to 1e-6 (the reference's bounds; see its module docstring);
* ZeRO-1 with the flatten fallback agrees per leaf with the plain engine,
  each along its own offset map, to 1e-5, its bytes the plan's too;
* the launcher with ``--full-schedule staggered --guard`` and NaN gradients
  at step 1: every step runs its phase (the skipped step's escalation
  forces step 2 to the compiled 'full'), a skipped stagger step issues only
  the classes of a skipped step (grad reduce, ``tp``, ``norm``, ``guard``),
  every healthy stagger step's bytes are the plan's, the ``schedule`` event
  carries the plan's offsets and the ``comm_rates`` record is written.
"""

import dataclasses
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
from repro_torch.core import label_tree
from repro_torch.sharding import specs as sh

ARCH = "muonbp-960m"
PERIOD = 3
WORLD_SIZE = 4
REF_TOL = 1e-5       # port vs reference, max abs (tests/test_torch_distributed.py)
PARAM_TOL = 1e-5     # staggered vs synchronous parameters after one period
MOMENTUM_TOL = 1e-6  # and momentum (the reference's bounds)
LR_FULL, LR_BLOCK, WD = 0.02, 0.005, 0.1
SKIP_CLASSES = {"grad_reduce", "norm", "tp", "guard"}   # chip_smoke's DIST_SKIP_CLASSES
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "16",
          "--period", str(PERIOD), "--compute-dtype", "float32", "--schedule", "const",
          "--full-schedule", "staggered", "--guard", "--guard-warmup", "1",
          "--fault-plan", "nan_grads@1", "--log-every", "1"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    zero1: bool = True
    flatten: bool = False
    layers: int = 0
    variants: tuple = ("muon",)
    launch: bool = False


WORLDS = {
    "data2_model2": World("data=2,model=2", variants=("muon", "normuon"), launch=True),
    "data2_model2_flatten": World("data=2,model=2", flatten=True, layers=3),
    "pod2_model2": World("pod=2,model=2"),
}


def _cfg(world: World, jax_side: bool = False):
    cfg = (j_get_config if jax_side else get_config)(ARCH).reduced()
    return dataclasses.replace(cfg, num_layers=world.layers) if world.layers else cfg


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _case(world: World):
    """(numpy Muon params from the reference's init, numpy Muon gradients)."""
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), _cfg(world, True)))
    labels = label_tree(params)
    params = tree_lib.tree_map(lambda x, l: x if l == "muon" else None, params, labels)
    rng = np.random.default_rng(1)
    grads = tree_lib.tree_map(lambda p: 0.1 * rng.standard_normal(p.shape).astype(np.float32),
                              params)
    return params, grads


def _block_specs(params, cfg, sizes):
    return sh.block_specs_for(params, sh.param_specs(params, cfg, sizes), sizes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, port, cases, queue):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD_SIZE)
        try:
            out = {name: _rank_cases(rank, WORLDS[name], *cases[name]) for name in WORLDS}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world, params_np, grads_np) -> dict:
    from repro_torch.core import muon, phase_for_step, program
    from repro_torch.distributed import assert_staggered_matches_plan, make_engine, plan_comm
    from repro_torch.launch.mesh import make_mesh_from_spec

    out: dict = {}
    mesh = make_mesh_from_spec(world.spec)
    sizes = sh.mesh_axis_sizes(mesh)
    cfg = _cfg(world)
    params = interop.params_from_numpy(params_np, device="cpu")
    grads = interop.params_from_numpy(grads_np, device="cpu")
    pspecs = sh.param_specs(params, cfg, sizes)
    bspecs = _block_specs(params, cfg, sizes)

    def engine_for(zero1, flatten):
        eng = make_engine(params, pspecs, mesh, zero1=zero1, zero1_flatten=flatten)
        plan = plan_comm(params, pspecs, sizes, block_specs=bspecs, zero1=zero1,
                         zero1_flatten=flatten)
        return eng, plan

    def cut(eng, tree):
        return tree_lib.map_with_path(lambda k, p: eng.cut(p, eng.pspec_by_path[k]), tree)

    blocks = dict(tree_lib.flatten_with_path(bspecs))

    def offsets_of(eng):
        leaf_specs = tuple(program.LeafSpec(key=k, shape=eng.state_shape_for(k, tuple(p.shape)),
                                            dtype="float32", block=blocks.get(k))
                           for k, p in tree_lib.flatten_with_path(params))
        return program.compile_program(leaf_specs, backend="cpu", engine=eng,
                                       full_schedule="staggered",
                                       stagger_period=PERIOD).stagger_offsets

    def residue_updates(eng, plan, variant, tag):
        """Each residue's update from the initial state, whole on every rank;
        each residue's trace against the plan (an error string or None)."""
        p, g = cut(eng, params), cut(eng, grads)
        opt = muon(LR_FULL, LR_BLOCK, period=PERIOD, weight_decay=WD, block_specs=bspecs,
                   comm=eng, full_schedule="staggered", variant=variant)
        state = opt.init(p)
        upds, errors = {}, {}
        for r in range(PERIOD):
            eng.comm.trace.step = (tag, r)
            upd, new_state = opt.update(g, state, p, program.stagger_phase(r))
            full = {k: eng.to_param_layout(k, u) for k, u in tree_lib.flatten_with_path(upd)}
            try:
                assert_staggered_matches_plan(eng.comm.trace, plan, period=PERIOD, residue=r,
                                              step=(tag, r), include_apply=True)
                errors[r] = None
            except AssertionError as e:
                errors[r] = str(e)
            eng.comm.trace.step = None
            upds[r] = {k: eng.join(u, eng.pspec_by_path[k], phase="check").numpy().copy()
                       for k, u in full.items()}
            if new_state.vcount is not None:
                upds[r]["vcount"] = {"/".join(k): c for k, c in new_state.vcount.items()}
        return upds, errors

    eng, plan = engine_for(world.zero1, world.flatten)
    out["offsets"] = plan.stagger_offsets(PERIOD)
    out["program_offsets"] = offsets_of(eng)
    out["plan_residue_bytes"] = plan.staggered_bytes_by_residue(PERIOD)
    out["plan_full_bytes"] = plan.predicted_bytes("full")
    for variant in world.variants:
        out[("updates", variant)], out[("trace", variant)] = residue_updates(
            eng, plan, variant, variant)

    if world.flatten:
        # The plain engine along its own offsets, against the flatten one's.
        eng0, plan0 = engine_for(False, False)
        out["plain_offsets"] = plan0.stagger_offsets(PERIOD)
        out["plain_updates"], out["plain_trace"] = residue_updates(eng0, plan0, "muon",
                                                                   "plain")
        return out

    # One period with constant gradients, no weight decay, constant LRs:
    # the staggered parameters and momentum against the synchronous ones.
    finals = {}
    for schedule in ("pipelined", "staggered"):
        p, g = cut(eng, params), cut(eng, grads)
        opt = muon(LR_FULL, LR_BLOCK, period=PERIOD, block_specs=bspecs, comm=eng,
                   full_schedule=schedule)
        state = opt.init(p)
        for step in range(PERIOD):
            phase = (program.stagger_phase(step) if schedule == "staggered"
                     else phase_for_step(step, PERIOD))
            upd, state = opt.update(g, state, p, phase)
            u_by_key = dict(tree_lib.flatten_with_path(upd))
            p = tree_lib.unflatten([(k, x + eng.to_param_layout(k, u_by_key[k]))
                                    for k, x in tree_lib.flatten_with_path(p)])
        finals[schedule] = (
            {k: v.numpy().copy() for k, v in tree_lib.flatten_with_path(p)},
            {k: v.numpy().copy() for k, v in state.momentum.items()})
    out["period_params"] = max(float(np.abs(finals["pipelined"][0][k] - v).max())
                               for k, v in finals["staggered"][0].items())
    out["period_momentum"] = max(float(np.abs(finals["pipelined"][1][k] - v).max())
                                 for k, v in finals["staggered"][1].items())

    if world.launch:
        out["launch"] = _launch(world, cfg)
    return out


def _launch(world, cfg) -> dict:
    """The launcher, staggered and guarded, on this mesh."""
    from repro_torch.distributed import assert_staggered_matches_plan, plan_comm
    from repro_torch.distributed.audit import PHASES as TRACE_PHASES
    from repro_torch.launch import train
    from repro_torch.obs import MemorySink

    argv = LAUNCH + ["--mesh", world.spec] + (["--zero1"] if world.zero1 else [])
    sink = MemorySink()
    run = train.run(argv, cfg=cfg, sinks=[sink])
    eng, trace = run.engine, run.engine.comm.trace
    shapes = tree_lib.map_with_path(
        lambda k, p: torch.empty(eng.full_shape(k, p.shape), device="meta"), run.state.params)
    plan = plan_comm(shapes, sh.param_specs(shapes, cfg, eng.axis_sizes), eng.axis_sizes,
                     block_specs=run.block_specs, zero1=world.zero1)
    res = {"phases": [r["phase"] for r in run.records],
           "healthy": [r["healthy"] for r in run.records],
           "due": [r["due"] for r in run.records],
           "escalation": [r["escalation"] for r in run.records],
           "offsets": plan.stagger_offsets(PERIOD),
           "events": [r for r in sink.records if r.get("event") in ("schedule", "comm_rates")],
           "classes": {}, "errors": {}}
    for step, (phase, healthy) in enumerate(zip(res["phases"], res["healthy"])):
        res["classes"][step] = sorted({e.phase for e in trace.select(None, step=step)})
        residues = {e.residue for e in trace.select("stagger", step=step)}
        res["errors"][step] = None
        if healthy and phase.startswith("stagger:"):
            try:
                assert_staggered_matches_plan(trace, plan, period=PERIOD,
                                              residue=int(phase.split(":")[1]), step=step,
                                              include_apply=True)
            except AssertionError as e:
                res["errors"][step] = str(e)
        elif residues:
            res["errors"][step] = f"stagger events of residues {residues}"
    res["known_classes"] = set().union(*map(set, res["classes"].values())) <= set(TRACE_PHASES)
    return res


@pytest.fixture(scope="module")
def world_results():
    cases = {name: _case(world) for name, world in WORLDS.items()}
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(_free_port(), cases, queue),
                               nprocs=WORLD_SIZE, start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(WORLD_SIZE))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return cases, results


@pytest.fixture(scope="module")
def reference_updates():
    """The reference's single-device synchronous 'full' and 'block' updates
    (jitted once each) on each world's block grid, from the initial state."""
    out = {}
    for name, world in WORLDS.items():
        params, grads = _case(world)
        bspecs = _block_specs(params, _cfg(world), _sizes(world))
        j_bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), bspecs)
        for variant in world.variants:
            opt = j_muon(LR_FULL, LR_BLOCK, period=PERIOD, weight_decay=WD,
                         block_specs=j_bspecs, variant=variant)
            state = opt.init(params)
            for phase in ("full", "block"):
                upd, _ = jax.jit(lambda g, s, p, ph=phase: opt.update(g, s, p, ph))(
                    grads, state, params)
                out[(name, variant, phase)] = dict(
                    (k, np.asarray(v)) for k, v in tree_lib.flatten_with_path(upd))
    return out


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(WORLDS))
def test_residue_updates_match_reference_full_and_block(world_results, reference_updates,
                                                       name):
    _, results = world_results
    world, r0 = WORLDS[name], results[0][name]
    offsets = r0["offsets"]
    for variant in world.variants:
        for r in range(PERIOD):
            got = r0[("updates", variant)][r]
            for k, v in got.items():
                if k == "vcount":
                    continue
                phase = "full" if offsets["/".join(k)] == r else "block"
                np.testing.assert_allclose(v, reference_updates[(name, variant, phase)][k],
                                           rtol=0, atol=REF_TOL,
                                           err_msg=f"{name} {variant} residue {r} {k}")
            if variant == "normuon":
                # A leaf's row statistics refresh at its own residue only.
                assert got["vcount"] == {k: int(o == r) for k, o in offsets.items()}
    for rank, res in results.items():   # every rank joins the same updates
        for variant in world.variants:
            for r in range(PERIOD):
                mine = res[name][("updates", variant)][r]
                assert all(np.array_equal(mine[k], r0[("updates", variant)][r][k])
                           for k in mine if k != "vcount")


@pytest.mark.parametrize("name", list(WORLDS))
def test_residue_bytes_match_plan_to_the_byte(world_results, name):
    _, results = world_results
    world = WORLDS[name]
    r0 = results[0][name]
    assert r0["program_offsets"] == r0["offsets"]
    # Over a period each leaf gathers whole once: the residues' bytes sum to
    # the synchronous full step's (no leaf gathers on its block phase here).
    assert sum(r0["plan_residue_bytes"]) == r0["plan_full_bytes"] > 0
    assert max(r0["plan_residue_bytes"]) < r0["plan_full_bytes"]
    for rank, res in results.items():
        assert res[name]["offsets"] == r0["offsets"]
        for variant in world.variants:
            assert res[name][("trace", variant)] == {r: None for r in range(PERIOD)}, rank
        if world.flatten:
            assert res[name]["plain_trace"] == {r: None for r in range(PERIOD)}, rank


@pytest.mark.parametrize("name", ["data2_model2", "pod2_model2"])
def test_staggered_equals_synchronous_after_one_period(world_results, name):
    _, results = world_results
    for rank, res in results.items():
        assert res[name]["period_params"] < PARAM_TOL, (rank, res[name]["period_params"])
        assert res[name]["period_momentum"] < MOMENTUM_TOL, (rank, res[name]["period_momentum"])


def test_zero1_flatten_agrees_per_leaf_with_the_plain_engine(world_results):
    _, results = world_results
    r0 = results[0]["data2_model2_flatten"]
    off_f, off_0 = r0["offsets"], r0["plain_offsets"]
    assert set(off_f) == set(off_0)
    upd_f, upd_0 = r0[("updates", "muon")], r0["plain_updates"]
    for path in upd_f[0]:
        key = "/".join(path)
        rf, r0_ = off_f[key], off_0[key]
        bf = next(r for r in range(PERIOD) if r != rf)
        b0 = next(r for r in range(PERIOD) if r != r0_)
        for a, b in ((upd_f[rf][path], upd_0[r0_][path]), (upd_f[bf][path], upd_0[b0][path])):
            np.testing.assert_allclose(a, b, rtol=0, atol=REF_TOL, err_msg=key)


def test_launcher_staggered_guarded_on_a_mesh(world_results):
    _, results = world_results
    want = ["stagger:0", "stagger:1", "full", "stagger:0"]
    for rank, res in results.items():
        launch = res["data2_model2"]["launch"]
        assert launch["phases"] == want and launch["healthy"] == [1, 0, 1, 1], launch
        assert launch["escalation"][1] == "force_full"
        # The skipped stagger step issues no optimizer collective.
        assert set(launch["classes"][1]) <= SKIP_CLASSES, launch["classes"][1]
        assert "stagger" in launch["classes"][0] and "full" in launch["classes"][2]
        assert launch["errors"] == {s: None for s in range(4)}, launch["errors"]
        assert launch["known_classes"]
    launch = results[0]["data2_model2"]["launch"]
    sched = [e for e in launch["events"] if e["event"] == "schedule"]
    rates = [e for e in launch["events"] if e["event"] == "comm_rates"]
    assert len(sched) == 1 and sched[0]["offsets"] == launch["offsets"]
    assert sched[0]["mode"] == "staggered" and sched[0]["period"] == PERIOD
    due = [sum(1 for o in launch["offsets"].values() if o == r) for r in range(PERIOD)]
    assert launch["due"] == [due[0], due[1], sum(due), due[0]]
    assert len(rates) == 1 and len(rates[0]["comm_bytes_by_residue"]) == PERIOD
    assert rates[0]["counts_by_residue"] == {"0": 2, "1": 1}
