"""The staggered full-step schedule of the port against the JAX package, on
the host and on a one-rank ``gloo`` world.

Held, against the reference's ``tests/test_stagger.py`` where it has the
case:

* ``StaggerSchedule``: the phases over two periods, the synchronous mode
  against ``phase_for_step``, the validation errors; the stagger phase
  names' round trip;
* the program's offsets on the reference test's hierarchical layout
  (``pod=2,data=2,model=2``, no ranks): equal to ``plan.stagger_offsets``
  and to the reference program's, the due sets partitioning the leaves,
  each mixed phase's gather bytes and pipeline schedule the reference's;
* ``muon``'s errors for the staggered schedule and its stagger phases;
  one program compile covers all P phases over two periods;
* each residue's update over two periods on a one-rank world
  (``data=1,model=1``, every gather 0 B) against the reference's on its
  ``(1, 1)``-mesh engine, for ``muon`` and ``normuon``, every step's update
  and the final state at max abs 1e-5 (``tests/test_torch_optim.py``'s
  tolerance);
* the launcher: ``--full-schedule staggered`` on the one-rank world runs
  ``stagger:{step % P}`` with ``residue`` and ``due`` on each step, writes
  the ``schedule`` event and the offsets into the snapshots' run metadata
  and a ``comm_rates`` record at the end; on one rank with no block grid
  every phase orthogonalizes every leaf whole, so its losses equal the
  synchronous run's bitwise; a staggered resume continues the residues, a
  synchronous resume of its snapshot is refused; the run metadata check
  after a JSON round trip gives the reference's verdicts; the four argparse
  errors; ``--drift-threshold 0`` builds no monitor.

The reference's calls run jitted, each output once in a module fixture.
"""

import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (torch on one intra-op thread)
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import LeafSpec as JLeafSpec
from repro.core import compile_program as j_compile_program
from repro.core import muon as j_muon
from repro.core import program as j_program
from repro.core.muon import StaggerSchedule as JStaggerSchedule
from repro.distributed import make_engine as j_make_engine
from repro.distributed import plan_comm as j_plan_comm
from repro.training.checkpoint import CheckpointError as JCheckpointError
from repro.training.checkpoint import check_run_meta as j_check_run_meta
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.core import BlockSpec2D, StaggerSchedule, muon, phase_for_step
from repro_torch.core import program
from repro_torch.distributed import make_engine, plan_comm
from repro_torch.launch import train
from repro_torch.obs import MemorySink
from repro_torch.training import checkpoint

PERIOD = 3
TOL = 1e-5   # tests/test_torch_optim.py: port vs reference updates, max abs
VARIANTS = ("muon", "normuon")
LAUNCH = ["--reduced", "--device", "cpu", "--mesh", "data=1", "--period", str(PERIOD),
          "--batch", "2", "--seq", "16", "--compute-dtype", "float32", "--schedule", "const",
          "--log-every", "1"]


# ---------------------------------------------------------------------------
# The schedule and the phase names
# ---------------------------------------------------------------------------

def test_stagger_schedule_phases_match_reference():
    for mode, period in (("staggered", 3), ("staggered", 5), ("synchronous", None),
                         ("synchronous", 1), ("synchronous", 3), ("synchronous", 5)):
        port, ref = StaggerSchedule(period, mode), JStaggerSchedule(period, mode)
        steps = range(2 * (period or 2))
        assert [port.phase_for(s) for s in steps] == [ref.phase_for(s) for s in steps]
        assert port.phases() == ref.phases()
        if mode == "synchronous":
            assert [port.phase_for(s) for s in steps] == [phase_for_step(s, period)
                                                          for s in steps]
    assert [StaggerSchedule(3, "staggered").phase_for(s) for s in range(6)] == [
        "stagger:0", "stagger:1", "stagger:2"] * 2


@pytest.mark.parametrize("args", [(3, "sometimes"), (1, "staggered"), (None, "staggered")])
def test_stagger_schedule_validation_matches_reference(args):
    with pytest.raises(ValueError) as ref:
        JStaggerSchedule(*args)
    with pytest.raises(ValueError) as port:
        StaggerSchedule(*args)
    assert str(port.value) == str(ref.value)


def test_stagger_phase_roundtrip():
    assert program.stagger_phase(4) == j_program.stagger_phase(4) == "stagger:4"
    for name in ("stagger:4", "stagger:0", "full", "block", "stagger:", "stagger:x", None):
        assert program.parse_stagger_phase(name) == j_program.parse_stagger_phase(name)
    assert program.STAGGER_PREFIX == j_program.STAGGER_PREFIX


# ---------------------------------------------------------------------------
# The program's offsets and mixed phases (no ranks)
# ---------------------------------------------------------------------------

HIER = {"pod": 2, "data": 2, "model": 2}
HIER_LAYOUT = {   # the reference's test_plan_offsets_match_program_offsets
    "a": ((64, 128), (None, ("pod", "model"))),
    "b": ((64, 64), (None, "model")),
    "c": ((4, 32, 32), (None, None, "model")),
    "d": ((32, 96), (None, ("pod", "model"))),
    "e": ((16, 16), (None, None)),
}


def _fake_mesh(sizes: dict) -> Mesh:
    shape = tuple(sizes.values())
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), tuple(sizes))


def _hier_programs():
    meta = {k: torch.empty(s, device="meta") for k, (s, _) in HIER_LAYOUT.items()}
    specs = {k: sp for k, (_, sp) in HIER_LAYOUT.items()}
    engine = make_engine(meta, specs, HIER)
    leaf_specs = tuple(program.LeafSpec(key=(k,), shape=s, dtype="float32")
                       for k, (s, _) in HIER_LAYOUT.items())
    port = program.compile_program(leaf_specs, backend="cpu", engine=engine,
                                   full_schedule="staggered", stagger_period=PERIOD)
    plan = plan_comm(meta, specs, HIER, labels={k: "muon" for k in HIER_LAYOUT})
    j_params = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, (s, _) in HIER_LAYOUT.items()}
    j_specs = {k: P(*sp) for k, (_, sp) in HIER_LAYOUT.items()}
    j_eng = j_make_engine(j_params, j_specs, _fake_mesh(HIER))
    ref = j_compile_program(tuple(JLeafSpec(key=(k,), shape=s, dtype="float32")
                                  for k, (s, _) in HIER_LAYOUT.items()),
                            backend="jnp", engine=j_eng, full_schedule="staggered",
                            stagger_period=PERIOD)
    j_plan = j_plan_comm(j_params, j_specs, _fake_mesh(HIER),
                         labels={k: "muon" for k in HIER_LAYOUT})
    return port, plan, ref, j_plan, leaf_specs


def test_program_offsets_match_plan_and_reference():
    port, plan, ref, j_plan, leaf_specs = _hier_programs()
    assert port.stagger_period == ref.stagger_period == PERIOD
    assert port.stagger_offsets == plan.stagger_offsets(PERIOD) == ref.stagger_offsets
    assert plan.stagger_offsets(PERIOD) == j_plan.stagger_offsets(PERIOD)
    assert set(port.phases) == set(ref.phases) == (
        {"block", "full"} | {f"stagger:{r}" for r in range(PERIOD)})
    seen = []
    for r in range(PERIOD):
        name = program.stagger_phase(r)
        due = port.phase(name).due
        assert due == ref.phase(name).due
        assert set(due) == {i for i, ls in enumerate(leaf_specs)
                            if port.stagger_offsets["/".join(ls.key)] == r}
        seen += list(due)
        # Each residue gathers what the reference's does (with no block grid
        # given, every sharded leaf here gathers on every phase).
        assert port.phase(name).predicted_comm_bytes() == ref.phase(name).predicted_comm_bytes()
        assert port.phase(name).schedule.describe() == ref.phase(name).schedule.describe()
        assert ([le.eff_dims for le in port.phase(name).leaf_execs]
                == [tuple(le.eff_dims) for le in ref.phase(name).leaf_execs])
    assert sorted(seen) == list(range(len(leaf_specs)))   # the due sets partition
    # The plain full phase pipelines under 'staggered' (the forced-full step).
    assert port.phase("full").schedule.describe() == ref.phase("full").schedule.describe()
    assert "due=" in port.summary()


def test_compile_program_staggered_requirements():
    engine = make_engine({"w": torch.empty(4, 8, 8, device="meta")},
                         {"w": (None, None, "model")}, {"model": 2})
    ls = (program.LeafSpec(key=("w",), shape=(4, 8, 8), dtype="float32"),)
    with pytest.raises(ValueError, match="engine"):
        program.compile_program(ls, full_schedule="staggered", stagger_period=3)
    for period in (None, 1):
        with pytest.raises(ValueError, match="stagger_period >= 2"):
            program.compile_program(ls, engine=engine, full_schedule="staggered",
                                    stagger_period=period)
    prog = program.compile_program(ls, engine=engine, full_schedule="staggered",
                                   stagger_period=2)
    assert prog.stagger_offsets == {"w": 0} and prog.phase("stagger:1").due == ()


# ---------------------------------------------------------------------------
# The one-rank world and the optimizer
# ---------------------------------------------------------------------------

LAYOUT = {   # global shape, spec on the (1, 1) mesh, block grid
    "stack": ((3, 16, 32), (None, None, "model"), (1, 2)),
    "wq": ((16, 32), (None, "model"), (1, 2)),
    "wd": ((24, 16), ("model", None), (2, 1)),
    "ub": ((16, 48), (None, "model"), None),   # unblocked: gathers on every phase
    "local": ((12, 12), (None, None), None),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world():
    """A one-rank gloo world for the module."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _case():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _, _) in LAYOUT.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, (s, _, _) in LAYOUT.items()}
             for _ in range(2 * PERIOD)]
    return params, grads


def _phases():
    return [StaggerSchedule(PERIOD, "staggered").phase_for(s) for s in range(2 * PERIOD)]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's staggered updates on its (1, 1)-mesh engine over two
    periods, each phase's update jitted once, for each variant."""
    params_np, grads_np = _case()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    params = {k: jnp.asarray(v) for k, v in params_np.items()}
    eng = j_make_engine(params, {k: P(*sp) for k, (_, sp, _) in LAYOUT.items()}, mesh)
    blocks = {k: JBlockSpec2D(*b) if b else None for k, (_, _, b) in LAYOUT.items()}
    out = {}
    for variant in VARIANTS:
        opt = j_muon(0.02, 0.005, period=PERIOD, block_specs=blocks, comm=eng,
                     full_schedule="staggered", weight_decay=0.1, variant=variant)
        steps = {ph: jax.jit(lambda g, s, p, ph=ph: opt.update(g, s, p, ph))
                 for ph in set(_phases())}
        state = opt.init(params)
        upds = []
        for phase, g in zip(_phases(), grads_np):
            u, state = steps[phase]({k: jnp.asarray(v) for k, v in g.items()}, state, params)
            upds.append(jax.tree.map(np.asarray, u))
        out[variant] = (upds, jax.tree.map(lambda x: np.asarray(x) if x is not None else x,
                                           state._asdict()))
    return out


def _port_engine():
    from repro_torch.launch.mesh import make_mesh_from_spec

    params_np, grads_np = _case()
    params = interop.params_from_numpy(params_np, device="cpu")
    engine = make_engine(params, {k: sp for k, (_, sp, _) in LAYOUT.items()},
                         make_mesh_from_spec("data=1,model=1"))
    blocks = {k: BlockSpec2D(*b) if b else None for k, (_, _, b) in LAYOUT.items()}
    return params, grads_np, engine, blocks


def _close(port, ref, atol=TOL):
    for key, v in tree_lib.flatten_with_path(port):
        r = ref
        for part in key:
            r = r[part]
        np.testing.assert_allclose(v.double().numpy(), np.asarray(r, np.float64), rtol=0,
                                   atol=atol, err_msg=str(key))


@pytest.mark.parametrize("variant", VARIANTS)
def test_staggered_updates_match_reference_on_one_rank(world, reference_runs, variant):
    params, grads_np, engine, blocks = _port_engine()
    opt = muon(0.02, 0.005, period=PERIOD, block_specs=blocks, comm=engine,
               full_schedule="staggered", weight_decay=0.1, variant=variant)
    state = opt.init(params)
    ref_upds, ref_state = reference_runs[variant]
    for step, (phase, g) in enumerate(zip(_phases(), grads_np)):
        upd, state = opt.update(interop.params_from_numpy(g, device="cpu"), state, params,
                                phase)
        _close(upd, ref_upds[step])
    _close(tree_lib.unflatten(list(state.momentum.items())), ref_state["momentum"])
    if variant == "normuon":
        # The row statistics refreshed on each leaf's due steps only.
        _close(tree_lib.unflatten(list(state.second_moment.items())),
               ref_state["second_moment"], atol=1e-6)
        assert {"/".join(k): c for k, c in state.vcount.items()} == {
            k: int(v) for k, v in ref_state["vcount"].items()}
        assert set(state.vcount.values()) == {2}   # one refresh a period


def test_staggered_updates_compile_once_across_two_periods(world):
    params, grads_np, engine, blocks = _port_engine()
    opt = muon(0.02, 0.005, period=PERIOD, block_specs=blocks, comm=engine,
               full_schedule="staggered")
    state = opt.init(params)
    compiled = []
    real = program.compile_program

    def counting(*a, **kw):
        prog = real(*a, **kw)
        compiled.append(prog)
        return prog

    program.compile_program = counting
    try:
        for phase, g in zip(_phases(), grads_np):
            _, state = opt.update(interop.params_from_numpy(g, device="cpu"), state, params,
                                  phase)
    finally:
        program.compile_program = real
    assert len(compiled) == 1, "the stagger phases must not recompile per residue"
    assert set(compiled[0].phases) == {"block", "full"} | {f"stagger:{r}"
                                                           for r in range(PERIOD)}


def test_muon_staggered_errors_match_reference():
    meta = {"w": torch.empty(8, 8, device="meta")}
    engine = make_engine(meta, {"w": (None, "model")}, {"data": 1, "model": 1})
    j_eng = j_make_engine({"w": jax.ShapeDtypeStruct((8, 8), jnp.float32)},
                          {"w": P(None, "model")}, jax.make_mesh((1, 1), ("data", "model")))
    for kw, j_kw, match in ((dict(period=3), dict(period=3), "staggered"),
                            (dict(period=None, comm=engine), dict(period=None, comm=j_eng),
                             "period"),
                            (dict(period=1, comm=engine), dict(period=1, comm=j_eng),
                             "period")):
        with pytest.raises(ValueError, match=match):
            j_muon(1e-2, full_schedule="staggered", **j_kw)
        with pytest.raises(ValueError, match=match):
            muon(1e-2, full_schedule="staggered", **kw)
    params = {"w": torch.ones(8, 8)}
    opt = muon(1e-2, period=3, comm=engine, full_schedule="staggered")
    with pytest.raises(ValueError, match="out of range"):
        opt.update(params, opt.init(params), params, "stagger:3")
    sync = muon(1e-2, period=3, comm=engine)
    with pytest.raises(ValueError, match="stagger"):
        sync.update(params, sync.init(params), params, "stagger:0")
    with pytest.raises(ValueError, match="stagger:<r>"):
        opt.update(params, opt.init(params), params, "half")


# ---------------------------------------------------------------------------
# The launcher and its snapshots
# ---------------------------------------------------------------------------

def _run(argv):
    sink = MemorySink()
    run = train.run(argv, sinks=[sink])
    return run, sink.records


def _events(records, name):
    return [r for r in records if r.get("event") == name]


def _program_offsets(run) -> dict:
    """The offsets the run's update program compiles (on its engine, from
    its Muon leaves' global state shapes and block grids)."""
    from repro_torch.core import label_tree

    eng, labels = run.engine, dict(tree_lib.flatten_with_path(label_tree(run.state.params)))
    blocks = dict(tree_lib.flatten_with_path(run.block_specs))
    leaf_specs = tuple(
        program.LeafSpec(key=k, shape=eng.state_shape_for(k, eng.full_shape(k, p.shape)),
                         dtype="float32", block=blocks.get(k))
        for k, p in tree_lib.flatten_with_path(run.state.params) if labels[k] == "muon")
    return program.compile_program(leaf_specs, backend="cpu", engine=eng,
                                   full_schedule="staggered",
                                   stagger_period=PERIOD).stagger_offsets


@pytest.fixture(scope="module")
def launcher_runs(world, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stagger_launch"))
    ck = os.path.join(tmp, "ckpt")
    runs = {
        "staggered": _run(LAUNCH + ["--full-schedule", "staggered", "--steps", "4",
                                    "--checkpoint-every", "2", "--checkpoint-dir", ck]),
        "synchronous": _run(LAUNCH + ["--steps", "4"]),
        "no_drift": _run(LAUNCH + ["--full-schedule", "staggered", "--steps", "2",
                                   "--drift-threshold", "0"]),
    }
    snaps = [meta for _, meta in ((p, checkpoint.load_meta(p))
                                  for _, p in checkpoint.list_snapshots(ck))]
    # A staggered resume continues the residues from the newest snapshot
    # (step 3); a synchronous one refuses it and the one before.
    runs["resume"] = _run(LAUNCH + ["--full-schedule", "staggered", "--steps", "6",
                                    "--checkpoint-dir", ck, "--resume"])
    runs["sync_resume"] = _run(LAUNCH + ["--steps", "2", "--checkpoint-dir", ck, "--resume"])
    return runs, snaps


def test_launcher_runs_stagger_phases(launcher_runs):
    runs, _ = launcher_runs
    run, records = runs["staggered"]
    (sched,) = _events(records, "schedule")
    assert sched["mode"] == "staggered" and sched["period"] == PERIOD
    offsets = sched["offsets"]
    assert offsets == _program_offsets(run)
    due = [sum(1 for r in offsets.values() if r == res) for res in range(PERIOD)]
    assert [r["phase"] for r in run.records] == [f"stagger:{s % PERIOD}" for s in range(4)]
    assert [r["residue"] for r in run.records] == [s % PERIOD for s in range(4)]
    assert [r["due"] for r in run.records] == [due[s % PERIOD] for s in range(4)]
    spans = [r for r in records if r.get("event") == "span" and r.get("name") == "step"]
    assert [(s["phase"], s["residue"], s["due"]) for s in spans] == [
        (r["phase"], r["residue"], r["due"]) for r in run.records]
    assert sched["max_staggered_dcn_bytes"] == 0 and sched["full_dcn_bytes"] == 0
    (rates,) = _events(records, "comm_rates")
    assert rates["comm_bytes_by_residue"] == [{"ici": 0, "dcn": 0}] * PERIOD
    assert rates["counts_by_residue"] == {"0": 2, "1": 1, "2": 1}
    assert not _events(records, "drift")
    spans = {r["name"] for r in records if r.get("event") == "span"}
    assert "muonbp.stagger0.s1.ns" in spans


def test_staggered_losses_equal_synchronous_on_one_rank(launcher_runs):
    """One rank has no block grid: every phase orthogonalizes every leaf whole
    at the same LR, so the schedules take the same steps."""
    runs, _ = launcher_runs
    stag = [r["loss"] for r in runs["staggered"][0].records]
    sync = [r["loss"] for r in runs["synchronous"][0].records]
    assert [r["phase"] for r in runs["synchronous"][0].records] == [
        "full", "block", "block", "full"]
    assert stag == sync
    (sched,) = _events(runs["synchronous"][1], "schedule")
    assert sched["mode"] == "synchronous" and sched["offsets"] is None
    (rates,) = _events(runs["synchronous"][1], "comm_rates")
    assert (rates["block_n"], rates["full_n"]) == (2, 2)


def test_snapshots_carry_the_schedule_and_resume_continues_the_residues(launcher_runs):
    runs, snaps = launcher_runs
    (sched,) = _events(runs["staggered"][1], "schedule")
    assert [m["step"] for m in snaps] == [2, 3]
    for meta in snaps:
        assert meta["run"]["schedule"] == {"mode": "staggered", "period": PERIOD,
                                           "offsets": sched["offsets"]}
    run, records = runs["resume"]
    (resume,) = _events(records, "resume")
    assert resume["step"] == 4
    assert os.path.basename(resume["snapshot"]) == os.path.basename(
        checkpoint.snapshot_path("", 3))
    assert [(r["step"], r["phase"]) for r in run.records] == [
        (4, "stagger:1"), (5, "stagger:2")]


def test_synchronous_resume_of_a_staggered_snapshot_is_refused(launcher_runs):
    runs, _ = launcher_runs
    run, records = runs["sync_resume"]
    skips = _events(records, "skip_snapshot")
    assert len(skips) == 2 and all("schedule" in s["why"] for s in skips)
    (resume,) = _events(records, "resume")
    assert resume["snapshot"] is None and run.records[0]["step"] == 0


def test_drift_threshold_zero_builds_no_monitor(launcher_runs):
    runs, _ = launcher_runs
    records = runs["no_drift"][1]
    assert _events(records, "schedule") and not _events(records, "comm_rates")


def test_run_meta_schedule_check_matches_reference():
    stag = {"mode": "staggered", "period": 3,
            "offsets": {"layers/attn/wq": 0, "layers/mlp/wi": 1}}
    sync = {"mode": "synchronous", "period": 3, "offsets": None}
    other = dict(stag, offsets={"layers/attn/wq": 1, "layers/mlp/wi": 0})
    meta = json.loads(json.dumps({"run": {"arch": "granite-8b", "schedule": stag}}))
    for expect, refused in (({"schedule": sync}, True), ({"schedule": other}, True),
                            ({"schedule": json.loads(json.dumps(stag)), "arch": "granite-8b"},
                             False)):
        for check, error in ((checkpoint.check_run_meta, checkpoint.CheckpointError),
                             (j_check_run_meta, JCheckpointError)):
            if refused:
                with pytest.raises(error, match="schedule"):
                    check(meta, expect)
            else:
                check(meta, expect)


@pytest.mark.parametrize("extra, message", [
    (["--full-schedule", "staggered"], "requires the explicit engine"),
    (["--mesh", "data=1", "--full-schedule", "staggered", "--optimizer", "muon"],
     "requires --optimizer muonbp"),
    (["--mesh", "data=1", "--full-schedule", "staggered", "--optimizer-variant", "dion"],
     "incompatible with the dion variant"),
    (["--mesh", "data=1", "--full-schedule", "staggered", "--period", "1"],
     "requires --period >= 2"),
])
def test_staggered_argparse_errors(extra, message, capsys):
    with pytest.raises(SystemExit) as e:
        train.run(["--reduced", "--device", "cpu"] + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
