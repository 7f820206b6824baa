"""The guarded step on a mesh of ranks, on a multi-process ``gloo`` world on
the CPU.

One world, ``data=2,model=2`` with ZeRO-1, spawned once a module. Its ranks
run the launcher with ``--guard --guard-warmup 2 --fault-plan
nan_grads@2,spike_loss@4x8`` (six steps, period 5, fp32), the reduced
muonbp-960m, mamba2-1.3b, internvl2-1b and whisper-small, each
tensor-parallel. Each step's state is kept just before it
runs. Held:

* the ``healthy`` / ``skipped`` / escalation sequence equal on every rank
  and equal to one process's guarded launcher run on the same global batch
  (steps 2 and 4 skipped, step 3 forced full);
* a skipped step leaves the parameters and every optimizer-state leaf
  ``torch.equal``, launches no NS work, and its trace holds only
  ``grad_reduce``, ``norm``, ``tp`` and ``guard``; every step agrees on
  the predicate through one 4 B ``guard`` all-reduce;
* each healthy guarded step equals the unguarded mesh step
  (``train_step`` without the guard, on the same state, batch and phase)
  bitwise;
* an abort (``--guard-abort-after 2``, NaN gradients at steps 1 and 2):
  ``force_full`` at step 1 and ``abort`` at step 2 on every rank, each rank
  exits with code 3 after the mesh snapshot, and a resume from it restores
  the guard's skip count.
"""

import os
import socket
import traceback

import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)


SPEC = "data=2,model=2"
# arch: runs tensor-parallel
ARCHS = {"muonbp-960m": True, "mamba2-1.3b": True, "internvl2-1b": True,
         "whisper-small": True}
PLAN = "nan_grads@2,spike_loss@4x8"
STEPS, SKIPPED, FORCED = 6, (2, 4), 3
BASE = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--period", "5",
        "--compute-dtype", "float32", "--schedule", "const", "--guard", "--guard-warmup", "2",
        "--log-every", "1"]
ALLOWED_ON_A_SKIP = {"grad_reduce", "norm", "tp", "guard"}


def _argv(arch: str, *extra) -> list:
    return ["--arch", arch] + BASE + list(extra)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tensors(state) -> list:
    """Every tensor of a state (NamedTuples, dicts, lists), in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state, key=str) for t in _tensors(state[k])]
    if isinstance(state, (tuple, list)):
        return [t for v in state for t in _tensors(v)]
    return []


def _clone(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_clone(v) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(_clone(v) for v in state)
    return state


def _equal(a, b) -> bool:
    la, lb = _tensors(a), _tensors(b)
    return len(la) == len(lb) > 0 and all(torch.equal(x, y) for x, y in zip(la, lb))


def _sequence(records) -> list:
    return [(r["step"], r["phase"], r["healthy"], r["skipped"], r["escalation"])
            for r in records]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, port, tmp, queue):
    try:
        queue.put((rank, _rank_cases(rank, world_size, port, tmp)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _guarded_run(arch: str) -> dict:
    """The guarded launcher run of ``arch`` on the mesh, each step's state
    and NS dispatch count kept before it runs, and the checks made here."""
    from repro_torch.launch import train
    from repro_torch.obs import get_bus
    from repro_torch.training.train_step import TrainState, train_step

    before, launches = {}, {}

    def ns_dispatches() -> int:
        return sum(v for k, v in get_bus().counters.items() if k.startswith("ns_launch."))

    def keep(step, state, batch):
        before[step] = (_clone(state.params), _clone(state.opt_state),
                        {k: v.clone() for k, v in batch.items()})
        launches[step] = ns_dispatches()

    argv = _argv(arch, "--steps", str(STEPS), "--mesh", SPEC, "--zero1", "--fault-plan", PLAN)
    run = train.run(argv, before_step=keep)
    before[STEPS] = (run.state.params, run.state.opt_state, None)
    launches[STEPS] = sum(v for k, v in run.counters.items() if k.startswith("ns_launch."))
    trace = run.engine.comm.trace
    out = {"sequence": _sequence(run.records), "tensor_parallel": run.engine.tensor_parallel,
           "phases_by_step": {s: sorted({e.phase for e in trace.select(None, step=s)})
                              for s in range(STEPS)},
           "guard_events": [[(e.kind, e.bytes) for e in trace.select("guard", step=s)]
                            for s in range(STEPS)],
           "ns_by_step": [launches[s + 1] - launches[s] for s in range(STEPS)]}
    out["skip_equal"] = {s: _equal(before[s][0], before[s + 1][0])
                         and _equal(before[s][1], before[s + 1][1]) for s in SKIPPED}
    # Each healthy step again without the guard, on the state it started
    # from: the unguarded mesh step must give the guarded one's state.
    out["healthy_equal"] = {}
    for rec in run.records:
        s = rec["step"]
        if not rec["healthy"]:
            continue
        trace.step = ("unguarded", s)
        state = TrainState(params=before[s][0], opt_state=before[s][1], step=s)
        new, _ = train_step(state, before[s][2], cfg=run.cfg, optimizer=run.optimizer,
                            phase=rec["phase"], compute_dtype=torch.float32,
                            engine=run.engine, ctx=run.ctx)
        out["healthy_equal"][s] = (_equal(new.params, before[s + 1][0])
                                   and _equal(new.opt_state, before[s + 1][1]))
    return out


def _abort_and_resume(arch: str, ckpt: str) -> dict:
    from repro_torch.launch import train

    records = []
    argv = _argv(arch, "--steps", str(STEPS), "--mesh", SPEC, "--zero1", "--fault-plan",
                 "nan_grads@1,nan_grads@2", "--guard-abort-after", "2", "--checkpoint-dir", ckpt)
    out = {"exit": None}
    try:
        train.run(argv, on_step=records.append)
    except SystemExit as e:
        out["exit"] = e.code
    out["sequence"] = _sequence(records)
    resumed = train.run(_argv(arch, "--steps", "4", "--mesh", SPEC, "--zero1",
                              "--checkpoint-dir", ckpt, "--resume"))
    out["resumed"] = _sequence(resumed.records)
    return out


def _rank_cases(rank, world_size, port, tmp) -> dict:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)
    out: dict = {}
    try:
        for arch in ARCHS:
            out[(arch, "guarded")] = _guarded_run(arch)
            out[(arch, "abort")] = _abort_and_resume(arch, os.path.join(tmp, arch))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    n = 4
    tmp = str(tmp_path_factory.mktemp("mesh_guard"))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(n, _free_port(), tmp, queue), nprocs=n,
                               start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(n))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return results


@pytest.fixture(scope="module")
def single():
    """One process's guarded launcher run of each arch on the same global
    batch and block grid."""
    from repro_torch.launch import train

    return {arch: _sequence(train.run(_argv(arch, "--steps", str(STEPS), "--mesh-model", "2",
                                            "--fault-plan", PLAN)).records)
            for arch in ARCHS}


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skip_sequence_equals_one_process(arch, world, single):
    for res in world.values():
        got = res[(arch, "guarded")]
        assert got["tensor_parallel"] is ARCHS[arch]
        assert got["sequence"] == single[arch]
    skipped = [s for s, _, healthy, _, _ in single[arch] if not healthy]
    assert skipped == list(SKIPPED)
    assert single[arch][FORCED][1] == "full" and single[arch][FORCED - 1][4] == "force_full"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skipped_steps_leave_the_state_and_issue_no_optimizer_work(arch, world):
    for res in world.values():
        got = res[(arch, "guarded")]
        assert all(got["skip_equal"].values()), got["skip_equal"]
        for s in SKIPPED:
            assert got["ns_by_step"][s] == 0, (s, got["ns_by_step"])
            assert set(got["phases_by_step"][s]) <= ALLOWED_ON_A_SKIP, got["phases_by_step"][s]
        # Step 2 is a skipped block step; step 1, a healthy one, ran NS work.
        assert got["sequence"][2][1] == "block" and got["ns_by_step"][1] > 0
        for s in range(STEPS):
            assert got["guard_events"][s] == [("all-reduce", 4)], (s, got["guard_events"][s])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_healthy_guarded_steps_equal_unguarded_mesh_steps(arch, world):
    for res in world.values():
        got = res[(arch, "guarded")]
        assert sorted(got["healthy_equal"]) == [s for s in range(STEPS) if s not in SKIPPED]
        assert all(got["healthy_equal"].values()), got["healthy_equal"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_escalation_and_abort_fire_at_the_same_step_on_every_rank(arch, world):
    """force_full at step 1, abort at step 2, exit 3 on every rank; the
    resume from the abort's snapshot carries the skip count on."""
    seqs = [res[(arch, "abort")] for res in world.values()]
    for got in seqs:
        assert got["exit"] == 3
        assert [r[4] for r in got["sequence"]] == ["none", "force_full", "abort"]
        assert got["sequence"] == seqs[0]["sequence"]
        assert [r[0] for r in got["resumed"]] == [3]
        assert got["resumed"][0][3] == 2 and got["resumed"][0][2] == 1
