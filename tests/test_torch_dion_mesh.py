"""Dion on a mesh of ranks (``--mesh``) on one ``gloo`` world of four ranks
on the CPU, which runs ``data=2,model=2``, the same with ZeRO-1 and
``model=4`` in turn (one spawn for the module). The reduced muonbp-960m's
Muon leaves from the reference's weights, fp32, on the kernels' plain
versions; each rank holds its param-layout shards and Dion runs through the
engine (``core/dion.py``).

Held:

* each rank's update (momentum layout and, after the 'apply' gathers, param
  layout), momentum and basis against the matching shard of the reference's
  single-device ``dion`` fed the whole gradient, over two steps from the
  reference's start basis, at the tolerance of
  ``tests/test_torch_variants.py`` (max abs 1e-5); the state gathered whole
  (``zero1.gather_state``, Dion's basis split on ``n``) against the
  reference's;
* block equal to full, bitwise, on every rank;
* the trace of each update: only the class ``'dion'``, equal to
  ``plan.dion_bytes`` to the byte, two collectives a split leaf (``P``'s,
  then ``R``'s), each smaller than the leaf's momentum shard;
* the launcher under ``--mesh --optimizer-variant dion`` (fp32 compute)
  against the launcher's loop on one process with the mesh's head layouts:
  losses to 1e-5 relative; each step's
  ``dion``, ``apply`` and ``tp`` bytes as the plans give them, no
  ``block``/``full`` gathers; ``--full-schedule staggered`` still refused.
"""

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
from repro.core import build_variant as j_build_variant
from repro.models.model import init_params as j_init_params
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import label_tree
from repro_torch.distributed import dion_bytes, plan_comm, tp_bytes
from repro_torch.distributed.audit import PHASES as TRACE_PHASES
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.sharding import specs as sh

ARCH = "muonbp-960m"
LR, WD, RANK = 0.02, 0.1, 8
TOL = 1e-5         # tests/test_torch_variants.py
LOSS_TOL = 1e-5    # the launcher on a mesh vs one process, relative, fp32 compute
STEPS = 2
BATCH, SEQ = 4, 16
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", str(BATCH), "--seq",
          str(SEQ), "--compute-dtype", "float32", "--schedule", "const",
          "--optimizer-variant", "dion"]
# name -> (mesh spec, ZeRO-1)
MESHES = {
    "data2_model2": ("data=2,model=2", False),
    "data2_model2_zero1": ("data=2,model=2", True),
    "model4": ("model=4", False),
}
WORLD_SIZE = 4


def _sizes(name: str) -> dict:
    return dict(zip(*parse_mesh_spec(MESHES[name][0])))


def _muon_only(tree, labels):
    return tree_lib.tree_map(lambda x, l: x if l == "muon" else None, tree, labels)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_lib.flatten_with_path(tree)}


def _grads_at(grads, step: int):
    return jax.tree.map(lambda g: g * np.float32(1.0 + 0.5 * step), grads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, port, case, queue):
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD_SIZE)
        try:
            out = {name: _rank_mesh(rank, name, case) for name in MESHES}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_mesh(rank, name, case) -> dict:
    from repro_torch.core import build_variant
    from repro_torch.core.dion import basis_spec
    from repro_torch.distributed import make_engine
    from repro_torch.distributed import zero1 as zero1_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_from_spec

    spec, zero1 = MESHES[name]
    mesh = make_mesh_from_spec(spec)
    cfg = get_config(ARCH).reduced()
    params = interop.params_from_numpy(case["params"], device="cpu")
    labels = label_tree(params)
    engine = make_engine(params, sh.param_specs(params, cfg, mesh), mesh, zero1=zero1)
    trace = engine.comm.trace
    cut = lambda tree: tree_lib.map_with_path(
        lambda k, p: engine.cut(p, engine.pspec_by_path[k]), tree)
    shards = cut(_muon_only(params, labels))
    opt = build_variant("dion", LR, rank=RANK, weight_decay=WD, comm=engine)
    state = zero1_lib.shard_state(interop.opt_state_from_numpy(case["init"], device="cpu"),
                                  shards, engine)
    errs: dict = {}

    def err(kind, key, got, want, spec):
        want = engine.cut(torch.from_numpy(want), spec)
        assert got.shape == want.shape, (kind, key, got.shape, want.shape)
        errs[(kind, key)] = max(errs.get((kind, key), 0.0),
                                float((got.to(torch.float64) - want.to(torch.float64))
                                      .abs().max()))

    out: dict = {"block_eq_full": []}
    for step, ref in enumerate(case["steps"]):
        grads = cut(interop.params_from_numpy(_grads_at(case["grads"], step), device="cpu"))
        trace.step = ("block", step)
        u_b, s_b = opt.update(grads, state, shards, "block")
        trace.step = ("full", step)
        u_f, state = opt.update(grads, state, shards, "full")
        out["block_eq_full"].append(all(
            torch.equal(a, b) for a, b in zip(
                tree_lib.leaves(u_b) + list(s_b.momentum.values()) + list(s_b.basis.values()),
                tree_lib.leaves(u_f) + list(state.momentum.values())
                + list(state.basis.values()))))
        trace.step = ("apply", step)
        for k, u in tree_lib.flatten_with_path(u_f):
            uspec = engine.spec_for(k, u.dim())
            err("update", k, u, ref["update"][k], uspec)
            err("param_update", k, engine.to_param_layout(k, u), ref["update"][k],
                engine.pspec_by_path[k])
            err("momentum", k, state.momentum[k], ref["momentum"][k], uspec)
            err("basis", k, state.basis[k], ref["basis"][k], basis_spec(uspec))
    out["errs"] = errs
    trace.step = "check"
    whole = zero1_lib.gather_state(state, shards, engine, phase="check")
    last = case["steps"][-1]
    out["gathered"] = max(
        float(np.abs(whole.momentum[k].numpy() - last["momentum"][k]).max())
        + float(np.abs(whole.basis[k].numpy() - last["basis"][k]).max())
        for k in whole.momentum)
    out["trace"] = list(trace.events)
    # The momentum-shard bytes of each leaf the mesh splits in its matrix
    # dims, in the update's leaf order: its P collective, then (after the
    # factor program) its R one, each leaf in turn.
    out["split_shards"] = [
        m.numel() * m.element_size() for k, m in state.momentum.items()
        if any(sh.spec_entry_size(e, engine.axis_sizes) > 1
               for e in engine.spec_for(k, m.dim())[-2:])]

    # The launcher on the mesh.
    argv = LAUNCH + ["--mesh", spec] + (["--zero1"] if zero1 else [])
    run = train.run(argv, cfg=cfg)
    out["losses"] = [r["loss"] for r in run.records]
    out["launch_trace"] = list(run.engine.comm.trace.events)
    return out


# ---------------------------------------------------------------------------
# The reference, once, and the world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    """The reduced model's Muon leaves, gradients, the reference's start state
    and its two steps (updates, momentum, basis), all numpy."""
    jcfg = j_get_config(ARCH).reduced()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    labels = label_tree(params)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    m_params, m_grads = _muon_only(params, labels), _muon_only(grads, labels)
    ref = j_build_variant("dion", LR, rank=RANK, weight_decay=WD)
    state = ref.init(m_params)
    init = jax.tree.map(np.asarray, state._asdict())
    update = jax.jit(lambda g, s, p: ref.update(g, s, p, "full"))
    steps = []
    for step in range(STEPS):
        upd, state = update(_grads_at(m_grads, step), state, m_params)
        steps.append({"update": _flat(upd), "momentum": _flat(state.momentum),
                      "basis": _flat(state.basis)})
    return {"params": params, "grads": m_grads, "init": init, "steps": steps}


def _single_process_losses(model: int) -> list:
    """The launcher's loop on one process, with the Q and K/V head layouts
    of ``model=model`` (the reduced model's one KV head lays out 'hd' on
    ``model=4``; the single-process launcher computes 'head' only)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params
    from repro_torch.training.train_step import init_train_state, train_step

    cfg = get_config(ARCH).reduced()
    args = train.parser().parse_args(LAUNCH)
    params = init_params(cfg, seed=args.seed, device="cpu")
    opt, period = train.build_optimizer("dion", params, lr=args.lr, adam_lr=args.adam_lr,
                                        period=args.period)
    q_layout, kv_layout = sh.attn_layouts(cfg, model)
    state = init_train_state(params, opt)
    pipe = iter(SyntheticLM(cfg, args.batch, args.seq, seed=args.seed))
    losses = []
    for step in range(args.steps):
        state, metrics = train_step(state, train.device_batch(next(pipe), "cpu"), cfg=cfg,
                                    optimizer=opt, phase=train.phase_for_step(step, period),
                                    compute_dtype=torch.float32,
                                    ctx=sh.ShardCtx(q_layout=q_layout, kv_layout=kv_layout))
        losses.append(float(metrics["loss"]))
    return losses


@pytest.fixture(scope="module")
def world(case):
    """Every rank's results of every mesh, and the single-process losses a
    model-axis size (the launcher on a mesh is held to them)."""
    singles = {m: _single_process_losses(m) for m in sorted({_sizes(n)["model"]
                                                            for n in MESHES})}
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(_free_port(), case, queue),
                               nprocs=WORLD_SIZE, start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(WORLD_SIZE))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return results, singles


def _trace(events):
    from repro_torch.distributed.audit import CollectiveTrace

    trace = CollectiveTrace()
    trace.events = events
    return trace


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_shards_match_reference_single_device(name, world):
    results, _ = world
    for rank, res in results.items():
        errs = res[name]["errs"]
        kinds = {kind for kind, _ in errs}
        assert kinds == {"update", "param_update", "momentum", "basis"}
        bad = {key: e for key, e in errs.items() if not e <= TOL}
        assert not bad, (name, rank, bad)
        assert res[name]["gathered"] <= 2 * TOL, (name, rank)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_block_equals_full_bitwise(name, world):
    results, _ = world
    for res in results.values():
        assert res[name]["block_eq_full"] == [True] * STEPS


@pytest.mark.parametrize("name", sorted(MESHES))
def test_dion_bytes_equal_the_plan_and_none_is_parameter_sized(name, world, case):
    results, _ = world
    spec, zero1 = MESHES[name]
    sizes = _sizes(name)
    cfg = get_config(ARCH).reduced()
    params = interop.params_from_numpy(case["params"], device="cpu")
    want = dion_bytes(params, sh.param_specs(params, cfg, sizes), sizes,
                      labels=label_tree(params), rank=RANK, zero1=zero1)
    assert want > 0
    for res in results.values():
        trace = _trace(res[name]["trace"])
        for step in range(STEPS):
            for phase in ("block", "full"):
                events = trace.select(None, step=(phase, step))
                assert {e.phase for e in events} == {"dion"}
                assert trace.total_bytes("dion", step=(phase, step)) == want
                shards = res[name]["split_shards"]
                assert len(events) == 2 * len(shards) > 0
                for i, shard in enumerate(shards):
                    assert events[i].bytes < shard and events[len(shards) + i].bytes < shard


@pytest.mark.parametrize("name", sorted(MESHES))
def test_launcher_runs_dion_on_a_mesh(name, world, case):
    results, singles = world
    spec, zero1 = MESHES[name]
    sizes = _sizes(name)
    cfg = get_config(ARCH).reduced()
    params = interop.params_from_numpy(case["params"], device="cpu")
    specs = sh.param_specs(params, cfg, sizes)
    dion = dion_bytes(params, specs, sizes, rank=64, zero1=zero1)
    apply = plan_comm(params, specs, sizes, zero1=zero1).predicted_bytes("apply")
    data = int(np.prod([v for a, v in sizes.items() if a != "model"]))
    tp = tp_bytes(cfg, BATCH // data, SEQ, sizes, compute_bytes=4)
    for res in results.values():
        np.testing.assert_allclose(res[name]["losses"], singles[sizes["model"]],
                                   rtol=LOSS_TOL, atol=0)
        trace = _trace(res[name]["launch_trace"])
        for step in range(3):
            assert trace.total_bytes("dion", step=step) == dion
            assert trace.total_bytes("apply", step=step) == apply
            assert trace.total_bytes("tp", step=step) == tp
            assert not trace.select(("block", "full"), step=step)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


def test_launcher_refuses_dion_with_the_staggered_schedule():
    from repro_torch.launch import train

    for flag in (["--optimizer-variant", "dion"], ["--optimizer", "dion"]):
        argv = [a for a in LAUNCH if a not in ("--optimizer-variant", "dion")] + flag
        with pytest.raises(SystemExit):
            train.run(argv + ["--mesh", "data=2,model=2", "--full-schedule", "staggered"])
