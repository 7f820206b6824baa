"""The tensor-parallel SSM and hybrid models on multi-process ``gloo`` worlds
on the CPU.

Three worlds, each spawned once a module (its ranks run every case and hand
back numpy results): ``model=2``, ``data=2,model=2`` with ZeRO-1, and
``model=4``. Four configs, fp32, from the reference's weights, each rank
holding its ``param_specs`` shards (``d_inner`` columns, heads, ``out_proj``
rows; ``wb``/``wc``, the B/C convs and ``gate_norm`` whole):

* the reduced mamba2-1.3b (every world);
* the reduced hymba-1.5b, its window cut to 8 tokens so that the sequences
  here reach past it (``model=2`` and ``data=2,model=2``);
* the same with 5 Q heads and 1 KV head, so that Q and K/V both take the
  'hd' layout on ``model=2``, as full hymba's 25/5 heads do (the reduced
  config's 4/2 heads split 'head');
* the same window with ``d_model=96`` (``model=4``): ``d_inner`` 192 in
  six SSM heads of 32, which 4 does not divide, so each rank holds 48
  ``d_inner`` columns (1.5 heads: heads 1 and 4 cut in half between two
  ranks) and every head whole (``wdt``, ``A_log``, ``D`` and ``dt_bias``
  whole on every rank), as full hymba's 50 heads on model 4, 8 or 16.
  (At ``d_model=160`` the ``A_log`` gradient of these batches sits at the
  fp32 floor: the reference's own is further than the tolerance from an
  fp64 computation of it, so no fp32 path can be held to it there.)

Held against the JAX package's single-device ``forward``, ``loss_fn`` and
``jax.grad`` on the same weights (its ``ShardCtx`` carrying the world's
head layouts, mesh-free), at a sequence length the model axis divides
(sequence-sharded residual) and one it does not:

* the logits joined over the vocab, max abs 1e-5;
* the loss, relative 1e-6;
* every gradient after ``reduce_grads`` joined over the ranks, max abs 1e-5
  of the leaf's max|grad|: the B/C leaves', ``gate_norm``'s and the
  branch scales' come out whole only if summed over the model axis in
  either layout, and so do the whole heads' ``wdt``, ``A_log``, ``D`` and
  ``dt_bias``;
* one MuonBP full and one block update of the joined gradients on the
  engine against the reference's single-device ``muon`` with the mesh's
  block specs, max abs 1e-5; the block update moves no optimizer byte;
* the ``'tp'`` trace equal to ``plan.tp_bytes``, to the byte, and every
  collective of a class the port records (``audit.PHASES``).

Through the launcher on ``data=2,model=2`` (mamba2 and hymba, three steps,
full, block, full): the path line, the losses against one process
(relative 1e-5), ``'tp'`` equal to ``tp_bytes`` a step, every optimizer
phase equal to ``plan_comm``, no collective of another class; a mamba2 snapshot crossing
between the mesh and one process bitwise. ``scripts.mesh_bytes`` predicts
the straddling hymba's 'tp' bytes on ``model=4`` at both lengths from fake
tensors. ``mesh_path`` runs full hymba
tensor-parallel on model 2, 4, 8 and 16, and keeps a ``d_inner`` the axis
does not divide whole on every rank.
"""

import contextlib
import dataclasses
import io
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_cpu  # noqa: F401  (torch on one intra-op thread)

from repro.configs import get_config as j_get_config
from repro.core import BlockSpec2D as JBlockSpec2D
from repro.core import muon as j_muon
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.transformer import ShardCtx as JShardCtx
from repro.models.transformer import forward as j_forward
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import label_tree
from repro_torch.distributed import plan_comm, tp_bytes
from repro_torch.distributed.audit import PHASES as TRACE_PHASES
from repro_torch.sharding import specs as sh
from repro_torch.training import checkpoint

BATCH = 4
LOGIT_TOL = 1e-5     # max abs
LOSS_TOL = 1e-6      # relative
GRAD_TOL = 1e-5      # max abs over the leaf's max|grad|
UPDATE_TOL = 1e-5    # max abs, the port's update tolerance (tests/test_torch_optim.py)
LAUNCH_TOL = 1e-5    # launcher on the mesh vs one process, relative
WINDOW = 8           # hymba's window (64 reduced) cut below the sequences
# name: (arch, overrides of its reduced config)
CONFIGS = {
    "mamba2": ("mamba2-1.3b", {}),
    "hymba": ("hymba-1.5b", dict(window_size=WINDOW)),
    "hymba_q_hd": ("hymba-1.5b", dict(window_size=WINDOW, num_heads=5, num_kv_heads=1)),
    "hymba_straddle": ("hymba-1.5b", dict(window_size=WINDOW, d_model=96)),
}
LAUNCH_CONFIGS = ("mamba2", "hymba")
LAUNCH_STEPS = 3     # full, block, full
LAUNCH = ["--reduced", "--device", "cpu", "--steps", str(LAUNCH_STEPS), "--batch", str(BATCH),
          "--seq", "16", "--period", "2", "--compute-dtype", "float32", "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    seqs: tuple              # the first sequence-sharded, the second not
    configs: tuple
    zero1: bool = False
    launch: bool = False     # the launcher on the mesh, LAUNCH_CONFIGS


WORLDS = {
    "model2": World("model=2", seqs=(16, 15), configs=("mamba2", "hymba", "hymba_q_hd")),
    "data2_model2_zero1": World("data=2,model=2", seqs=(16, 15),
                                configs=("mamba2", "hymba", "hymba_q_hd"), zero1=True,
                                launch=True),
    "model4": World("model=4", seqs=(16, 18), configs=("mamba2", "hymba_straddle")),
}
CASES = {f"{name}:{c}": (name, c) for name, world in WORLDS.items() for c in world.configs}


def _cfg(name: str, get=get_config):
    """The reduced config ``name`` of CONFIGS (``get``: the port's or the JAX
    package's ``get_config``)."""
    arch, overrides = CONFIGS[name]
    return dataclasses.replace(get(arch).reduced(), **overrides)


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _data_shards(world: World) -> int:
    return int(np.prod([v for a, v in _sizes(world).items() if a != "model"]))


def _layouts(name: str, world: World) -> tuple:
    return sh.attn_layouts(_cfg(name), _sizes(world)["model"])


def _batch(seq: int) -> dict:
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, _cfg("mamba2").vocab_size, (BATCH, seq))
    labels = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
    return {"tokens": tokens, "labels": labels}


def _muon_block_specs(params, cfg, sizes):
    labels = label_tree(params)
    bspecs = sh.block_specs_for(params, sh.param_specs(params, cfg, sizes), sizes)
    return tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)


def _muon_only(tree, labels):
    return tree_lib.tree_map(lambda x, l: x if l == "muon" else None, tree, labels)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, port, name, params_np, tmp, queue):
    try:
        queue.put((rank, _rank_cases(rank, world_size, port, WORLDS[name], params_np, tmp)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world_size, port, world, params_np, tmp) -> dict:
    import torch.distributed as dist

    from repro_torch.core import muon
    from repro_torch.distributed import make_engine
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models.model import forward
    from repro_torch.training.train_step import loss_and_grads, reduce_grads

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)
    out: dict = {}
    try:
        mesh = make_mesh_from_spec(world.spec)
        sizes = sh.mesh_axis_sizes(mesh)
        for name in world.configs:
            cfg = _cfg(name)
            full = interop.params_from_numpy(params_np[name], device="cpu")
            engine = make_engine(full, sh.param_specs(full, cfg, sizes), mesh,
                                 zero1=world.zero1)
            comm = engine.comm
            out["coords"] = dict(comm.coords)
            params = interop.shard_params(params_np[name], cfg, sizes, comm.coords,
                                          device="cpu")
            data = sh.data_axes_for(sizes)
            n, i = comm.size(data), comm.index(data)
            rows = slice(i * BATCH // n, (i + 1) * BATCH // n)
            for seq in world.seqs:
                ctx = sh.make_ctx(cfg, engine, seq=seq)
                batch = {k: torch.from_numpy(v[rows]) for k, v in _batch(seq).items()}
                comm.trace.step = ("grads", seq)
                loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32,
                                                      ctx=ctx)
                loss, _ = reduce_grads(engine, loss, metrics, grads, ctx)
                comm.trace.step = ("logits", seq)
                with torch.no_grad():
                    logits = forward(params, batch["tokens"], cfg, ctx=ctx)
                out[(name, "layouts", seq)] = (ctx.q_layout, ctx.kv_layout, ctx.seq_shard,
                                               params["layers"]["ssm"]["A_log"].shape[-1])
                out[(name, "loss", seq)] = float(loss)
                out[(name, "grads", seq)] = interop.params_to_numpy(grads)
                out[(name, "logits", seq)] = logits.numpy()
                if seq == world.seqs[0]:
                    kept = grads

            # One full and one block MuonBP update of the first length's
            # reduced gradients, joined to the whole leaves on rank 0.
            labels = label_tree(params)
            p_m, g_m = _muon_only(params, labels), _muon_only(kept, labels)
            opt = muon(0.02, 0.02, period=5, weight_decay=0.1,
                       block_specs=_muon_block_specs(full, cfg, sizes), comm=engine)
            state = opt.init(p_m)
            for phase in ("full", "block"):
                comm.trace.step = ("update", phase)
                upd, state = opt.update(g_m, state, p_m, phase)
                comm.trace.step = ("update_join", phase)
                joined = {k: engine.join(engine.to_param_layout(k, u), engine.pspec_by_path[k],
                                         phase="check")
                          for k, u in tree_lib.flatten_with_path(upd)}
                if rank == 0:
                    out[(name, "update", phase)] = {k: v.numpy().copy()
                                                    for k, v in joined.items()}
            out[(name, "trace")] = list(comm.trace.events)
        if world.launch:
            out.update(_launches(world, params_np, tmp, sizes, rank))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _launches(world, params_np, tmp, sizes, rank) -> dict:
    """The launcher on the mesh for each of LAUNCH_CONFIGS, rank 0's stdout
    kept; mamba2 with a snapshot every 2 steps, and the single process's
    snapshot restored into the mesh."""
    from repro_torch.distributed import zero1 as zero1_lib
    from repro_torch.launch import train

    out = {}
    for name in LAUNCH_CONFIGS:
        cfg = _cfg(name)
        argv = LAUNCH + ["--arch", CONFIGS[name][0], "--mesh", world.spec, "--zero1"]
        if name == "mamba2":
            argv += ["--checkpoint-every", "2", "--checkpoint-dir", os.path.join(tmp, "mesh_ckpt")]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = train.run(argv, params=interop.params_from_numpy(params_np[name], device="cpu"),
                            cfg=cfg)
        out[(name, "launch")] = {
            "stdout": printed.getvalue(), "tensor_parallel": run.engine.tensor_parallel,
            "losses": [r["loss"] for r in run.records], "phases": [r["phase"] for r in run.records],
            "trace": list(run.engine.comm.trace.events),
            "shapes": {k: tuple(p.shape) for k, p in tree_lib.flatten_with_path(run.state.params)}}
        if name != "mamba2":
            continue
        joined = zero1_lib.gather_params(run.state.params, run.engine, phase="check")
        state = zero1_lib.gather_state(run.state.opt_state, run.state.params, run.engine,
                                       phase="check")
        if rank == 0:
            out["final_params"] = checkpoint._flatten(joined)
            out["final_state"] = checkpoint._flatten(state)
        # One process -> the mesh: the parameters restore cut to this rank's shards.
        snap = checkpoint.list_snapshots(os.path.join(tmp, "single_ckpt"))[-1][1]
        shardings = zero1_lib.opt_shardings(run.state.opt_state, run.state.params, run.engine)
        r_params, _, _ = checkpoint.restore(snap, run.state.params, run.state.opt_state,
                                            opt_shardings=shardings, engine=run.engine)
        on_disk = dict(np.load(os.path.join(snap, "params.npz")))
        cut = interop.shard_params(checkpoint.map_leaves(lambda key, _: on_disk[key],
                                                         params_np[name]),
                                   cfg, sizes, run.engine.comm.coords, "cpu")
        out["restore_into_mesh"] = all(
            torch.equal(a, b) for a, b in zip(tree_lib.leaves(r_params), tree_lib.leaves(cut)))
    return out


def _spawn(name: str, params_np, tmp: str) -> dict:
    n = int(np.prod(list(_sizes(WORLDS[name]).values())))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(n, _free_port(), name, params_np, tmp, queue),
                               nprocs=n, start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(n))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return results


@pytest.fixture(scope="module")
def params_np():
    """The reference's weights of every config, from one seed."""
    return {c: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(c, j_get_config)))
            for c in CONFIGS}


@pytest.fixture(scope="module")
def single(params_np, tmp_path_factory):
    """One process's launcher run of each of LAUNCH_CONFIGS on the same
    global batches and block grid; mamba2's with a snapshot every 2 steps."""
    from repro_torch.launch import train

    tmp = str(tmp_path_factory.mktemp("single"))
    out = {}
    for name in LAUNCH_CONFIGS:
        argv = LAUNCH + ["--arch", CONFIGS[name][0], "--mesh-model", "2"]
        if name == "mamba2":
            argv += ["--checkpoint-every", "2", "--checkpoint-dir",
                     os.path.join(tmp, "single_ckpt")]
        run = train.run(argv, params=interop.params_from_numpy(params_np[name], device="cpu"),
                        cfg=_cfg(name))
        out[name] = [r["loss"] for r in run.records]
    return out, tmp


@pytest.fixture(scope="module")
def worlds(params_np, single):
    """Every world's results, spawned once; the launcher's world after the
    single process whose snapshot its ranks restore."""
    return {name: _spawn(name, params_np, single[1]) for name in sorted(WORLDS)}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

_REF: dict = {}


def _reference(params_np, name: str, seq: int, layouts: tuple):
    """The JAX package's single-device logits, loss and gradients."""
    key = (name, seq, layouts)
    if key not in _REF:
        cfg = _cfg(name, j_get_config)
        ctx = JShardCtx(q_layout=layouts[0], kv_layout=layouts[1])
        p = jax.tree.map(jnp.asarray, params_np[name])
        b = {k: jnp.asarray(v, jnp.int32) for k, v in _batch(seq).items()}
        # Jitted: a third of the eager dispatch's time on the CPU.
        logits, _ = jax.jit(lambda q: j_forward(q, b["tokens"], cfg, ctx=ctx))(p)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: j_loss_fn(q, b, cfg, ctx=ctx), has_aux=True))(p)
        _REF[key] = (np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads))
    return _REF[key]


def _case_reference(params_np, case: str, seq: int):
    name, config = CASES[case]
    return _reference(params_np, config, seq, _layouts(config, WORLDS[name]))


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_layouts_follow_the_reference_rules(case, worlds):
    """The context's head layouts are the reference's ``attn_layouts`` (Q and
    K/V 'hd' for the 5/1-head hymba on model=2), the first length is
    sequence-sharded and the second is not; a rank's shards hold its share
    of the SSM heads where their count divides the axis and every head
    where it does not (the straddling hymba on model=4)."""
    name, config = CASES[case]
    world = WORLDS[name]
    a, b = world.seqs
    layouts = _layouts(config, world)
    if config == "hymba_q_hd":
        assert layouts == ("hd", "hd")
    split = config != "hymba_straddle"
    m, heads = _sizes(world)["model"], sh.ssm_dims(_cfg(config)).num_heads
    assert sh.ssm_heads_split(_cfg(config), m) == split
    local = heads // m if split else heads
    for res in worlds[name].values():
        assert res[(config, "layouts", a)] == layouts + (True, local)
        assert res[(config, "layouts", b)] == layouts + (False, local)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_reference(case, worlds, params_np):
    name, config = CASES[case]
    world = WORLDS[name]
    results = worlds[name]
    rows = BATCH // _data_shards(world)
    for seq in world.seqs:
        ref, _, _ = _case_reference(params_np, case, seq)
        for res in results.values():
            c = res["coords"]
            if c["model"]:
                continue
            # The rank's data rows, its vocab columns joined over the model axis.
            peers = sorted((r["coords"]["model"], r[(config, "logits", seq)])
                           for r in results.values()
                           if all(r["coords"][a] == v for a, v in c.items() if a != "model"))
            joined = np.concatenate([lg for _, lg in peers], axis=-1)
            d = c.get("data", 0)
            err = float(np.abs(joined - ref[d * rows:(d + 1) * rows]).max())
            assert err <= LOGIT_TOL, (case, seq, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case, worlds, params_np):
    name, config = CASES[case]
    for seq in WORLDS[name].seqs:
        _, ref, _ = _case_reference(params_np, case, seq)
        losses = {res[(config, "loss", seq)] for res in worlds[name].values()}
        assert len(losses) == 1, losses
        assert abs(losses.pop() - ref) <= LOSS_TOL * abs(ref), (case, seq)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_reference(case, worlds, params_np):
    """Every joined gradient: the B/C projections and convs, gate_norm and
    hymba's branch scales summed over the model axis in both layouts."""
    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    specs = sh.param_specs(params_np[config], _cfg(config), sizes)
    for seq in world.seqs:
        _, _, ref = _case_reference(params_np, case, seq)
        joined = dict(tree_lib.flatten_with_path(interop.join_params(
            [(r["coords"], r[(config, "grads", seq)]) for r in worlds[name].values()],
            specs, sizes)))
        flat_ref = tree_lib.flatten_with_path(ref)
        assert sorted(joined) == sorted(k for k, _ in flat_ref)
        for k, r in flat_ref:
            # hymba's ssm_norm is never read: zero in both.
            scale = float(np.abs(r).max())
            err = float(np.abs(joined[k] - r).max())
            assert err <= GRAD_TOL * scale or err == scale == 0.0, (case, seq, k, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_reference(case, worlds, params_np):
    """One full and one block MuonBP update on the SSM shards, joined,
    against the reference's single-device muon with the mesh's block specs
    on the same (joined) gradients and weights."""
    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    results = worlds[name]
    cfg = _cfg(config)
    params = params_np[config]
    labels = label_tree(params)
    grads = interop.join_params(
        [(r["coords"], r[(config, "grads", world.seqs[0])]) for r in results.values()],
        sh.param_specs(params, cfg, sizes), sizes)
    bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c),
                               _muon_block_specs(params, cfg, sizes))
    ref = j_muon(0.02, 0.02, period=5, weight_decay=0.1, block_specs=bspecs)
    p, g = _muon_only(params, labels), _muon_only(grads, labels)
    state = ref.init(p)
    for phase in ("full", "block"):
        upd, state = ref.update(g, state, p, phase)
        got = results[0][(config, "update", phase)]
        flat = tree_lib.flatten_with_path(upd)
        assert sorted(got) == sorted(k for k, _ in flat)
        for k, r in flat:
            np.testing.assert_allclose(got[k], np.asarray(r), rtol=0, atol=UPDATE_TOL,
                                       err_msg=f"{case} {phase} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_equals_tp_bytes_and_the_plan(case, worlds, params_np):
    """'tp' of a forward and backward equals tp_bytes (the SSM's gathers,
    reduces and norm statistic, the Q and K/V column gathers on 'hd', the
    partial leaves' sums); the block update moves no optimizer byte, the
    full one and its 'apply' exactly the plan's; no collective of another
    class."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes

    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    cfg = _cfg(config)
    params = params_np[config]
    plan = plan_comm(params, sh.param_specs(params, cfg, sizes), sizes,
                     block_specs=_muon_block_specs(params, cfg, sizes), zero1=world.zero1)
    rows = BATCH // _data_shards(world)
    for res in worlds[name].values():
        trace = CollectiveTrace()
        trace.events = res[(config, "trace")]
        for seq in world.seqs:
            got = trace.total_bytes("tp", step=("grads", seq))
            assert got == tp_bytes(cfg, rows, seq, sizes, compute_bytes=4), (case, seq)
        assert not trace.select(None, step=("update", "block"))
        for phase in ("full", "block"):
            step = ("update", phase)
            assert {e.phase for e in trace.select(None, step=step)} <= {phase}
            assert_matches_plan_by_axes(trace, plan, phase, step=step)
        assert {e.phase for e in trace.events} <= set(TRACE_PHASES) | {"check"}


@pytest.mark.parametrize("config", LAUNCH_CONFIGS)
def test_launcher_trains_tensor_parallel(config, worlds, single, params_np):
    """``--mesh data=2,model=2 --zero1``: the path line, the shards, the
    losses of one process, and a trace whose 'tp' equals tp_bytes, whose
    optimizer phases equal plan_comm and whose collectives are of the known
    classes, every step."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes
    from repro_torch.launch.train import matrix_block_specs

    world = WORLDS["data2_model2_zero1"]
    sizes = _sizes(world)
    cfg = _cfg(config)
    full = interop.params_from_numpy(params_np[config], device="cpu")
    plan = plan_comm(full, sh.param_specs(full, cfg, sizes), sizes,
                     block_specs=matrix_block_specs(full, cfg, sizes), zero1=True)
    results = worlds["data2_model2_zero1"]
    assert "mesh path: tensor_parallel" in results[0][(config, "launch")]["stdout"]
    inner = sh.ssm_dims(cfg).d_inner // sizes["model"]
    for res in results.values():
        got = res[(config, "launch")]
        assert got["tensor_parallel"] is True
        assert got["shapes"][("layers", "ssm", "wx")] == (cfg.num_layers, cfg.d_model, inner)
        assert got["shapes"][("layers", "ssm", "out_proj")] == (cfg.num_layers, inner,
                                                                 cfg.d_model)
        np.testing.assert_allclose(got["losses"], single[0][config], rtol=LAUNCH_TOL, atol=0)
        trace = CollectiveTrace()
        trace.events = got["trace"]
        assert got["phases"] == ["full", "block", "full"]
        for step, phase in enumerate(got["phases"]):
            assert trace.total_bytes("tp", step=step) == tp_bytes(
                cfg, BATCH // _data_shards(world), 16, sizes, compute_bytes=4)
            assert_matches_plan_by_axes(trace, plan, (phase, "apply"), step=step)
            if phase == "block":
                assert not trace.select("block", step=step)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


@pytest.mark.parametrize("config", LAUNCH_CONFIGS)
def test_mesh_bytes_predicts_the_launcher_trace(config, worlds):
    """``scripts.mesh_bytes``, from the shapes alone, gives every phase's
    bytes of the launcher's steps on the mesh and the parameters a rank
    holds."""
    from repro_torch.distributed.audit import CollectiveTrace
    from repro_torch.scripts.mesh_bytes import mesh_bytes

    sizes = _sizes(WORLDS["data2_model2_zero1"])
    want = mesh_bytes(_cfg(config), sizes, batch=BATCH, seq=16, zero1=True, compute_bytes=4)
    assert want["path"] == sh.TENSOR_PARALLEL
    for res in worlds["data2_model2_zero1"].values():
        got = res[(config, "launch")]
        assert want["params_a_rank"] == sum(int(np.prod(s)) for s in got["shapes"].values())
        trace = CollectiveTrace()
        trace.events = got["trace"]
        for step, phase in enumerate(got["phases"]):
            for cls in ("tp", "grad_reduce", "apply", "block", "full"):
                expect = want[cls] if cls != "full" or phase == "full" else 0
                assert trace.total_bytes(cls, step=step) == expect, (config, step, cls)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


@pytest.mark.parametrize("seq", WORLDS["model4"].seqs)
def test_mesh_bytes_predicts_the_whole_heads_trace(seq, worlds, params_np):
    """``scripts.mesh_bytes`` from fake tensors gives the straddling hymba's
    'tp' bytes on model=4 (the convolved input's gather and its
    reduce-scatter, their recompute, the whole per-head leaves' sums) at a
    length the axis divides and one it does not, and the parameters a rank
    holds, ``wdt`` and the per-head scalars whole."""
    from repro_torch.distributed.audit import CollectiveTrace
    from repro_torch.scripts.mesh_bytes import mesh_bytes

    cfg = _cfg("hymba_straddle")
    sizes = _sizes(WORLDS["model4"])
    params = params_np["hymba_straddle"]
    specs = sh.param_specs(params, cfg, sizes)
    assert specs["layers"]["ssm"]["wdt"] == (None, None, None)
    assert specs["layers"]["ssm"]["A_log"] == (None, None)
    assert specs["layers"]["ssm"]["wx"] == (None, None, "model")
    want = mesh_bytes(cfg, sizes, batch=BATCH, seq=seq, compute_bytes=4)
    assert want["path"] == sh.TENSOR_PARALLEL
    assert want["params_a_rank"] == sum(
        int(np.prod(sh.local_shape(s, p.shape, sizes)))
        for p, s in zip(tree_lib.leaves(params), tree_lib.leaves(specs)))
    for res in worlds["model4"].values():
        trace = CollectiveTrace()
        trace.events = res[("hymba_straddle", "trace")]
        assert trace.total_bytes("tp", step=("grads", seq)) == want["tp"], seq


def test_mamba2_snapshots_cross_between_mesh_and_one_process(worlds, params_np, single):
    from repro_torch.core import adamw, combine, muon
    from repro_torch.training.train_step import init_train_state

    results = worlds["data2_model2_zero1"]
    # Mesh -> one process: the full leaves the ranks joined, bitwise.
    snap = checkpoint.list_snapshots(os.path.join(single[1], "mesh_ckpt"))[-1][1]
    params = interop.params_from_numpy(params_np["mamba2"], device="cpu")
    opt = combine({"muon": muon(0.02, 0.02, period=2, weight_decay=0.1),
                   "adamw": adamw(0.008, weight_decay=0.1)}, label_tree(params))
    tpl = init_train_state(params, opt)
    r_params, r_opt, step = checkpoint.restore(snap, tpl.params, tpl.opt_state)
    assert step == LAUNCH_STEPS - 1   # the last step's index
    for k, arr in checkpoint._flatten(r_params).items():
        assert np.array_equal(arr, results[0]["final_params"][k]), k
    for k, arr in checkpoint._flatten(r_opt).items():
        assert np.array_equal(arr, checkpoint._fit_lead(results[0]["final_state"][k],
                                                        arr.shape, k)), k
    # One process -> mesh: every rank's restored shards are the file's cut.
    assert all(res["restore_into_mesh"] for res in results.values())


@pytest.mark.parametrize("arch,model", [("mamba2-1.3b", 2), ("mamba2-1.3b", 4),
                                        ("hymba-1.5b", 2), ("hymba-1.5b", 4),
                                        ("hymba-1.5b", 8), ("hymba-1.5b", 16)])
def test_mesh_path_runs_the_ssm_archs_tensor_parallel(arch, model):
    """At full width: mamba2 on model 2 and 4, hymba on model 2, 4, 8 and
    16 (the reference's production mesh) with Q and K/V in 'hd' (25 and 5
    heads of 64), its 50 SSM heads split on model=2 and whole on the
    others, where its d_inner of 3200 splits off the head boundaries."""
    cfg = get_config(arch)
    assert sh.mesh_path(cfg, {"data": 2, "model": model}) == sh.TENSOR_PARALLEL
    assert sh.ssm_heads_split(cfg, model) == (arch == "mamba2-1.3b" or model == 2)
    if arch == "hymba-1.5b":
        assert sh.attn_layouts(cfg, model) == ("hd", "hd")


def test_mesh_path_keeps_a_d_inner_the_axis_does_not_divide_whole():
    """Heads the axis does not divide run whole on every rank (full hymba on
    model=4, its 50 SSM heads), and so does a d_inner the axis does not
    divide, as the reference replicates wz/wx there: a hymba of d_model
    1604 (d_inner 3208 in 401 heads of 8) on model=16 is tensor-parallel
    with its SSM whole on every rank."""
    assert sh.mesh_path(get_config("hymba-1.5b"), {"model": 4}) == sh.TENSOR_PARALLEL
    assert not sh.whole_sub_blocks(get_config("hymba-1.5b"), {"model": 4})["ssm"]
    cfg = dataclasses.replace(get_config("hymba-1.5b"), d_model=1604, ssm_head_dim=8)
    assert sh.mesh_path(cfg, {"model": 16}) == sh.TENSOR_PARALLEL
    assert sh.whole_sub_blocks(cfg, {"model": 16})["ssm"]
