"""The tensor-parallel dense model on multi-process ``gloo`` worlds on the CPU.

Each world runs once per module (a fixture spawns its ranks, which run
every case and hand back numpy results): ``model=2``, ``data=2,model=2``
with ZeRO-1, and ``model=4``, on which the reduced muonbp-960m's 2 KV heads
take the 'hd' layout. The ``model=2`` world also runs the reduced
gemma2-9b: tied embeddings (``embed.T`` split on the vocab, so the lookup
and the head both put gradient into one shard), post-attention and
post-MLP norms on the sequence shard, attention and final softcaps,
``embed_scale``, and its sliding window, cut to 8 tokens so that the
sequences here reach past it. Each rank holds only its ``param_specs``
shards of the reference's weights (``interop.shard_params``), fp32.

Held against the JAX package's single-device ``forward``, ``loss_fn`` and
``jax.grad`` on the same weights (its ``ShardCtx`` carrying the world's
head layouts, mesh-free), at a sequence length the model axis divides
(sequence-sharded residual) and one it does not:

* the logits joined over the vocab, max abs 1e-5;
* the loss, relative 1e-6;
* every gradient after ``reduce_grads`` joined over the ranks
  (``interop.join_params``), max abs 1e-5 of the leaf's max|grad|: the
  norm gains' come out whole only if each rank's sequence shard is summed
  over the model axis;
* the ``'tp'`` trace equal to ``plan.tp_bytes``, to the byte.

Through the launcher under ``--mesh``: the losses against one process
(relative 1e-5; on 'hd' against the single-process step that computes the
'hd' split), every collective of a class the port records
(``audit.PHASES``), the gradient reduce moving exactly the
shards, snapshots crossing between the mesh and one process bitwise; Q
and K/V in 'hd' (3 Q heads and 1 KV head on ``model=2``) against the
single-process step that computes the 'hd' split; the reduced internvl2-1b
on ``data=4,model=1`` runs replicated (no ``'tp'``: the gradient reduce of
the whole leaves and the optimizer's collectives only); Q heads with no
layout (whisper-small's 3 heads of 33 on ``model=2``) run whole on every
rank, the losses one process's.
"""

import dataclasses
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
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.transformer import ShardCtx as JShardCtx
from repro.models.transformer import forward as j_forward
from repro_torch import interop
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.distributed import tp_bytes
from repro_torch.distributed.audit import PHASES as TRACE_PHASES
from repro_torch.sharding import specs as sh
from repro_torch.training import checkpoint

ARCH = "muonbp-960m"
GEMMA = "gemma2-9b"
GEMMA_WINDOW = 8     # the reduced gemma2-9b's window (64) cut below the sequences
BATCH = 4
LOGIT_TOL = 1e-5     # max abs
LOSS_TOL = 1e-6      # relative
GRAD_TOL = 1e-5      # max abs over the leaf's max|grad|
LAUNCH_TOL = 1e-5    # launcher on the mesh vs one process, relative
LAUNCH = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
          "--period", "2", "--compute-dtype", "float32", "--schedule", "const"]
REPLICATED_ARCH = "internvl2-1b"   # run on a mesh without a model split
REPLICATED_SPEC = "data=4,model=1"
REPLICATED_LAUNCH = ["--arch", REPLICATED_ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                     "--batch", "4", "--seq", "16", "--period", "2", "--compute-dtype",
                     "float32"]
# Q heads whose count and head_dim neither divide model=2: no layout.
NO_Q_LAYOUT = dict(num_heads=3, num_kv_heads=1, head_dim=33)
# whisper has no RoPE, so an odd head_dim runs: its attention whole on model=2.
WHOLE_Q_ARCH = "whisper-small"
WHOLE_Q_HEADS = dict(num_heads=3, num_kv_heads=3, head_dim=33)
WHOLE_Q_LAUNCH = ["--arch", WHOLE_Q_ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                  "--batch", "4", "--seq", "16", "--period", "2", "--compute-dtype", "float32",
                  "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    seqs: tuple              # the first sequence-sharded, the second not
    zero1: bool = False
    launch: bool = False     # the dense launcher on the mesh
    replicated: bool = False  # the reduced REPLICATED_ARCH on REPLICATED_SPEC (4 ranks)
    whole_q: bool = False    # the launcher with Q heads of no layout (WHOLE_Q_HEADS)
    q_hd: bool = False       # the launcher with Q and K/V in 'hd' (Q_HD_HEADS)
    archs: tuple = (ARCH,)   # the configs held against the reference


WORLDS = {
    "model2": World("model=2", seqs=(16, 15), whole_q=True, q_hd=True, archs=(ARCH, GEMMA)),
    "data2_model2_zero1": World("data=2,model=2", seqs=(16, 15), zero1=True, launch=True,
                                replicated=True),
    "model4_hd": World("model=4", seqs=(16, 18), launch=True),
}
# A case is a world and a config: the world's name alone for muonbp-960m.
# Q and K/V heads that neither divide model=2: both lay out 'hd'.
Q_HD_HEADS = dict(num_heads=3, num_kv_heads=1)
CASES = {name if arch == ARCH else f"{name}:{arch}": (name, arch)
         for name, world in WORLDS.items() for arch in world.archs}


def _cfg(arch: str, get=get_config):
    """The reduced config of ``arch`` (``get``: the port's or the JAX
    package's ``get_config``), gemma2-9b's window cut to GEMMA_WINDOW."""
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, window_size=GEMMA_WINDOW) if arch == GEMMA else cfg


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _whole_q_cfg():
    return dataclasses.replace(get_config(WHOLE_Q_ARCH).reduced(), **WHOLE_Q_HEADS)


def _layouts(world: World, arch: str = ARCH) -> tuple:
    return sh.attn_layouts(_cfg(arch), _sizes(world)["model"])


def _batch(seq: int) -> dict:
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, get_config(ARCH).reduced().vocab_size, (BATCH, seq))
    labels = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
    return {"tokens": tokens, "labels": labels}


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

    from repro_torch.distributed import make_engine
    from repro_torch.distributed import zero1 as zero1_lib
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models.model import forward
    from repro_torch.obs import MemorySink
    from repro_torch.training.train_step import loss_and_grads, reduce_grads

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)
    out: dict = {}
    try:
        mesh = make_mesh_from_spec(world.spec)
        sizes = sh.mesh_axis_sizes(mesh)
        for arch in world.archs:
            cfg = _cfg(arch)
            full = interop.params_from_numpy(params_np[arch], device="cpu")
            engine = make_engine(full, sh.param_specs(full, cfg, sizes), mesh,
                                 zero1=world.zero1)
            comm = engine.comm
            out["coords"] = dict(comm.coords)
            params = interop.shard_params(params_np[arch], cfg, sizes, comm.coords,
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
                out[(arch, "seq_shard", seq)] = ctx.seq_shard
                out[(arch, "loss", seq)] = float(loss)
                out[(arch, "grads", seq)] = interop.params_to_numpy(grads)
                out[(arch, "logits", seq)] = logits.numpy()
            out[(arch, "trace")] = list(comm.trace.events)
        cfg = _cfg(ARCH)
        params_np = params_np[ARCH]

        if world.launch:
            ckpt = os.path.join(tmp, "mesh_ckpt")
            argv = LAUNCH + ["--mesh", world.spec, "--checkpoint-every", "2",
                             "--checkpoint-dir", ckpt] + (["--zero1"] if world.zero1 else [])
            sink = MemorySink()
            run = train.run(argv, params=interop.params_from_numpy(params_np, device="cpu"),
                            cfg=cfg, sinks=[sink])
            out["losses"] = [r["loss"] for r in run.records]
            out["launch_trace"] = list(run.engine.comm.trace.events)
            out["shard_bytes"] = sum(p.numel() * p.element_size()
                                     for p in tree_lib.leaves(run.state.params))
            out["spans"] = sorted({r["name"] for r in sink.records
                                   if r.get("event") == "span"})
            joined = zero1_lib.gather_params(run.state.params, run.engine, phase="check")
            state = zero1_lib.gather_state(run.state.opt_state, run.state.params, run.engine,
                                           phase="check")
            if rank == 0:
                out["final_params"] = checkpoint._flatten(joined)
                out["final_state"] = checkpoint._flatten(state)
            single = os.path.join(tmp, "single_ckpt")
            if os.path.isdir(single):
                # One process -> the mesh: the parameters restore cut to
                # this rank's shards.
                snap = checkpoint.list_snapshots(single)[-1][1]
                shardings = zero1_lib.opt_shardings(run.state.opt_state, run.state.params,
                                                    run.engine)
                r_params, _, _ = checkpoint.restore(snap, run.state.params,
                                                    run.state.opt_state,
                                                    opt_shardings=shardings, engine=run.engine)
                on_disk = dict(np.load(os.path.join(snap, "params.npz")))
                cut = interop.shard_params(checkpoint.map_leaves(
                    lambda key, _: on_disk[key], params_np), cfg, sizes, comm.coords, "cpu")
                out["restore_into_mesh"] = all(
                    torch.equal(a, b) for a, b in zip(tree_lib.leaves(r_params),
                                                      tree_lib.leaves(cut)))

        if world.replicated:
            rep_cfg = get_config(REPLICATED_ARCH).reduced()
            run = train.run(REPLICATED_LAUNCH + ["--mesh", REPLICATED_SPEC], cfg=rep_cfg)
            out["rep_losses"] = [r["loss"] for r in run.records]
            out["rep_trace"] = list(run.engine.comm.trace.events)
            out["rep_tensor_parallel"] = run.engine.tensor_parallel
            # The whole leaves' gradients, reduced over the data axis.
            out["rep_leaf_bytes"] = sum(p.numel() * p.element_size()
                                        for p in tree_lib.leaves(run.state.params))

        if world.whole_q:
            run = train.run(WHOLE_Q_LAUNCH + ["--mesh", world.spec], cfg=_whole_q_cfg())
            out["whole_q_losses"] = [r["loss"] for r in run.records]
            out["whole_q_layouts"] = (run.ctx.q_layout, run.ctx.kv_layout)
            out["whole_q_shapes"] = {k: tuple(p.shape)
                                     for k, p in tree_lib.flatten_with_path(run.state.params)}

        if world.q_hd:
            run = train.run(LAUNCH + ["--mesh", world.spec],
                            cfg=dataclasses.replace(cfg, **Q_HD_HEADS))
            out["q_hd_losses"] = [r["loss"] for r in run.records]
            out["q_hd_layouts"] = (run.ctx.q_layout, run.ctx.kv_layout)
        dist.barrier()
    finally:
        dist.destroy_process_group()
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
def arch_params_np():
    """The reference's weights of every config the worlds run, from one seed."""
    archs = sorted({a for world in WORLDS.values() for a in world.archs})
    return {a: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(a, j_get_config)))
            for a in archs}


@pytest.fixture(scope="module")
def params_np(arch_params_np):
    return arch_params_np[ARCH]


@pytest.fixture(scope="module")
def worlds(arch_params_np, params_np, tmp_path_factory):
    """Every world's results, spawned once; the data world after a
    single-process launcher run whose snapshot its ranks restore."""
    from repro_torch.launch import train

    out = {}
    for name in sorted(WORLDS):
        tmp = str(tmp_path_factory.mktemp(name))
        single = None
        if name == "data2_model2_zero1":
            single = train.run(LAUNCH + ["--mesh-model", "2", "--checkpoint-every", "2",
                                         "--checkpoint-dir", os.path.join(tmp, "single_ckpt")],
                               params=interop.params_from_numpy(params_np, device="cpu"),
                               cfg=get_config(ARCH).reduced())
        out[name] = (_spawn(name, arch_params_np, tmp), tmp, single)
    return out


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

_REF: dict = {}


def _reference(params_np, seq: int, kv_layout: str, arch: str = ARCH):
    """The JAX package's single-device logits, loss and gradients."""
    key = (arch, seq, kv_layout)
    if key not in _REF:
        cfg = _cfg(arch, j_get_config)
        ctx = JShardCtx(kv_layout=kv_layout)
        p = jax.tree.map(jnp.asarray, params_np)
        b = {k: jnp.asarray(v, jnp.int32) for k, v in _batch(seq).items()}
        # Jitted: a third of the eager dispatch's time on the CPU.
        logits, _ = jax.jit(lambda q: j_forward(q, b["tokens"], cfg, ctx=ctx))(p)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: j_loss_fn(q, b, cfg, ctx=ctx), has_aux=True))(p)
        _REF[key] = (np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads))
    return _REF[key]


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_reference(case, worlds, arch_params_np):
    name, arch = CASES[case]
    results, _, _ = worlds[name]
    world = WORLDS[name]
    sizes = _sizes(world)
    m = sizes["model"]
    for seq in world.seqs:
        ref, _, _ = _reference(arch_params_np[arch], seq, _layouts(world, arch)[1], arch)
        rows_per = BATCH // (int(np.prod(list(sizes.values()))) // m)
        for res in results.values():
            c = res["coords"]
            if c["model"]:
                continue
            # The rank's data rows, its vocab columns joined over the model axis.
            peers = sorted((r["coords"]["model"], r[(arch, "logits", seq)])
                           for r in results.values()
                           if all(r["coords"][a] == v for a, v in c.items() if a != "model"))
            joined = np.concatenate([lg for _, lg in peers], axis=-1)
            d = c.get("data", 0)
            err = float(np.abs(joined - ref[d * rows_per:(d + 1) * rows_per]).max())
            assert err <= LOGIT_TOL, (case, seq, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case, worlds, arch_params_np):
    name, arch = CASES[case]
    results, _, _ = worlds[name]
    world = WORLDS[name]
    for seq in world.seqs:
        _, ref, _ = _reference(arch_params_np[arch], seq, _layouts(world, arch)[1], arch)
        losses = {res[(arch, "loss", seq)] for res in results.values()}
        assert len(losses) == 1, losses
        assert abs(losses.pop() - ref) <= LOSS_TOL * abs(ref), (case, seq)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_reference(case, worlds, arch_params_np):
    """Every joined gradient, the norm gains (summed over the model axis
    under sequence sharding) and gemma2-9b's tied embedding among them."""
    name, arch = CASES[case]
    results, _, _ = worlds[name]
    world = WORLDS[name]
    sizes = _sizes(world)
    specs = sh.param_specs(arch_params_np[arch], _cfg(arch), sizes)
    for seq in world.seqs:
        _, _, ref = _reference(arch_params_np[arch], seq, _layouts(world, arch)[1], arch)
        joined = dict(tree_lib.flatten_with_path(interop.join_params(
            [(r["coords"], r[(arch, "grads", seq)]) for r in results.values()], specs, sizes)))
        flat_ref = tree_lib.flatten_with_path(ref)
        assert sorted(joined) == sorted(k for k, _ in flat_ref)
        for k, r in flat_ref:
            err = float(np.abs(joined[k] - r).max())
            assert err <= GRAD_TOL * float(np.abs(r).max()), (case, seq, k, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_sharding_follows_the_reference_rule(case, worlds):
    """The first length is sequence-sharded and the second is not (the
    other tests hold both to the reference)."""
    name, arch = CASES[case]
    results, _, _ = worlds[name]
    a, b = WORLDS[name].seqs
    for res in results.values():
        assert res[(arch, "seq_shard", a)] and not res[(arch, "seq_shard", b)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_trace_equals_tp_bytes(case, worlds):
    """gemma2-9b's adds the post-norms' gradients to the sum over the model
    axis."""
    from repro_torch.distributed.audit import CollectiveTrace

    name, arch = CASES[case]
    results, _, _ = worlds[name]
    world = WORLDS[name]
    sizes = _sizes(world)
    cfg = _cfg(arch)
    rows = BATCH // int(np.prod([v for a, v in sizes.items() if a != "model"]))
    for res in results.values():
        trace = CollectiveTrace()
        trace.events = res[(arch, "trace")]
        for seq in world.seqs:
            got = trace.total_bytes("tp", step=("grads", seq))
            assert got == tp_bytes(cfg, rows, seq, sizes, compute_bytes=4), (case, seq)
            assert {e.phase for e in trace.select(None, step=("grads", seq))} <= set(TRACE_PHASES)


@pytest.mark.parametrize("name", ["data2_model2_zero1", "model4_hd"])
def test_launcher_trace_moves_no_replica_gather(name, worlds):
    """Under the launcher: 'tp' equals tp_bytes every step, every
    collective is of a class the port records (no gather back to whole
    replicas), and the gradient reduce moves exactly each rank's shards
    (plus the loss and metrics)."""
    from repro_torch.distributed.audit import CollectiveTrace

    results, _, _ = worlds[name]
    sizes = _sizes(WORLDS[name])
    cfg = get_config(ARCH).reduced()
    data = int(np.prod([v for a, v in sizes.items() if a != "model"]))
    for res in results.values():
        trace = CollectiveTrace()
        trace.events = res["launch_trace"]
        for step in range(3):
            assert trace.total_bytes("tp", step=step) == tp_bytes(cfg, BATCH // data, 16, sizes,
                                                                  compute_bytes=4)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)
            reduce = trace.select("grad_reduce", step=step)
            if data > 1:
                # The shards' bytes, then one vector of the loss and metrics.
                assert sum(e.bytes for e in reduce[:-1]) == res["shard_bytes"]
                assert reduce[-1].bytes == 4 * 3
            else:
                assert not reduce


def _single_process_losses(params, cfg, model: int, kv_layout: str,
                           q_layout: str = "head") -> list:
    """The launcher's loop on one process with the block grid of
    ``model=model`` and the model's head layouts given (the single-process
    launcher computes 'head' only)."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.training.train_step import init_train_state, train_step

    args = train.parser().parse_args(LAUNCH)
    opt, period = train.build_optimizer(
        "muonbp", params, lr=args.lr, adam_lr=args.adam_lr, period=args.period,
        block_specs=train.matrix_block_specs(params, cfg, {"model": model}))
    state = init_train_state(params, opt)
    pipe = iter(SyntheticLM(cfg, args.batch, args.seq, seed=args.seed))
    losses = []
    for step in range(args.steps):
        batch = train.device_batch(next(pipe), "cpu")
        state, metrics = train_step(state, batch, cfg=cfg, optimizer=opt,
                                    phase=train.phase_for_step(step, period),
                                    compute_dtype=torch.float32,
                                    ctx=sh.ShardCtx(q_layout=q_layout, kv_layout=kv_layout))
        losses.append(float(metrics["loss"]))
    return losses


def test_launcher_on_the_mesh_matches_one_process(worlds):
    results, _, single = worlds["data2_model2_zero1"]
    ref = [r["loss"] for r in single.records]
    for res in results.values():
        np.testing.assert_allclose(res["losses"], ref, rtol=LAUNCH_TOL, atol=0)
        assert res["losses"] == results[0]["losses"]
    assert {"train.fwd_bwd", "train.grad_reduce", "train.apply"} <= set(results[0]["spans"])


def test_launcher_on_the_hd_layout_matches_one_process(worlds, params_np):
    results, _, _ = worlds["model4_hd"]
    ref = _single_process_losses(interop.params_from_numpy(params_np, device="cpu"),
                                 get_config(ARCH).reduced(), 4, "hd")
    for res in results.values():
        np.testing.assert_allclose(res["losses"], ref, rtol=LAUNCH_TOL, atol=0)


def test_launcher_on_the_q_hd_layout_matches_one_process(worlds):
    """3 Q heads and 1 KV head on model=2: each rank gathers its Q columns,
    attends over every head and keeps its 'hd' slice for the row-parallel
    wo; the losses equal the single-process step that computes the 'hd'
    split."""
    from repro_torch.models.model import init_params

    results, _, _ = worlds["model2"]
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **Q_HD_HEADS)
    ref = _single_process_losses(init_params(cfg, seed=0, device="cpu"), cfg, 2, "hd", "hd")
    for res in results.values():
        assert res["q_hd_layouts"] == ("hd", "hd")
        np.testing.assert_allclose(res["q_hd_losses"], ref, rtol=LAUNCH_TOL, atol=0)


def test_snapshots_cross_between_mesh_and_one_process(worlds, params_np):
    from repro_torch.core import adamw, combine, label_tree, muon
    from repro_torch.training.train_step import init_train_state

    results, tmp, _ = worlds["data2_model2_zero1"]
    # Mesh -> one process: the full leaves the ranks joined, bitwise.
    snap = checkpoint.list_snapshots(os.path.join(tmp, "mesh_ckpt"))[-1][1]
    params = interop.params_from_numpy(params_np, device="cpu")
    opt = combine({"muon": muon(0.02, 0.02, period=2, weight_decay=0.1),
                   "adamw": adamw(0.008, weight_decay=0.1)}, label_tree(params))
    tpl = init_train_state(params, opt)
    r_params, r_opt, step = checkpoint.restore(snap, tpl.params, tpl.opt_state)
    assert step == 2
    for k, arr in checkpoint._flatten(r_params).items():
        assert np.array_equal(arr, results[0]["final_params"][k]), k
    for k, arr in checkpoint._flatten(r_opt).items():
        assert np.array_equal(arr, checkpoint._fit_lead(results[0]["final_state"][k],
                                                        arr.shape, k)), k
    # One process -> mesh: every rank's restored shards are the file's cut.
    assert all(res["restore_into_mesh"] for res in results.values())


def test_non_dense_arch_runs_replicated(worlds):
    """The reduced internvl2-1b on data=4,model=1, a mesh without a model
    split, keeps the replicated path: whole replicas, no 'tp', nothing but
    the gradient reduce (moving the whole leaves) and the optimizer's
    collectives, losses equal to one process's."""
    from repro_torch.distributed.audit import CollectiveTrace
    from repro_torch.launch import train

    results, _, _ = worlds["data2_model2_zero1"]
    single = train.run(REPLICATED_LAUNCH, cfg=get_config(REPLICATED_ARCH).reduced())
    ref = [r["loss"] for r in single.records]
    for res in results.values():
        assert res["rep_tensor_parallel"] is False
        np.testing.assert_allclose(res["rep_losses"], ref, rtol=LAUNCH_TOL, atol=0)
        trace = CollectiveTrace()
        trace.events = res["rep_trace"]
        for step in range(len(ref)):
            # Whole leaves: no tensor-parallel collective, nothing but the
            # gradient reduce and the optimizer's own.
            assert {e.phase for e in trace.select(None, step=step)} <= {
                "grad_reduce", "block", "full", "apply"}
            reduce = trace.select("grad_reduce", step=step)
            assert sum(e.bytes for e in reduce[:-1]) == res["rep_leaf_bytes"]
        assert not trace.select("tp")


def test_launcher_runs_a_q_layout_whole(worlds):
    """Q heads whose count and head_dim neither divide the model axis have
    no layout: whisper-small with 3 heads of 33 on model=2 keeps its
    attention projections whole on every rank (the decoder's, the
    cross-attention's and the encoder's), computes them whole and trains
    with one process's losses."""
    from repro_torch.launch import train

    results, _, _ = worlds["model2"]
    cfg = _whole_q_cfg()
    ref = [r["loss"] for r in train.run(WHOLE_Q_LAUNCH + ["--mesh-model", "2"],
                                        cfg=cfg).records]
    for res in results.values():
        assert res["whole_q_layouts"] == (None, None)
        for group in (("layers", "attn"), ("layers", "cross"), ("encoder", "attn")):
            assert res["whole_q_shapes"][group + ("wq",)][-1] == cfg.q_dim
            assert res["whole_q_shapes"][group + ("wo",)][-2] == cfg.q_dim
        np.testing.assert_allclose(res["whole_q_losses"], ref, rtol=LAUNCH_TOL, atol=0)


@pytest.mark.parametrize("arch,overrides,model,whole", [
    (REPLICATED_ARCH, NO_Q_LAYOUT, 2, ("q", "kv")),
    (ARCH, dict(num_heads=3, num_kv_heads=1, head_dim=33), 2, ("q", "kv")),
    (ARCH, dict(num_kv_heads=1, head_dim=33), 2, ("kv",)),
    ("whisper-small", dict(num_heads=3, num_kv_heads=3, head_dim=33), 4, ("q", "kv")),
])
def test_mesh_path_runs_layouts_whole(arch, overrides, model, whole):
    """A Q or KV layout of None runs tensor-parallel on every arch, the
    projections whole on every rank (internvl2-1b's 3 Q heads of 33 on
    model=2, whisper's 3 heads of 33 on model=4); the context says so."""
    import types

    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    assert sh.mesh_path(cfg, {"model": model}) == sh.TENSOR_PARALLEL
    got = sh.whole_sub_blocks(cfg, {"model": model})
    assert {k for k, v in got.items() if v} == set(whole)
    comm = types.SimpleNamespace(size=lambda axes: model, index=lambda axes: 0)
    ctx = sh.make_ctx(cfg, comm=comm, seq=16)
    assert (ctx.q_layout is None, ctx.kv_layout is None) == ("q" in whole, "kv" in whole)
    assert ctx.attn_whole == ("q" in whole)


@pytest.mark.parametrize("arch,sizes,path", [
    (ARCH, {"model": 2}, sh.TENSOR_PARALLEL),
    (ARCH, {"data": 2, "model": 4}, sh.TENSOR_PARALLEL),
    (ARCH, {"data": 4, "model": 1}, sh.REPLICATED),
    ("olmoe-1b-7b", {"model": 4}, sh.TENSOR_PARALLEL),
    ("mamba2-1.3b", {"model": 4}, sh.TENSOR_PARALLEL),
    ("hymba-1.5b", {"model": 4}, sh.TENSOR_PARALLEL),
    ("internvl2-1b", {"model": 2}, sh.TENSOR_PARALLEL),
    ("whisper-small", {"model": 2}, sh.TENSOR_PARALLEL),
    ("internvl2-1b", {"model": 4}, sh.TENSOR_PARALLEL),
    ("whisper-small", {"model": 4}, sh.TENSOR_PARALLEL),
    ("internvl2-1b", {"data": 2, "model": 8}, sh.TENSOR_PARALLEL),
    ("whisper-small", {"data": 2, "model": 8}, sh.TENSOR_PARALLEL),
    ("internvl2-1b", {"data": 4, "model": 1}, sh.REPLICATED),
    ("whisper-small", {"data": 4, "model": 1}, sh.REPLICATED),
])
def test_mesh_path_decides_from_the_config_and_the_axes(arch, sizes, path):
    """Every arch on a model split runs tensor-parallel; a mesh without one
    runs replicated."""
    assert sh.mesh_path(get_config(arch).reduced(), sizes) == path


@pytest.mark.parametrize("arch,sizes,seq,match", [
    (REPLICATED_ARCH, {"data": 4, "model": 1}, 16, None),
    (ARCH, {"model": 2}, None, "sequence length"),
    (ARCH, {"model": 2}, 16, None),
])
def test_make_ctx_follows_the_engine(arch, sizes, seq, match):
    """The engine's mesh is the one source: without a model split the
    one-device context, on one the tensor-parallel context, which needs the
    residual's length."""
    import types

    from repro_torch.distributed.engine import ShardMapEngine

    m = sizes["model"]
    comm = types.SimpleNamespace(size=lambda axes: m, index=lambda axes: m - 1)
    engine = ShardMapEngine(mesh=sizes, uspec_by_path={}, comm=comm)
    cfg = get_config(arch).reduced()
    if match is not None:
        with pytest.raises(ValueError, match=match):
            sh.make_ctx(cfg, engine, seq=seq)
        return
    ctx = sh.make_ctx(cfg, engine, seq=seq)
    assert engine.tensor_parallel is ctx.tensor_parallel is (m > 1)
    if m > 1:
        assert (ctx.size, ctx.index, ctx.seq_shard) == (m, m - 1, True)
    else:
        assert ctx == sh.ShardCtx()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_gate_norm_stays_replicated(arch):
    """The name rule for norms comes before the SSM group's, so gate_norm is
    replicated, as in the reference (whose column rule for it is never
    reached), while the d_inner weights beside it split."""
    cfg = get_config(arch).reduced()
    params = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), _cfg(arch, j_get_config)))
    specs = sh.param_specs(params, cfg, {"model": 2})
    assert specs["layers"]["ssm"]["gate_norm"] == (None, None)
    assert specs["layers"]["ssm"]["wx"][-1] == sh.MODEL_AXIS
