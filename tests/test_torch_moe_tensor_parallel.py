"""The tensor-parallel Mixture-of-Experts model on multi-process ``gloo``
worlds on the CPU.

Two worlds, each spawned once a module (its ranks run every case and hand
back numpy results): ``data=2,model=2`` with ZeRO-1, and ``model=4``, on
which the reduced mixtral-8x7b's 2 KV heads take the 'hd' layout. Each runs
the reduced olmoe-1b-7b (``softmax_topk`` router) and mixtral-8x7b
(``topk_softmax``) in fp32 from the reference's weights, each rank holding
its ``param_specs`` shards (the experts' ``(E, D, F/m)`` and ``(E, F/m,
D)``), at a sequence length the model axis divides (a sequence-sharded
residual) and one it does not.

The oracle. The reference's mesh routes each data shard's tokens alone
(``x_spec = P(data_axes, None, None)`` in ``repro/models/moe.py``) and
averages the aux losses over the data shards; its own mesh tests fail on
this tree, so it is held here as that computation: the single-device
``loss_fn`` and ``jax.grad`` on each data shard's rows, averaged over the
shards. Held:

* each layer's ``top_idx`` equal to the reference's, exactly (a flip is
  reported with the gap between the k-th and (k+1)-th router logits);
* the loss, ``ce``, ``load_balance`` and ``z_loss`` within 1e-5 relative;
* every gradient after ``reduce_grads``, joined over the ranks, within
  1e-4 of its leaf's max|grad| of ``jax.grad``'s: the router's is partial
  over ``model`` in both layouts, and the aux terms count once only through
  ``tensor_parallel.replica_mean``;
* one MuonBP full and one block update of the joined gradients on the
  engine against the reference's single-device ``muon`` with the mesh's
  block specs, max abs 1e-5;
* the ``'tp'`` trace equal to ``plan.tp_bytes``; through the launcher
  (olmoe, three steps): the path line, the expert shards, ``'tp'`` equal to
  ``tp_bytes`` a step, every optimizer phase equal to ``plan_comm``, and every
  collective of a class the port records (``audit.PHASES``).
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

import repro.models.moe as j_moe
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

ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")
LAUNCH_ARCH = "olmoe-1b-7b"
BATCH = 4
LOSS_TOL = 1e-5      # relative, the loss and each metric
GRAD_TOL = 1e-4      # max abs over the leaf's max|grad|
UPDATE_TOL = 1e-5    # max abs, the port's update tolerance (tests/test_torch_optim.py)
LAUNCH_STEPS = 3     # full, block, full
LAUNCH = ["--arch", LAUNCH_ARCH, "--reduced", "--device", "cpu", "--steps", str(LAUNCH_STEPS),
          "--batch", str(BATCH), "--seq", "16", "--period", "2", "--compute-dtype", "float32",
          "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    seqs: tuple          # the first sequence-sharded, the second not
    zero1: bool = False


WORLDS = {
    "data2_model2_zero1": World("data=2,model=2", seqs=(16, 15), zero1=True),
    "model4": World("model=4", seqs=(16, 18)),
}
CASES = {f"{name}:{arch}": (name, arch) for name in WORLDS for arch in ARCHS}


def _cfg(arch: str, get=get_config):
    return get(arch).reduced()


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _data_shards(world: World) -> int:
    return int(np.prod([v for a, v in _sizes(world).items() if a != "model"]))


def _batch(seq: int) -> dict:
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, get_config(ARCHS[0]).reduced().vocab_size, (BATCH, seq))
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

def _rank_main(rank, world_size, port, name, params_np, queue):
    try:
        queue.put((rank, _rank_cases(rank, world_size, port, WORLDS[name], params_np)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world_size, port, world, params_np) -> dict:
    import torch.distributed as dist

    from repro_torch.core import muon
    from repro_torch.distributed import make_engine
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models import moe as moe_lib
    from repro_torch.training.train_step import loss_and_grads, reduce_grads

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world_size)
    # Each MoE layer's top_idx, in layer order, as the forward routes.
    routes = []
    route = moe_lib._route

    def recording_route(logits, top_k, style):
        gates, idx = route(logits, top_k, style)
        routes.append(idx.reshape(-1, top_k).numpy().copy())
        return gates, idx

    moe_lib._route = recording_route
    out: dict = {}
    try:
        mesh = make_mesh_from_spec(world.spec)
        sizes = sh.mesh_axis_sizes(mesh)
        for arch in ARCHS:
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
                routes.clear()
                loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32,
                                                      ctx=ctx)
                # The forward's routes, then the backward's recompute of
                # each checkpointed layer, last layer first.
                out[(arch, "top_idx", seq)] = routes[:cfg.num_layers]
                out[(arch, "recompute_idx", seq)] = routes[cfg.num_layers:][::-1]
                loss, metrics = reduce_grads(engine, loss, metrics, grads, ctx)
                out[(arch, "seq_shard", seq)] = ctx.seq_shard
                out[(arch, "metrics", seq)] = {k: float(v) for k, v in metrics.items()}
                out[(arch, "grads", seq)] = interop.params_to_numpy(grads)
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
                    out[(arch, "update", phase)] = {k: v.numpy().copy()
                                                    for k, v in joined.items()}
            out[(arch, "trace")] = list(comm.trace.events)

        # The launcher on the mesh, rank 0's stdout kept.
        argv = LAUNCH + ["--mesh", world.spec] + (["--zero1"] if world.zero1 else [])
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = train.run(argv)
        out["launch_stdout"] = printed.getvalue()
        out["launch_tensor_parallel"] = run.engine.tensor_parallel
        out["launch_phases"] = [r["phase"] for r in run.records]
        out["launch_trace"] = list(run.engine.comm.trace.events)
        out["launch_shapes"] = {k: tuple(p.shape)
                                for k, p in tree_lib.flatten_with_path(run.state.params)}
        dist.barrier()
    finally:
        moe_lib._route = route
        dist.destroy_process_group()
    return out


def _spawn(name: str, params_np) -> dict:
    n = int(np.prod(list(_sizes(WORLDS[name]).values())))
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = mp.start_processes(_rank_main, args=(n, _free_port(), name, params_np, queue),
                               nprocs=n, start_method="spawn", join=False)
    results = dict(queue.get(timeout=600) for _ in range(n))
    procs.join()
    for rank, res in results.items():
        assert "error" not in res, f"rank {rank} failed:\n{res['error']}"
    return results


@pytest.fixture(scope="module")
def params_np():
    """The reference's weights of both configs, from one seed."""
    return {a: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(a, j_get_config)))
            for a in ARCHS}


@pytest.fixture(scope="module")
def worlds(params_np):
    return {name: _spawn(name, params_np) for name in sorted(WORLDS)}


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

_REF: dict = {}


def _reference(params_np, arch: str, seq: int, kv_layout: str, shards: int) -> list:
    """The JAX package's single-device computation on each data shard's
    rows: ``[(top_idx per layer, router logits per layer, loss, metrics,
    grads)]``, one entry a shard."""
    key = (arch, seq, kv_layout, shards)
    if key in _REF:
        return _REF[key]
    cfg = _cfg(arch, j_get_config)
    ctx = JShardCtx(kv_layout=kv_layout)
    p = jax.tree.map(jnp.asarray, params_np[arch])
    routed = []
    route = j_moe._route

    def recording_route(logits, top_k, style):
        gates, idx = route(logits, top_k, style)
        jax.debug.callback(lambda i, lg: routed.append((np.asarray(i), np.asarray(lg))),
                           idx, logits, ordered=True)
        return gates, idx

    # Jitted: a third of the eager dispatch's time on the CPU.
    grad_fn = jax.jit(jax.value_and_grad(lambda q, b: j_loss_fn(q, b, cfg, ctx=ctx),
                                         has_aux=True))
    out = []
    rows = BATCH // shards
    for d in range(shards):
        b = {k: jnp.asarray(v[d * rows:(d + 1) * rows], jnp.int32)
             for k, v in _batch(seq).items()}
        routed.clear()
        j_moe._route = recording_route
        try:
            jax.block_until_ready(jax.jit(lambda q: j_forward(q, b["tokens"], cfg, ctx=ctx))(p))
            jax.effects_barrier()
        finally:
            j_moe._route = route
        (loss, metrics), grads = grad_fn(p, b)
        out.append(([i for i, _ in routed], [lg for _, lg in routed], float(loss),
                    {k: float(v) for k, v in metrics.items()},
                    jax.tree.map(np.asarray, grads)))
    _REF[key] = out
    return out


def _case_reference(params_np, name: str, arch: str, seq: int) -> list:
    world = WORLDS[name]
    kv = sh.attn_layouts(_cfg(arch), _sizes(world)["model"])[1]
    return _reference(params_np, arch, seq, kv, _data_shards(world))


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_matches_reference(case, worlds, params_np):
    """Every rank's top_idx of every layer equals the reference's on its
    data shard; a flip names its tokens' gap between the k-th and (k+1)-th
    router logits. The backward's recompute of each checkpointed layer
    routes exactly as its forward did."""
    name, arch = CASES[case]
    k = _cfg(arch).top_k
    for seq in WORLDS[name].seqs:
        ref = _case_reference(params_np, name, arch, seq)
        for res in worlds[name].values():
            idx, logits = ref[res["coords"].get("data", 0)][:2]
            got = res[(arch, "top_idx", seq)]
            assert len(got) == len(idx) == _cfg(arch).num_layers, (case, seq)
            again = res[(arch, "recompute_idx", seq)]
            assert len(again) == len(got) and all(
                np.array_equal(a, g) for a, g in zip(again, got)), (case, seq)
            for layer, (g, r, lg) in enumerate(zip(got, idx, logits)):
                flips = np.nonzero((g != r.reshape(g.shape)).any(axis=-1))[0]
                top = -np.sort(-lg.reshape(-1, lg.shape[-1]), axis=-1)
                gaps = (top[:, k - 1] - top[:, k])[flips]
                assert not len(flips), (case, seq, layer, "flipped tokens", flips.tolist(),
                                        "logit gaps", gaps.tolist())


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_aux_match_reference(case, worlds, params_np):
    """The loss, ce, load_balance and z_loss after the reduce: equal on
    every rank, and the mean of the reference's over the data shards."""
    name, arch = CASES[case]
    for seq in WORLDS[name].seqs:
        ref = _case_reference(params_np, name, arch, seq)
        results = worlds[name]
        first = results[0][(arch, "metrics", seq)]
        assert set(first) == {"loss", "ce", "load_balance", "z_loss"}
        for key in first:
            want = float(np.mean([m[key] for _, _, _, m, _ in ref]))
            assert all(r[(arch, "metrics", seq)][key] == first[key] for r in results.values())
            assert abs(first[key] - want) <= LOSS_TOL * abs(want), (case, seq, key,
                                                                   first[key], want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_reference(case, worlds, params_np):
    """Every joined gradient against jax.grad's mean over the data shards,
    the router's and the norm gains' among them."""
    name, arch = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    specs = sh.param_specs(params_np[arch], _cfg(arch), sizes)
    for seq in world.seqs:
        ref = _case_reference(params_np, name, arch, seq)
        mean = jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0), *[r[4] for r in ref])
        joined = dict(tree_lib.flatten_with_path(interop.join_params(
            [(r["coords"], r[(arch, "grads", seq)]) for r in worlds[name].values()],
            specs, sizes)))
        flat_ref = tree_lib.flatten_with_path(mean)
        assert sorted(joined) == sorted(k for k, _ in flat_ref)
        for k, r in flat_ref:
            err = float(np.abs(joined[k] - r).max())
            assert err <= GRAD_TOL * float(np.abs(r).max()), (case, seq, k, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_reference(case, worlds, params_np):
    """One full and one block MuonBP update on the expert shards, joined,
    against the reference's single-device muon with the mesh's block specs
    on the same (joined) gradients and weights."""
    name, arch = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    results = worlds[name]
    cfg = _cfg(arch)
    params = params_np[arch]
    labels = label_tree(params)
    specs = sh.param_specs(params, cfg, sizes)
    grads = interop.join_params(
        [(r["coords"], r[(arch, "grads", world.seqs[0])]) for r in results.values()],
        specs, sizes)
    bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c),
                               _muon_block_specs(params, cfg, sizes))
    ref = j_muon(0.02, 0.02, period=5, weight_decay=0.1, block_specs=bspecs)
    p, g = _muon_only(params, labels), _muon_only(grads, labels)
    state = ref.init(p)
    for phase in ("full", "block"):
        upd, state = ref.update(g, state, p, phase)
        got = results[0][(arch, "update", phase)]
        flat = tree_lib.flatten_with_path(upd)
        assert sorted(got) == sorted(k for k, _ in flat)
        for k, r in flat:
            np.testing.assert_allclose(got[k], np.asarray(r), rtol=0, atol=UPDATE_TOL,
                                       err_msg=f"{case} {phase} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_equals_tp_bytes_and_the_plan(case, worlds, params_np):
    """'tp' of a forward and backward equals tp_bytes (the router's
    gradient sum in both layouts); the block update moves no optimizer
    byte, the full one and its 'apply' exactly the plan's."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes

    name, arch = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    cfg = _cfg(arch)
    params = params_np[arch]
    plan = plan_comm(params, sh.param_specs(params, cfg, sizes), sizes,
                     block_specs=_muon_block_specs(params, cfg, sizes), zero1=world.zero1)
    rows = BATCH // _data_shards(world)
    for res in worlds[name].values():
        trace = CollectiveTrace()
        trace.events = res[(arch, "trace")]
        for seq in world.seqs:
            got = trace.total_bytes("tp", step=("grads", seq))
            assert got == tp_bytes(cfg, rows, seq, sizes, compute_bytes=4), (case, seq)
        for phase in ("full", "block"):
            step = ("update", phase)
            assert {e.phase for e in trace.select(None, step=step)} <= {phase}
            assert_matches_plan_by_axes(trace, plan, phase, step=step)
        assert {e.phase for e in trace.events} <= set(TRACE_PHASES) | {"check"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_sharding_follows_the_reference_rule(case, worlds):
    name, arch = CASES[case]
    a, b = WORLDS[name].seqs
    for res in worlds[name].values():
        assert res[(arch, "seq_shard", a)] and not res[(arch, "seq_shard", b)]


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_launcher_trains_moe_tensor_parallel(name, worlds):
    """``--mesh`` with olmoe: the path line, (E, D, F/m) expert shards, and a
    trace whose 'tp' equals tp_bytes, whose optimizer phases equal
    plan_comm and whose collectives are of the known classes, every step."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes
    from repro_torch.launch.train import matrix_block_specs
    from repro_torch.models.model import init_params

    world = WORLDS[name]
    sizes = _sizes(world)
    m = sizes["model"]
    cfg = _cfg(LAUNCH_ARCH)
    full = init_params(cfg, seed=0, device="cpu")
    plan = plan_comm(full, sh.param_specs(full, cfg, sizes), sizes,
                     block_specs=matrix_block_specs(full, cfg, sizes), zero1=world.zero1)
    results = worlds[name]
    assert "mesh path: tensor_parallel" in results[0]["launch_stdout"]
    wi = (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff // m)
    for res in results.values():
        assert res["launch_tensor_parallel"] is True
        assert res["launch_shapes"][("layers", "moe", "wi")] == wi
        assert res["launch_shapes"][("layers", "moe", "wg")] == wi
        assert res["launch_shapes"][("layers", "moe", "wo")] == wi[:2] + (wi[3], wi[2])
        trace = CollectiveTrace()
        trace.events = res["launch_trace"]
        for step, phase in enumerate(res["launch_phases"]):
            assert trace.total_bytes("tp", step=step) == tp_bytes(
                cfg, BATCH // _data_shards(world), 16, sizes, compute_bytes=4)
            assert_matches_plan_by_axes(trace, plan, (phase, "apply"), step=step)
            if phase == "block":
                assert not trace.select("block", step=step)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_path_keeps_an_expert_d_ff_the_axis_does_not_divide_whole(arch):
    """An expert d_ff of 6 splits over model=2 and stays whole over model=4,
    where the reference keeps the experts replicated
    (``repro/models/moe.py``'s ``use_model``): the path is tensor-parallel,
    the experts whole on every rank, the router whole."""
    cfg = dataclasses.replace(_cfg(arch), d_ff=6)
    params = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  dataclasses.replace(_cfg(arch, j_get_config),
                                                                      d_ff=6)))
    for model, whole in ((2, False), (4, True)):
        assert sh.mesh_path(cfg, {"model": model}) == sh.TENSOR_PARALLEL
        assert sh.whole_sub_blocks(cfg, {"model": model})["experts"] is whole
        moe = sh.param_specs(params, cfg, {"model": model})["layers"]["moe"]
        assert (moe["wi"] == (None,) * 4) is whole and (moe["wo"] == (None,) * 4) is whole
        assert moe["router"] == (None,) * 3
