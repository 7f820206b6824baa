"""The tensor-parallel VLM and whisper on multi-process ``gloo`` worlds on the
CPU.

Three worlds, spawned together once a module (their ranks run every case
and hand back numpy results): ``model=2``, ``data=2,model=2`` with ZeRO-1,
and ``model=4``. This module runs the VLM's configs and
``tests/test_torch_whisper_tensor_parallel.py`` whisper's, with these
checks. Four configs, fp32, from the reference's weights, each rank
holding its ``param_specs`` shards (the decoder's and the encoder's
attention and MLP, whisper's cross-attention; every norm whole):

* the reduced internvl2-1b: 16 vision tokens ahead of the text, which the
  vocab-parallel embedding puts into the partial sum on model index 0 only
  (every world; its 2 KV heads lay out 'hd' on ``model=4``);
* the same with 5 Q heads and 1 KV head, so that Q and K/V take 'hd' on
  ``model=2``, as full internvl2's 14/2 heads do on ``model=4``
  (``model=2`` and ``data=2,model=2``);
* the reduced whisper-small: its 64-frame encoder sequence-sharded on
  ``model`` 2 and 4, its output gathered once as the cross-attention's K/V
  source (every world);
* the same with 63 frames, which neither axis divides: the encoder runs
  whole on every rank while the decoder is sequence-sharded, so its leaves'
  gradients are whole on each rank and must not be summed over ``model``
  (every world).

Held against the JAX package's single-device ``forward``, ``loss_fn`` and
``jax.grad`` on the same weights (its ``ShardCtx`` carrying the world's
head layouts, mesh-free), at a decoder length the model axis divides
(sequence-sharded residual) and one it does not:

* the logits joined over the vocab (the vision positions too), max abs
  1e-5;
* the loss (the CE over the text positions), relative 1e-6;
* every gradient after ``reduce_grads`` joined over the ranks, max abs 1e-5
  of the leaf's max|grad|;
* one MuonBP full and one block update of the joined gradients on the
  engine against the reference's single-device ``muon`` with the mesh's
  block specs, max abs 1e-5; the block update moves no optimizer byte;
* the ``'tp'`` trace equal to ``plan.tp_bytes``, to the byte, and every
  collective of a class the port records (``audit.PHASES``).

Through the launcher on ``data=2,model=2`` (both archs, three steps: full,
block, full): the path line, the shards, the losses against one process
(relative 1e-5), ``'tp'`` equal to ``tp_bytes`` a step, every optimizer
phase equal to ``plan_comm``, no collective of another class, and
``scripts.mesh_bytes``
equal to the trace. ``mesh_path`` runs both full-width configs
tensor-parallel on ``model`` 2, 4 and 8.
"""

import contextlib
import dataclasses
import io
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

BATCH = 4
LOGIT_TOL = 1e-5     # max abs
LOSS_TOL = 1e-6      # relative
GRAD_TOL = 1e-5      # max abs over the leaf's max|grad|
UPDATE_TOL = 1e-5    # max abs, the port's update tolerance (tests/test_torch_optim.py)
LAUNCH_TOL = 1e-5    # launcher on the mesh vs one process, relative
# name: (arch, overrides of its reduced config)
CONFIGS = {
    "vlm": ("internvl2-1b", {}),
    "vlm_q_hd": ("internvl2-1b", dict(num_heads=5, num_kv_heads=1)),
    "whisper": ("whisper-small", {}),
    "whisper_enc63": ("whisper-small", dict(encoder_seq=63)),
}
LAUNCH_CONFIGS = ("vlm", "whisper")
# This module's configs; tests/test_torch_whisper_tensor_parallel.py runs the others.
MODULE_CONFIGS = ("vlm", "vlm_q_hd")
LAUNCH_STEPS = 3     # full, block, full
LAUNCH_SEQ = 16
LAUNCH = ["--reduced", "--device", "cpu", "--steps", str(LAUNCH_STEPS), "--batch", str(BATCH),
          "--seq", str(LAUNCH_SEQ), "--period", "2", "--compute-dtype", "float32",
          "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    seqs: tuple              # decoder lengths: the first sequence-sharded, the second not
    configs: tuple
    zero1: bool = False
    launch: bool = False     # the launcher on the mesh, LAUNCH_CONFIGS


WORLDS = {
    "model2": World("model=2", seqs=(16, 15), configs=tuple(CONFIGS)),
    "data2_model2_zero1": World("data=2,model=2", seqs=(16, 15), configs=tuple(CONFIGS),
                                zero1=True, launch=True),
    "model4": World("model=4", seqs=(16, 15), configs=("vlm", "whisper", "whisper_enc63")),
}
CASES = {f"{name}:{c}": (name, c) for name, world in WORLDS.items() for c in world.configs}


def cases_of(configs) -> list:
    """The cases of ``configs``, in order."""
    return sorted(case for case, (_, c) in CASES.items() if c in configs)


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


def _batch(name: str, seq: int) -> dict:
    """Tokens, labels, and the config's vision embeddings or audio frames."""
    cfg = _cfg(name)
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq))
    labels = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.vision_tokens:
        batch["vision_embeds"] = 0.02 * rng.standard_normal(
            (BATCH, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_seq:
        batch["audio_frames"] = 0.02 * rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


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

def _rank_main(rank, world_size, port, name, configs, params_np, queue):
    try:
        queue.put((rank, _rank_cases(rank, world_size, port, WORLDS[name], configs, params_np)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank_cases(rank, world_size, port, world, configs, params_np) -> dict:
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
        for name in (c for c in world.configs if c in configs):
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
                ctx = sh.make_ctx(cfg, engine, seq=sh.residual_len(cfg, seq))
                batch = {k: torch.from_numpy(v[rows]) for k, v in _batch(name, seq).items()}
                comm.trace.step = ("grads", seq)
                loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32,
                                                      ctx=ctx)
                loss, _ = reduce_grads(engine, loss, metrics, grads, ctx)
                comm.trace.step = ("logits", seq)
                with torch.no_grad():
                    logits = forward(params, batch["tokens"], cfg, ctx=ctx,
                                     extra_embeds=batch.get("vision_embeds"),
                                     encoder_frames=batch.get("audio_frames"))
                out[(name, "layouts", seq)] = (ctx.q_layout, ctx.kv_layout, ctx.seq_shard,
                                               ctx.encoder_seq_shard)
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
            out.update(_launches(world, [c for c in LAUNCH_CONFIGS if c in configs], params_np))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _launches(world, names, params_np) -> dict:
    """The launcher on the mesh for each config of ``names``, rank 0's
    stdout kept."""
    from repro_torch.launch import train
    from repro_torch.obs import MemorySink

    out = {}
    for name in names:
        argv = LAUNCH + ["--arch", CONFIGS[name][0], "--mesh", world.spec, "--zero1"]
        printed, sink = io.StringIO(), MemorySink()
        with contextlib.redirect_stdout(printed):
            run = train.run(argv, params=interop.params_from_numpy(params_np[name], device="cpu"),
                            cfg=_cfg(name), sinks=[sink])
        out[(name, "launch")] = {
            "stdout": printed.getvalue(), "tensor_parallel": run.engine.tensor_parallel,
            "losses": [r["loss"] for r in run.records], "phases": [r["phase"] for r in run.records],
            "trace": list(run.engine.comm.trace.events),
            "spans": sorted({r["name"] for r in sink.records if r.get("event") == "span"}),
            "shapes": {k: tuple(p.shape) for k, p in tree_lib.flatten_with_path(run.state.params)}}
    return out


def spawn_worlds(configs, params_np) -> dict:
    """Every world at once, each on its own port, running its cases of
    ``configs``; their results."""
    ctx = mp.get_context("spawn")
    started = {}
    for name in sorted(WORLDS):
        n = int(np.prod(list(_sizes(WORLDS[name]).values())))
        queue = ctx.Queue()
        procs = mp.start_processes(_rank_main,
                                   args=(n, _free_port(), name, configs, params_np, queue),
                                   nprocs=n, start_method="spawn", join=False)
        started[name] = (n, queue, procs)
    out = {}
    for name, (n, queue, procs) in started.items():
        out[name] = dict(queue.get(timeout=600) for _ in range(n))
        procs.join()
        for rank, res in out[name].items():
            assert "error" not in res, f"{name}: rank {rank} failed:\n{res['error']}"
    return out


def reference_params(configs) -> dict:
    """The reference's weights of each of ``configs``, from one seed."""
    return {c: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(c, j_get_config)))
            for c in configs}


def single_losses(config, params_np) -> list:
    """One process's launcher losses of ``config`` on the same global
    batches and block grid as the mesh's."""
    from repro_torch.launch import train

    return [r["loss"] for r in train.run(
        LAUNCH + ["--arch", CONFIGS[config][0], "--mesh-model", "2"],
        params=interop.params_from_numpy(params_np[config], device="cpu"),
        cfg=_cfg(config)).records]


@pytest.fixture(scope="module")
def params_np():
    return reference_params(MODULE_CONFIGS)


@pytest.fixture(scope="module")
def worlds(params_np):
    """Every world's results, the worlds spawned together, once."""
    return spawn_worlds(MODULE_CONFIGS, params_np)


@pytest.fixture(scope="module", params=cases_of(MODULE_CONFIGS))
def case(request):
    return request.param


@pytest.fixture(scope="module", params=[c for c in LAUNCH_CONFIGS if c in MODULE_CONFIGS])
def launch_config(request):
    return request.param


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
        b = {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels") else jnp.float32)
             for k, v in _batch(name, seq).items()}
        # Jitted, the forward and the gradient in one program: a third of
        # the eager dispatch's time on the CPU.
        logits, ((loss, _), grads) = jax.jit(lambda q: (
            j_forward(q, b["tokens"], cfg, extra_embeds=b.get("vision_embeds"),
                      encoder_frames=b.get("audio_frames"), ctx=ctx)[0],
            jax.value_and_grad(lambda q: j_loss_fn(q, b, cfg, ctx=ctx), has_aux=True)(q)))(p)
        _REF[key] = (np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads))
    return _REF[key]


def _case_reference(params_np, case: str, seq: int):
    name, config = CASES[case]
    return _reference(params_np, config, seq, _layouts(config, WORLDS[name]))


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

def test_layouts_follow_the_reference_rules(case, worlds):
    """The context's head layouts are the reference's ``attn_layouts`` (Q and
    K/V 'hd' for the 5/1-head VLM on model=2); the first decoder length's
    residual (the VLM's vision tokens included) is sequence-sharded and the
    second's is not; whisper's encoder follows its own length (64 frames
    sharded, 63 not)."""
    name, config = CASES[case]
    world = WORLDS[name]
    a, b = world.seqs
    layouts = _layouts(config, world)
    if config == "vlm_q_hd":
        assert layouts == ("hd", "hd")
    encoder = config == "whisper"
    for res in worlds[name].values():
        assert res[(config, "layouts", a)] == layouts + (True, encoder)
        assert res[(config, "layouts", b)] == layouts + (False, encoder)


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


def test_loss_matches_reference(case, worlds, params_np):
    name, config = CASES[case]
    for seq in WORLDS[name].seqs:
        _, ref, _ = _case_reference(params_np, case, seq)
        losses = {res[(config, "loss", seq)] for res in worlds[name].values()}
        assert len(losses) == 1, losses
        assert abs(losses.pop() - ref) <= LOSS_TOL * abs(ref), (case, seq)


def test_gradients_match_reference(case, worlds, params_np):
    """Every joined gradient: the encoder's norm gains summed over the model
    axis only where the encoder is sequence-sharded, ``cross_norm`` where
    the decoder is."""
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
            err = float(np.abs(joined[k] - r).max())
            assert err <= GRAD_TOL * float(np.abs(r).max()), (case, seq, k, err)


def test_updates_match_reference(case, worlds, params_np):
    """One full and one block MuonBP update on the shards, joined, against
    the reference's single-device muon with the mesh's block specs on the
    same (joined) gradients and weights."""
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


def test_trace_equals_tp_bytes_and_the_plan(case, worlds, params_np):
    """'tp' of a forward and backward equals tp_bytes (the VLM's V + S
    residual, whisper's encoder layers, its output's gather and the
    cross-attention, the Q and K/V column gathers on 'hd', the partial
    leaves' sums); the block update moves no optimizer byte, the full one
    and its 'apply' exactly the plan's; no collective of another class."""
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


def test_launcher_trains_tensor_parallel(launch_config, worlds, params_np):
    """``--mesh data=2,model=2 --zero1``: the path line, the shards, the
    losses of one process, and a trace whose 'tp' equals tp_bytes and whose
    optimizer phases equal plan_comm every step, with no collective of
    another class."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes
    from repro_torch.launch.train import matrix_block_specs

    config = launch_config
    world = WORLDS["data2_model2_zero1"]
    sizes = _sizes(world)
    cfg = _cfg(config)
    full = interop.params_from_numpy(params_np[config], device="cpu")
    plan = plan_comm(full, sh.param_specs(full, cfg, sizes), sizes,
                     block_specs=matrix_block_specs(full, cfg, sizes), zero1=True)
    results = worlds["data2_model2_zero1"]
    single = single_losses(config, params_np)
    line = "mesh path: tensor_parallel"
    if config == "whisper":
        line += " (model axis 2, Q layout 'head', KV layout 'head', sequence-sharded " \
                "residual True, sequence-sharded encoder True)"
    assert line in results[0][(config, "launch")]["stdout"]
    half = cfg.d_ff // sizes["model"]
    for res in results.values():
        got = res[(config, "launch")]
        assert got["tensor_parallel"] is True
        assert got["shapes"][("layers", "mlp", "wi")] == (cfg.num_layers, cfg.d_model, half)
        if config == "whisper":
            assert got["shapes"][("encoder", "mlp", "wo")] == (cfg.encoder_layers, half,
                                                               cfg.d_model)
            assert got["shapes"][("layers", "cross", "wk")] == (
                cfg.num_layers, cfg.d_model, cfg.kv_dim // sizes["model"])
        np.testing.assert_allclose(got["losses"], single, rtol=LAUNCH_TOL, atol=0)
        trace = CollectiveTrace()
        trace.events = got["trace"]
        assert got["phases"] == ["full", "block", "full"]
        for step, phase in enumerate(got["phases"]):
            assert trace.total_bytes("tp", step=step) == tp_bytes(
                cfg, BATCH // _data_shards(world), LAUNCH_SEQ, sizes, compute_bytes=4)
            assert_matches_plan_by_axes(trace, plan, (phase, "apply"), step=step)
            if phase == "block":
                assert not trace.select("block", step=step)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


def test_mesh_bytes_predicts_the_launcher_trace(launch_config, worlds):
    """``scripts.mesh_bytes``, from the shapes alone, gives every phase's
    bytes of the launcher's steps on the mesh and the parameters a rank
    holds, and the trace has no collective of another class."""
    from repro_torch.distributed.audit import CollectiveTrace
    from repro_torch.scripts.mesh_bytes import mesh_bytes

    config = launch_config
    sizes = _sizes(WORLDS["data2_model2_zero1"])
    want = mesh_bytes(_cfg(config), sizes, batch=BATCH, seq=LAUNCH_SEQ, zero1=True,
                      compute_bytes=4)
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


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-small"])
@pytest.mark.parametrize("model", [2, 4, 8])
def test_mesh_path_runs_the_vlm_and_whisper_tensor_parallel(arch, model):
    """At full width: internvl2-1b's 14/2 heads lay out 'head' on model=2 and
    'hd' on 4 and 8; whisper-small's 12 heads 'head' on 2 and 4, 'hd' on 8;
    its 1500 frames are sequence-sharded on 2 and 4 but not on 8."""
    cfg = get_config(arch)
    assert sh.mesh_path(cfg, {"data": 2, "model": model}) == sh.TENSOR_PARALLEL
    want = {("internvl2-1b", 2): ("head", "head"), ("whisper-small", 2): ("head", "head"),
            ("whisper-small", 4): ("head", "head")}.get((arch, model), ("hd", "hd"))
    assert sh.attn_layouts(cfg, model) == want
    if arch == "whisper-small":
        assert sh.sequence_sharded(cfg.encoder_seq, model) is (model != 8)
