"""Sub-blocks a model axis leaves whole, trained tensor-parallel on ``gloo``
worlds on the CPU.

Where the model axis does not divide a weight, the reference keeps it whole
on every rank (``repro/sharding/specs.py``'s ``col``/``row`` rules, its
MoE ``use_model``), and so does the port's ``param_specs``; each rank then
computes that sub-block whole on its rows' whole sequence and keeps its
sequence shard of the output (``tensor_parallel.enter_whole`` /
``leave_whole``; ``sharding.specs.whole_sub_blocks`` names them). Two
worlds, spawned together once a module, each rank holding its
``param_specs`` shards of the reference's weights (fp32), every case alone
and beside split sub-blocks:

* ``model=2``: a ``d_ff`` of 511 (the MLP whole beside split attention and
  vocab); a padded vocab of 511 (the plain lookup, logits and cross
  entropy on every rank), also on gemma2-9b (tied embedding, post-norms,
  softcaps) and internvl2-1b (vision rows ahead of the text);
* ``model=4``: K/V heads of 30 whole beside Q in 'head'; Q and K/V whole
  (3 heads of 30); olmoe-1b-7b's experts whole (expert ``d_ff`` 6, router
  whole); mamba2-1.3b's ``d_inner`` of 198 whole (d_model 99, SSM heads of
  18); hymba-1.5b with its SSM whole beside split attention, with its
  attention whole beside a split SSM (each whole branch entering the one
  reduce on model index 0), and with every sub-block whole but the vocab
  (its d_inner of 198 in nine heads of 22: in eleven heads of 18 the
  ``A_log`` gradient of these batches sits at the fp32 floor, the
  reference's own 1.02e-5 of its max from an fp64 computation of it, so
  no fp32 path can be held to the tolerance there; 3.6e-6 in nine);
  whisper-small with its heads and ``d_ff`` whole (encoder and
  cross-attention too).

Held against the JAX package's single-device ``forward``, ``loss_fn``,
``jax.grad`` and ``muon`` on the same weights, at a sequence length the
model axis divides (sequence-sharded residual) and one it does not:

* the logits (joined over the vocab where it splits), max abs 1e-5;
* the loss, relative 1e-6;
* every gradient after ``reduce_grads`` joined over the ranks, max abs 1e-5
  of the leaf's max|grad| (a whole sub-block's gradients are whole on
  every rank and summed over no axis; whole K/V beside split Q heads, and
  hymba's whole branch beside a split one, are summed once);
* one MuonBP full and one block update of the joined gradients against the
  reference's ``muon`` with the mesh's block grids (a whole matrix's grid
  1x1), max abs 1e-5;
* the ``'tp'`` trace equal to ``plan.tp_bytes``, the block update moving no
  byte and the full one exactly ``plan_comm``'s (nothing for a whole leaf).

Through the launcher on each world (the padded vocab of 511 on ``model=2``,
hymba with every sub-block whole on ``model=4``; three steps, full, block,
full): the path line naming the whole sub-blocks, one process's losses
(relative 1e-5), ``'tp'`` equal to ``tp_bytes`` each step, every optimizer
phase equal to ``plan_comm``.
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
WINDOW = 8           # the sliding windows (64 reduced) cut below the sequences
VOCAB_511 = dict(vocab_size=511, vocab_pad_multiple=1)
HEADS_30 = dict(num_heads=3, num_kv_heads=1, head_dim=30)
D_INNER_198 = dict(d_model=99, ssm_head_dim=18)
# name: (arch, overrides of its reduced config, the sub-blocks whole on its world)
CONFIGS = {
    "mlp_whole": ("muonbp-960m", dict(d_ff=511), {"mlp"}),
    "vocab_whole": ("muonbp-960m", VOCAB_511, {"vocab"}),
    "gemma_vocab_whole": ("gemma2-9b", dict(window_size=WINDOW, **VOCAB_511), {"vocab"}),
    "vlm_vocab_whole": ("internvl2-1b", VOCAB_511, {"vocab"}),
    "kv_whole": ("muonbp-960m", dict(num_heads=4, num_kv_heads=2, head_dim=30), {"kv"}),
    "attn_whole": ("muonbp-960m", HEADS_30, {"q", "kv"}),
    "olmoe_experts_whole": ("olmoe-1b-7b", dict(d_ff=6), {"experts"}),
    "mamba2_whole": ("mamba2-1.3b", D_INNER_198, {"ssm"}),
    "hymba_ssm_whole": ("hymba-1.5b", dict(window_size=WINDOW, **D_INNER_198), {"ssm"}),
    "hymba_attn_whole": ("hymba-1.5b", dict(window_size=WINDOW, **HEADS_30), {"q", "kv"}),
    "hymba_all_whole": ("hymba-1.5b", dict(window_size=WINDOW, d_ff=510, d_model=99,
                                           ssm_head_dim=22, **HEADS_30),
                        {"q", "kv", "mlp", "ssm"}),
    "whisper_whole": ("whisper-small", dict(num_heads=3, num_kv_heads=3, head_dim=30,
                                            d_ff=510), {"q", "kv", "mlp"}),
}
LAUNCH_STEPS = 3     # full, block, full
LAUNCH = ["--reduced", "--device", "cpu", "--steps", str(LAUNCH_STEPS), "--batch", str(BATCH),
          "--seq", "16", "--period", "2", "--compute-dtype", "float32", "--schedule", "const"]


@dataclasses.dataclass(frozen=True)
class World:
    spec: str
    seqs: tuple              # the first sequence-sharded, the second not
    configs: tuple
    launch: str              # the config the launcher trains on the mesh


WORLDS = {
    "model2": World("model=2", seqs=(16, 15),
                    configs=("mlp_whole", "vocab_whole", "gemma_vocab_whole", "vlm_vocab_whole"),
                    launch="vocab_whole"),
    "model4": World("model=4", seqs=(16, 18),
                    configs=("kv_whole", "attn_whole", "olmoe_experts_whole", "mamba2_whole",
                             "hymba_ssm_whole", "hymba_attn_whole", "hymba_all_whole",
                             "whisper_whole"),
                    launch="hymba_all_whole"),
}
CASES = {f"{name}:{c}": (name, c) for name, world in WORLDS.items() for c in world.configs}


def _cfg(name: str, get=get_config):
    """The reduced config ``name`` of CONFIGS (``get``: the port's or the JAX
    package's ``get_config``)."""
    arch, overrides, _ = CONFIGS[name]
    return dataclasses.replace(get(arch).reduced(), **overrides)


def _sizes(world: World) -> dict:
    from repro_torch.launch.mesh import parse_mesh_spec

    return dict(zip(*parse_mesh_spec(world.spec)))


def _layouts(name: str, world: World) -> tuple:
    return sh.attn_layouts(_cfg(name), _sizes(world)["model"])


def _batch(cfg, seq: int) -> dict:
    """Tokens, labels and the arch's stub inputs, from a seed."""
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq))
    labels = np.concatenate([tokens[:, 1:], -np.ones((BATCH, 1), np.int64)], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = (0.1 * rng.standard_normal(
            (BATCH, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.arch_type == "audio":
        out["audio_frames"] = (0.1 * rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


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
            engine = make_engine(full, sh.param_specs(full, cfg, sizes), mesh)
            comm = engine.comm
            out["coords"] = dict(comm.coords)
            params = interop.shard_params(params_np[name], cfg, sizes, comm.coords,
                                          device="cpu")
            for seq in world.seqs:
                ctx = sh.make_ctx(cfg, engine, seq=sh.residual_len(cfg, seq))
                batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seq).items()}
                comm.trace.step = ("grads", seq)
                loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32,
                                                      ctx=ctx)
                loss, _ = reduce_grads(engine, loss, metrics, grads, ctx)
                comm.trace.step = ("logits", seq)
                with torch.no_grad():
                    logits = forward(params, batch["tokens"], cfg, ctx=ctx,
                                     extra_embeds=batch.get("vision_embeds"),
                                     encoder_frames=batch.get("audio_frames"))
                out[(name, "ctx", seq)] = (ctx.q_layout, ctx.kv_layout, ctx.seq_shard,
                                           ctx.mlp_whole, ctx.experts_whole, ctx.ssm_whole,
                                           ctx.vocab_whole, ctx.whole_on_index0)
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

        name = world.launch
        argv = LAUNCH + ["--arch", CONFIGS[name][0], "--mesh", world.spec]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = train.run(argv, params=interop.params_from_numpy(params_np[name], device="cpu"),
                            cfg=_cfg(name))
        out["launch"] = {"stdout": printed.getvalue(),
                         "losses": [r["loss"] for r in run.records],
                         "phases": [r["phase"] for r in run.records],
                         "trace": list(run.engine.comm.trace.events)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def _spawn_all(params_np) -> dict:
    """Every world at once, each on its own port; their results."""
    ctx = mp.get_context("spawn")
    started = {}
    for name, world in WORLDS.items():
        n = int(np.prod(list(_sizes(world).values())))
        queue = ctx.Queue()
        procs = mp.start_processes(_rank_main, args=(n, _free_port(), name, params_np, queue),
                                   nprocs=n, start_method="spawn", join=False)
        started[name] = (n, queue, procs)
    out = {}
    for name, (n, queue, procs) in started.items():
        out[name] = dict(queue.get(timeout=900) for _ in range(n))
        procs.join()
        for rank, res in out[name].items():
            assert "error" not in res, f"{name}: rank {rank} failed:\n{res['error']}"
    return out


@pytest.fixture(scope="module")
def params_np():
    """The reference's weights of every config, from one seed."""
    return {c: jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0),
                                                      _cfg(c, j_get_config)))
            for c in CONFIGS}


@pytest.fixture(scope="module")
def worlds(params_np):
    return _spawn_all(params_np)


@pytest.fixture(scope="module")
def single(params_np):
    """One process's launcher run of each world's launch config, on the
    same global batches and the mesh's block grids."""
    from repro_torch.launch import train

    out = {}
    for world in WORLDS.values():
        name = world.launch
        argv = LAUNCH + ["--arch", CONFIGS[name][0], "--mesh-model", str(_sizes(world)["model"])]
        run = train.run(argv, params=interop.params_from_numpy(params_np[name], device="cpu"),
                        cfg=_cfg(name))
        out[name] = [r["loss"] for r in run.records]
    return out


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

_REF: dict = {}


def _reference(params_np, case: str, seq: int):
    """The JAX package's single-device logits, loss and gradients."""
    name, config = CASES[case]
    ql, kvl = _layouts(config, WORLDS[name])
    key = (config, seq, ql, kvl)
    if key not in _REF:
        cfg = _cfg(config, j_get_config)
        ctx = JShardCtx(q_layout=ql or "head", kv_layout=kvl or "head")
        p = jax.tree.map(jnp.asarray, params_np[config])
        b = {k: jnp.asarray(v, jnp.int32 if k in ("tokens", "labels") else jnp.float32)
             for k, v in _batch(cfg, seq).items()}
        # Jitted: a third of the eager dispatch's time on the CPU.
        logits, _ = jax.jit(lambda q: j_forward(
            q, b["tokens"], cfg, ctx=ctx, extra_embeds=b.get("vision_embeds"),
            encoder_frames=b.get("audio_frames")))(p)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: j_loss_fn(q, b, cfg, ctx=ctx), has_aux=True))(p)
        _REF[key] = (np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads))
    return _REF[key]


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_context_names_the_whole_sub_blocks(case, worlds):
    """The context's whole sub-blocks are ``whole_sub_blocks``' (read from
    ``param_specs``), the ones the case was built to leave whole; hymba's
    whole branch beside a split one enters on index 0; the first length
    is sequence-sharded and the second is not."""
    name, config = CASES[case]
    world = WORLDS[name]
    cfg = _cfg(config)
    whole = sh.whole_sub_blocks(cfg, _sizes(world))
    assert {k for k, v in whole.items() if v} == CONFIGS[config][2]
    ql, kvl = _layouts(config, world)
    index0 = frozenset()
    if config in ("hymba_ssm_whole", "hymba_attn_whole"):
        index0 = frozenset({"ssm" if whole["ssm"] else "attn"})
    for res in worlds[name].values():
        for seq, shard in zip(world.seqs, (True, False)):
            assert res[(config, "ctx", seq)] == (
                ql, kvl, shard, whole["mlp"], whole["experts"], whole["ssm"], whole["vocab"],
                index0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_reference(case, worlds, params_np):
    name, config = CASES[case]
    world = WORLDS[name]
    results = worlds[name]
    vocab_whole = sh.whole_sub_blocks(_cfg(config), _sizes(world))["vocab"]
    for seq in world.seqs:
        ref, _, _ = _reference(params_np, case, seq)
        peers = sorted((r["coords"]["model"], r[(config, "logits", seq)])
                       for r in results.values())
        # The vocab columns joined over the model axis; whole, every rank's.
        got = [lg for _, lg in peers] if vocab_whole else [
            np.concatenate([lg for _, lg in peers], axis=-1)]
        for lg in got:
            err = float(np.abs(lg - ref).max())
            assert err <= LOGIT_TOL, (case, seq, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_reference(case, worlds, params_np):
    name, config = CASES[case]
    for seq in WORLDS[name].seqs:
        _, ref, _ = _reference(params_np, case, seq)
        losses = {res[(config, "loss", seq)] for res in worlds[name].values()}
        assert len(losses) == 1, losses
        assert abs(losses.pop() - ref) <= LOSS_TOL * abs(ref), (case, seq)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_reference(case, worlds, params_np):
    """Every gradient, joined over the ranks; a whole leaf's equal on every
    rank (summed over no axis, or summed once)."""
    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    specs = sh.param_specs(params_np[config], _cfg(config), sizes)
    results = list(worlds[name].values())
    for seq in world.seqs:
        _, _, ref = _reference(params_np, case, seq)
        joined = dict(tree_lib.flatten_with_path(interop.join_params(
            [(r["coords"], r[(config, "grads", seq)]) for r in results], specs, sizes)))
        flat_ref = tree_lib.flatten_with_path(ref)
        assert sorted(joined) == sorted(k for k, _ in flat_ref)
        flat_specs = dict(tree_lib.flatten_with_path(specs))
        for k, r in flat_ref:
            # hymba's ssm_norm is never read: zero in both.
            scale = float(np.abs(r).max())
            err = float(np.abs(joined[k] - r).max())
            assert err <= GRAD_TOL * scale or err == scale == 0.0, (case, seq, k, err)
            if sh.MODEL_AXIS not in flat_specs[k]:
                mine = [dict(tree_lib.flatten_with_path(res[(config, "grads", seq)]))[k]
                        for res in results]
                assert all(np.array_equal(g, mine[0]) for g in mine), (case, seq, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_reference(case, worlds, params_np):
    """One full and one block MuonBP update, joined, against the reference's
    single-device muon with the mesh's block grids: a whole matrix's grid
    is 1x1, so both phases orthogonalize it whole."""
    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    results = worlds[name]
    cfg = _cfg(config)
    params = params_np[config]
    labels = label_tree(params)
    specs = sh.param_specs(params, cfg, sizes)
    grads = interop.join_params(
        [(r["coords"], r[(config, "grads", world.seqs[0])]) for r in results.values()],
        specs, sizes)
    port_specs = _muon_block_specs(params, cfg, sizes)
    for (k, spec), (_, b) in zip(tree_lib.flatten_with_path(_muon_only(specs, labels)),
                                 tree_lib.flatten_with_path(port_specs)):
        if sh.MODEL_AXIS not in spec:
            assert (b.r, b.c) == (1, 1), k
    bspecs = tree_lib.tree_map(lambda b: JBlockSpec2D(b.r, b.c), port_specs)
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
    """'tp' of a forward and backward equals tp_bytes at both lengths; the
    block update moves no byte, the full one exactly the plan's, whose
    whole leaves gather nothing; no collective of another class."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes

    name, config = CASES[case]
    world = WORLDS[name]
    sizes = _sizes(world)
    cfg = _cfg(config)
    params = params_np[config]
    specs = dict(tree_lib.flatten_with_path(sh.param_specs(params, cfg, sizes)))
    plan = plan_comm(params, sh.param_specs(params, cfg, sizes), sizes,
                     block_specs=_muon_block_specs(params, cfg, sizes))
    for leaf in plan.leaves:
        if sh.MODEL_AXIS not in specs[tuple(leaf.path.split("/"))]:
            assert not leaf.block and not leaf.full, leaf.path
    for res in worlds[name].values():
        trace = CollectiveTrace()
        trace.events = res[(config, "trace")]
        for seq in world.seqs:
            got = trace.total_bytes("tp", step=("grads", seq))
            assert got == tp_bytes(cfg, BATCH, seq, sizes, compute_bytes=4), (case, seq)
        assert not trace.select(None, step=("update", "block"))
        for phase in ("full", "block"):
            step = ("update", phase)
            assert {e.phase for e in trace.select(None, step=step)} <= {phase}
            assert_matches_plan_by_axes(trace, plan, phase, step=step)
        assert {e.phase for e in trace.events} <= set(TRACE_PHASES) | {"check"}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_launcher_trains_whole_sub_blocks(name, worlds, single, params_np):
    """The launcher on the mesh: the path line names the whole sub-blocks,
    the losses are one process's, and every step's 'tp' equals tp_bytes and
    its optimizer phases plan_comm."""
    from repro_torch.distributed.audit import CollectiveTrace, assert_matches_plan_by_axes
    from repro_torch.launch.train import matrix_block_specs

    world = WORLDS[name]
    config = world.launch
    sizes = _sizes(world)
    cfg = _cfg(config)
    full = interop.params_from_numpy(params_np[config], device="cpu")
    plan = plan_comm(full, sh.param_specs(full, cfg, sizes), sizes,
                     block_specs=matrix_block_specs(full, cfg, sizes))
    whole = ", ".join(k for k, v in sh.whole_sub_blocks(cfg, sizes).items() if v)
    results = worlds[name]
    assert f"); whole on every rank: {whole}; collectives" in results[0]["launch"]["stdout"]
    for res in results.values():
        got = res["launch"]
        np.testing.assert_allclose(got["losses"], single[config], rtol=LAUNCH_TOL, atol=0)
        assert got["phases"] == ["full", "block", "full"]
        trace = CollectiveTrace()
        trace.events = got["trace"]
        for step, phase in enumerate(got["phases"]):
            assert trace.total_bytes("tp", step=step) == tp_bytes(cfg, BATCH, 16, sizes,
                                                                  compute_bytes=4)
            assert_matches_plan_by_axes(trace, plan, (phase, "apply"), step=step)
            assert {e.phase for e in trace.select(None, step=step)} <= set(TRACE_PHASES)


ARCHS = ("granite-8b", "mixtral-8x7b", "phi4-mini-3.8b", "internvl2-1b", "gemma2-9b",
         "whisper-small", "hymba-1.5b", "olmoe-1b-7b", "minitron-8b", "mamba2-1.3b",
         "muonbp-960m")


@pytest.mark.parametrize("model", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_path_runs_every_config_tensor_parallel(arch, reduced, model):
    """Every config of the registry, full and reduced, on model 2, 3, 4, 8
    and 16: tensor-parallel, whatever the axis leaves whole; the context of
    such a mesh builds without raising."""
    import types

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    assert sh.mesh_path(cfg, {"data": 2, "model": model}) == sh.TENSOR_PARALLEL
    comm = types.SimpleNamespace(size=lambda axes: model, index=lambda axes: model - 1)
    ctx = sh.make_ctx(cfg, comm=comm, seq=sh.residual_len(cfg, 1024))
    whole = sh.whole_sub_blocks(cfg, {"model": model})
    assert (ctx.q_layout is None, ctx.vocab_whole) == (whole["q"], whole["vocab"])
