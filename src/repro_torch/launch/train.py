"""Training launcher of the port: config-driven MuonBP pretraining.

Counterpart of ``repro/launch/train.py``, with the reference's flag names
and defaults. On one process ``--mesh-model N`` declares the
tensor-parallel size whose shards define the MuonBP blocks, so one GPU runs
the paper's N-way block grids. The phase schedule is driven here
(``core.muon.StaggerSchedule``): synchronous, ``step % P == 0`` runs
'full' and every other step 'block'; ``--full-schedule staggered`` runs
the mixed phase ``"stagger:{step % P}"`` each step, in which only the
Muon leaves whose residue offset is due gather and orthogonalize whole.

``--mesh pod=2,data=2,model=2`` (or ``"2,2"`` for data,model) runs on a
mesh of ranks, one process a rank, started by ``python -m
torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and the rendezvous address); the world size must equal the
mesh's product. ``--dist-backend`` names the ``torch.distributed`` backend:
``nccl`` when each rank has a card of its own (more ranks than visible cards
raises before the process group starts), ``gloo`` (the default) when ranks
share a card or run on the CPU. A rank's device is ``cuda:{LOCAL_RANK %
device_count}``. The optimizer runs on the explicit engine
(``--comm-engine shard_map``, ``distributed/engine.py``: block steps on each
rank's shards with zero optimizer collectives, full steps through one
gather a sharded matrix, ``--full-schedule pipelined|barrier|staggered``);
``--zero1`` splits the optimizer state over the data axes and
``--zero1-flatten`` adds the lead-padded fallback. ``--comm-engine gspmd``
raises: eager PyTorch has no partitioner. ``--batch`` is the global batch;
the ranks of one data coordinate read the same rows. Before the first step
the launcher decides the path (``sharding.specs.mesh_path``) and prints it:
every arch on a ``model`` axis larger than one runs tensor-parallel --
every rank builds the full parameters from ``--seed`` (or takes the
caller's) and keeps only its ``param_specs`` shards, which it computes with
(``models/transformer.py``, ``models/encdec.py``,
``distributed/tensor_parallel.py``) -- and a mesh without a model split
runs replicated, each rank holding the whole model. A sub-block whose
heads or width the axis does not divide keeps its weights whole on every
rank and runs whole there (``sharding.specs.whole_sub_blocks``), as the
reference keeps them replicated; the path line names such sub-blocks
(``--mesh model=3`` runs every arch so). See ``training/train_step.py``
for the gradient reduce and the 'apply' gathers. Only rank 0 prints step
lines and writes ``--log-file``; a rank that fails raises, which fails the
run.

Resilience: ``--guard`` runs the optimizer apply behind the health check of
``training/resilience.py`` (skip on NaN/Inf or a loss spike) and drives the
escalation ladder from here -- skip -> force an early 'full'-phase step ->
LR backoff -> checkpoint-and-abort (exit 3). Under ``--mesh`` every rank
takes the branch the mesh agrees on, so the ladder fires on every rank at
the same step, and an abort snapshots the mesh and exits 3 on each.
``--checkpoint-every`` writes atomic, checksummed snapshots in the
reference's format (always including the final step) and ``--resume``
continues from the newest *valid* one: the step, the optimizer state, the
data-stream position and the guard counters. ``--fault-plan`` injects
deterministic faults for drills (``python -m repro_torch.scripts.chaos_run``).

Telemetry flows through ``repro_torch.obs``: per-step lines, the
checkpoint/resume/escalation/abort/skip_snapshot events, spans and counters
go to the event bus. Stdout keeps the reference's wire format: a step line
every ``--log-every`` steps (and on the last and every unhealthy step) whose
``wall_s`` is the time since the run began. ``--log-file`` append-streams
fsync'd JSONL, so a SIGKILL loses no record already printed. Each step runs
in a ``step`` span; ``--obs-block`` puts a device sync inside it, so its
``dur_s`` is the step's wall time with the device work included.
``--profile-steps A:B`` captures a ``torch.profiler`` trace of those steps.
Under ``--mesh`` the drift monitor (``obs/drift.py``, ``--drift-threshold``,
0 turns it off) joins the comm plan's bytes against the step walls and
writes a ``comm_rates`` record at the end of the run; without a mesh the
run issues no collective, so there is nothing to monitor.
The NS dispatch counters ``ns_launch.<device>.<strategy>`` count
orthogonalize calls as they run (the reference counts traces, once per
compiled specialisation); ``python -m repro_torch.scripts.obs_report``
reads the JSONL.

Example (one H100, full-width muonbp-960m):
  PYTHONPATH=src python -m repro_torch.launch.train --arch muonbp-960m \\
      --optimizer muonbp --period 5 --mesh-model 8 --steps 6 --batch 4 --seq 1024

Four ranks on the CPU, ZeRO-1:
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --reduced --device cpu --mesh data=2,model=2 \\
      --zero1 --steps 6 --batch 4 --seq 32

The staggered schedule needs the explicit engine, so ``--mesh``; on one
card it runs in a one-rank world (every gather 0 B, as the reference's
(1, 1) mesh):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 1 \\
      -m repro_torch.launch.train --mesh data=1 --dist-backend nccl \\
      --full-schedule staggered --period 5 --steps 10 --batch 4 --seq 1024

Guarded, with snapshots and a resume:
  PYTHONPATH=src python -m repro_torch.launch.train --arch muonbp-960m \\
      --period 5 --mesh-model 8 --steps 20 --batch 4 --seq 1024 --guard \\
      --checkpoint-every 5 --checkpoint-dir ckpt --log-file run.jsonl --resume

``--arch`` takes every arch of the registry: dense, MoE, ``mamba2-1.3b``
(SSM), ``hymba-1.5b`` (hybrid), ``internvl2-1b`` (VLM: the stream carries
``vision_embeds``, and its residual is ``vision_tokens + --seq`` long) and
``whisper-small`` (audio: ``audio_frames``, ``encoder_seq`` frames), on one
process and, tensor-parallel, under ``--mesh``.

``--optimizer-variant {muon,turbo_muon,normuon,dion}`` picks the optimizer
variant (``core/variants.py``), as ``--optimizer dion`` picks Dion, with or
without ``--mesh`` (not with ``--full-schedule staggered``). Every step
checkpoints each decoder layer, as the reference's (no flag: only the
residual between layers is kept for the backward). ``--device cpu`` runs
the same path on the CPU (every kernel wrapper then runs its plain PyTorch
version); without it the launcher needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import ModelConfig, NSEngineConfig, get_config
from repro_torch.core import adamw, block_muon, combine, label_tree, muon, muon_full
from repro_torch.core import variants as variants_lib
from repro_torch.core.muon import StaggerSchedule, phase_for_step  # noqa: F401
from repro_torch.core.schedule import cosine, wsd
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import dispatch
from repro_torch.models.model import init_params
from repro_torch.obs import (
    Bus,
    DriftConfig,
    DriftMonitor,
    JsonlSink,
    ResidueDriftMonitor,
    StdoutSink,
    set_bus,
    span,
    stage_scope,
)
from repro_torch.obs.spans import parse_profile_window
from repro_torch.sharding import specs as sh
from repro_torch.training import checkpoint, resilience
from repro_torch.training import faults as faults_lib
from repro_torch.training.train_step import init_train_state, train_step

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The MoE loss's aux metrics, carried on the step records and run_end.
AUX_METRICS = ("load_balance", "z_loss")


def build_optimizer(name, params, *, lr, adam_lr, period, schedule_fn=None,
                    block_specs=None, rank=64, weight_decay=0.1, ns_strategy=None,
                    bucketing=True, variant=None, comm=None, full_schedule=None):
    """(combined optimizer, effective period) as the reference builds them.

    ``--optimizer dion`` and the ``dion`` variant build the same low-rank
    program, whose period is 1 (the same work every step). ``comm`` is the
    distributed engine, ``full_schedule`` its full-step schedule.
    """
    labels = label_tree(params)
    lr_s = schedule_fn(lr) if schedule_fn else lr
    adam_s = schedule_fn(adam_lr) if schedule_fn else adam_lr
    vspec = variants_lib.get(variant)
    ns_kw = dict(bucketing=bucketing, ns_strategy=ns_strategy, comm=comm,
                 full_schedule=full_schedule)
    if name == "adamw":
        return combine({"adamw": adamw(adam_s, weight_decay=weight_decay, comm=comm)},
                       tree_lib.tree_map(lambda _: "adamw", labels)), None
    if name == "dion" or vspec.low_rank:
        matrix_opt = variants_lib.build_variant("dion", lr_s, rank=rank,
                                                weight_decay=weight_decay, period=period,
                                                **ns_kw)
        name = "dion"
    elif name == "muon":
        matrix_opt = muon_full(lr_s, weight_decay=weight_decay, block_specs=block_specs,
                               variant=vspec, **ns_kw)
    elif name == "blockmuon":
        matrix_opt = block_muon(lr_s, weight_decay=weight_decay, block_specs=block_specs,
                                variant=vspec, **ns_kw)
    elif name == "muonbp":
        matrix_opt = muon(lr_s, lr_s, period=period, weight_decay=weight_decay,
                          block_specs=block_specs, variant=vspec, **ns_kw)
    else:
        raise ValueError(name)
    period_eff = {"muon": 1, "blockmuon": None, "dion": 1, "muonbp": period}[name]
    return combine({"muon": matrix_opt,
                    "adamw": adamw(adam_s, weight_decay=weight_decay, comm=comm)},
                   labels), period_eff


def engine_config(args: argparse.Namespace) -> NSEngineConfig:
    """``NSEngineConfig.from_env()`` with the flags given on top of it, as
    the reference's launcher resolves it (a flag beats its env variable)."""
    ns = NSEngineConfig.from_env()
    if args.ns_strategy:
        ns = dataclasses.replace(ns, strategy=args.ns_strategy)
    if args.no_ns_bucketing:
        ns = dataclasses.replace(ns, bucketing=False)
    if args.full_schedule:
        ns = dataclasses.replace(ns, full_schedule=args.full_schedule)
    if args.optimizer_variant:
        ns = dataclasses.replace(ns, variant=args.optimizer_variant)
    return ns


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="muonbp-960m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimizer", default="muonbp",
                    choices=["muonbp", "muon", "blockmuon", "adamw", "dion"])
    ap.add_argument("--optimizer-variant", default=None, choices=list(variants_lib.names()),
                    help="optimizer variant (core/variants.py): 'muon' baseline, "
                         "'turbo_muon' spectral pre-scale + K-2 NS steps, 'normuon' "
                         "neuron-wise second-moment epilogue, 'dion' low-rank (it "
                         "replaces the matrix optimizer); default: REPRO_OPTIMIZER_VARIANT, "
                         "else the baseline")
    ap.add_argument("--period", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--adam-lr", type=float, default=0.008)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "const"])
    ap.add_argument("--ns-strategy", default=None,
                    choices=["auto", "plain", "fused_chain", "fused_iter", "tiled"],
                    help="pin the per-bucket NS kernel strategy (default: "
                         "REPRO_NS_STRATEGY, else auto: the update program picks per "
                         "bucket)")
    ap.add_argument("--no-ns-bucketing", action="store_true",
                    help="one NS chain per parameter instead of per shape bucket "
                         "(as REPRO_NS_BUCKETING=0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="declared tensor-parallel size on one process; its shards are "
                         "the MuonBP blocks")
    ap.add_argument("--mesh", default=None,
                    help="mesh of ranks, e.g. 'pod=2,data=2,model=2' or '4,2' (data,model); "
                         "one process a rank (torch.distributed.run); overrides --mesh-model")
    ap.add_argument("--dist-backend", default="gloo", choices=["gloo", "nccl"],
                    help="torch.distributed backend under --mesh: nccl needs a card a "
                         "rank; gloo runs ranks that share a card or the CPU")
    ap.add_argument("--comm-engine", default="shard_map", choices=["shard_map", "gspmd"],
                    help="optimizer comm engine under --mesh: the explicit engine "
                         "(distributed/engine.py); 'gspmd' raises (eager PyTorch has "
                         "no partitioner)")
    ap.add_argument("--full-schedule", default=None,
                    choices=["pipelined", "barrier", "staggered"],
                    help="the engine's full-step schedule (default: REPRO_FULL_SCHEDULE, "
                         "else pipelined: bucket i+1's gathers in flight during bucket "
                         "i's NS; 'barrier': gather all, NS all, write back all; "
                         "'staggered': step t runs 'stagger:{t %% P}', each Muon leaf "
                         "full on its own residue; needs --mesh and --optimizer muonbp)")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer state over the mesh's data axes (ZeRO-1)")
    ap.add_argument("--zero1-flatten", action="store_true",
                    help="with --zero1: lead-padded flatten-and-shard fallback for "
                         "stacks whose layer count does not divide the data axes")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(COMPUTE_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--keep-checkpoints", type=int, default=3,
                    help="snapshot retention: keep the newest k step_* dirs "
                         "under --checkpoint-dir")
    ap.add_argument("--resume", action="store_true",
                    help="auto-resume from the newest VALID snapshot under "
                         "--checkpoint-dir (corrupt ones are skipped; run "
                         "metadata is verified); starts fresh when none exists")
    ap.add_argument("--guard", action="store_true",
                    help="guarded train step: health check (all-finite loss/grads + "
                         "EMA loss-spike detector) skips unstable updates and drives "
                         "the escalation ladder (skip -> forced full step -> LR "
                         "backoff -> checkpoint-and-abort)")
    ap.add_argument("--guard-spike-factor", type=float, default=3.0,
                    help="skip the step when loss > factor * EMA(loss)")
    ap.add_argument("--guard-ema-beta", type=float, default=0.98,
                    help="EMA decay of the loss-spike detector")
    ap.add_argument("--guard-warmup", type=int, default=10,
                    help="healthy steps before spike detection engages")
    ap.add_argument("--guard-force-full-after", type=int, default=1,
                    help="consecutive skips before forcing an early 'full'-phase "
                         "step (the paper's stabilizer); 0 disables the rung")
    ap.add_argument("--guard-backoff-after", type=int, default=3,
                    help="consecutive skips before LR backoff; 0 disables")
    ap.add_argument("--guard-backoff-factor", type=float, default=0.5,
                    help="multiplier applied to the guard lr_scale per backoff")
    ap.add_argument("--guard-abort-after", type=int, default=6,
                    help="consecutive skips before checkpoint-and-abort (exit 3); "
                         "0 disables")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault injection spec, e.g. "
                         "'nan_grads@7,spike_loss@9x8,kill_in_save@12' "
                         "(repro_torch.training.faults; drills only)")
    ap.add_argument("--log-file", default=None,
                    help="append-stream every telemetry record (steps, spans, events, "
                         "counters) as fsync'd JSONL; a kill loses at most the record "
                         "being written. Read with python -m repro_torch.scripts.obs_report")
    ap.add_argument("--obs-block", action="store_true",
                    help="synchronize the device inside each step span so its dur_s "
                         "includes device completion (one more sync per step)")
    ap.add_argument("--drift-threshold", type=float, default=2.0,
                    help="under --mesh: emit a 'drift' event when the measured full-minus-"
                         "block step time (per residue when staggered) disagrees with the "
                         "comm plan's modeled time by more than this factor, either way; "
                         "0 disables the monitor")
    ap.add_argument("--profile-steps", default=None,
                    help="capture a torch.profiler trace over steps A:B (half-open "
                         "window), e.g. '3:6'")
    ap.add_argument("--profile-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_profile"),
                    help="output dir for the --profile-steps trace")
    return ap


@dataclasses.dataclass
class TrainRun:
    """What one launcher run leaves behind, for callers that inspect it.

    ``records`` holds one record a step: ``step``, ``loss`` (unrounded),
    ``phase``, ``residue``, ``due``, ``dur_s`` (the step span's duration),
    for an MoE model ``load_balance`` and ``z_loss`` (the step's metrics,
    layer-summed), and, under ``--guard``, ``healthy``, ``skipped``,
    ``escalation`` and ``lr_scale``.
    """

    cfg: Any
    state: Any
    block_specs: dict
    records: list
    counters: dict
    engine: Any = None   # the distributed engine under --mesh (its trace on .comm)
    ctx: Any = None      # the model's ShardCtx under --mesh
    optimizer: Any = None  # the run's optimizer (its state is state.opt_state)


def run(argv=None, *, params: Optional[dict] = None, cfg: Optional[ModelConfig] = None,
        on_step: Optional[Callable[[dict], None]] = None,
        before_step: Optional[Callable[[int, Any, dict], None]] = None,
        sinks: Optional[list] = None) -> TrainRun:
    """Parse ``argv`` and train; returns the :class:`TrainRun`.

    ``params`` replaces the seeded initialization (tests start both packages
    from the reference's weights); ``cfg`` replaces the config that
    ``--arch`` and ``--reduced`` name (a caller's cut in depth, which the
    reference has no flag for); ``before_step(step, state, batch)`` is
    called just before each step runs, ``on_step(record)`` after it, once its
    loss has been read. An abort raises ``SystemExit(3)``. The bus, the NS
    dispatch hook and the active fault plan are installed for the run and
    removed after it. ``sinks`` are added to the bus on every rank (a
    caller's ``MemorySink``). Under ``--mesh`` the run starts the process
    group from the launcher's environment unless one is running, and ends
    what it started.
    """
    ap = parser()
    args = ap.parse_args(argv)
    check_schedule_args(ap, args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    started = _start_world(args) if args.mesh else False
    rank = 0
    if args.mesh:
        import torch.distributed as dist

        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)

    # Sink order matters: the durable JSONL sink comes FIRST, so every record
    # a stdout parser (chaos_run) sees is already fsync'd on disk. Only rank
    # 0 writes the trail and prints.
    all_sinks: list = []
    if rank == 0:
        all_sinks = [JsonlSink(args.log_file)] if args.log_file else []
        all_sinks.append(StdoutSink())
    bus = Bus(all_sinks + list(sinks or ()))
    prev_bus = set_bus(bus)
    dispatch.set_launch_hook(
        lambda dev, strategy, shape: bus.inc(f"ns_launch.{dev}.{strategy}"))
    plan = faults_lib.FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    faults_lib.set_active(plan)
    try:
        bus.event("run_start", argv=list(sys.argv[1:] if argv is None else argv),
                  args=vars(args))
        return _train(args, device, bus, plan, params, cfg, on_step, before_step, rank)
    finally:
        faults_lib.set_active(None)
        dispatch.set_launch_hook(None)
        set_bus(prev_bus)
        bus.close()
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def check_schedule_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The reference's argparse errors of ``--full-schedule staggered``: it
    spreads the per-leaf full-step gathers of the explicit engine, so it
    needs ``--mesh``, a periodic ``--optimizer muonbp`` with ``--period``
    >= 2, and not the low-rank Dion (no per-leaf gathers to spread)."""
    if args.full_schedule != "staggered":
        return
    variant = (args.optimizer_variant if args.optimizer_variant is not None
               else NSEngineConfig.from_env().variant)
    if not args.mesh:
        ap.error("--full-schedule staggered requires the explicit engine on a mesh of "
                 "ranks (--mesh; one card: --mesh data=1)")
    if args.optimizer != "muonbp":
        ap.error(f"--full-schedule staggered requires --optimizer muonbp "
                 f"(got {args.optimizer!r})")
    if variant == "dion":
        ap.error("--full-schedule staggered is incompatible with the dion variant (a "
                 "low-rank update has no per-leaf full-step gathers to stagger)")
    if args.period < 2:
        ap.error(f"--full-schedule staggered requires --period >= 2 (got {args.period})")


def _start_world(args) -> bool:
    """Start the process group of ``--mesh`` from the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless one
    is running; True when this call started it."""
    import torch.distributed as dist

    if args.comm_engine != "shard_map":
        raise ValueError("--comm-engine gspmd has no counterpart in eager PyTorch (no "
                         "partitioner); use the explicit engine, shard_map")
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--mesh runs one process a rank: start it with "
                           "python -m torch.distributed.run --nproc-per-node N ...")
    world = int(os.environ["WORLD_SIZE"])
    if args.dist_backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise RuntimeError(f"--dist-backend nccl needs a card a rank: {world} ranks, "
                               f"{cards} visible cards (ranks that share a card use gloo)")
    dist.init_process_group(args.dist_backend, rank=int(os.environ["RANK"]),
                            world_size=world)
    return True

def device_batch(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids and labels as int64, a VLM's
    or whisper's float32 stub inputs as they are."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.long if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}


def matrix_block_specs(params, cfg: ModelConfig, mesh_model) -> dict:
    """The MuonBP block grid of every Muon leaf (None for the AdamW leaves)
    on a declared ``{"model": mesh_model}`` tensor-parallel size, or on the
    ``{axis: size}`` dict of a mesh."""
    axis_sizes = mesh_model if isinstance(mesh_model, dict) else {"model": mesh_model}
    bspecs = sh.block_specs_for(params, sh.param_specs(params, cfg, axis_sizes), axis_sizes)
    return tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs,
                             label_tree(params))


def _train(args, device, bus, plan, params, cfg, on_step, before_step, rank) -> TrainRun:
    prof_window = parse_profile_window(args.profile_steps) if args.profile_steps else None
    if args.zero1 and not args.mesh:
        raise ValueError("--zero1 shards over a mesh of ranks: give --mesh")
    if args.zero1_flatten and not args.zero1:
        raise ValueError("--zero1-flatten needs --zero1")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    if params is None:
        params = init_params(cfg, seed=args.seed, device=device)
    sync = ((lambda: torch.cuda.synchronize(device))
            if args.obs_block and device.type == "cuda" else None)
    engine = ctx = None
    mesh_path = None
    if args.mesh:
        from repro_torch.distributed import make_engine
        from repro_torch.launch.mesh import make_mesh_from_spec

        mesh = make_mesh_from_spec(args.mesh, "cuda" if args.dist_backend == "nccl" else "cpu")
        axis_sizes = sh.mesh_axis_sizes(mesh)
        mesh_path = sh.mesh_path(cfg, axis_sizes)
        engine = make_engine(params, sh.param_specs(params, cfg, axis_sizes), mesh,
                             zero1=args.zero1, zero1_flatten=args.zero1_flatten)
        engine.comm.sync = sync
        ctx = sh.make_ctx(cfg, engine, seq=sh.residual_len(cfg, args.seq))
        if rank == 0:
            encoder = (f", sequence-sharded encoder {ctx.encoder_seq_shard}"
                       if cfg.arch_type == "audio" else
                       f", SSM heads "
                       f"{'split' if sh.ssm_heads_split(cfg, ctx.size) else 'whole'}"
                       if cfg.arch_type in ("ssm", "hybrid") else "")
            whole = [k for k, v in sh.whole_sub_blocks(cfg, axis_sizes).items() if v]
            print(f"mesh path: {mesh_path} (model axis {axis_sizes.get('model', 1)}, "
                  f"Q layout {ctx.q_layout!r}, KV layout {ctx.kv_layout!r}, sequence-sharded "
                  f"residual {ctx.seq_shard}{encoder}); whole on every rank: "
                  f"{', '.join(whole) or 'none'}; collectives: {args.dist_backend}'s own "
                  f"on {device.type} tensors", flush=True)
    else:
        axis_sizes = {"model": args.mesh_model}
    bspecs = matrix_block_specs(params, cfg, axis_sizes)
    labels = label_tree(params)
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    ns = engine_config(args)
    # As the reference's: the flag, not REPRO_FULL_SCHEDULE, staggers the
    # step schedule (check_schedule_args has vetted it).
    staggered = args.full_schedule == "staggered"
    # The comm plan of the mesh, from the global shapes: the stagger offsets
    # and the drift monitor's bytes.
    comm_plan = None
    if engine is not None and args.optimizer != "adamw" and (
            staggered or args.drift_threshold > 0):
        from repro_torch.distributed import plan_comm

        comm_plan = plan_comm(params, sh.param_specs(params, cfg, axis_sizes), axis_sizes,
                              labels=labels, block_specs=bspecs, zero1=args.zero1,
                              zero1_flatten=args.zero1_flatten)
    if ctx is not None and ctx.tensor_parallel:
        # Keep this rank's shards only: every rank built (or was given) the
        # same full parameters.
        params = tree_lib.map_with_path(
            lambda path, p: engine.cut(p, engine.pspec_by_path[path]).clone(), params)

    sched = {"wsd": lambda peak: wsd(peak, args.steps),
             "cosine": lambda peak: cosine(peak, args.steps),
             "const": None}[args.schedule]
    optimizer, period = build_optimizer(
        args.optimizer, params, lr=args.lr, adam_lr=args.adam_lr, period=args.period,
        schedule_fn=sched, block_specs=bspecs, ns_strategy=ns.strategy,
        bucketing=ns.bucketing, variant=ns.variant, comm=engine,
        full_schedule=ns.full_schedule,
    )
    variant_name = variants_lib.get(ns.variant).name
    n_muon_matrices = sum(
        1 for lab, p in zip(tree_lib.leaves(labels), tree_lib.leaves(params))
        if lab == "muon" and p.ndim >= 2)
    schedule = StaggerSchedule(period, "staggered" if staggered else "synchronous")
    # The offsets come from the plan's balancer (plan.assign_stagger_offsets
    # on the same leaves and bytes the program compiles with), persisted in
    # run_meta so a resume under another schedule is refused by name.
    stagger_offsets = due_by_residue = None
    if staggered:
        stagger_offsets = comm_plan.stagger_offsets(period)
        due_by_residue = [0] * period
        for r in stagger_offsets.values():
            due_by_residue[r] += 1
    bus.event("schedule", mode=schedule.mode, period=period, offsets=stagger_offsets,
              max_staggered_dcn_bytes=(comm_plan.max_staggered_dcn_bytes(period)
                                       if staggered else None),
              full_dcn_bytes=(comm_plan.predicted_bytes("full", "dcn")
                              if comm_plan is not None else None))
    drift_mon = make_drift_monitor(comm_plan, schedule, args.drift_threshold, bus)
    guard_cfg = (
        resilience.GuardConfig(spike_factor=args.guard_spike_factor,
                               ema_beta=args.guard_ema_beta, warmup_steps=args.guard_warmup)
        if args.guard else None
    )
    state = init_train_state(params, optimizer, guard=args.guard)
    pipe_src = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    pipe = iter(pipe_src)
    rows = _batch_rows(engine, args.batch)
    compute_dtype = COMPUTE_DTYPES[args.compute_dtype]

    # Run metadata, the reference's fields: checked on resume, so a
    # wrong-arch/optimizer/mesh/schedule resume fails with a named mismatch
    # instead of a shape error. The residue needs no state of its own: the
    # step is restored and the phase is a function of (step, schedule).
    run_meta = {
        "arch": cfg.name,
        "optimizer": args.optimizer,
        "variant": variant_name,
        "period": period,
        "mesh": ({k: int(v) for k, v in axis_sizes.items()} if engine is not None
                 else {"data": 1, "model": args.mesh_model}),
        "zero1": bool(args.zero1),
        "seed": args.seed,
        "schedule": {"mode": schedule.mode, "period": period, "offsets": stagger_offsets},
    }
    if mesh_path is not None:
        run_meta["path"] = mesh_path

    def save_ckpt(step):
        extra = {
            "run": run_meta,
            "args": vars(args),
            "data_state": pipe_src.state(),
            "guard": resilience.guard_to_meta(state.guard),
        }
        with span(bus, "checkpoint.save", step=step):
            full_params, opt_state = state.params, state.opt_state
            if engine is not None:
                # Snapshots are mesh-independent: full leaves, one writer.
                from repro_torch.distributed import zero1 as zero1_lib

                opt_state = zero1_lib.gather_state(opt_state, state.params, engine)
                full_params = zero1_lib.gather_params(full_params, engine)
            path = checkpoint.snapshot_path(args.checkpoint_dir, step)
            if rank == 0:
                path = checkpoint.save_snapshot(
                    args.checkpoint_dir, full_params, opt_state, step=step,
                    extra=extra, keep=args.keep_checkpoints)
            del full_params, opt_state
            if engine is not None:
                import torch.distributed as dist

                dist.barrier()
        bus.inc("checkpoint.saves")
        bus.emit({"event": "checkpoint", "step": step, "path": path})

    def on_skip_snapshot(p, why):
        bus.inc("checkpoint.fallbacks")
        bus.emit({"event": "skip_snapshot", "path": p, "why": why})

    start_step = 0
    if args.resume:
        with span(bus, "resume"):
            with span(bus, "checkpoint.verify"):
                found = checkpoint.latest_valid(args.checkpoint_dir, expect_run=run_meta,
                                                on_skip=on_skip_snapshot)
            if found is not None:
                ck_path, meta = found
                with span(bus, "checkpoint.restore"):
                    shardings = None
                    if engine is not None:
                        from repro_torch.distributed import zero1 as zero1_lib

                        shardings = zero1_lib.opt_shardings(state.opt_state, state.params,
                                                            engine)
                    r_params, r_opt, saved_step = checkpoint.restore(
                        ck_path, state.params, state.opt_state, device=device,
                        verify_checksums=False,  # latest_valid already verified
                        opt_shardings=shardings, engine=engine)
                state = state._replace(
                    params=r_params, opt_state=r_opt, step=saved_step + 1,
                    guard=(resilience.guard_from_meta(meta.get("guard"), device)
                           if args.guard else None))
                if meta.get("data_state"):
                    pipe_src.set_state(meta["data_state"])
                start_step = saved_step + 1
        if found is not None:
            bus.inc("resumes")
            bus.emit({"event": "resume", "step": start_step, "snapshot": ck_path})
        else:
            bus.emit({"event": "resume", "step": 0, "snapshot": None})

    if rank == 0:
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M optimizer={args.optimizer} "
              f"variant={variant_name} period={period} mesh={axis_sizes} device={device}"
              + (f" zero1={args.zero1} zero1_flatten={args.zero1_flatten} "
                 f"backend={args.dist_backend}" if engine is not None else ""), flush=True)

    escalator = (
        resilience.Escalator(resilience.EscalationPolicy(
            force_full_after=args.guard_force_full_after,
            backoff_after=args.guard_backoff_after,
            backoff_factor=args.guard_backoff_factor,
            abort_after=args.guard_abort_after,
        ))
        if args.guard else None
    )
    if escalator is not None and start_step:
        # The cumulative skip counter survives the resume; don't re-escalate
        # on skips that happened before the preemption.
        escalator._last_total = int(state.guard.skipped)

    profiler = None
    records = []

    def finish(status):
        nonlocal profiler
        if drift_mon is not None:
            drift_mon.report()
        if profiler is not None:
            _stop_profiler(profiler, args.profile_dir, prof_window)
            profiler = None
        # An MoE run's last aux metrics ride along, as on its step records.
        aux = {k: records[-1][k] for k in AUX_METRICS if records and k in records[-1]}
        bus.event("run_end", steps=args.steps - start_step,
                  wall_s=round(time.time() - t0, 1), status=status,
                  counters=dict(bus.counters), **aux)

    t0 = time.time()
    forced_full = False
    for step in range(start_step, args.steps):
        if prof_window is not None and step == prof_window[0]:
            profiler = _start_profiler(device)
        batch = device_batch({k: v[rows] for k, v in next(pipe).items()}, device)
        phase = schedule.phase_for(step) if args.optimizer != "adamw" else "block"
        if forced_full and args.optimizer != "adamw":
            phase = "full"
        forced_full = False
        # The residue is the step's place in the period; due counts the Muon
        # matrices on their full path this step (the residue's offset group
        # when staggered, all of them on a full step).
        residue = step % period if period else 0
        if due_by_residue is not None and phase != "full":
            due = due_by_residue[residue]
        else:
            due = n_muon_matrices if phase == "full" else 0
        fault = plan.grad_fault(step) if plan else None
        if before_step is not None:
            before_step(step, state, batch)
        if engine is not None:
            engine.comm.trace.step = step
        with span(bus, "step", sync=sync, step=step, phase=phase, residue=residue,
                  due=due) as sp:
            with stage_scope(f"muonbp.{phase.replace(':', '')}"):
                state, metrics = train_step(state, batch, cfg=cfg, optimizer=optimizer,
                                            phase=phase, compute_dtype=compute_dtype,
                                            guard=guard_cfg, fault=fault, engine=engine,
                                            ctx=ctx)
        if drift_mon is not None:
            drift_mon.observe(step, phase, sp.dur_s)
        if profiler is not None and step == prof_window[1] - 1:
            _stop_profiler(profiler, args.profile_dir, prof_window)
            profiler = None
        loss = float(metrics["loss"])
        rec = {"step": step, "loss": loss, "phase": phase, "residue": residue, "due": due,
               "dur_s": sp.dur_s}
        rec.update({k: float(metrics[k]) for k in AUX_METRICS if k in metrics})
        action = "none"
        healthy = None
        if escalator is not None:
            skipped = int(metrics["skipped"])
            healthy = int(metrics["healthy"])
            if not healthy:
                bus.inc("guard.skipped_steps")
            action = escalator.observe(step, skipped)
            if action != "none":
                bus.inc(f"escalation.{action}")
                bus.event("escalation", step=step, action=action)
            if action == "force_full":
                forced_full = True
            elif action == "backoff":
                state = resilience.apply_backoff(state, args.guard_backoff_factor)
            rec.update(healthy=healthy, skipped=skipped, escalation=action,
                       lr_scale=float(metrics["lr_scale"]))
        if (step % args.log_every == 0 or step == args.steps - 1
                or (healthy is not None and not healthy)):
            line = {"step": step, "loss": round(loss, 4), "phase": phase,
                    "residue": residue, "due": due, "wall_s": round(time.time() - t0, 1)}
            line.update({k: round(rec[k], 6) for k in AUX_METRICS if k in rec})
            if escalator is not None:
                line.update(healthy=healthy, skipped=rec["skipped"], escalation=action,
                            lr_scale=round(rec["lr_scale"], 4))
            bus.emit(line)
        records.append(rec)
        if on_step is not None:
            on_step(rec)
        if args.checkpoint_every and (
                (step and step % args.checkpoint_every == 0) or step == args.steps - 1):
            save_ckpt(step)
        if action == "abort":
            save_ckpt(step)
            bus.emit({"event": "abort", "step": step,
                      "consecutive_skips": escalator.consecutive})
            finish("abort")
            raise SystemExit(3)
    finish("ok")
    return TrainRun(cfg=cfg, state=state, block_specs=bspecs, records=records,
                    counters=dict(bus.counters), engine=engine, ctx=ctx, optimizer=optimizer)


def make_drift_monitor(comm_plan, schedule: StaggerSchedule, threshold: float, bus):
    """The plan-vs-runtime drift monitor of a run, or None (no plan, or a
    threshold of 0). Synchronous: the full-minus-block bytes per link, which
    the full steps' extra wall pays. Staggered: each residue's bytes per
    link, since every step runs the same mixed body with another due set."""
    if comm_plan is None or threshold <= 0 or schedule.period is None:
        return None
    from repro_torch.distributed.plan import LINKS

    cfg = DriftConfig(threshold=threshold)
    if schedule.mode == "staggered":
        return ResidueDriftMonitor(
            comm_bytes_by_residue=tuple(
                {ln: comm_plan.predicted_bytes("staggered", ln, period=schedule.period,
                                               residue=r) for ln in LINKS}
                for r in range(schedule.period)),
            cfg=cfg, bus=bus)
    full_b = comm_plan.predicted_by_link("full")
    block_b = comm_plan.predicted_by_link("block")
    return DriftMonitor(
        comm_bytes_by_link={k: max(full_b.get(k, 0) - block_b.get(k, 0), 0) for k in full_b},
        cfg=cfg, bus=bus)


def _batch_rows(engine, batch: int) -> slice:
    """This rank's rows of the global batch: its slice over the data axes
    (every rank of one data coordinate reads the same rows)."""
    if engine is None:
        return slice(None)
    axes = sh.data_axes_for(engine.axis_sizes)
    n = engine.comm.size(axes)
    if batch % n:
        raise ValueError(f"--batch {batch} does not divide over the data axes "
                         f"{axes} ({n} ranks)")
    i = engine.comm.index(axes)
    return slice(i * (batch // n), (i + 1) * (batch // n))


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str, window: tuple[int, int]) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(
        os.path.join(profile_dir, f"trace_steps_{window[0]}_{window[1]}.json"))


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
