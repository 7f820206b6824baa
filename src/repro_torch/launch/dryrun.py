"""Multi-pod dry-run of the port: one rank of the production world for each
(arch x input shape x mesh).

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles the whole SPMD program on 512 forced host devices and reads XLA's
``memory_analysis``, ``cost_analysis`` and the post-partitioning HLO. Eager
PyTorch has no lowering to read, so here the process runs ONE RANK of the
production world instead: it joins a fake world of 256 ranks (512 with
``--multi-pod``; torch's in-process ``fake`` process group, whose
collectives move no data and return at once) at ``--rank r``, builds only
that rank's shards (the engine from the parameters' shapes as fake
tensors, then the rank's parameters, optimizer state, inputs and cache
allocated directly; the whole model never exists), runs one step of the shape's phase through the
port's own code (``train_step``; ``prefill`` or ``decode_step``) and
records what the rank allocated, computed and sent.

Fake collectives move no data, so the values a step computes are not
results: a gathered buffer is left as ``torch.empty`` made it (NaNs
included) and nothing reads it. The step's bytes, counts, shapes and memory
are results.

``--device``: ``cuda`` (the default) runs the step on the card, the NS
chains on the hand-written kernels; ``cpu`` runs it for real on the CPU, on
the kernels' plain versions (tests); ``fake`` runs it under
``FakeTensorMode`` on the CPU, which allocates nothing and takes the plain
versions' arithmetic: the counterpart of the reference's abstract lowering,
which runs anywhere. ``cuda`` without a card raises; nothing falls back.

The record keeps the reference's keys where their meaning carries over
(``arch``, ``shape``, ``mesh``, ``mesh_axes``, ``phase``, ``kind``,
``memory``, ``cost``, ``collectives``, ``collective_bytes_total``,
``calibrated``, ``variant``) and adds ``rank`` and ``device``. The
reference's ``lower_s`` and ``compile_s`` become the walls of what the
port does: ``build_s`` (the rank's shards, optimizer, state and inputs) and
``step_s`` (the step).

* ``memory.argument_bytes``: the rank's parameters, optimizer state,
  inputs and cache, from their shapes; ``memory.peak_bytes``: on ``cuda``
  ``torch.cuda.max_memory_allocated`` over the step after a reset, on
  ``cpu`` and ``fake`` the peak of live storages that
  ``torch.distributed._tools.mem_tracker.MemTracker`` counts (the
  arguments tracked), ``memory.peak_source`` says which.
* ``cost.flops``: ``FlopCounterMode`` over the step with the NS chains
  left out (``cost.counted_flops``: a kernel is opaque to the counter on
  the card, so the counter pauses in every chain on every device,
  ``kernels.dispatch.set_chain_scope``), plus the chains' FLOPs from the
  packed shapes they ran on (``cost.ns_chain_flops``,
  ``distributed.plan.ns_chain_flops``). ``bytes accessed`` and
  ``transcendentals`` have no eager counterpart: null, with the reason.
* ``collectives``: the rank's ``CollectiveTrace`` in the reference's
  ``{op: {count, bytes}}`` schema, and ``collectives_by_class`` its bytes
  by trace class (``tp``, ``grad_reduce``, ``full``, ``apply``,
  ``stagger``, ``dion``, ...).
* ``calibrated``: the reference fits L = 2 and 4 unrolled compiles because
  XLA counts a scan body once; here every layer runs and is counted, so it
  holds the direct counts with ``samples`` null and the reason.
  ``--no-calibrate`` leaves it null, as the reference's.

Train shapes run ``train_step`` directly (no host read in the step: the
launcher's loop reads the loss every step, which a fake tensor cannot give)
for both MuonBP phases, or ``stagger:0..4`` under ``--full-schedule
staggered``. Records go to ``experiments/dryrun_torch/`` (``--results-dir``
elsewhere), named as the reference names them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --device fake \\
      --arch muonbp-960m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device fake --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device fake \\
      --arch muonbp-960m --shape train_smoke --mesh pod=2,data=2,model=2 --reduced
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, shape_applies
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.sharding import specs as sh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                           "dryrun_torch")
DEVICES = ("cuda", "cpu", "fake")
SEED = 0
# Variant keys of the reference's ``_lower`` (launch/dryrun.py there).
VARIANT_KEYS = ("layer_shard", "accum_steps", "ring_cache", "kv_seq_shard", "flash_block_k",
                "engine", "zero1", "zero1_flatten", "full_schedule", "optimizer_variant",
                "bf16_grads")
NO_EAGER_COUNT = ("eager PyTorch has no count of it (the reference reads XLA's cost_analysis); "
                  "not estimated")
CALIBRATION = ("every layer runs eagerly and is counted: the scan-body undercount that the "
               "reference's L=2/4 unrolled fit corrects does not arise")
SKIP_REASON = "full-attention arch: long_500k requires sub-quadratic attention (DESIGN.md)"


# ---------------------------------------------------------------------------
# The fake world and the rank's pieces
# ---------------------------------------------------------------------------

def join_fake_world(world: int, rank: int) -> None:
    """Make this process rank ``rank`` of an in-process fake world of
    ``world`` ranks (no peers, no store traffic); a running world of another
    size or rank is left first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (world, rank):
            return
        dist.destroy_process_group()
    if not 0 <= rank < world:
        raise ValueError(f"--rank {rank} is not in a world of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def build_mesh(*, multi_pod: bool = False, mesh_spec: Optional[str] = None, rank: int = 0):
    """The rank's mesh: ``--mesh``'s, or the production one, over a fake
    world of its size."""
    from repro_torch.launch.mesh import (make_mesh_from_spec, make_production_mesh,
                                         parse_mesh_spec)

    shape = parse_mesh_spec(mesh_spec)[1] if mesh_spec else (
        (2, 16, 16) if multi_pod else (16, 16))
    join_fake_world(math.prod(shape), rank)
    if mesh_spec:
        return make_mesh_from_spec(mesh_spec, "cpu")
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The whole model's parameters as fake tensors: shapes, no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params

    with FakeTensorMode():
        return init_params(cfg, device="cpu", dtype=dtype)


class _Alloc:
    """Allocates the rank's tensors on ``device`` ('fake': under the
    process's ``FakeTensorMode``), from a seeded generator: parameters
    N(0, 0.02), token ids uniform. A dry-run's values are not results."""

    def __init__(self, device: str, seed: int = SEED):
        self.device = "cpu" if device == "fake" else device
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, dtype, std: float = 1.0) -> torch.Tensor:
        return (std * torch.randn(shape, generator=self.gen, dtype=torch.float32,
                                  device=self.device)).to(dtype)

    def tokens(self, shape, vocab: int) -> torch.Tensor:
        return torch.randint(0, vocab, shape, generator=self.gen, device=self.device)


def rank_params(full: dict, pspecs: dict, sizes: dict, alloc: _Alloc, dtype,
                tensor_parallel: bool) -> dict:
    """The rank's parameters, allocated directly: its ``param_specs``
    shards on the tensor-parallel path, whole leaves on the replicated one."""
    spec_by_key = dict(tree_lib.flatten_with_path(pspecs))
    return tree_lib.map_with_path(
        lambda k, p: alloc.normal(sh.local_shape(spec_by_key[k], p.shape, sizes)
                                  if tensor_parallel else tuple(p.shape), dtype, 0.02), full)


def local_rows(global_batch: int, sizes: dict) -> int:
    """A rank's rows of the global batch: its share over the data axes that
    divide it (``specs.batch_axes_for``), as the reference's input specs
    lay it out; a batch no data axis divides is whole on every rank."""
    return global_batch // math.prod(sizes[a] for a in sh.batch_axes_for(global_batch, sizes))


def input_specs(cfg: ModelConfig, shape: InputShape, sizes: dict, alloc: _Alloc) -> dict:
    """The rank's input batch of this shape: its rows of the tokens (and
    labels), a VLM's vision rows and whisper's frames (fp32, as the
    launcher's stub inputs), or a decode step's tokens (and whisper's
    encoder output in the activations' dtype)."""
    B, S = shape.global_batch, shape.seq_len
    rows = local_rows(B, sizes)
    batch: dict = {}
    if shape.kind in ("train", "prefill"):
        text = S - (cfg.vision_tokens or 0)
        batch["tokens"] = alloc.tokens((rows, text), cfg.vocab_size)
        if shape.kind == "train":
            batch["labels"] = alloc.tokens((rows, text), cfg.vocab_size)
        if cfg.arch_type == "vlm":
            batch["vision_embeds"] = alloc.normal((rows, cfg.vision_tokens, cfg.d_model),
                                                  torch.float32)
        if cfg.arch_type == "audio":
            batch["audio_frames"] = alloc.normal((rows, cfg.encoder_seq, cfg.d_model),
                                                 torch.float32)
    else:
        batch["tokens"] = alloc.tokens((rows, 1), cfg.vocab_size)
        if cfg.arch_type == "audio":
            batch["encoder_out"] = alloc.normal((rows, cfg.encoder_seq, cfg.d_model),
                                                torch.bfloat16)
    return batch


def abstract_cache(cfg: ModelConfig, shape: InputShape, ctx, device: str) -> dict:
    """The rank's decode cache (``transformer.init_cache`` with the
    context's layout: its ``specs.local_cache_shapes``), bf16."""
    from repro_torch.models.transformer import init_cache

    return init_cache(cfg, shape.global_batch, ctx.cache_len, dtype=torch.bfloat16,
                      device="cpu" if device == "fake" else device, ctx=ctx)


def make_optimizer(cfg: ModelConfig, full: dict, pspecs: dict, sizes: dict, period: int = 5,
                   layer_shard=None, comm=None, full_schedule=None, opt_variant=None):
    """The reference's dry-run optimizer: MuonBP (or the named variant; Dion
    builds its own program) on the Muon leaves, AdamW on the rest."""
    from repro_torch.core import adamw, combine, label_tree, muon
    from repro_torch.core import variants as variants_lib

    labels = label_tree(full)
    bspecs = sh.block_specs_for(full, pspecs, sizes)
    vspec = variants_lib.get(opt_variant)
    if vspec.low_rank:
        opt_muon = variants_lib.build_variant("dion", 1e-3, comm=comm,
                                              full_schedule=full_schedule)
    else:
        opt_muon = muon(1e-3, 1e-3, period=period, block_specs=tree_lib.tree_map(
            lambda lab, b: b if lab == "muon" else None, labels, bspecs),
            layer_shard=layer_shard, comm=comm, full_schedule=full_schedule, variant=vspec)
    return combine({"muon": opt_muon, "adamw": adamw(3e-4, comm=comm)}, labels)


def _tensors(tree) -> list:
    """Every tensor in a tree of dicts, tuples and NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def nbytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, tuples, NamedTuples)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


# ---------------------------------------------------------------------------
# One step, measured
# ---------------------------------------------------------------------------

class _StepCounter:
    """FLOPs of a step with the NS chains apart: ``FlopCounterMode`` paused
    in every chain (``dispatch.set_chain_scope``), the chains' FLOPs from
    their packed shapes, and their count."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        outer = self

        class _Counter(FlopCounterMode):
            def _count_flops(self, func_packet, out, args, kwargs):
                if outer.paused:
                    return out
                return super()._count_flops(func_packet, out, args, kwargs)

        self.mode = _Counter(display=False)
        self.paused = False
        self.ns_flops = 0
        self.chains: dict = {}

    @contextlib.contextmanager
    def _chain(self, device_type, strategy, shape, steps):
        from repro_torch.distributed.plan import ns_chain_flops

        self.ns_flops += ns_chain_flops(shape, steps)
        key = f"{strategy} {'x'.join(map(str, shape))} K={steps}"
        self.chains[key] = self.chains.get(key, 0) + 1
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was

    @contextlib.contextmanager
    def counting(self):
        from repro_torch.kernels import dispatch

        dispatch.set_chain_scope(self._chain)
        try:
            with self.mode:
                yield
        finally:
            dispatch.set_chain_scope(None)

    @property
    def counted(self) -> int:
        return int(self.mode.get_total_flops())


def _collectives(trace) -> tuple[dict, dict]:
    """The trace as the reference's ``{op: {count, bytes}}`` and as bytes
    by trace class."""
    by_op: dict = {}
    by_class: dict = {}
    for e in trace.events:
        rec = by_op.setdefault(e.kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += e.bytes
        by_class[e.phase] = by_class.get(e.phase, 0) + e.bytes
    return dict(sorted(by_op.items())), dict(sorted(by_class.items()))


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _run_step(fn, args_tree, device: str) -> tuple[dict, dict, float]:
    """Run ``fn()`` once, measured: ``(memory, cost, wall)``."""
    from repro_torch import kernels

    counter = _StepCounter()
    tracker = None
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    else:
        from torch.distributed._tools.mem_tracker import MemTracker

        tracker = MemTracker()
        tracker.track_external(*_tensors(args_tree))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with (tracker if tracker is not None else contextlib.nullcontext()), counter.counting():
        fn()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if device == "cuda":
        peak, source = torch.cuda.max_memory_allocated(), "torch.cuda.max_memory_allocated"
    else:
        peak = int(tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"])
        source = ("live " + ("fake " if device == "fake" else "") + "storages "
                  "(torch.distributed._tools.mem_tracker.MemTracker, arguments tracked)")
    memory = {"argument_bytes": nbytes(args_tree), "peak_bytes": peak, "peak_source": source}
    cost = {"flops": counter.counted + counter.ns_flops, "counted_flops": counter.counted,
            "ns_chain_flops": counter.ns_flops, "ns_chains": counter.chains,
            "kernel_launches": launches,
            "bytes accessed": None, "transcendentals": None,
            "null_reason": {"bytes accessed": NO_EAGER_COUNT, "transcendentals": NO_EAGER_COUNT},
            "flops_note": ("counted_flops: FlopCounterMode over the step, paused in the NS "
                           "chains (the card's kernels are opaque to it); ns_chain_flops: "
                           "plan.ns_chain_flops of each chain's packed shape")}
    return memory, cost, wall


def _device_mode(device: str):
    """The context the rank's tensors live in: ``FakeTensorMode`` for
    ``fake`` (a mesh's own tensors are real, hence non-fake inputs)."""
    if device == "fake":
        from torch._subclasses.fake_tensor import FakeTensorMode

        return FakeTensorMode(allow_non_fake_inputs=True)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card (use --device fake or cpu on a machine "
                           "without one)")
    return contextlib.nullcontext()


def _lower(cfg: ModelConfig, shape: InputShape, mesh, phase: str, period: int,
           variant: Optional[dict], device: str) -> dict:
    """Build the rank's pieces for one (cfg, shape) and run its step; the
    record's measured part. ``variant`` holds the reference's knobs
    (:data:`VARIANT_KEYS`); ``engine: gspmd`` raises, as the launcher's.
    What holds the mesh (the engine, the collectives, the context) is made
    before the device's mode: it reads the mesh's ranks as host data."""
    from repro_torch.distributed import make_engine
    from repro_torch.distributed.audit import Collectives

    v = dict(variant or {})
    unknown = set(v) - set(VARIANT_KEYS)
    if unknown:
        raise ValueError(f"unknown variant keys {sorted(unknown)}; known: {VARIANT_KEYS}")
    if v.get("engine", "shard_map") != "shard_map":
        raise ValueError("engine 'gspmd' has no counterpart in eager PyTorch (no partitioner); "
                         "the explicit engine, shard_map, runs every variant")
    sizes = sh.mesh_axis_sizes(mesh)
    train = shape.kind == "train"
    out: dict = {}
    t0 = time.perf_counter()
    full = abstract_params(cfg, torch.float32 if train else torch.bfloat16)
    pspecs = sh.param_specs(full, cfg, sizes)
    if train:
        engine = make_engine(full, pspecs, mesh, zero1=bool(v.get("zero1")),
                             zero1_flatten=bool(v.get("zero1_flatten")))
        comm, tensor_parallel = engine.comm, engine.tensor_parallel
        ctx = sh.make_ctx(cfg, engine, seq=sh.residual_len(cfg, shape.seq_len))
    else:
        comm, tensor_parallel = Collectives(mesh), True
        ring = bool(v.get("ring_cache"))
        ctx = sh.make_ctx(cfg, comm=comm, seq=sh.residual_len(cfg, shape.seq_len),
                          batch=shape.global_batch,
                          cache_len=cfg.window_size if ring else shape.seq_len,
                          kv_seq_shard=bool(v.get("kv_seq_shard")), ring_cache=ring)
    if v.get("flash_block_k"):
        ctx = dataclasses.replace(ctx, flash_block_k=int(v["flash_block_k"]))
    out["tensor_parallel"] = tensor_parallel
    with _device_mode(device):
        alloc = _Alloc(device)
        params = rank_params(full, pspecs, sizes, alloc,
                             torch.float32 if train else torch.bfloat16, tensor_parallel)
        batch = input_specs(cfg, shape, sizes, alloc)
        if train:
            from repro_torch.training.train_step import TrainState, train_step

            optimizer = make_optimizer(
                cfg, full, pspecs, sizes, period=period,
                layer_shard=(mesh, "data") if v.get("layer_shard") else None, comm=engine,
                full_schedule=v.get("full_schedule"), opt_variant=v.get("optimizer_variant"))
            state = TrainState(params=params, opt_state=optimizer.init(params), step=0)
            args = (state.params, state.opt_state, batch)

            def fn():
                train_step(state, batch, cfg=cfg, optimizer=optimizer, phase=phase,
                           accum_steps=int(v.get("accum_steps", 1)),
                           bf16_grads=bool(v.get("bf16_grads")), engine=engine, ctx=ctx)
        elif shape.kind == "prefill":
            from repro_torch.models.model import prefill

            args = (params, batch)

            def fn():
                with torch.no_grad():
                    prefill(params, batch, cfg, ctx=ctx)
        else:
            from repro_torch.models.model import decode_step

            cache = abstract_cache(cfg, shape, ctx, device)
            pos = shape.seq_len - 1
            args = (params, batch, cache)
            out["decode_pos"] = pos
            out["cache_bytes"] = nbytes(cache)

            def fn():
                with torch.no_grad():
                    decode_step(params, batch["tokens"], cache, pos, cfg, ctx=ctx,
                                encoder_out=batch.get("encoder_out"))
        _sync(device)
        out["build_s"] = round(time.perf_counter() - t0, 3)
        comm.trace.events.clear()
        memory, cost, wall = _run_step(fn, args, device)
    collectives, by_class = _collectives(comm.trace)
    out.update({"step_s": round(wall, 3), "memory": memory, "cost": cost,
                "collectives": collectives, "collectives_by_class": by_class,
                "collective_bytes_total": sum(r["bytes"] for r in collectives.values())})
    return out


def mesh_name(mesh) -> str:
    return "x".join(str(d) for d in sh.mesh_axis_sizes(mesh).values())


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False, phase: str = "block",
                period: int = 5, calibrate: bool = True, variant: Optional[dict] = None,
                mesh_spec: Optional[str] = None, reduced: bool = False, device: str = "cuda",
                rank: int = 0) -> dict:
    """One rank's step of one combination; returns the record.

    ``mesh_spec`` (e.g. ``'pod=2,data=2,model=2'``) overrides the production
    mesh; ``reduced`` runs the config's reduced variant; ``rank`` is the
    rank this process plays (its shards, rows and coordinates).
    """
    if device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = get_shape(shape_name)
    if not shape_applies(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True, "reason": SKIP_REASON}
    mesh = build_mesh(multi_pod=multi_pod, mesh_spec=mesh_spec, rank=rank)
    measured = _lower(cfg, shape, mesh, phase, period, variant, device)
    calibrated = None
    if calibrate:
        calibrated = {"flops": measured["cost"]["flops"], "bytes": None,
                      "collective_bytes": measured["collective_bytes_total"],
                      "samples": None, "reason": CALIBRATION}
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "mesh_axes": list(sh.mesh_axis_sizes(mesh)),
        "phase": phase if shape.kind == "train" else None,
        "kind": shape.kind,
        "rank": rank,
        "device": device,
        "build_s": measured.pop("build_s"),
        "step_s": measured.pop("step_s"),
        **measured,
        "calibrated": calibrated,
        "variant": variant,
        "values_note": ("fake collectives move no data: the step's values are not results; "
                        "its bytes, counts, shapes and memory are"),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def result_path(arch, shape, multi_pod, phase, variant=None, mesh_label=None, reduced=False,
                results_dir: Optional[str] = None) -> str:
    """The record's path, named as the reference names it."""
    mesh = mesh_label or ("2x16x16" if multi_pod else "16x16")
    name = f"{arch}__{shape}__{mesh}"
    if reduced:
        name += "__reduced"
    if phase:
        name += f"__{phase.replace(':', '')}"  # 'stagger:2' -> 'stagger2'
    for k in sorted(variant or {}):
        val = variant[k]
        name += f"__{k}" if val is True else f"__{k}-{val}"
    return os.path.join(results_dir or RESULTS_DIR, name + ".json")


def run_and_save(arch, shape, multi_pod, phase, skip_existing=True, variant=None,
                 mesh_spec=None, reduced=False, calibrate=True, device="cuda", rank=0,
                 results_dir: Optional[str] = None) -> dict:
    """Run one combination and write its record (an error is a record too);
    returns the record, or None when an existing one was kept."""
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.obs import get_bus, record_span

    mesh_label = "x".join(str(d) for d in parse_mesh_spec(mesh_spec)[1]) if mesh_spec else None
    path = result_path(arch, shape, multi_pod,
                       phase if get_shape(shape).kind == "train" else None,
                       variant=variant, mesh_label=mesh_label, reduced=reduced,
                       results_dir=results_dir)
    mesh_str = mesh_label or ("2x16x16" if multi_pod else "16x16")
    if skip_existing and os.path.exists(path):
        print(f"[skip existing] {path}")
        return None
    label = f"{arch} x {shape} x {mesh_str}" + (f" x {phase}" if phase else "")
    print(f"[dryrun] {label} ({device}, rank {rank}) ...", flush=True)
    try:
        rec = lower_combo(arch, shape, multi_pod=multi_pod, phase=phase or "block",
                          variant=variant, mesh_spec=mesh_spec, reduced=reduced,
                          calibrate=calibrate, device=device, rank=rank)
    except Exception:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_str, "phase": phase, "rank": rank,
               "device": device, "error": traceback.format_exc()}
        print(rec["error"], flush=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "SKIPPED" if rec.get("skipped") else ("ERROR" if "error" in rec else "ok")
    bus = get_bus()
    if status == "ok":
        record_span(bus, "dryrun.build", rec["build_s"], arch=arch, shape=shape)
        record_span(bus, "dryrun.step", rec["step_s"], arch=arch, shape=shape)
    # The reference's fields: no lowering and no compile here (null).
    bus.event("dryrun_combo", phase=rec.get("phase"), lower_s=None, compile_s=None,
              build_s=rec.get("build_s"), step_s=rec.get("step_s"), arch=arch, shape=shape,
              mesh=rec.get("mesh", mesh_str), status=status, rank=rank, device=device,
              collective_bytes_total=rec.get("collective_bytes_total"))
    print(f"[dryrun] {label}: {status} (build {rec.get('build_s', '-')}s, step "
          f"{rec.get('step_s', '-')}s, coll {rec.get('collective_bytes_total', '-')} B)",
          flush=True)
    rec["path"] = path
    return rec


def add_run_args(ap: argparse.ArgumentParser) -> None:
    """The flags the dry-run and the perf runner share."""
    ap.add_argument("--device", default="cuda", choices=DEVICES,
                    help="where the rank's step runs: the card (default), the CPU for real "
                         "(tests), or 'fake' (FakeTensorMode: nothing allocated, any machine)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world this process plays")


def main(argv=None) -> None:
    from repro_torch.core import variants as variants_lib
    from repro_torch.core.program import parse_stagger_phase

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="production hierarchical mesh: (2,16,16) over ('pod','data','model')")
    ap.add_argument("--mesh", default=None,
                    help="explicit mesh spec, e.g. 'pod=2,data=2,model=2'; overrides "
                         "--multi-pod")
    ap.add_argument("--reduced", action="store_true", help="the reduced config variant")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="leave 'calibrated' null (there is no calibration run to skip)")
    ap.add_argument("--phase", default=None,
                    help="one phase only: 'block', 'full', or 'stagger:<r>' (with "
                         "--full-schedule staggered); default: every phase of the schedule")
    ap.add_argument("--full-schedule", default=None,
                    choices=["pipelined", "barrier", "staggered"])
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 momentum sharding over the mesh's data axes")
    ap.add_argument("--zero1-flatten", action="store_true",
                    help="with --zero1: flatten-and-shard fallback for indivisible layer counts")
    ap.add_argument("--optimizer-variant", default=None,
                    help="muon / turbo_muon / normuon / dion (core/variants.py); non-default "
                         "variants get their own record")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="keep records already on disk (the default without --force)")
    ap.add_argument("--force", action="store_true", help="re-run existing results")
    ap.add_argument("--results-dir", default=None,
                    help=f"where records go (default {os.path.normpath(RESULTS_DIR)})")
    ap.add_argument("--log-file", default=None,
                    help="append build/step spans and dryrun_combo events as JSONL")
    add_run_args(ap)
    args = ap.parse_args(argv)
    if args.phase is not None and args.phase not in ("block", "full") \
            and parse_stagger_phase(args.phase) is None:
        ap.error(f"--phase must be 'block', 'full' or 'stagger:<r>', got {args.phase!r}")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a card; --device fake runs anywhere")
    if args.log_file:
        from repro_torch.obs import Bus, JsonlSink, set_bus

        set_bus(Bus([JsonlSink(args.log_file)]))
    variant: dict = {}
    if args.full_schedule:
        variant["full_schedule"] = args.full_schedule
    if args.zero1:
        variant["zero1"] = True
    if args.zero1_flatten:
        variant["zero1_flatten"] = True
    if args.optimizer_variant:
        variants_lib.get(args.optimizer_variant)  # validate the name early
        variant["optimizer_variant"] = args.optimizer_variant
    variant = variant or None
    if args.full_schedule == "staggered":
        train_phases = [f"stagger:{r}" for r in range(5)]
    else:
        train_phases = ["block", "full"]
    combos = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                phases = list(train_phases) if SHAPES[shape].kind == "train" else [None]
                combos += [(arch, shape, phase) for phase in phases]
    else:
        kind = SHAPES[args.shape].kind
        phases = [args.phase] if (args.phase or kind != "train") else train_phases
        combos = [(args.arch, args.shape, p) for p in phases]
    for arch, shape, phase in combos:
        run_and_save(arch, shape, args.multi_pod, phase, skip_existing=not args.force,
                     variant=variant, mesh_spec=args.mesh, reduced=args.reduced,
                     calibrate=not args.no_calibrate, device=args.device, rank=args.rank,
                     results_dir=args.results_dir)


if __name__ == "__main__":
    main()
