"""Training launcher of the port: config-driven MuonBP pretraining on one GPU.

Counterpart of a minimal ``repro/launch/train.py``, with the reference's
flag names and defaults. ``--mesh-model N`` declares the tensor-parallel
size whose shards define the MuonBP blocks, so one GPU runs the paper's
N-way block grids. The phase schedule is driven here: ``step % P == 0``
runs 'full', every other step 'block'. One JSON line per step reports the
loss, the phase and the step's wall time (ending in a device sync).

Example (one H100, full-width muonbp-960m):
  PYTHONPATH=src python -m repro_torch.launch.train --arch muonbp-960m \\
      --optimizer muonbp --period 5 --mesh-model 8 --steps 6 --batch 4 --seq 1024

``--optimizer-variant {muon,turbo_muon,normuon,dion}`` picks the optimizer
variant (``core/variants.py``), as ``--optimizer dion`` picks Dion, e.g.
  PYTHONPATH=src python -m repro_torch.launch.train --arch muonbp-960m \\
      --optimizer muonbp --optimizer-variant normuon --period 5 --mesh-model 8 \\
      --steps 6 --batch 4 --seq 1024

``--device cpu`` runs the same path on the CPU (every kernel wrapper then
runs its plain PyTorch version); without it the launcher needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.core import adamw, block_muon, combine, label_tree, muon, muon_full
from repro_torch.core import variants as variants_lib
from repro_torch.core.muon import phase_for_step
from repro_torch.core.schedule import cosine, wsd
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import init_params
from repro_torch.sharding import specs as sh
from repro_torch.training.train_step import init_train_state, train_step

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_optimizer(name, params, *, lr, adam_lr, period, schedule_fn=None,
                    block_specs=None, rank=64, weight_decay=0.1, ns_strategy=None,
                    bucketing=True, variant=None):
    """(combined optimizer, effective period) as the reference builds them.

    ``--optimizer dion`` and the ``dion`` variant build the same low-rank
    program, whose period is 1 (the same work every step).
    """
    labels = label_tree(params)
    lr_s = schedule_fn(lr) if schedule_fn else lr
    adam_s = schedule_fn(adam_lr) if schedule_fn else adam_lr
    vspec = variants_lib.get(variant)
    ns_kw = dict(bucketing=bucketing, ns_strategy=ns_strategy)
    if name == "adamw":
        return combine({"adamw": adamw(adam_s, weight_decay=weight_decay)},
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
    return combine({"muon": matrix_opt, "adamw": adamw(adam_s, weight_decay=weight_decay)},
                   labels), period_eff


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
                         "replaces the matrix optimizer); default: the baseline")
    ap.add_argument("--period", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--adam-lr", type=float, default=0.008)
    ap.add_argument("--schedule", default="wsd", choices=["wsd", "cosine", "const"])
    ap.add_argument("--ns-strategy", default=None,
                    choices=["auto", "plain", "fused_chain", "fused_iter", "tiled"],
                    help="pin the per-bucket NS kernel strategy (default: auto, "
                         "the update program picks per bucket)")
    ap.add_argument("--no-ns-bucketing", action="store_true",
                    help="one NS chain per parameter instead of per shape bucket")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="declared tensor-parallel size; its shards are the MuonBP blocks")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=sorted(COMPUTE_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


@dataclasses.dataclass
class TrainRun:
    """What one launcher run leaves behind, for callers that inspect it."""

    cfg: Any
    state: Any
    block_specs: dict
    records: list


def run(argv=None, *, params: Optional[dict] = None,
        on_step: Optional[Callable[[dict], None]] = None) -> TrainRun:
    """Parse ``argv`` and train; returns the :class:`TrainRun`.

    ``params`` replaces the seeded initialization (tests start both packages
    from the reference's weights); ``on_step(record)`` is called after every
    step, once the step's device work has finished.
    """
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if params is None:
        params = init_params(cfg, seed=args.seed, device=device)
    axis_sizes = {"model": args.mesh_model}
    bspecs = sh.block_specs_for(params, sh.param_specs(params, cfg, axis_sizes), axis_sizes)
    labels = label_tree(params)
    bspecs = tree_lib.tree_map(lambda b, l: b if l == "muon" else None, bspecs, labels)

    sched = {"wsd": lambda peak: wsd(peak, args.steps),
             "cosine": lambda peak: cosine(peak, args.steps),
             "const": None}[args.schedule]
    optimizer, period = build_optimizer(
        args.optimizer, params, lr=args.lr, adam_lr=args.adam_lr, period=args.period,
        schedule_fn=sched, block_specs=bspecs, ns_strategy=args.ns_strategy,
        bucketing=not args.no_ns_bucketing, variant=args.optimizer_variant,
    )
    state = init_train_state(params, optimizer)
    pipe = iter(SyntheticLM(cfg, args.batch, args.seq, seed=args.seed))
    compute_dtype = COMPUTE_DTYPES[args.compute_dtype]

    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M optimizer={args.optimizer} "
          f"variant={variants_lib.get(args.optimizer_variant).name} period={period} "
          f"mesh={axis_sizes} device={device}", flush=True)
    records = []
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                 for k, v in next(pipe).items()}
        phase = phase_for_step(step, period) if args.optimizer != "adamw" else "block"
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, cfg=cfg, optimizer=optimizer,
                                    phase=phase, compute_dtype=compute_dtype)
        loss = float(metrics["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec = {"step": step, "loss": loss, "phase": phase,
               "wall_s": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        if on_step is not None:
            on_step(rec)
    return TrainRun(cfg=cfg, state=state, block_specs=bspecs, records=records)


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
