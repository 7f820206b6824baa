"""Perf runner of the port: one named (arch x shape x phase x variant) record.

Counterpart of ``repro/launch/perf.py``. It measures one combination with
the dry-run's machinery (``launch/dryrun.py``: one rank of the production
world, its step run on ``--device``) and stores the record under
``experiments/perf_torch/<name>.json`` (``--results-dir`` elsewhere), with
a ``perf_record`` event on the bus and the summary lines: FLOPs a rank,
collective bytes, argument + peak GB.

  PYTHONPATH=src python -m repro_torch.launch.perf --name granite_full_dist \\
      --arch granite-8b --shape train_4k --phase full --layer-shard --device fake
"""

from __future__ import annotations

import argparse
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                           "perf_torch")


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import add_run_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--name", default=None,
                    help="the record's name (default: arch__shape[__phase])")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--phase", default="block")
    ap.add_argument("--period", type=int, default=5)
    ap.add_argument("--layer-shard", "--distribute-full", action="store_true",
                    dest="layer_shard",
                    help="muon(layer_shard=): split full-step stacks over 'data' so each rank "
                         "orthogonalizes only its share of layers (the engine's fold)")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--ring-cache", action="store_true")
    ap.add_argument("--kv-seq-shard", action="store_true")
    ap.add_argument("--flash-block-k", type=int, default=0)
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 momentum sharding (distributed.zero1)")
    ap.add_argument("--zero1-flatten", action="store_true",
                    help="with --zero1: flatten-and-shard fallback for layer counts that do "
                         "not divide the ZeRO axes")
    ap.add_argument("--mesh", default=None,
                    help="mesh spec, e.g. 'pod=2,data=2,model=2'; default is the 16x16 "
                         "production mesh")
    ap.add_argument("--engine", default=None, choices=["shard_map", "gspmd"],
                    help="optimizer comm engine: the explicit engine (default); 'gspmd' "
                         "raises, eager PyTorch has no partitioner")
    ap.add_argument("--full-schedule", default=None,
                    choices=["pipelined", "barrier", "staggered"],
                    help="engine full-step schedule ('staggered': pass --phase stagger:<r>)")
    ap.add_argument("--optimizer-variant", default=None,
                    help="muon / turbo_muon / normuon / dion (core/variants.py)")
    ap.add_argument("--bf16-grads", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced variant (tests)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=None,
                    help=f"where the record goes (default {os.path.normpath(RESULTS_DIR)})")
    ap.add_argument("--log-file", default=None,
                    help="append build/step spans and a perf_record event as JSONL")
    add_run_args(ap)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_shape

    name = args.name or "__".join(
        [args.arch, args.shape] + ([args.phase.replace(":", "")]
                                   if get_shape(args.shape).kind == "train" else []))

    if args.log_file:
        from repro_torch.obs import Bus, JsonlSink, set_bus

        set_bus(Bus([JsonlSink(args.log_file)]))

    path = os.path.join(args.results_dir or RESULTS_DIR, name + ".json")
    if os.path.exists(path) and not args.force:
        print(f"[skip existing] {path}")
        return

    from repro_torch.launch.dryrun import lower_combo

    variant = {"engine": args.engine or "shard_map"}
    if args.full_schedule:
        variant["full_schedule"] = args.full_schedule
    if args.layer_shard:
        variant["layer_shard"] = True
    if args.accum_steps > 1:
        variant["accum_steps"] = args.accum_steps
    if args.ring_cache:
        variant["ring_cache"] = True
    if args.kv_seq_shard:
        variant["kv_seq_shard"] = True
    if args.flash_block_k:
        variant["flash_block_k"] = args.flash_block_k
    if args.zero1:
        variant["zero1"] = True
    if args.zero1_flatten:
        variant["zero1_flatten"] = True
    if args.bf16_grads:
        variant["bf16_grads"] = True
    if args.optimizer_variant:
        from repro_torch.core import variants as variants_lib

        variants_lib.get(args.optimizer_variant)  # validate the name early
        variant["optimizer_variant"] = args.optimizer_variant

    rec = lower_combo(args.arch, args.shape, phase=args.phase, period=args.period,
                      variant=variant, mesh_spec=args.mesh, reduced=args.reduced,
                      device=args.device, rank=args.rank)
    rec["perf_name"] = name
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    from repro_torch.obs import get_bus, record_span

    bus = get_bus()
    record_span(bus, "perf.build", rec.get("build_s") or 0.0, artifact=name)
    record_span(bus, "perf.step", rec.get("step_s") or 0.0, artifact=name)
    bus.event("perf_record", name=name, arch=args.arch, shape=args.shape, phase=args.phase,
              build_s=rec.get("build_s"), step_s=rec.get("step_s"), device=args.device,
              collective_bytes_total=rec.get("collective_bytes_total"),
              variant=rec.get("variant"))
    print(f"[perf] {name}: build {rec.get('build_s')}s, step {rec.get('step_s')}s "
          f"({args.device}, rank {args.rank}) -> {path}")
    if rec.get("skipped"):
        print(f"  skipped: {rec['reason']}")
        return
    cost, mem = rec["cost"], rec["memory"]
    print(f"  flops/rank            : {cost['flops']:.4g} (counted {cost['counted_flops']:.4g}"
          f" + NS chains {cost['ns_chain_flops']:.4g})")
    print(f"  coll bytes/rank       : {rec['collective_bytes_total']:.4g} "
          f"{json.dumps(rec['collectives_by_class'])}")
    peak = mem.get("peak_bytes")
    print(f"  args+peak GB          : {mem['argument_bytes'] / 2**30:.2f} + "
          f"{'null' if peak is None else f'{peak / 2**30:.2f}'} ({mem['peak_source']})")


if __name__ == "__main__":
    main()
