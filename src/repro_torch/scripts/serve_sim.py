"""Seeded multi-tenant open-loop traffic generator for the serving engine.

Counterpart of the reference's ``scripts/serve_sim.py``: the same flags and
defaults, the same seeded arrivals, report, events and exit codes. Drives
``repro_torch.serving.ServingEngine`` with Poisson arrivals (optionally
bursty), mixed prompt/output lengths, per-tenant priorities, and TTL
deadlines, then reports tail latency and goodput:

* p50/p95/p99 time-to-first-token and per-output-token latency (virtual
  clock: one engine scheduler iteration = ``--step-dt`` seconds, so a
  seeded run produces an identical event stream on any host);
* goodput (completed tokens/s) vs offered load (requested tokens/s);
* per-outcome counts: completed / rejected{reason} / shed / cancelled{reason}.

Open loop: arrivals are drawn up front from the seed and submitted on
schedule regardless of completions -- offered load above slot capacity
exercises admission control, degradation, and shedding rather than simply
slowing the client down. The whole event stream lands on the telemetry
bus (``--log-file`` = crash-safe fsync'd JSONL, stdout mirrors the non-quiet
events), so ``python -m repro_torch.scripts.obs_report`` renders the same
percentiles offline and ``--strict`` validates the schema.

Two flags are the port's own, as in its training launcher. The reference
always serves ``get_config(arch).reduced()``; the port serves the full-width
model unless ``--reduced`` is given, and runs on the card unless
``--device cpu`` is given (without a card and without it, it raises). The
weights are random, from ``init_params(seed=0)`` on the device.

Faults ride the ``repro_torch.training.faults`` grammar, e.g. (on the CPU,
the reduced model; on the card drop ``--device cpu``, and ``--reduced`` for
full width)::

    PYTHONPATH=src python -m repro_torch.scripts.serve_sim --reduced --device cpu \
        --arch granite-8b --steps 80 --rate 0.6 --burst 20:40x6 \
        --fault-plan slow_step@10x0.2,kill_in_decode@60 --log-file serve.jsonl

Exit status: 0 when the drive completed (shedding under overload is the
engine working as designed, not a failure); 1 when the engine leaked KV
blocks or slots.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.obs import bus as bus_lib
from repro_torch.obs.spans import percentiles
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.training.faults import FaultPlan


def parse_bursts(specs: list[str]) -> list[tuple[int, int, float]]:
    """``start:end:xMULT`` windows, e.g. ``20:40x6`` = 6x rate in [20, 40)."""
    out = []
    for spec in specs:
        try:
            window, mult = spec.split("x")
            a, b = window.split(":")
            out.append((int(a), int(b), float(mult)))
        except ValueError:
            raise SystemExit(
                f"bad --burst {spec!r} (want START:ENDxMULT, e.g. 20:40x6)")
    return out


def parse_lens(spec: str, what: str) -> list[int]:
    try:
        vals = [int(v) for v in spec.split(",") if v.strip()]
    except ValueError:
        vals = []
    if not vals or any(v <= 0 for v in vals):
        raise SystemExit(f"bad --{what} {spec!r} (want positive csv ints)")
    return vals


def build_arrivals(args, vocab: int) -> list[list[Request]]:
    """Deterministic per-step arrival schedule (open loop)."""
    rng = np.random.default_rng(args.seed)
    prompt_lens = parse_lens(args.prompt_lens, "prompt-lens")
    new_tokens = parse_lens(args.new_tokens, "new-tokens")
    bursts = parse_bursts(args.burst)
    arrivals: list[list[Request]] = []
    rid = 0
    for t in range(args.steps):
        rate = args.rate
        for a, b, mult in bursts:
            if a <= t < b:
                rate *= mult
        batch = []
        for _ in range(int(rng.poisson(rate))):
            tenant = int(rng.integers(args.tenants))
            plen = int(rng.choice(prompt_lens))
            req = Request(
                rid=f"r{rid:05d}",
                prompt=rng.integers(0, vocab, size=plen).astype(np.int32),
                max_new_tokens=int(rng.choice(new_tokens)),
                tenant=f"t{tenant}",
                priority=tenant % 3,
                deadline=(t * args.step_dt + args.ttl) if args.ttl > 0 else None,
                seed=rid,
            )
            batch.append(req)
            rid += 1
        arrivals.append(batch)
    return arrivals


def report(engine: ServingEngine, args, offered: int, offered_tokens: int,
           sim_steps: int, bus: bus_lib.Bus) -> None:
    done = [r for r in engine.finished if r.state == "done"]
    by_state: dict[str, int] = {}
    for r in engine.finished:
        key = r.state if r.reason is None else f"{r.state}:{r.reason}"
        by_state[key] = by_state.get(key, 0) + 1
    wall = max(sim_steps * args.step_dt, 1e-9)
    completed_tokens = sum(len(r.tokens) for r in done)
    ttft = percentiles([r.first_token_t - r.arrival_t for r in done])
    tpot = percentiles(
        [(r.finish_t - r.first_token_t) / (len(r.tokens) - 1)
         for r in done if len(r.tokens) > 1])
    goodput = completed_tokens / wall
    print(f"serve_sim: offered {offered} requests ({offered_tokens} tokens) "
          f"over {sim_steps} steps x {args.step_dt}s")
    for k in sorted(by_state):
        print(f"serve_sim: outcome {k}: {by_state[k]}")
    print(f"serve_sim: goodput {goodput:.1f} tok/s (virtual) vs offered "
          f"{offered_tokens / wall:.1f} tok/s")
    if ttft:
        print(f"serve_sim: ttft p50={ttft['p50']:.3f}s p95={ttft['p95']:.3f}s "
              f"p99={ttft['p99']:.3f}s (virtual)")
    if tpot:
        print(f"serve_sim: per-token p50={tpot['p50'] * 1e3:.1f}ms "
              f"p95={tpot['p95'] * 1e3:.1f}ms p99={tpot['p99'] * 1e3:.1f}ms "
              f"(virtual)")
    bus.event(
        "serve_report",
        offered=offered,
        offered_tokens=offered_tokens,
        completed=len(done),
        completed_tokens=completed_tokens,
        goodput_tps=round(goodput, 3),
        offered_tps=round(offered_tokens / wall, 3),
        ttft_p50_s=ttft.get("p50"), ttft_p95_s=ttft.get("p95"),
        ttft_p99_s=ttft.get("p99"),
        tpot_p50_s=tpot.get("p50"), tpot_p95_s=tpot.get("p95"),
        tpot_p99_s=tpot.get("p99"),
        outcomes=by_state,
        shed=sum(v for k, v in by_state.items() if k.startswith("shed")),
        timeouts=by_state.get("cancelled:deadline", 0),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=100,
                    help="scheduler iterations of arrival traffic")
    ap.add_argument("--step-dt", type=float, default=0.05,
                    help="virtual seconds per scheduler iteration")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="mean arrivals per iteration (Poisson, all tenants)")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--burst", action="append", default=[],
                    help="START:ENDxMULT rate-multiplier window (repeatable)")
    ap.add_argument("--prompt-lens", default="8,16,24",
                    help="csv of prompt lengths to sample")
    ap.add_argument("--new-tokens", default="8,16",
                    help="csv of requested output lengths to sample")
    ap.add_argument("--ttl", type=float, default=0.0,
                    help="per-request deadline = arrival + ttl virtual "
                         "seconds (0 = no deadline)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--queue", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-model-len", type=int, default=64)
    ap.add_argument("--max-prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default=None,
                    help="repro_torch.training.faults grammar, e.g. "
                         "slow_step@10x0.2,corrupt_cache@20,kill_in_decode@30")
    ap.add_argument("--log-file", default=None,
                    help="crash-safe JSONL telemetry trail (registered "
                         "before the stdout sink)")
    ap.add_argument("--no-drain", action="store_true",
                    help="stop at --steps instead of draining in-flight work")
    ap.add_argument("--drain-grace", type=int, default=200,
                    help="max extra iterations to wait for drain")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced model (the reference always does)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the KV pool live")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to run on the CPU")

    sinks: list = []
    if args.log_file:
        sinks.append(bus_lib.JsonlSink(args.log_file))
    sinks.append(bus_lib.StdoutSink())
    bus = bus_lib.Bus(sinks)
    bus.event("run_start", argv=sys.argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=0, device=device)
    ecfg = EngineConfig(
        slots=args.slots, queue_capacity=args.queue,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_model_len=args.max_model_len, max_prompt_len=args.max_prompt_len,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature)
    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    engine = ServingEngine(params, cfg, ecfg, bus=bus, fault_plan=plan)

    arrivals = build_arrivals(args, cfg.vocab_size)
    offered = sum(len(b) for b in arrivals)
    offered_tokens = sum(r.max_new_tokens for b in arrivals for r in b)

    t_wall = time.perf_counter()
    sim_steps = 0
    for t, batch in enumerate(arrivals):
        now = t * args.step_dt
        for req in batch:
            engine.submit(req, now)
        engine.step(now)
        sim_steps += 1
    if not args.no_drain:
        engine.begin_drain(sim_steps * args.step_dt)
        for extra in range(args.drain_grace):
            if engine.idle:
                break
            engine.step((sim_steps + extra) * args.step_dt)
            sim_steps += 1
    wall_s = time.perf_counter() - t_wall

    report(engine, args, offered, offered_tokens, sim_steps, bus)
    leak = engine.outstanding_blocks()
    active = int(engine._active.sum())
    status = "ok" if (leak == 0 or not engine.idle) else "leak"
    bus.event("run_end", steps=sim_steps, wall_s=round(wall_s, 3),
              status=status, counters=dict(bus.counters))
    bus.close()
    if engine.idle and (leak or active):
        print(f"serve_sim: FAIL -- idle engine leaked {leak} blocks / "
              f"{active} slots", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
