#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``src/repro_torch`` and
drives the port end to end:

  1. device   -- the card's name and power limit (nvidia-smi), device count;
  2. build    -- one nvcc per kernel source, in parallel; -Xptxas -v report;
  3. kernels  -- every kernel against its plain PyTorch version at the
                 shapes of the training step (TF32 off), with tolerances;
  4. train    -- six steps of full-width muonbp-960m MuonBP training
                 (12 layers, virtual 8-way tensor-parallel block grid,
                 batch 4 x seq 1024): phases full, block x4, full; launch
                 counts of every kernel on that path; the Muon update from
                 the kernels against the one from the plain versions on
                 the same gradients, for one block and one full step;
  5. reference -- six reduced steps on the card against the same steps on
                 the CPU (plain versions), from the same weights;
  6. times    -- each kernel, its plain version and the one-call PyTorch
                 counterpart (where one exists) timed with CUDA events, with
                 the least time the card could take for the same work.

Any failed phase raises, so the script exits non-zero and prints no result.
Its last two lines are the kernels JSON and the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound.
FP32_FLOPS = 67e12       # fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12

# Main-path shapes at full-width muonbp-960m with an 8-way block grid
# (after the transpose to the small side).
MLP_FULL = (24, 1536, 6144)    # full phase, mlp wi/wg: tiled
QO_FULL = (24, 1536, 1536)     # full phase, attn wq/wo: tiled
MLP_BLOCK = (192, 768, 1536)   # block phase, mlp wi/wg blocks: fused chain
KV_BLOCK = (192, 48, 1536)     # block phase, attn wk/wv blocks: fused chain
NS_STEPS = 5

# Tolerances, relative to max|plain|. Single products: fp32 FFMA sums in
# another order than cuBLAS's fp32 SGEMM (TF32 off) agree to ~1e-6 of the
# largest value. The 5-step chains compound per-step rounding differences
# through a cubic polynomial, so they get one more decade.
PRODUCT_TOL = 1e-4
CHAIN_TOL = 1e-3
UPDATE_TOL = 1e-3      # Muon update: NS chains + the RMS-matched epilogue
SMALL_LOSS_TOL = 1e-3  # reduced run on the card vs the CPU, fp32 compute

TPU_KERNELS = {
    "ns_matmul": ("cuda", "src/repro_torch/kernels/csrc/ns_matmul.cu",
                  "src/repro/kernels/newton_schulz/newton_schulz.py:48"),
    "ns_fma_matmul": ("cuda", "src/repro_torch/kernels/csrc/ns_matmul.cu",
                      "src/repro/kernels/newton_schulz/newton_schulz.py:66"),
    "ns_fused_chain": ("cuda", "src/repro_torch/kernels/csrc/ns_fused.cu",
                       "src/repro/kernels/newton_schulz/fused.py:104"),
    "ns_fused_iter": ("cuda", "src/repro_torch/kernels/csrc/ns_fused.cu",
                      "src/repro/kernels/newton_schulz/fused.py:98"),
}
MAIN_PATH_KERNELS = ("ns_matmul", "ns_fma_matmul", "ns_fused_chain")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def rel_err(out, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    import torch

    if out.shape != ref.shape:
        fail(f"shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail("non-finite kernel output")
    err = float((out.double() - ref.double()).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def unit_inputs(shape, seed: int):
    """Frobenius-normalised random fp32 units on the card (NS inputs)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)


def ns_step_flops(b: int, m: int, n: int) -> float:
    """Least flops of one NS step on b units of m x n (m <= n).

    The Gram and its square are symmetric, so only their m(m+1)/2 distinct
    entries need computing (n and m multiply-adds each); the update
    P X needs all m n entries (m multiply-adds each).
    """
    return b * (n * m * (m + 1.0) + m * m * (m + 1.0) + 2.0 * m * m * n)


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {smi}")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"[device] torch: {name} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "kind": name, "count": count}


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line or "registers" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(errors: dict) -> None:
    import torch

    from repro_torch.core.newton_schulz import PAPER_COEFFS, orthogonalize_plain
    from repro_torch.kernels.newton_schulz import fused, ops
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    a, b, c = PAPER_COEFFS

    def record(name, label, out, ref, tol):
        err, rel = rel_err(out, ref)
        ok = rel <= tol
        log(f"[kernels] {name} {label}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
            f"{'ok' if ok else 'FAIL'}")
        errors[name] = max(errors.get(name, 0.0), err)
        if not ok:
            fail(f"{name} {label} disagrees with its plain version")

    x = unit_inputs(MLP_FULL, 1)
    gram_ref = tiled.matmul_plain(x, x.transpose(-1, -2))
    record("ns_matmul", f"gram {MLP_FULL}", tiled.matmul(x, x.transpose(-1, -2)), gram_ref, PRODUCT_TOL)
    poly_ref = tiled.fma_matmul_plain(gram_ref, gram_ref, gram_ref, alpha=b, beta=c)
    record("ns_fma_matmul", "poly bA+cA^2",
           tiled.fma_matmul(gram_ref, gram_ref, gram_ref, alpha=b, beta=c), poly_ref, PRODUCT_TOL)
    upd_ref = tiled.fma_matmul_plain(poly_ref, x, x, alpha=a, beta=1.0)
    record("ns_fma_matmul", "update aX+PX",
           tiled.fma_matmul(poly_ref, x, x, alpha=a, beta=1.0), upd_ref, PRODUCT_TOL)
    del x, gram_ref, poly_ref, upd_ref

    for shape, seed in ((MLP_BLOCK, 2), (KV_BLOCK, 3)):
        xb = unit_inputs(shape, seed)
        ref = fused.ns_chain_plain(xb, PAPER_COEFFS, NS_STEPS)
        record("ns_fused_chain", f"{shape} x{NS_STEPS} steps",
               fused.ns_chain(xb, PAPER_COEFFS, NS_STEPS), ref, CHAIN_TOL)
        if shape == MLP_BLOCK:
            y = xb
            for _ in range(NS_STEPS):
                y = fused.ns_iteration(y, PAPER_COEFFS)
            record("ns_fused_iter", f"{shape} {NS_STEPS} launches", y, ref, CHAIN_TOL)
        del xb, ref

    g = unit_inputs(QO_FULL, 4)
    ref = orthogonalize_plain(g, steps=NS_STEPS)
    out = ops.orthogonalize(g, steps=NS_STEPS)
    err, rel = rel_err(out, ref)
    log(f"[kernels] tiled chain {QO_FULL} x{NS_STEPS} steps: max_abs_err {err:.3e} rel {rel:.3e} "
        f"(tol {CHAIN_TOL:g}) {'ok' if rel <= CHAIN_TOL else 'FAIL'}")
    if rel > CHAIN_TOL:
        fail("tiled NS chain disagrees with the plain chain")
    torch.cuda.synchronize()


def phase_train(launches: dict) -> None:
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core import label_tree, muon
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.training.train_step import loss_and_grads

    argv = ["--arch", "muonbp-960m", "--optimizer", "muonbp", "--period", "5",
            "--mesh-model", "8", "--steps", "6", "--batch", "4", "--seq", "1024"]
    log(f"[train] python -m repro_torch.launch.train {' '.join(argv)}")
    per_step = []
    last = {}

    def on_step(rec):
        counts = kernels.launch_counts()
        per_step.append((rec["phase"], {k: counts[k] - last.get(k, 0) for k in counts}))
        last.update(counts)
        log(f"[train] step {rec['step']} phase {rec['phase']} loss {rec['loss']:.4f} "
            f"wall {rec['wall_s']:.3f} s launches {per_step[-1][1]}")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = train.run(argv, on_step=on_step)
    counts = kernels.launch_counts()
    launches.update(counts)
    log(f"[train] launches on the main path: {counts}")
    log(f"[train] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    losses = [r["loss"] for r in run.records]
    phases = [r["phase"] for r in run.records]
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        fail(f"non-finite loss: {losses}")
    if phases != ["full", "block", "block", "block", "block", "full"]:
        fail(f"unexpected phases {phases}")
    for name in MAIN_PATH_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} never launched on the main path")
    for phase in ("block", "full"):
        step_counts = next(c for p, c in per_step if p == phase)
        log(f"[train] launches per {phase} step: {step_counts}")
        launches[f"per_{phase}_step"] = step_counts

    # The Muon update from the kernels against the plain versions, on the
    # same gradients, for one block and one full step; each also timed (the
    # second of two calls, host clock around a synchronised update), with
    # the forward and backward beside them: where the step's time goes.
    params = run.state.params
    cfg = run.cfg
    batch = next(iter(SyntheticLM(cfg, 4, 1024, seed=1)))
    batch = {k: torch.from_numpy(v).to(device="cuda", dtype=torch.long) for k, v in batch.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    loss_and_grads(params, batch, cfg)
    (_, _, grads), fwd_bwd_ms = timed(lambda: loss_and_grads(params, batch, cfg))
    log(f"[train] forward+backward (bf16 compute) {fwd_bwd_ms:.1f} ms")
    breakdown = {"fwd_bwd_ms": fwd_bwd_ms}
    labels = label_tree(params)
    only_muon = lambda t: tree_lib.tree_map(lambda x, l: x if l == "muon" else None, t, labels)
    g_m, p_m = only_muon(grads), only_muon(params)
    del grads
    for phase in ("block", "full"):
        outs = {}
        for strategy in (None, "plain"):
            opt = muon(0.02, 0.02, period=5, weight_decay=0.1,
                       block_specs=run.block_specs, ns_strategy=strategy)
            state = opt.init(p_m)
            opt.update(g_m, state, p_m, phase)
            (upd, _), ms = timed(lambda: opt.update(g_m, state, p_m, phase))
            outs[strategy] = tree_lib.flatten_with_path(upd)
            breakdown[f"muon_{phase}_{'kernels' if strategy is None else 'plain'}_ms"] = ms
        err = max(float((u.double() - v.double()).abs().max())
                  for (_, u), (_, v) in zip(outs[None], outs["plain"]))
        scale = max(float(v.abs().max()) for _, v in outs["plain"])
        log(f"[train] muon update {phase}: kernels vs plain max_abs_err {err:.3e} "
            f"rel {err / scale:.3e} (tol {UPDATE_TOL:g}); "
            f"{breakdown[f'muon_{phase}_kernels_ms']:.1f} ms with the kernels, "
            f"{breakdown[f'muon_{phase}_plain_ms']:.1f} ms plain")
        if not err / scale <= UPDATE_TOL:
            fail(f"{phase} Muon update from the kernels disagrees with the plain update")
    log(f"[train] breakdown {json.dumps(breakdown)}")
    del run, params, g_m, p_m, outs
    torch.cuda.empty_cache()


def phase_reference() -> None:
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    cfg = get_config("muonbp-960m").reduced()
    base = init_params(cfg, seed=0, device="cpu")
    argv = ["--arch", "muonbp-960m", "--reduced", "--mesh-model", "4", "--steps", "6",
            "--batch", "2", "--seq", "64", "--compute-dtype", "float32"]
    cpu = train.run(argv + ["--device", "cpu"], params=base).records
    # "plain" runs cuBLAS on the card: its drift from the CPU is the card's
    # summation order alone, the yardstick for the kernels' drift.
    for strategy in ("plain", "auto", "tiled"):
        gpu_params = tree_lib.tree_map(lambda p: p.to("cuda"), base)
        gpu = train.run(argv + ["--device", "cuda", "--ns-strategy", strategy],
                        params=gpu_params).records
        diff = max(abs(g["loss"] - c["loss"]) for g, c in zip(gpu, cpu))
        log(f"[reference] reduced 6 steps, card ({strategy}) vs CPU plain: "
            f"max |loss diff| {diff:.3e} (tol {SMALL_LOSS_TOL:g})")
        if not diff <= SMALL_LOSS_TOL:
            fail(f"card run ({strategy}) does not track the CPU reference")
    torch.cuda.synchronize()


def phase_times(errors: dict, launches: dict) -> list:
    import torch

    from repro_torch.core.newton_schulz import PAPER_COEFFS
    from repro_torch.kernels.newton_schulz import fused
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    a, b, c = PAPER_COEFFS
    rows = []

    def add(name, shape, fn, plain, library, flops, nbytes, iters):
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain, iters)
        lib_ms = cuda_ms(library, iters) if library is not None else None
        bms, kind = bound_ms(flops, nbytes)
        route, source, replaces = TPU_KERNELS[name]
        row = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": int(launches.get(name, 0)), "max_abs_err": errors.get(name),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": kind,
               "library_ms": lib_ms, "shape": shape}
        log(f"[times] {name} {shape}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.3f}'}, bound {bms:.3f} ms by {kind}, "
            f"{bms / ms:.1%} of bound)")
        rows.append(row)

    # On the main path ns_matmul only forms the Gram X X^T, which is
    # symmetric: the least work is its m(m+1)/2 distinct entries, n
    # multiply-adds each, as ns_step_flops counts it (the kernel computes
    # every tile).
    B, m, n = MLP_FULL
    x = unit_inputs(MLP_FULL, 5)
    xt = x.transpose(-1, -2)
    add("ns_matmul", f"gram {B}x{m}x{n}", lambda: tiled.matmul(x, xt),
        lambda: tiled.matmul_plain(x, xt), lambda: torch.bmm(x, xt),
        B * m * (m + 1.0) * n, 4.0 * (B * m * n + B * m * m), 3)
    gram = tiled.matmul_plain(x, xt)
    poly = tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c)
    add("ns_fma_matmul", f"update aX+PX {B}x{m}x{m}@{m}x{n}",
        lambda: tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
        lambda: tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0),
        lambda: torch.baddbmm(x, poly, x, beta=a, alpha=1.0),
        2.0 * B * m * m * n + 2.0 * B * m * n, 4.0 * (B * m * m + 2 * B * m * n), 3)
    del x, xt, gram, poly
    torch.cuda.empty_cache()

    B, m, n = MLP_BLOCK
    xb = unit_inputs(MLP_BLOCK, 6)
    io = 4.0 * 2 * B * m * n
    add("ns_fused_chain", f"{B}x{m}x{n} x{NS_STEPS} steps",
        lambda: fused.ns_chain(xb, PAPER_COEFFS, NS_STEPS),
        lambda: fused.ns_chain_plain(xb, PAPER_COEFFS, NS_STEPS), None,
        NS_STEPS * ns_step_flops(B, m, n), io, 2)
    add("ns_fused_iter", f"{B}x{m}x{n} one step",
        lambda: fused.ns_iteration(xb, PAPER_COEFFS),
        lambda: fused.ns_chain_plain(xb, PAPER_COEFFS, 1), None,
        ns_step_flops(B, m, n), io, 3)
    del xb
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package at {SRC / 'repro_torch'}; run it from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    device = phase_device()
    errors: dict = {}
    launches: dict = {}
    phase_build()
    phase_kernels(errors)
    phase_train(launches)
    phase_reference()
    rows = phase_times(errors, launches)
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
