#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``src/repro_torch`` and
drives the port end to end on four paths: the MuonBP baseline and the
optimizer variants NorMuon, Turbo-Muon and Dion.

  1. device   -- the card's name and power limit (nvidia-smi), device count;
  2. build    -- one nvcc per kernel source, in parallel; -Xptxas -v report;
  3. kernels  -- every kernel against its plain PyTorch version at the
                 shapes of the training steps (TF32 off), with tolerances:
                 the NS products (the symmetric Gram and polynomial exactly
                 symmetric; the Gram also against fp64) and chains (the
                 fused chain also against an fp64 chain), the fused chain
                 at Dion's polar shapes (K = 6) and Turbo-Muon's K = 3 on
                 spectrally pre-scaled stacks, and the NorMuon row norm at
                 every leaf shape in both modes;
  4. train    -- full-width muonbp-960m (12 layers, virtual 8-way
                 tensor-parallel block grid, batch 4 x seq 1024): six
                 MuonBP steps (full, block x4, full), six NorMuon steps and
                 six Turbo-Muon steps (the same phases; 9 NorMuon launches
                 a step) and two Dion steps. For each path: the
                 launch counts of every kernel, counted from zero just before
                 it and read just after, and the update from the kernels
                 against the one from the plain versions on the same
                 gradients and state; no launch of the path, tiled or
                 fused, packs an operand;
  5. reference -- six reduced steps on the card against the same steps on
                 the CPU (plain versions), from the same weights, for the
                 baseline and for NorMuon;
  6. times    -- each kernel, its plain version and the one-call PyTorch
                 counterpart (where one exists) timed with CUDA events, with
                 the least time the card could take for the same work; the
                 tiled Gram with its B operand K-major and N-major (the
                 transposed split) over the full grid; the tiled 5-step chain
                 beside the fused one at every block-phase bucket shape; the
                 whole NorMuon epilogue of a step.

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
TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
TC_PASSES = 3            # the tiled products' 3xTF32: hi*hi + hi*lo + lo*hi
HBM_BYTES_S = 3.35e12

# Main-path shapes at full-width muonbp-960m with an 8-way block grid
# (after the transpose to the small side).
MLP_FULL = (24, 1536, 6144)    # full phase, mlp wi/wg: tiled
QO_FULL = (24, 1536, 1536)     # full phase, attn wq/wo: tiled
MLP_BLOCK = (192, 768, 1536)   # block phase, mlp wi/wg blocks: fused chain
KV_BLOCK = (192, 48, 1536)     # block phase, attn wk/wv blocks: fused chain
# Every block-phase bucket (the norm gains aside): mlp wi/wg, mlp wo, wq/wo,
# wk/wv.
BLOCK_BUCKETS = (MLP_BLOCK, (96, 768, 1536), (96, 192, 1536), KV_BLOCK)
NS_STEPS = 5
# Dion's full-phase polar buckets on the small side (rank 64: 72 units of
# the 1536-row factors, 12 of the 6144-row ones), K = 6; Turbo-Muon's K.
DION_POLAR = ((72, 64, 1536), (12, 64, 6144))
DION_STEPS, TURBO_STEPS = 6, 3
# The NorMuon epilogue's launches, one a Muon leaf a step, as (B, m, n).
NORMUON_LEAVES = {
    "mlp/wi": (12, 1536, 6144), "mlp/wg": (12, 1536, 6144), "mlp/wo": (12, 6144, 1536),
    "attn/wq": (12, 1536, 1536), "attn/wo": (12, 1536, 1536),
    "attn/wk": (12, 1536, 384), "attn/wv": (12, 1536, 384),
    "norms/attn_norm": (1, 12, 1536), "norms/mlp_norm": (1, 12, 1536),
}
NORMUON_TIMED = (12, 6144, 1536)   # the largest launch, mlp/wo
BETA2, STAT_EPS = 0.95, 1e-8

# Tolerances, relative to max|plain|. Single products: the kernels' 3xTF32
# tensor-core sums (tiled and fused alike), in another order than cuBLAS's
# fp32 SGEMM (TF32 off), agree to a few 1e-6 of the largest value. The
# 5-step chains compound per-step rounding differences through a cubic
# polynomial, so they get one more decade.
PRODUCT_TOL = 1e-4
CHAIN_TOL = 1e-3
UPDATE_TOL = 1e-3      # Muon update: NS chains + the RMS-matched epilogue
SMALL_LOSS_TOL = 1e-3  # reduced run on the card vs the CPU, fp32 compute
NORM_TOL = 1e-5        # NorMuon row norm: only the row sum's order differs

TPU_KERNELS = {
    "ns_matmul": ("cuda", "src/repro_torch/kernels/csrc/ns_matmul.cu",
                  "src/repro/kernels/newton_schulz/newton_schulz.py:48"),
    "ns_fma_matmul": ("cuda", "src/repro_torch/kernels/csrc/ns_matmul.cu",
                      "src/repro/kernels/newton_schulz/newton_schulz.py:66"),
    "ns_fused_chain": ("cuda", "src/repro_torch/kernels/csrc/ns_fused.cu",
                       "src/repro/kernels/newton_schulz/fused.py:104"),
    "ns_fused_iter": ("cuda", "src/repro_torch/kernels/csrc/ns_fused.cu",
                      "src/repro/kernels/newton_schulz/fused.py:98"),
    "normuon": ("cuda", "src/repro_torch/kernels/csrc/normuon.cu",
                "src/repro/kernels/normuon.py:67"),
}
MAIN_PATH_KERNELS = ("ns_matmul", "ns_fma_matmul", "ns_fused_chain")

# The training paths: (label, extra launcher flags, steps, kernels that must
# launch, phases whose update is checked against the plain versions).
BASE_ARGV = ["--arch", "muonbp-960m", "--optimizer", "muonbp", "--period", "5",
             "--mesh-model", "8", "--batch", "4", "--seq", "1024"]
PATHS = (
    ("muonbp", [], 6, MAIN_PATH_KERNELS, ("block", "full")),
    ("normuon", ["--optimizer-variant", "normuon"], 6, MAIN_PATH_KERNELS + ("normuon",),
     ("block", "full")),
    ("turbo_muon", ["--optimizer-variant", "turbo_muon"], 6, MAIN_PATH_KERNELS,
     ("block", "full")),
    ("dion", ["--optimizer-variant", "dion"], 2, ("ns_fused_chain",), ("full",)),
)


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


def bound_ms(flops: float, nbytes: float, rate: float = FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def unit_inputs(shape, seed: int):
    """Frobenius-normalised random fp32 units on the card (NS inputs)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return x / torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True)


def spectral_inputs(shape, seed: int):
    """Random fp32 stacks on the card divided by their spectral-norm estimate
    with the variants' margin (Turbo-Muon's and Dion's NS inputs)."""
    import torch

    from repro_torch.core.muon import SPECTRAL_MARGIN
    from repro_torch.core.newton_schulz import spectral_norm_est

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return x / (spectral_norm_est(x) * SPECTRAL_MARGIN + 1e-7)


def normuon_inputs(shape, seed: int):
    """An update-like stack and positive row statistics on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    v = torch.rand((*shape[:-1], 1), generator=gen, device="cuda", dtype=torch.float32)
    return x / shape[-1] ** 0.5, v / shape[-1]


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
    from repro_torch.kernels import normuon
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

    # The three products of an NS step as ops.ns_iteration calls them: the
    # Gram and the polynomial from their upper tiles (symmetric=True, the
    # output exactly symmetric), each kernel and its plain version on the
    # same inputs.
    x = unit_inputs(MLP_FULL, 1)
    xt = x.transpose(-1, -2)
    gram = tiled.matmul(x, xt, symmetric=True)
    gram_ref = tiled.matmul_plain(x, xt)
    record("ns_matmul", f"gram {MLP_FULL}", gram, gram_ref, PRODUCT_TOL)
    # Both against an fp64 product: how much of the difference is whose.
    gram64 = torch.matmul(x.double(), xt.double())
    log(f"[kernels] gram {MLP_FULL} against fp64: kernel rel {rel_err(gram, gram64)[1]:.3e}, "
        f"cuBLAS fp32 rel {rel_err(gram_ref, gram64)[1]:.3e}")
    del gram_ref, gram64
    poly = tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True)
    record("ns_fma_matmul", "poly bA+cA^2", poly,
           tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c), PRODUCT_TOL)
    if not (torch.equal(gram, gram.mT) and torch.equal(poly, poly.mT)):
        fail("a symmetric product's output is not exactly symmetric")
    record("ns_fma_matmul", "update aX+PX", tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
           tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), PRODUCT_TOL)
    del x, xt, gram, poly

    for shape, seed in ((MLP_BLOCK, 2), (KV_BLOCK, 3)):
        xb = unit_inputs(shape, seed)
        ref = fused.ns_chain_plain(xb, PAPER_COEFFS, NS_STEPS)
        out = fused.ns_chain(xb, PAPER_COEFFS, NS_STEPS)
        record("ns_fused_chain", f"{shape} x{NS_STEPS} steps", out, ref, CHAIN_TOL)
        # Both against an fp64 chain: how much of the difference is whose.
        ref64 = fused.ns_chain_plain(xb.double(), PAPER_COEFFS, NS_STEPS)
        log(f"[kernels] fused chain {shape} against fp64: kernel rel {rel_err(out, ref64)[1]:.3e}, "
            f"cuBLAS fp32 chain rel {rel_err(ref, ref64)[1]:.3e}")
        del out, ref64
        if shape == MLP_BLOCK:
            y = xb
            for _ in range(NS_STEPS):
                y = fused.ns_iteration(y, PAPER_COEFFS)
            record("ns_fused_iter", f"{shape} {NS_STEPS} launches", y, ref, CHAIN_TOL)
        del xb, ref

    # The variants' chains: unnormalised, spectrally pre-scaled stacks.
    for shape, steps, seed in ((DION_POLAR[0], DION_STEPS, 7), (DION_POLAR[1], DION_STEPS, 8),
                               (MLP_BLOCK, TURBO_STEPS, 9)):
        xs = spectral_inputs(shape, seed)
        ref = fused.ns_chain_plain(xs, PAPER_COEFFS, steps)
        record("ns_fused_chain", f"{shape} x{steps} steps, spectral pre-scale",
               fused.ns_chain(xs, PAPER_COEFFS, steps), ref, CHAIN_TOL)
        del xs, ref

    corr = normuon.bias_correction(2, BETA2)
    for i, shape in enumerate(sorted(set(NORMUON_LEAVES.values()))):
        x, v = normuon_inputs(shape, 10 + i)
        for refresh in (True, False):
            kw = dict(beta2=BETA2, eps=STAT_EPS, refresh=refresh)
            y, v_new = normuon.neuron_norm(x, v, corr, **kw)
            y_ref, v_ref = normuon.neuron_norm_plain(x, v, corr, **kw)
            mode = "refresh" if refresh else "apply"
            record("normuon", f"{shape} {mode} y", y, y_ref, NORM_TOL)
            record("normuon", f"{shape} {mode} v", v_new, v_ref, NORM_TOL)
        del x, v, y, v_new, y_ref, v_ref

    g = unit_inputs(QO_FULL, 4)
    ref = orthogonalize_plain(g, steps=NS_STEPS)
    out = ops.orthogonalize(g, steps=NS_STEPS)
    err, rel = rel_err(out, ref)
    log(f"[kernels] tiled chain {QO_FULL} x{NS_STEPS} steps: max_abs_err {err:.3e} rel {rel:.3e} "
        f"(tol {CHAIN_TOL:g}) {'ok' if rel <= CHAIN_TOL else 'FAIL'}")
    if rel > CHAIN_TOL:
        fail("tiled NS chain disagrees with the plain chain")
    torch.cuda.synchronize()


def matrix_optimizer(label: str, block_specs, strategy):
    """The path's matrix optimizer as the launcher builds it, at constant LR;
    ``strategy="plain"`` runs the plain NS chain."""
    from repro_torch.core import build_variant, muon

    if label == "dion":
        return build_variant("dion", 0.02, rank=64, weight_decay=0.1, ns_strategy=strategy)
    return muon(0.02, 0.02, period=5, weight_decay=0.1, block_specs=block_specs,
                ns_strategy=strategy, variant=None if label == "muonbp" else label)


def check_update(label: str, run, phases, breakdown: dict) -> None:
    """The path's matrix update from the kernels against the plain versions.

    Both start from the run's final optimizer state and the same gradients;
    each update is timed (the second of two calls, host clock around a
    synchronised update), with the forward and backward beside them: where
    the step's time goes. For the plain update the NorMuon epilogue runs its
    plain version too.
    """
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import label_tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import normuon
    from repro_torch.training.train_step import loss_and_grads

    params, cfg = run.state.params, run.cfg
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
    breakdown["fwd_bwd_ms"] = fwd_bwd_ms
    log(f"[train:{label}] forward+backward (bf16 compute) {fwd_bwd_ms:.1f} ms")
    labels = label_tree(params)
    only_muon = lambda t: tree_lib.tree_map(lambda x, l: x if l == "muon" else None, t, labels)
    g_m, p_m = only_muon(grads), only_muon(params)
    state = run.state.opt_state.inner["muon"]
    del grads
    kernel_norm = normuon.neuron_norm
    for phase in phases:
        outs = {}
        for strategy in (None, "plain"):
            opt = matrix_optimizer(label, run.block_specs, strategy)
            if strategy == "plain":
                normuon.neuron_norm = normuon.neuron_norm_plain
            opt.update(g_m, state, p_m, phase)
            (upd, _), ms = timed(lambda: opt.update(g_m, state, p_m, phase))
            normuon.neuron_norm = kernel_norm
            outs[strategy] = tree_lib.flatten_with_path(upd)
            breakdown[f"update_{phase}_{'kernels' if strategy is None else 'plain'}_ms"] = ms
        err = max(float((u.double() - v.double()).abs().max())
                  for (_, u), (_, v) in zip(outs[None], outs["plain"]))
        scale = max(float(v.abs().max()) for _, v in outs["plain"])
        log(f"[train:{label}] update {phase}: kernels vs plain max_abs_err {err:.3e} "
            f"rel {err / scale:.3e} (tol {UPDATE_TOL:g}); "
            f"{breakdown[f'update_{phase}_kernels_ms']:.1f} ms with the kernels, "
            f"{breakdown[f'update_{phase}_plain_ms']:.1f} ms plain")
        if not err / scale <= UPDATE_TOL:
            fail(f"{label} {phase} update from the kernels disagrees with the plain update")
        breakdown[f"update_{phase}_rel_err"] = err / scale


def phase_train(launches: dict) -> None:
    """Drive each path of PATHS at full width and check it.

    ``launches`` gets the baseline's counts for the NS kernels and the
    NorMuon path's count for the NorMuon kernel.
    """
    import torch

    from repro_torch import kernels
    from repro_torch.core.muon import phase_for_step
    from repro_torch.launch import train

    for label, extra, steps, required, checked in PATHS:
        argv = BASE_ARGV + extra + ["--steps", str(steps)]
        log(f"[train:{label}] python -m repro_torch.launch.train {' '.join(argv)}")
        per_step = []
        last = {}

        def on_step(rec):
            counts = kernels.launch_counts()
            per_step.append((rec["phase"], {k: counts[k] - last.get(k, 0) for k in counts}))
            last.update(counts)
            log(f"[train:{label}] step {rec['step']} phase {rec['phase']} loss {rec['loss']:.4f} "
                f"wall {rec['wall_s']:.3f} s launches {per_step[-1][1]}")

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        run = train.run(argv, on_step=on_step)
        counts = kernels.launch_counts()
        log(f"[train:{label}] launches on the path: {counts}")
        log(f"[train:{label}] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        losses = [r["loss"] for r in run.records]
        phases = [r["phase"] for r in run.records]
        if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
            fail(f"{label}: non-finite loss: {losses}")
        period = 1 if label == "dion" else 5
        if phases != [phase_for_step(t, period) for t in range(steps)]:
            fail(f"{label}: unexpected phases {phases}")
        for name in required:
            if counts[name] <= 0:
                fail(f"{label}: kernel {name} never launched on its path")
        if kernels.packed_launches() != 0:
            fail(f"{label}: {kernels.packed_launches()} launches (tiled or fused chain) "
                 "packed an operand")
        if label == "normuon":
            norm_steps = [c["normuon"] for _, c in per_step]
            if norm_steps != [len(NORMUON_LEAVES)] * steps:
                fail(f"normuon launches per step {norm_steps}, expected {len(NORMUON_LEAVES)}")
            launches["normuon"] = counts["normuon"]
            launches["normuon_refresh"] = sum(c["normuon"] for p, c in per_step if p == "full")
            launches["normuon_apply"] = sum(c["normuon"] for p, c in per_step if p == "block")
        if label == "muonbp":
            launches.update({k: v for k, v in counts.items() if k != "normuon"})
        for phase in dict.fromkeys(phases):
            step_counts = next(c for p, c in per_step if p == phase)
            log(f"[train:{label}] launches per {phase} step: {step_counts}")
        if label == "muonbp":
            for p_, c_ in per_step:
                if p_ == "full" and (c_["ns_matmul"], c_["ns_fma_matmul"]) != (15, 30):
                    fail(f"muonbp full step launched {c_['ns_matmul']} Grams and "
                         f"{c_['ns_fma_matmul']} fma products, expected 15 and 30")
        breakdown = {"step_wall_s": [r["wall_s"] for r in run.records], "phases": phases}
        check_update(label, run, checked, breakdown)
        log(f"[train:{label}] breakdown {json.dumps(breakdown)}")
        del run
        torch.cuda.empty_cache()


def phase_reference() -> None:
    import torch

    from repro_torch import kernels
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

    nm_argv = argv + ["--optimizer-variant", "normuon"]
    cpu = train.run(nm_argv + ["--device", "cpu"], params=base).records
    kernels.reset_launch_counts()
    gpu = train.run(nm_argv + ["--device", "cuda"],
                    params=tree_lib.tree_map(lambda p: p.to("cuda"), base)).records
    diff = max(abs(g["loss"] - c["loss"]) for g, c in zip(gpu, cpu))
    log(f"[reference] reduced 6 NorMuon steps, card vs CPU plain: max |loss diff| {diff:.3e} "
        f"(tol {SMALL_LOSS_TOL:g}), {kernels.launch_counts()['normuon']} normuon launches")
    if not diff <= SMALL_LOSS_TOL or kernels.launch_counts()["normuon"] <= 0:
        fail("NorMuon card run does not track the CPU reference")
    torch.cuda.synchronize()


def phase_times(errors: dict, launches: dict) -> list:
    import torch

    from repro_torch.core.newton_schulz import PAPER_COEFFS
    from repro_torch.kernels import normuon
    from repro_torch.kernels.newton_schulz import fused, ops
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    a, b, c = PAPER_COEFFS
    rows = []

    def add(name, shape, fn, plain, library, flops, nbytes, iters, tc_flops=None, **extra):
        """``flops``: the least work, bound at the fp32 rate. A tensor-core
        row gives ``tc_flops``, its product's least work: it is bound at its
        own arithmetic, TC_PASSES TF32 products at TF32_FLOPS, and keeps the
        fp32-rate bound beside it as ``fp32_bound_ms``."""
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain, iters)
        lib_ms = cuda_ms(library, iters) if library is not None else None
        if tc_flops is not None:
            bms, kind = bound_ms(TC_PASSES * tc_flops, nbytes, TF32_FLOPS)
            extra["fp32_bound_ms"] = bound_ms(flops, nbytes)[0]
        else:
            bms, kind = bound_ms(flops, nbytes)
        route, source, replaces = TPU_KERNELS[name]
        row = {"name": name, "route": route, "source": source, "replaces": replaces,
               "launches": int(launches.get(name, 0)), "max_abs_err": errors.get(name),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": kind,
               "library_ms": lib_ms, "shape": shape, **extra}
        fp32_note = (f", fp32-rate bound {extra['fp32_bound_ms']:.3f} ms"
                     if "fp32_bound_ms" in extra else "")
        log(f"[times] {name} {shape}: {ms:.3f} ms (plain {plain_ms:.3f}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.3f}'}, bound {bms:.3f} ms by {kind}, "
            f"{bms / ms:.1%} of bound{fp32_note})")
        rows.append(row)

    # The three products of an NS step, as ops.ns_iteration calls them. The
    # Gram and the polynomial are symmetric: the least work is their
    # m(m+1)/2 distinct entries, n (resp. m) multiply-adds each, as
    # ns_step_flops counts it, and the kernel computes the upper tiles only.
    # Each product of an NS step launches once per Gram, so the polynomial
    # and the update each make ns_matmul's count of the fma launches.
    B, m, n = MLP_FULL
    x = unit_inputs(MLP_FULL, 5)
    xt = x.transpose(-1, -2)
    per_gram = int(launches.get("ns_matmul", 0))
    add("ns_matmul", f"gram {B}x{m}x{n}", lambda: tiled.matmul(x, xt, symmetric=True),
        lambda: tiled.matmul_plain(x, xt), lambda: torch.bmm(x, xt),
        B * m * (m + 1.0) * n, 4.0 * (B * m * n + B * m * m), 5,
        tc_flops=B * m * (m + 1.0) * n)
    gram = tiled.matmul(x, xt, symmetric=True)
    add("ns_fma_matmul", f"poly bA+cA^2 {B}x{m}x{m}",
        lambda: tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True),
        lambda: tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c),
        lambda: torch.baddbmm(gram, gram, gram, beta=b, alpha=c),
        B * m * m * (m + 1.0) + 2.0 * B * m * m, 4.0 * 2 * B * m * m, 10,
        tc_flops=B * m * m * (m + 1.0), launches_in_mode=per_gram)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True)
    add("ns_fma_matmul", f"update aX+PX {B}x{m}x{m}@{m}x{n}",
        lambda: tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
        lambda: tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0),
        lambda: torch.baddbmm(x, poly, x, beta=a, alpha=1.0),
        2.0 * B * m * m * n + 2.0 * B * m * n, 4.0 * (B * m * m + 2 * B * m * n), 5,
        tc_flops=2.0 * B * m * m * n, launches_in_mode=per_gram)
    # The transposed split's share: the same full-grid Gram with B read
    # K-major (X^T in place) and N-major (X^T packed row-major, so every
    # stage's B is transposed into the K-major layout by the consumers).
    xt_rows = xt.contiguous()
    ab = {}
    for turn in ("kmajor", "nmajor", "nmajor", "kmajor"):
        y = xt if turn == "kmajor" else xt_rows
        ab.setdefault(turn, []).append(cuda_ms(lambda: tiled.matmul(x, y), 5))
    log(f"[times] A/B full-grid Gram {B}x{m}x{n}, B operand K-major vs N-major (transposed "
        f"split), in turns: {json.dumps(ab)}")
    del x, xt, xt_rows, gram, poly
    torch.cuda.empty_cache()

    # The fused chain and iteration: three TF32 products of the least work
    # a step (the symmetric Gram and A^2 from their distinct entries), the
    # fp32-rate bound beside it.
    B, m, n = MLP_BLOCK
    xb = unit_inputs(MLP_BLOCK, 6)
    io = 4.0 * 2 * B * m * n
    add("ns_fused_chain", f"{B}x{m}x{n} x{NS_STEPS} steps",
        lambda: fused.ns_chain(xb, PAPER_COEFFS, NS_STEPS),
        lambda: fused.ns_chain_plain(xb, PAPER_COEFFS, NS_STEPS), None,
        NS_STEPS * ns_step_flops(B, m, n), io, 2, tc_flops=NS_STEPS * ns_step_flops(B, m, n))
    add("ns_fused_iter", f"{B}x{m}x{n} one step",
        lambda: fused.ns_iteration(xb, PAPER_COEFFS),
        lambda: fused.ns_chain_plain(xb, PAPER_COEFFS, 1), None,
        ns_step_flops(B, m, n), io, 3, tc_flops=ns_step_flops(B, m, n))
    del xb
    torch.cuda.empty_cache()
    # The dispatcher's gate sends every block-phase bucket to the fused
    # chain; the tiled path (3 product launches a step) beside it, in turns.
    gate = {}
    for shape in BLOCK_BUCKETS:
        xs = unit_inputs(shape, 7)
        fused_ms = cuda_ms(lambda: fused.ns_chain(xs, PAPER_COEFFS, NS_STEPS), 2)
        tiled_ms = cuda_ms(lambda: ops.orthogonalize(xs, steps=NS_STEPS, normalize=False), 2)
        fused_ms2 = cuda_ms(lambda: fused.ns_chain(xs, PAPER_COEFFS, NS_STEPS), 2)
        bound = bound_ms(TC_PASSES * NS_STEPS * ns_step_flops(*shape), 4.0 * 2 * xs.numel(),
                         TF32_FLOPS)[0]
        key = "x".join(map(str, shape))
        gate[key] = {"fused_ms": [fused_ms, fused_ms2], "tiled_ms": tiled_ms, "bound_ms": bound}
        log(f"[times] block-phase bucket {key} x{NS_STEPS} steps: fused chain {fused_ms:.3f} / "
            f"{fused_ms2:.3f} ms, tiled chain {tiled_ms:.3f} ms, 3xTF32 bound {bound:.3f} ms; "
            f"{'fused' if min(fused_ms, fused_ms2) < tiled_ms else 'tiled'} is faster")
        del xs
        torch.cuda.empty_cache()
    log(f"[times] fused vs tiled chain at the block-phase buckets: {json.dumps(gate)}")

    # NorMuon at its largest launch, in each mode. It reads x and writes y,
    # 8 bytes an element, plus v (read, and written on a refresh); it does
    # a multiply-add an element for the row sum and a division for y. No
    # one PyTorch call computes it.
    corr = normuon.bias_correction(2, BETA2)
    x, v = normuon_inputs(NORMUON_TIMED, 20)
    rows_n, elems = x.numel() // x.shape[-1], x.numel()
    for refresh in (True, False):
        kw = dict(beta2=BETA2, eps=STAT_EPS, refresh=refresh)
        mode = "refresh" if refresh else "apply"
        add("normuon", f"{'x'.join(map(str, NORMUON_TIMED))} {mode}",
            lambda: normuon.neuron_norm(x, v, corr, **kw),
            lambda: normuon.neuron_norm_plain(x, v, corr, **kw), None,
            (3.0 if refresh else 1.0) * elems, 8.0 * elems + (8.0 if refresh else 4.0) * rows_n,
            20, mode=mode, launches_in_mode=int(launches.get(f"normuon_{mode}", 0)))
    del x, v
    torch.cuda.empty_cache()

    # The whole NorMuon epilogue of a step: the kernel on every leaf, and
    # the kernel plus the plain rescale and casts around it.
    leaves = [normuon_inputs(shape, 30 + i) for i, shape in enumerate(NORMUON_LEAVES.values())]
    elems = sum(x.numel() for x, _ in leaves)
    rows_n = sum(v.numel() for _, v in leaves)
    epilogue = {}
    for refresh in (True, False):
        kw = dict(beta2=BETA2, eps=STAT_EPS, refresh=refresh)
        mode = "refresh" if refresh else "apply"
        epilogue[f"{mode}_kernels_ms"] = cuda_ms(
            lambda: [normuon.neuron_norm(x, v, corr, **kw) for x, v in leaves], 5)
        epilogue[f"{mode}_epilogue_ms"] = cuda_ms(
            lambda: [normuon.apply_neuron_norm(x, v, 1, **kw) for x, v in leaves], 5)
        epilogue[f"{mode}_bound_ms"] = bound_ms(
            0.0, 8.0 * elems + (8.0 if refresh else 4.0) * rows_n)[0]
    log(f"[times] NorMuon epilogue a step, {len(leaves)} leaves, {elems} elements: "
        f"{json.dumps(epilogue)}")
    del leaves
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
