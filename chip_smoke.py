#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``src/repro_torch`` and
drives the port end to end: the MuonBP baseline and the optimizer variants
NorMuon, Turbo-Muon and Dion on the dense model, MuonBP on the
Mixture-of-Experts model, and serving of both; MuonBP training and
generate on the SSM, hybrid, VLM and audio models; the tensor-parallel
dense and MoE models, the guarded step and the distributed optimizer on
four ranks that share the card.

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
  5. train_moe -- MuonBP on expert stacks: full-width olmoe-1b-7b (d 2048,
                 64 experts top-8 of d_ff 1024) cut to 4 of its 16 layers,
                 through the launcher (8-way block grid, batch 4 x seq 1024,
                 bf16, --obs-block): six steps (full, block x4, full), loss,
                 load_balance and z_loss each step, the launches and NS
                 buckets of each phase, the update from the kernels against
                 the plain versions in both phases, and each kernel against
                 its plain version, and timed, at the buckets the MoE path
                 adds (64 x 2048 router units, 128 x 2048 expert blocks,
                 1024 x 2048 expert units);
  6. resilience -- the hardened launcher at full width (MuonBP, bf16,
                 --guard --guard-warmup 2 --fault-plan
                 nan_grads@2,spike_loss@4x8 --obs-block, constant LR): run A,
                 nine guarded steps, whose skipped steps 2 and 4 launch no
                 NS kernel and leave every state leaf torch.equal, step 3
                 forced full, and whose bus counters match the kernels'
                 launch counts; the same step run twice from one state
                 (bitwise or not, reported), the guarded and unguarded step
                 walls, and the guarded against the unguarded update
                 (torch.equal, both phases); run B, seven steps and one ~8 GB
                 snapshot, and run C, resumed from it to step 9: the
                 restored state torch.equal to run B's, skipped = 2, the data
                 position, and steps 7-8 against run A's; the kill drill
                 (chaos_run with kill_mid_save and kill_in_save) on the
                 reduced model;
  7. reference -- six reduced steps on the card against the same steps on
                 the CPU (plain versions), from the same weights, for the
                 baseline and for NorMuon;
  8. serve    -- the serving path, which launches none of the kernels:
                 full-width gemma2-9b (42 layers, fp32 parameters from
                 init_params(seed=0), a bf16 paged KV pool) behind the
                 continuous-batching engine (4 slots, blocks of 16, a
                 4608-token window), six greedy requests of 4400, 4200,
                 2048, 512, 64 and 16 prompt tokens run to idle: every one
                 completes, every block comes back, and each one's tokens
                 equal the port's generate on its prompt alone (a token may
                 differ only at a near-tie: a top-2 logit gap under 1e-4 of
                 max|logit|); decode after a 4096-token prefill against
                 teacher forcing over 64 tokens (fp32 cache, 1e-3 of
                 max|logit|); corrupt_cache on a shorter run cancels exactly
                 its victim and leaves the co-batched tokens as without it;
                 the reduced model on the card against the CPU on one seeded
                 trace; serve_sim's kill_in_decode drill and its telemetry
                 trail. It prints the TTFT wall per prompt length (the
                 engine's admission of the request alone: prefill, the copy
                 into the pool, the first token on the host), the
                 serve_decode span percentiles, decode tokens/s at 4 active
                 slots (tokens over the summed wall of those steps) beside
                 the decode step's bound, the device's busy share over a
                 traced window, one decode step's eager wall against the
                 same step as one CUDA graph (host or device), the pool's
                 bytes and the peak memory;
  9. serve_moe -- full-depth olmoe-1b-7b in fp32 with the bf16 paged pool
                 behind the engine (4 slots, a 2176-token window), six
                 greedy requests of 2048, 1024, 512, 128, 64 and 16 prompt
                 tokens to idle: every one completes, every block comes back,
                 each one's tokens equal generate's on its prompt alone (the
                 engine routes each slot alone, as the reference's per-slot
                 step; the near-tie rule as above); decode after a
                 1024-token prefill against teacher forcing on the dropless
                 config; the reduced olmoe-1b-7b and mixtral-8x7b card
                 against CPU. It prints the TTFT wall per prompt length,
                 the serve_decode percentiles, decode tokens/s at 4 slots
                 beside the bound and the peak memory;
 10. train_ssm -- MuonBP on full-width mamba2-1.3b (d 2048, d_inner 4096,
                 64 SSM heads of 64, state 128) cut to 24 of its 48 layers,
                 through the launcher (8-way block grid, batch 4 x seq 1024,
                 bf16, --obs-block): six steps (full, block x4, full), the
                 loss, launches (packed ones counted) and NS buckets of each
                 step, the update from the kernels against the plain
                 versions in both phases, and each kernel against its plain
                 version, and timed with its bound, at the buckets the SSM
                 paths add (2048 x 8 wdt blocks, 24 x 8 per-head scalar
                 blocks, 2048 x 128 wb/wc units, 2048 x 512 wz/wx blocks,
                 hymba's packed 32 x 50 scalars, the 2048 x 4096 full-phase
                 units on the tiled products);
 11. serve_ssm -- full-depth mamba2-1.3b in fp32 through generate (batch 4,
                 a 2048-token prompt, 64 new tokens); the same steps timed
                 one by one and held to teacher forcing (1e-3 of
                 max|logit|); the prefill wall and the decode step's p50 /
                 p95 beside its bound (every fp32 parameter and the SSM
                 state once);
 12. archs    -- hymba-1.5b, internvl2-1b (256 vision tokens) and
                 whisper-small (1500 encoder frames) at full width: two
                 MuonBP steps each (full, block) with the update checked
                 against the plain one, generate of 16 tokens after a
                 1024-token prompt against teacher forcing, hymba also past
                 its 1024-token window on the ring cache against the dense
                 cache; the four reduced models on the card against the CPU;
 13. distributed -- four ranks share the card through gloo (NCCL refuses two
                 ranks on one GPU), through the launcher (the kernels built
                 once, here, before any rank starts), batch 2 x 1024 a rank,
                 bf16, the dense and MoE models tensor-parallel (each rank
                 holds and computes with its parameter shards): run A,
                 full-width muonbp-960m at all 12 layers on data=2,model=2
                 with ZeRO-1, six steps, after one fp32 step (TF32 off)
                 whose loss and gradients, joined on rank 0, are held
                 against the single-process port's; run B, NorMuon with the
                 flatten fallback at 3 layers, two steps; run C, 12 layers
                 on model=4, three steps; run D, mamba2-1.3b at 4 of 48
                 layers on the replicated path (every rank a whole replica)
                 on data=2,model=2 with ZeRO-1, two steps; run E,
                 olmoe-1b-7b at 2 of 16 layers tensor-parallel (the experts'
                 d_ff split) on data=2,model=2 with ZeRO-1, three steps,
                 after its fp32 step held against one process on each data
                 shard's rows, routing flips counted; run F, muonbp-960m at
                 3 layers guarded (NaN gradients at step 2, an 8x loss at
                 step 4), six steps: both skipped on every rank with every
                 state leaf torch.equal, no kernel launch and no optimizer
                 collective, step 3 forced full, each healthy step equal
                 to the unguarded mesh step bitwise. Every rank's loss each
                 step, its collective trace (the optimizer's against
                 plan_comm to the byte, no optimizer collective on block
                 steps; tp against tp_bytes, 0 B on run D; the gradient
                 reduce against its shards; the replica gather 0 B on the
                 tensor-parallel runs and the model-split updates' bytes on
                 run D; the guard's 4 B agreement a step on run F), the
                 summed wall of each class of collectives a step, its
                 launches, peak memory, momentum shards and spans; the
                 update on the run's state and fresh gradients against the
                 single-process update on rank 0, both phases (not on run
                 E), and pipelined against barrier (torch.equal). gloo
                 copies through the host: these times measure no link;
 14. times    -- each kernel, its plain version and the one-call PyTorch
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
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
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

# The serve phase: full-width gemma2-9b behind the engine. Prompts past 4096
# tokens make the even (local, window 4096) layers mask; six requests on
# four slots make two wait and take recycled slots.
SERVE_ARCH = "gemma2-9b"
SERVE_ENGINE = dict(slots=4, block_size=16, max_model_len=4608, num_blocks=1152,
                    max_prompt_len=4480, max_new_tokens=64)
SERVE_PROMPTS = (4400, 4200, 2048, 512, 64, 16)
SERVE_NEW = (64, 32)
# corrupt_cache: a shorter run at full width, with and without the fault.
CORRUPT_PROMPTS, CORRUPT_NEW, CORRUPT_PLAN = (600, 300, 100), (16,), "corrupt_cache@2"
TF_PREFIX, TF_STEPS = 4096, 64   # decode against teacher forcing
PROFILE_STEPS = (10, 14)         # engine steps under torch.profiler, every slot
                                 # active: the first sets the profiler up, the
                                 # rest are traced
# The reduced model, card against CPU: the same trace scaled to its window
# of 64 (prompts past it) and a 128-token engine window.
SMALL_ENGINE = dict(slots=4, block_size=16, max_model_len=128, num_blocks=32,
                    max_prompt_len=112, max_new_tokens=16)
SMALL_PROMPTS, SMALL_NEW = (100, 90, 40, 20, 8, 4), (16, 8)
SERVE_KILL_ARGV = ["--reduced", "--steps", "10", "--rate", "1", "--slots", "2",
                   "--block-size", "4", "--num-blocks", "32", "--max-model-len", "32",
                   "--max-prompt-len", "16", "--max-new-tokens", "8", "--prompt-lens", "8",
                   "--new-tokens", "8", "--seed", "0", "--fault-plan", "kill_in_decode@3"]

# The MoE paths: olmoe-1b-7b (16 layers, d 2048, 16/16 heads of 128, 64
# experts top-8 of d_ff 1024, vocab 50304, untied). Training runs 4 of its
# 16 layers at full width (the whole model's fp32 master, gradients and
# momentum would take ~94 GB); serving runs all 16 in fp32 (27.7 GB).
MOE_ARCH = "olmoe-1b-7b"
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_ARGV = ["--arch", MOE_ARCH, "--optimizer", "muonbp", "--period", "5",
                  "--mesh-model", "8", "--batch", "4", "--seq", "1024", "--obs-block",
                  "--steps", "6"]
# The NS buckets the MoE path adds, on the small side, at 4 layers and an
# 8-way grid: the router's 64 x 2048 units in both phases (fewer rows than
# the kernels' 128-row tile), the block phase's 128 x 2048 expert blocks
# (wi/wg: 2 x 4 x 64 x 8 of them) and the full phase's 1024 x 2048 expert
# units (wo: 4 x 64 of them; over the fused chain's 25 MB budget).
MOE_ROUTER = (4, 64, 2048)
MOE_EXPERT_BLOCK = (4096, 128, 2048)
MOE_EXPERT_FULL = (256, 1024, 2048)
MOE_SERVE_ENGINE = dict(slots=4, block_size=16, max_model_len=2176, num_blocks=512,
                        max_prompt_len=2112, max_new_tokens=64)
MOE_SERVE_PROMPTS = (2048, 1024, 512, 128, 64, 16)
MOE_SERVE_NEW = (64, 32)
MOE_TF_PREFIX, MOE_TF_STEPS = 1024, 32
MOE_SMALL_ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")

# The SSM, hybrid, VLM and audio paths. mamba2-1.3b (48 layers, d 2048,
# d_inner 4096, 64 SSM heads of 64, state 128, vocab 50280) trains at
# SSM_TRAIN_LAYERS of its 48 layers: without the reference's activation
# checkpointing its saved activations come to ~1.3 GB a layer at 4 x 1024.
# It serves at full depth in fp32 through generate.
SSM_ARCH = "mamba2-1.3b"
SSM_TRAIN_LAYERS = 24
SSM_TRAIN_ARGV = ["--arch", SSM_ARCH, "--optimizer", "muonbp", "--period", "5",
                  "--mesh-model", "8", "--batch", "4", "--seq", "1024", "--obs-block",
                  "--steps", "6"]
# The NS buckets the SSM path adds, on the small side (m <= n), at 24 layers
# and an 8-way grid: the block phase's wdt blocks (24 x 8 of 2048 x 8), the
# per-head scalar blocks (A_log, D, dt_bias: 3 x 8 of 24 x 8), wz/wx blocks
# (2 x 24 x 8 of 2048 x 512) and the whole wb/wc units (2 x 24 of
# 2048 x 128); the full phase's wz/wx/out_proj units (72 of 2048 x 4096, on
# the tiled products). hymba's whole (32, 50) per-head scalars have a
# 200-byte row stride and are packed for TMA.
SSM_FUSED_BUCKETS = {"wdt blocks": (192, 8, 2048), "per-head scalar blocks": (24, 8, 24),
                     "wb/wc units": (48, 128, 2048), "wz/wx blocks": (384, 512, 2048),
                     "hymba per-head scalars, packed": (3, 32, 50)}
SSM_TILED = (72, 2048, 4096)
SSM_SERVE_BATCH, SSM_SERVE_PROMPT, SSM_SERVE_NEW = 4, 2048, 64
# hymba-1.5b, internvl2-1b and whisper-small at full width and depth: two
# MuonBP steps (full, block) at batch 2 x 1024, then greedy generate after a
# 1024-token prompt (internvl2: behind its 256 vision tokens; whisper: over
# 1500 encoded frames), checked against teacher forcing; hymba also decodes
# past its 1024-token window on the ring cache against the dense cache.
ARCHS_TRAINED = ("hymba-1.5b", "internvl2-1b", "whisper-small")
ARCHS_ARGV = ["--optimizer", "muonbp", "--period", "5", "--mesh-model", "8", "--batch", "2",
              "--seq", "1024", "--obs-block", "--steps", "2"]
ARCHS_PROMPT, ARCHS_NEW = 1024, 16
NEW_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "internvl2-1b", "whisper-small")

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
# Serving, relative to max|logit|: greedy tokens of two runs may part only
# where the first differing token's top-2 logit gap is under TIE_REL (a
# near-tie, which rounding in another order may flip); decode from an fp32
# cache against the full forward agrees to DECODE_TOL (the full softmax over
# the window sums in another order than the prefill's).
TIE_REL = 1e-4
DECODE_TOL = 1e-3

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
             "--mesh-model", "8", "--batch", "4", "--seq", "1024", "--obs-block"]
PATHS = (
    ("muonbp", [], 6, MAIN_PATH_KERNELS, ("block", "full")),
    ("normuon", ["--optimizer-variant", "normuon"], 6, MAIN_PATH_KERNELS + ("normuon",),
     ("block", "full")),
    ("turbo_muon", ["--optimizer-variant", "turbo_muon"], 6, MAIN_PATH_KERNELS,
     ("block", "full")),
    ("dion", ["--optimizer-variant", "dion"], 2, ("ns_fused_chain",), ("full",)),
)

# The resilience phase: the guarded launcher at full width, MuonBP, under the
# fault plan below, at a constant LR so that runs of 7 and 9 steps share
# their first 7. Steps 2 (NaN gradients) and 4 (the spike) are skipped, the
# escalator forces step 3 to 'full'.
RES_ARGV = BASE_ARGV + ["--schedule", "const", "--log-every", "1", "--guard",
                        "--guard-warmup", "2", "--fault-plan", "nan_grads@2,spike_loss@4x8"]
RES_SKIPPED = (2, 4)
RES_PHASES = ["full", "block", "block", "full", "block", "full", "block", "block", "block"]
# Launches of a healthy MuonBP step at full width: (Grams, fma products,
# fused chains) a full step, fused chains a block step.
FULL_STEP_LAUNCHES, BLOCK_STEP_CHAINS = (15, 30, 2), 6
# Resumed steps against the uninterrupted run's when the card does not
# repeat a step bitwise: |loss difference| in bf16 compute.
RESUME_LOSS_TOL = 1e-3
# The kill drill: the reduced model, a snapshot every 2 steps; the kill
# fires at the step-4 save, so every relaunch must resume at step 3.
CHAOS_ARGV = ["--arch", "muonbp-960m", "--reduced", "--steps", "6", "--batch", "2", "--seq",
              "64", "--period", "3", "--mesh-model", "4", "--guard", "--checkpoint-every", "2",
              "--keep-checkpoints", "2", "--log-every", "1"]


# The distributed phase: DIST_RANKS ranks share the one card through gloo
# (NCCL refuses two ranks on one GPU), through the launcher, batch 2 x 1024 a
# rank, bf16. The dense and MoE models run tensor-parallel: each rank holds
# and computes with its param_specs shards, sequence-sharded between layers.
# Run A: full-width muonbp-960m at all 12 layers on data=2,model=2 with
# ZeRO-1, six steps. Run B: NorMuon with the flatten fallback at 3 of 12
# layers (3 does not divide 2: padded lead, padded row statistics), two
# steps. Run C: 12 layers on model=4 (the 4 KV heads split 4 ways), three
# steps. Run D keeps the replicated path on the card: full-width
# mamba2-1.3b (the SSM runs replicated, every rank a whole replica) on
# data=2,model=2 with ZeRO-1, two steps, its replica gather held to the
# bytes of the model-split updates. Run E: full-width olmoe-1b-7b
# tensor-parallel (each rank the (E, D, F/2) expert shards) on
# data=2,model=2 with ZeRO-1, three steps (full, block, full). Run F: the
# guarded step on the mesh, muonbp-960m at 3 layers, --guard with NaN
# gradients at step 2 and a loss spike at step 4, six steps. Before run A's
# and run E's ranks train, one fp32 step (TF32 off) on the run's first
# global batch and weights: the loss and every gradient joined on rank 0
# against the single-process port's, computed in this process first (for
# MoE on each data shard's rows and averaged, as the mesh routes each data
# shard alone), and on run E each layer's routing against it.
DIST_RANKS = 4
DIST_ARGV = ["--optimizer", "muonbp", "--period", "5", "--seq", "1024", "--dist-backend",
             "gloo", "--obs-block", "--log-every", "1"]
DIST_SEQ, DIST_SEED = 1024, 0
# Run D's depth: four whole replicas of mamba2-1.3b share the card (a layer
# holds 25.8 M parameters, the embedding and head 206.6 M). At 4 of 48
# layers a rank peaks at 7.88 GiB (NVIDIA H100 80GB HBM3, 700.00 W).
DIST_D_LAYERS = 4
# Run E's depth: olmoe-1b-7b's layer holds 419.6 M parameters, its
# embedding and head 206.6 M; each rank builds them whole in fp32 (1.68 GB a
# layer, 0.83 GB) before it keeps its half. At 2 of 16 layers a rank peaks
# at 16.20 GiB (NVIDIA H100 80GB HBM3, 700.00 W), the first full step's
# 14.25 GiB plus 1.95 at the second; four ranks at 3 layers would need an
# estimated 70-88 GB of the card's 80.
DIST_E_LAYERS = 2
DIST_F_LAYERS = 3
# Run F's faults and the steps they hit: NaN gradients at step 2 and an 8x
# loss at step 4 (past the 2-step warmup) are skipped on every rank; the
# escalation ladder forces step 3 to 'full'.
DIST_F_FLAGS = ["--zero1", "--guard", "--guard-warmup", "2", "--fault-plan",
                "nan_grads@2,spike_loss@4x8"]
DIST_F_PHASES = ["full", "block", "block", "full", "block", "full"]
DIST_F_SKIPPED = (2, 4)
# The classes of collectives a skipped step may issue: no optimizer phase.
DIST_SKIP_CLASSES = {"grad_reduce", "norm", "tp", "guard"}
# (label, arch, mesh, global batch, extra flags, steps, layers (None: all),
# tensor-parallel, kernels that must launch)
DIST_RUNS = (
    ("A", "muonbp-960m", "data=2,model=2", 4, ["--zero1"], 6, None, True, MAIN_PATH_KERNELS),
    ("B", "muonbp-960m", "data=2,model=2", 4, ["--zero1", "--optimizer-variant", "normuon",
                                               "--zero1-flatten"], 2, 3, True,
     MAIN_PATH_KERNELS + ("normuon",)),
    ("C", "muonbp-960m", "model=4", 2, [], 3, None, True, MAIN_PATH_KERNELS),
    ("D", "mamba2-1.3b", "data=2,model=2", 4, ["--zero1"], 2, DIST_D_LAYERS, False,
     MAIN_PATH_KERNELS),
    ("E", MOE_ARCH, "data=2,model=2", 4, ["--zero1", "--period", "2"], 3, DIST_E_LAYERS, True,
     MAIN_PATH_KERNELS),
    ("F", "muonbp-960m", "data=2,model=2", 4, DIST_F_FLAGS, 6, DIST_F_LAYERS, True,
     MAIN_PATH_KERNELS),
)
# The runs whose first global batch is held in fp32 against one process.
DIST_FP32_RUNS = ("A", "E")
# Run E's update is not joined on rank 0 against one process: its whole
# gradients, parameters and optimizer state (~15 GB at 3 layers) do not fit
# beside the four ranks' runs. tests/test_torch_moe_tensor_parallel.py
# holds the MoE updates on the mesh against the reference.
DIST_NO_UPDATE_CHECK = ("E",)
# The runs whose Muon stacks all split four ways (model and ZeRO-1's data
# axis, or model=4); the others hold what their specs give (E's router is
# not split over model, F's 3 layers do not divide the data axis).
DIST_QUARTER_STACKS = ("A", "B", "C")
DIST_LOSS_TOL = 1e-5   # the fp32 step on the mesh vs one process, relative
DIST_GRAD_TOL = 1e-4   # its gradients, max abs over the leaf's max|grad|


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


def check_update(label: str, run, phases, breakdown: dict, tag: str = "",
                 profile: bool = False, batch_shape=(4, 1024)) -> None:
    """The path's matrix update from the kernels against the plain versions.

    Both start from the run's final optimizer state and the same gradients;
    each update is timed (the second of two calls, host clock around a
    synchronised update), with the forward and backward beside them: where
    the step's time goes. For the plain update the NorMuon epilogue runs its
    plain version too. ``profile``: one more update with the kernels under
    torch.profiler, its device time by kernel.
    """
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.core import label_tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import normuon
    from repro_torch.launch.train import device_batch
    from repro_torch.training.train_step import loss_and_grads

    tag = tag or f"train:{label}"
    params, cfg = run.state.params, run.cfg
    batch = device_batch(next(iter(SyntheticLM(cfg, *batch_shape, seed=1))), "cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    loss_and_grads(params, batch, cfg)
    (_, _, grads), fwd_bwd_ms = timed(lambda: loss_and_grads(params, batch, cfg))
    breakdown["fwd_bwd_ms"] = fwd_bwd_ms
    log(f"[{tag}] forward+backward (bf16 compute) {fwd_bwd_ms:.1f} ms")
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
            (upd, new_state), ms = timed(lambda: opt.update(g_m, state, p_m, phase))
            normuon.neuron_norm = kernel_norm
            if profile and strategy is None:
                del upd, new_state
                profile_update(tag, phase, lambda: opt.update(g_m, state, p_m, phase))
                (upd, new_state), _ = timed(lambda: opt.update(g_m, state, p_m, phase))
            # The kernels' update waits on the host while the plain one runs:
            # at full-width MoE the card holds one update tree and its
            # transients beside the state, not two.
            outs[strategy] = [(k, v.cpu() if strategy is None else v)
                              for k, v in tree_lib.flatten_with_path(upd)]
            del upd, new_state
            torch.cuda.empty_cache()
            breakdown[f"update_{phase}_{'kernels' if strategy is None else 'plain'}_ms"] = ms
        err = max(float((u.to(v.device).double() - v.double()).abs().max())
                  for (_, u), (_, v) in zip(outs[None], outs["plain"]))
        scale = max(float(v.abs().max()) for _, v in outs["plain"])
        log(f"[{tag}] update {phase}: kernels vs plain max_abs_err {err:.3e} "
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
                f"wall {rec['dur_s']:.3f} s launches {per_step[-1][1]}")

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
        breakdown = {"step_wall_s": [r["dur_s"] for r in run.records], "phases": phases}
        check_update(label, run, checked, breakdown)
        log(f"[train:{label}] breakdown {json.dumps(breakdown)}")
        del run
        torch.cuda.empty_cache()


def phase_train_moe(smi: str, errors: dict) -> None:
    """MuonBP on the expert stacks: six steps of full-width olmoe-1b-7b cut
    to MOE_TRAIN_LAYERS layers, through the launcher with the 8-way grid;
    launch and bucket counts a step, the update from the kernels against the
    plain versions in both phases, and the kernels at the new bucket shapes."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.core.muon import phase_for_step
    from repro_torch.launch import train
    from repro_torch.obs import get_bus

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)
    log(f"[train_moe] python -m repro_torch.launch.train {' '.join(MOE_TRAIN_ARGV)}, "
        f"cfg=dataclasses.replace(get_config({MOE_ARCH!r}), num_layers={MOE_TRAIN_LAYERS})")
    per_step, last = [], {}

    def on_step(rec):
        counts = dict(kernels.launch_counts())
        counts.update({k: v for k, v in get_bus().counters.items() if k.startswith("ns_launch.")})
        step = {k: v - last.get(k, 0) for k, v in counts.items()}
        last.update(counts)
        per_step.append((rec["phase"], step))
        buckets = {k.rsplit(".", 1)[1]: v for k, v in step.items() if k.startswith("ns_launch.")}
        launches = {k: v for k, v in step.items() if not k.startswith("ns_launch.")}
        log(f"[train_moe] step {rec['step']} phase {rec['phase']} loss {rec['loss']:.4f} "
            f"load_balance {rec['load_balance']:.5f} z_loss {rec['z_loss']:.4f} "
            f"wall {rec['dur_s']:.3f} s (--obs-block) launches {launches} buckets {buckets}")

    kernels.reset_launch_counts()
    run = train.run(MOE_TRAIN_ARGV, cfg=cfg, on_step=on_step)
    counts = kernels.launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree_lib.leaves(run.state.params))
    log(f"[train_moe] {n_params} parameters; launches on the path: {counts}, "
        f"{kernels.packed_launches()} of them packed an operand; peak memory "
        f"{train_peak / 2**30:.2f} GiB")
    records = run.records
    phases = [r["phase"] for r in records]
    if phases != [phase_for_step(t, 5) for t in range(len(records))]:
        fail(f"train_moe: unexpected phases {phases}")
    for r in records:
        values = (r["loss"], r["load_balance"], r["z_loss"])
        if not all(v == v and abs(v) != float("inf") for v in values):
            fail(f"train_moe: non-finite metrics at step {r['step']}: {values}")
    for name in MAIN_PATH_KERNELS:
        if counts[name] <= 0:
            fail(f"train_moe: kernel {name} never launched on its path")
    for phase in ("block", "full"):
        step = next(c for p, c in per_step if p == phase)
        log(f"[train_moe] a {phase} step: launches "
            f"{ {k: v for k, v in step.items() if not k.startswith('ns_launch.')} }, "
            f"NS buckets {sum(v for k, v in step.items() if k.startswith('ns_launch.'))}")
    walls = {p: [r["dur_s"] for r in records[1:] if r["phase"] == p] for p in ("block", "full")}
    breakdown = {"step_wall_s": [r["dur_s"] for r in records], "phases": phases,
                 "steady_step_wall_s": walls}
    check_update("muonbp", run, ("block", "full"), breakdown, tag="train_moe", profile=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"[train_moe] breakdown {json.dumps(breakdown)}")
    del run
    torch.cuda.empty_cache()
    moe_buckets(errors)
    log(f"[train_moe] card: {smi}; peak memory {peak / 2**30:.2f} GiB (the six steps "
        f"{train_peak / 2**30:.2f} GiB); phase {time.perf_counter() - t_phase:.1f} s")


def moe_buckets(errors: dict) -> None:
    """Each NS kernel against its plain version at the bucket shapes the MoE
    path adds, and its time beside the plain version's and the bound."""
    import torch

    from repro_torch.core.newton_schulz import PAPER_COEFFS
    from repro_torch.kernels.newton_schulz import fused, ops
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    a, b, c = PAPER_COEFFS
    times = {}

    def check(name, label, out, ref, tol):
        """``name``: the kernel whose error this is; None for a chain of both
        tiled products."""
        err, rel = rel_err(out, ref)
        log(f"[train_moe] {name or 'tiled chain'} {label}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {tol:g}) {'ok' if rel <= tol else 'FAIL'}")
        if name is not None:
            errors[name] = max(errors.get(name, 0.0), err)
        if not rel <= tol:
            fail(f"{name or 'tiled chain'} {label} disagrees with its plain version")

    def timed(label, fn, plain, flops, nbytes, iters):
        ms, plain_ms = cuda_ms(fn, iters), cuda_ms(plain, iters)
        bms, kind = bound_ms(TC_PASSES * flops, nbytes, TF32_FLOPS)
        times[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": kind}
        log(f"[train_moe] time {label}: {ms:.3f} ms (plain {plain_ms:.3f}, 3xTF32 bound "
            f"{bms:.3f} ms by {kind}, {bms / ms:.1%} of bound)")

    for shape, seed in ((MOE_ROUTER, 40), (MOE_EXPERT_BLOCK, 41)):
        x = unit_inputs(shape, seed)
        label = "x".join(map(str, shape))
        check("ns_fused_chain", f"{label} x{NS_STEPS} steps", fused.ns_chain(x, PAPER_COEFFS, NS_STEPS),
              fused.ns_chain_plain(x, PAPER_COEFFS, NS_STEPS), CHAIN_TOL)
        timed(f"ns_fused_chain {label} x{NS_STEPS}",
              lambda: fused.ns_chain(x, PAPER_COEFFS, NS_STEPS),
              lambda: fused.ns_chain_plain(x, PAPER_COEFFS, NS_STEPS),
              NS_STEPS * ns_step_flops(*shape), 4.0 * 2 * x.numel(), 2)
        # The gate sends these buckets to the fused chain; the tiled chain
        # (three product launches a step) beside it.
        times[f"tiled chain {label} x{NS_STEPS}"] = {"ms": cuda_ms(
            lambda: ops.orthogonalize(x, steps=NS_STEPS, normalize=False), 2)}
        log(f"[train_moe] time tiled chain {label} x{NS_STEPS}: "
            f"{times[f'tiled chain {label} x{NS_STEPS}']['ms']:.3f} ms")
        del x
        torch.cuda.empty_cache()

    B, m, n = MOE_EXPERT_FULL
    x = unit_inputs(MOE_EXPERT_FULL, 42)
    xt = x.transpose(-1, -2)
    label = f"{B}x{m}x{n}"
    gram = tiled.matmul(x, xt, symmetric=True)
    check("ns_matmul", f"gram {label}", gram, tiled.matmul_plain(x, xt), PRODUCT_TOL)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True)
    check("ns_fma_matmul", f"poly bA+cA^2 {B}x{m}x{m}", poly,
          tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c), PRODUCT_TOL)
    check("ns_fma_matmul", f"update aX+PX {label}", tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
          tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), PRODUCT_TOL)
    check(None, f"{label} x{NS_STEPS} steps",
          ops.orthogonalize(x, steps=NS_STEPS, normalize=False),
          fused.ns_chain_plain(x, PAPER_COEFFS, NS_STEPS), CHAIN_TOL)
    timed(f"ns_matmul gram {label}", lambda: tiled.matmul(x, xt, symmetric=True),
          lambda: tiled.matmul_plain(x, xt), B * m * (m + 1.0) * n,
          4.0 * (B * m * n + B * m * m), 3)
    timed(f"ns_fma_matmul poly {B}x{m}x{m}",
          lambda: tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True),
          lambda: tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c),
          B * m * m * (m + 1.0), 4.0 * 2 * B * m * m, 3)
    timed(f"ns_fma_matmul update {label}", lambda: tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
          lambda: tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), 2.0 * B * m * m * n,
          4.0 * (B * m * m + 2 * B * m * n), 3)
    del x, xt, gram, poly
    torch.cuda.empty_cache()
    log(f"[train_moe] times at the MoE bucket shapes: {json.dumps(times)}")


def state_leaves(tree) -> list:
    """Every tensor and host counter of a state tree, in a fixed order."""
    if isinstance(tree, tuple):
        return [x for v in tree for x in state_leaves(v)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in state_leaves(tree[k])]
    return [] if tree is None else [tree]


def states_equal(a, b) -> bool:
    import torch

    la, lb = state_leaves(a), state_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def clone_state(tree):
    import torch

    if isinstance(tree, tuple):
        items = [clone_state(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def span_seconds(log_file: str, name: str) -> float:
    from repro_torch.obs.bus import read_jsonl

    durs = [r["dur_s"] for r in read_jsonl(log_file)
            if r.get("event") == "span" and r.get("name") == name]
    if len(durs) != 1:
        fail(f"{log_file}: {len(durs)} '{name}' spans, expected 1")
    return durs[0]


def phase_resilience(smi: str) -> None:
    """The guarded launcher, snapshots, resume and the kill drill (see the
    module docstring); every snapshot lives in a temporary directory that is
    removed at the end."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        walls = resilience_runs(tmp)
        kill_drill(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[resilience] card: {smi}")
    for line in walls:
        log(f"[resilience] {line}")
    log(f"[resilience] phase {time.perf_counter() - t_phase:.1f} s")


def resilience_runs(tmp: str) -> list:
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core.combine import apply_updates
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.obs.bus import read_jsonl
    from repro_torch.training import checkpoint, resilience
    from repro_torch.training.train_step import loss_and_grads, train_step

    # Run A: nine guarded steps.
    saved, batches_a = {}, {}

    def before_a(step, state, batch):
        if step - 1 in RES_SKIPPED:
            if not states_equal(saved.pop(step - 1), (state.params, state.opt_state)):
                fail(f"skipped step {step - 1} changed the params or the optimizer state")
            log(f"[resilience] run A: skipped step {step - 1} left every state leaf torch.equal")
        if step in RES_SKIPPED:
            saved[step] = clone_state((state.params, state.opt_state))
        if step in (7, 8):
            batches_a[step] = {k: v.clone() for k, v in batch.items()}

    log_a = os.path.join(tmp, "run_a.jsonl")
    log(f"[resilience] run A: python -m repro_torch.launch.train {' '.join(RES_ARGV)} --steps 9")
    kernels.reset_launch_counts()
    run_a = train.run(RES_ARGV + ["--steps", "9", "--log-file", log_a], before_step=before_a)
    counts = kernels.launch_counts()
    recs = run_a.records
    for r in recs:
        log(f"[resilience] run A step {r['step']} {r['phase']} loss {r['loss']:.4f} "
            f"healthy {r['healthy']} skipped {r['skipped']} {r['escalation']} "
            f"wall {r['dur_s']:.3f} s")
    if ([r["phase"] for r in recs] != RES_PHASES or saved
            or [r["healthy"] for r in recs] != [int(t not in RES_SKIPPED) for t in range(9)]
            or recs[-1]["skipped"] != 2):
        fail("run A did not skip steps 2 and 4 and force step 3 to 'full'")
    n_full = sum(1 for r in recs if r["healthy"] and r["phase"] == "full")
    n_block = sum(1 for r in recs if r["healthy"] and r["phase"] == "block")
    want = {"ns_matmul": FULL_STEP_LAUNCHES[0] * n_full,
            "ns_fma_matmul": FULL_STEP_LAUNCHES[1] * n_full,
            "ns_fused_chain": FULL_STEP_LAUNCHES[2] * n_full + BLOCK_STEP_CHAINS * n_block}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"run A launched {counts}, expected {want}: a skipped step ran NS work")
    # The bus counts NS dispatches: one a fused chain, one a tiled chain of
    # NS_STEPS Grams and 2 NS_STEPS fma products.
    ns = {k: v for k, v in run_a.counters.items() if k.startswith("ns_launch.")}
    want_ns = {"ns_launch.cuda.tiled": counts["ns_matmul"] // NS_STEPS,
               "ns_launch.cuda.fused_chain": counts["ns_fused_chain"]}
    if ns != want_ns or counts["ns_fma_matmul"] != 2 * counts["ns_matmul"]:
        fail(f"bus counters {ns} do not match the kernels' launch counts {counts}")
    ends = [r for r in read_jsonl(log_a) if r.get("event") == "run_end"]
    if len(ends) != 1 or ends[0]["counters"] != run_a.counters or ends[0]["status"] != "ok":
        fail(f"run A's run_end record does not carry its counters: {ends}")
    log(f"[resilience] run A: launches {counts}, bus counters {run_a.counters}")

    # One state, one batch: the step twice (is the card's step repeatable?),
    # guarded and unguarded step walls in turns, and the guarded against the
    # unguarded update on the same gradients.
    base, cfg = run_a.state, run_a.cfg
    opt, _ = train.build_optimizer("muonbp", base.params, lr=0.02, adam_lr=0.008, period=5,
                                   block_specs=run_a.block_specs)
    gcfg = resilience.GuardConfig(warmup_steps=2)
    batch = next(iter(SyntheticLM(cfg, 4, 1024, seed=1)))
    batch = {k: torch.from_numpy(v).to(device="cuda", dtype=torch.long) for k, v in batch.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    deterministic, walls = True, []
    for phase in ("block", "full"):
        kw = dict(cfg=cfg, optimizer=opt, phase=phase)
        (u1, m1), t_u1 = timed(lambda: train_step(base, batch, **kw))
        mg, t_g1 = timed(lambda: train_step(base, batch, guard=gcfg, **kw)[1])
        _, t_g2 = timed(lambda: train_step(base, batch, guard=gcfg, **kw)[1])
        (u2, m2), t_u2 = timed(lambda: train_step(base, batch, **kw))
        if int(mg["healthy"]) != 1:
            fail(f"the guarded {phase} step from run A's state was not healthy")
        same = (states_equal((u1.params, u1.opt_state), (u2.params, u2.opt_state))
                and torch.equal(m1["loss"], m2["loss"]))
        deterministic = deterministic and same
        log(f"[resilience] the same full-width {phase} step twice from one state: "
            f"{'bitwise equal' if same else 'NOT bitwise equal'}")
        walls.append(f"{phase} step wall: unguarded {t_u1:.4f} / {t_u2:.4f} s, "
                     f"guarded {t_g1:.4f} / {t_g2:.4f} s (in turns u, g, g, u)")
        del u1, u2
        torch.cuda.empty_cache()
    loss, _, grads = loss_and_grads(base.params, batch, cfg)
    with torch.no_grad():
        gsq = sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_lib.leaves(grads))
        for phase in ("block", "full"):
            upd, o_u = opt.update(grads, base.opt_state, base.params, phase)
            p_u = apply_updates(base.params, upd)
            del upd
            p_g, o_g, _, healthy = resilience.guarded_update(
                opt, gcfg, grads, base.opt_state, base.params,
                resilience.init_guard_state("cuda"), loss, gsq, phase)
            if not bool(healthy) or not states_equal((p_u, o_u), (p_g, o_g)):
                fail(f"the guarded {phase} update is not torch.equal to the unguarded one")
            log(f"[resilience] guarded and unguarded {phase} update: torch.equal on every leaf")
            del p_u, o_u, p_g, o_g
    del grads
    torch.cuda.empty_cache()

    # Run B: seven steps, one snapshot (its last step); run C resumes it.
    ckpt = os.path.join(tmp, "ckpt")
    need = sum(t.numel() * t.element_size() for t in state_leaves((base.params, base.opt_state))
               if isinstance(t, torch.Tensor))
    free = shutil.disk_usage(tmp).free
    if free < 1.25 * need:
        fail(f"{tmp}: {free / 1e9:.2f} GB free on disk, a snapshot takes {need / 1e9:.2f} GB")
    log_b, log_c = os.path.join(tmp, "run_b.jsonl"), os.path.join(tmp, "run_c.jsonl")
    run_b = train.run(RES_ARGV + ["--steps", "7", "--checkpoint-every", "1000", "--checkpoint-dir",
                                  ckpt, "--keep-checkpoints", "1", "--log-file", log_b])
    snaps = checkpoint.list_snapshots(ckpt)
    if [s for s, _ in snaps] != [6]:
        fail(f"run B left snapshots {snaps}, expected one at step 6")
    snap_files = sorted(os.listdir(snaps[0][1]))
    snap_bytes = sum(os.path.getsize(os.path.join(snaps[0][1], f)) for f in snap_files)
    b_state = (run_b.state.params, run_b.state.opt_state)
    b_guard = resilience.guard_to_meta(run_b.state.guard)
    del run_b
    checked = []

    def before_c(step, state, batch_c):
        if step == 7:
            checked.append(
                state.step == 7 and states_equal((state.params, state.opt_state), b_state)
                and resilience.guard_to_meta(state.guard) == b_guard and b_guard["skipped"] == 2
                and all(torch.equal(batch_c[k], batches_a[7][k]) for k in batch_c))

    run_c = train.run(RES_ARGV + ["--steps", "9", "--resume", "--checkpoint-dir", ckpt,
                                  "--log-file", log_c], before_step=before_c)
    if checked != [True]:
        fail("run C did not restore run B's state, guard counters and data position at step 7")
    log("[resilience] run C: resumed at step 7, state torch.equal to run B's, skipped = 2, "
        "the step-7 batch equal to run A's")
    del b_state
    c_losses = [r["loss"] for r in run_c.records]
    a_losses = [r["loss"] for r in recs[7:]]
    if [r["step"] for r in run_c.records] != [7, 8]:
        fail(f"run C ran steps {[r['step'] for r in run_c.records]}, expected 7 and 8")
    if deterministic:
        if c_losses != a_losses or not states_equal(
                (run_c.state.params, run_c.state.opt_state), (base.params, base.opt_state)):
            fail("resumed steps 7-8 are not bitwise equal to run A's")
        log("[resilience] run C steps 7-8: losses and final state bitwise equal to run A's")
    else:
        diff = max(abs(c - a) for c, a in zip(c_losses, a_losses))
        if diff > RESUME_LOSS_TOL:
            fail(f"resumed steps 7-8 differ from run A's by {diff:.3e} in the loss")
        log(f"[resilience] run C steps 7-8: max |loss diff| {diff:.3e} against run A "
            f"(tol {RESUME_LOSS_TOL:g}; the card's step is not bitwise repeatable)")
    save_s = span_seconds(log_b, "checkpoint.save")
    verify_s = span_seconds(log_c, "checkpoint.verify")
    restore_s = span_seconds(log_c, "checkpoint.restore")
    guarded = {p: [r["dur_s"] for r in recs[1:] if r["phase"] == p and r["healthy"]]
               for p in ("block", "full")}
    guarded["skipped"] = [r["dur_s"] for r in recs if not r["healthy"]]
    del run_a, run_c, base
    torch.cuda.empty_cache()
    return [f"snapshot: {snap_bytes} bytes ({snap_bytes / 1e9:.3f} GB) in {snap_files}",
            f"snapshot save {save_s:.3f} s, verify {verify_s:.3f} s, restore {restore_s:.3f} s",
            *walls,
            f"run A guarded step walls after step 0 (--obs-block dur_s): {json.dumps(guarded)}",
            f"the card's full-width step repeats bitwise: {deterministic}"]


def subprocess_env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else []))}


def kill_drill(tmp: str) -> None:
    """chaos_run on the card: each kill fires in the step-4 save, and the
    relaunch must resume from the step-2 snapshot and finish."""
    env = subprocess_env()
    for kind in ("kill_mid_save", "kill_in_save"):
        cmd = [sys.executable, "-m", "repro_torch.scripts.chaos_run", "--plan", f"{kind}@3",
               "--max-restarts", "2", "--"] + CHAOS_ARGV + [
               "--checkpoint-dir", os.path.join(tmp, kind)]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
        lines = out.stdout.splitlines()
        resumes = [json.loads(l) for l in lines if l.startswith('{"event": "resume"')]
        if (out.returncode != 0 or not any(l.startswith("chaos_run: OK") for l in lines)
                or [r["step"] for r in resumes] != [3]):
            fail(f"kill drill {kind}: rc {out.returncode}, resumes {resumes}\n"
                 f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        log(f"[resilience] kill drill {kind}@3: killed once, resumed at step 3 from "
            f"{os.path.basename(resumes[0]['snapshot'])}, finished; "
            f"{time.perf_counter() - t0:.1f} s")


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


def serve_requests(vocab: int, prompts, new, seed: int) -> list:
    """Seeded greedy requests: random prompts of the given lengths, a
    new-token budget drawn from ``new`` for each."""
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=f"s{i}", prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=int(rng.choice(new))) for i, n in enumerate(prompts)]


def run_engine(params, cfg, engine_kw: dict, requests, plan=None, profile=None,
               tag: str = "serve"):
    """Submit ``requests`` at t = 0 and step the engine to idle (one virtual
    second a step). Returns (engine, bus records, (positions, active,
    profiled) of each decode step). ``profile`` (A, B): trace the card over
    steps A..B-1 with torch.profiler and print where their device time
    went; those steps are marked profiled."""
    from repro_torch.obs.bus import Bus, MemorySink
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.training import faults

    decode_log = []
    profiling = [False]

    class TracedEngine(ServingEngine):
        def _decode_fn(self, tables, tokens, pos, active, generators):
            decode_log.append((pos.copy(), active.copy(), profiling[0]))
            return super()._decode_fn(tables, tokens, pos, active, generators)

    bus = Bus([MemorySink()])
    eng = TracedEngine(params, cfg, EngineConfig(**engine_kw), bus=bus,
                       fault_plan=faults.FaultPlan.parse(plan) if plan else None)
    try:
        for req in requests:
            if not eng.submit(req, 0.0):
                fail(f"request {req.rid} rejected: {req.reason}")
        t = 0.0
        while not eng.idle:
            if t > 1000:
                fail("the engine did not reach idle in 1000 steps")
            if profile is not None and eng.step_idx == profile[0]:
                host_probe(eng, tag)
                profiling[0] = True
                profile_steps(eng, t, profile[1] - profile[0], tag)
                profiling[0] = False
                t += profile[1] - profile[0]
                continue
            eng.step(t)
            t += 1.0
    finally:
        faults.set_active(None)
    return eng, bus.sinks[0].records, decode_log


def profile_steps(eng, t: float, n: int, tag: str) -> None:
    """``n`` engine steps under torch.profiler: the first sets the profiler
    up, the other ``n - 1`` are traced. Prints the device time over the host
    wall of the same traced steps, and the kernels that took it, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        eng.step(t)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(1, n):
            eng.step(t + i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    n -= 1
    by_name = device_kernels(traced)
    busy = sum(us for us, _ in by_name.values())
    launches = sum(c for _, c in by_name.values())
    log(f"[{tag}] traced {n} decode steps at {int(eng._active.sum())} active slots: wall "
        f"{wall_us / n / 1e3:.3f} ms a step (profiler on), device busy {busy / n / 1e3:.3f} ms a "
        f"step, {busy / wall_us:.1%} of the same steps' wall; {launches // n} kernel launches "
        f"a step")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}]   {us / n / 1e3:8.3f} ms a step, {count // n:5d} launches: {name[:110]}")


def device_kernels(events) -> dict:
    """{name: (device microseconds, launches)} of a torch.profiler trace's
    device kernels and copies, the schedule's step annotations left out."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA and not ev.name.startswith("ProfilerStep"):
            us, count = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), count + 1)
    return by_name


def profile_update(tag: str, phase: str, update) -> None:
    """One ``update()`` under torch.profiler: its device time by kernel,
    the NS kernels' share beside everything else (packing, the momentum and
    epilogue's elementwise passes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(prof.events())
    busy = sum(us for us, _ in by_name.values()) / 1e3
    ns = sum(us for name, (us, _) in by_name.items()
             if any(k in name for k in ("ns_chain_kernel", "tc_gemm_kernel"))) / 1e3
    log(f"[{tag}] profiled {phase} update: wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms, of which the NS kernels {ns:.3f} ms; "
        f"{sum(c for _, c in by_name.values())} device launches")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag}]   {us / 1e3:8.3f} ms, {count:5d} launches: {name[:110]}")


def host_probe(eng, tag: str, reps: int = 3) -> None:
    """Host or device: one decode step at the engine's state, run ``reps``
    times each way. Eager, as the engine runs it: its wall, and the host's
    time to submit it (to the return of the call, before the sync). As one
    CUDA graph: the replay's wall, the device's time for the same kernels
    with no wait on the host's launches. Re-running the step writes the
    same K/V at the same positions, so the engine's run goes on as without
    the probe."""
    import torch

    from repro_torch.models.transformer import decode_layers
    from repro_torch.serving.kvcache import PagedLayer

    dev = eng.device
    tables = torch.as_tensor(eng.kv.tables, dtype=torch.long, device=dev)
    pos = torch.as_tensor(eng._pos, dtype=torch.long, device=dev)
    active = torch.as_tensor(eng._active, device=dev)
    tokens = torch.as_tensor(eng._tokens, dtype=torch.long, device=dev)[:, None]

    def step():
        with torch.no_grad():
            return decode_layers(eng.params, tokens, pos, eng.cfg,
                                 lambda i: PagedLayer(eng.kv, i, tables, active),
                                 group_rows=True).argmax(-1)

    eager = step()
    torch.cuda.synchronize()
    walls, submits, replays = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        submits.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = step()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        replays.append((time.perf_counter() - t0) * 1e3)
    same = torch.equal(out, eager)
    del graph, out
    torch.cuda.empty_cache()
    ms = lambda xs: "/".join(f"{x:.3f}" for x in xs)
    log(f"[{tag}] host probe, one decode step at {int(eng._active.sum())} active slots, "
        f"{reps} runs each: eager wall {ms(walls)} ms, of which the host submits it in "
        f"{ms(submits)} ms; as one CUDA graph {ms(replays)} ms (same tokens as eager: {same})")


def admission_walls(params, cfg, requests, engine_kw: dict = SERVE_ENGINE) -> dict:
    """TTFT wall by prompt length: the engine's own admission (prefill, the
    padded copy into the pool, the first token read on the host) of each
    prompt alone, into an idle engine, synchronized around it."""
    import torch

    from repro_torch.obs.bus import Bus
    from repro_torch.serving import EngineConfig, Request, ServingEngine

    eng = ServingEngine(params, cfg, EngineConfig(**engine_kw), bus=Bus([]))
    walls, t = {}, 0.0
    for req in sorted(requests, key=lambda r: r.prompt_len):
        one = Request(rid=f"ttft{req.prompt_len}", prompt=req.prompt, max_new_tokens=1)
        if not eng.submit(one, t):
            fail(f"{one.rid} rejected: {one.reason}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit(t)
        torch.cuda.synchronize()
        walls[req.prompt_len] = time.perf_counter() - t0
        if one.state != "active":
            fail(f"{one.rid} not admitted into an idle engine: {one.state}")
        while not eng.idle:
            eng.step(t)
            t += 1.0
    if eng.outstanding_blocks() != 0:
        fail(f"{eng.outstanding_blocks()} blocks outstanding after the TTFT runs")
    return walls


def top2_gap(params, cfg, prompt, tokens, j: int) -> float:
    """Top-2 gap over max|logit| of the logits that chose ``tokens[j]``
    after ``prompt``, from a prefill of the prompt and ``tokens[:j]``."""
    import torch

    from repro_torch.models.model import prefill

    dev = params["embed"].device
    seq = torch.cat([torch.as_tensor(prompt, dtype=torch.long),
                     torch.as_tensor(tokens[:j], dtype=torch.long)]).to(dev)
    with torch.no_grad():
        logits = prefill(params, {"tokens": seq[None]}, cfg)[0][0, -1].to(torch.float32)
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]) / float(logits.abs().max())


def same_tokens(label: str, params, cfg, prompt, got, expect) -> str:
    """``got`` against ``expect`` (greedy tokens after ``prompt``, computed
    by ``params`` on another path); they may part only at a near-tie."""
    if list(got) == list(expect):
        return "equal"
    j = next((i for i, (a, b) in enumerate(zip(got, expect)) if a != b), None)
    if j is None:
        fail(f"{label}: {len(got)} tokens against {len(expect)}")
    gap = top2_gap(params, cfg, prompt, expect, j)
    log(f"[serve] {label}: token {j} differs ({got[j]} vs {expect[j]}); top-2 logit gap "
        f"{gap:.3e} of max|logit| (tie rule {TIE_REL:g})")
    if not gap < TIE_REL:
        fail(f"{label}: tokens differ at {j} where the top-2 gap is {gap:.3e}, not a near-tie")
    return f"near-tie at token {j} (gap {gap:.3e})"


def serve_engine_run(tag: str, params, cfg, engine_kw: dict, requests, param_bytes: int,
                     kv_token_bytes: int, profile=None):
    """Run ``requests`` through the engine to idle and check that every one
    completed and every block came back; print the decode rate at every
    slot active beside its bound. Returns (finished requests by id, the
    engine's window, pool bytes, peak memory of the run)."""
    import numpy as np
    import torch

    from repro_torch.obs.spans import percentiles

    t0 = time.perf_counter()
    eng, records, decode_log = run_engine(params, cfg, engine_kw, requests, profile=profile,
                                          tag=tag)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    pool_bytes = eng.kv.k.numel() * eng.kv.k.element_size() * 2
    window = eng.kv.window
    engine_peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] engine {engine_kw}: pool {pool_bytes} bytes ({pool_bytes / 1e9:.3f} GB), "
        f"window {window} tokens; {eng.step_idx} steps, {len(decode_log)} decode steps in "
        f"{engine_s:.2f} s; peak memory {engine_peak / 2**30:.2f} GiB")
    done = {r.rid: r for r in eng.finished}
    if len(done) != len(requests) or any(r.state != "done" for r in done.values()):
        fail(f"not every request completed: {[(r.rid, r.state, r.reason) for r in eng.finished]}")
    if eng.outstanding_blocks() != 0:
        fail(f"{eng.outstanding_blocks()} blocks outstanding after the run")
    waited = [r["request"] for r in records if r.get("event") == "admit" and r["queue_wait_s"] > 0]
    log(f"[{tag}] every request completed, every block came back; waited for a slot: {waited}")
    del eng
    torch.cuda.empty_cache()

    # The serve_decode spans (synchronized on the card) against the least
    # time a step could take: every fp32 parameter and the active slots'
    # valid KV read once, at the HBM rate. The profiled steps are left out.
    slots = engine_kw["slots"]
    spans = [r for r in records if r.get("event") == "span" and r.get("name") == "serve_decode"]
    if len(spans) != len(decode_log):
        fail(f"{len(spans)} serve_decode spans for {len(decode_log)} decode steps")
    spans, decode_log = zip(*[(r, d) for r, d in zip(spans, decode_log) if not d[2]])
    full = [(r["dur_s"], pos, act) for r, (pos, act, _) in zip(spans, decode_log)
            if r["active"] == slots]
    if not full:
        fail("no decode step ran with every slot active")
    durs = percentiles([d for d, _, _ in full])
    wall = sum(d for d, _, _ in full)
    tokens = slots * len(full)
    bound = sum(param_bytes + kv_token_bytes * float(np.sum((pos + 1) * act))
                for _, pos, act in full) / HBM_BYTES_S
    all_p = percentiles([r["dur_s"] for r in spans])
    log(f"[{tag}] serve_decode span, all {len(spans)} steps not profiled: "
        f"p50 {all_p['p50'] * 1e3:.3f} ms, p95 {all_p['p95'] * 1e3:.3f} ms")
    log(f"[{tag}] decode at {slots} active slots, {len(full)} steps: "
        f"{tokens} tokens in {wall * 1e3:.3f} ms, {tokens / wall:.2f} tokens/s; a step p50 "
        f"{durs['p50'] * 1e3:.3f} ms, p95 {durs['p95'] * 1e3:.3f} ms; bound "
        f"{bound / len(full) * 1e3:.3f} ms a step (bytes: fp32 parameters + active KV at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s), {bound / wall:.1%} of it over these steps; the "
        f"window gather copies {slots * window * kv_token_bytes / 1e9:.2f} GB a step")
    return done, window, pool_bytes, engine_peak


def phase_serve(smi: str) -> None:
    """The serving path at full width and its checks (module docstring)."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SERVE_ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    param_bytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
    kv_token_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2  # K, V in bf16
    log(f"[serve] full-width {SERVE_ARCH}: {param_bytes / 4} fp32 parameters "
        f"({param_bytes / 1e9:.3f} GB), KV {kv_token_bytes} bytes a token in bf16")

    requests = serve_requests(cfg.vocab_size, SERVE_PROMPTS, SERVE_NEW, seed=0)
    done, window, pool_bytes, engine_peak = serve_engine_run(
        "serve", params, cfg, SERVE_ENGINE, requests, param_bytes, kv_token_bytes,
        profile=PROFILE_STEPS)

    ttft = admission_walls(params, cfg, requests)
    log(f"[serve] TTFT wall (the engine's admission of the prompt alone: prefill, pool "
        f"copy, first token; synchronized), by prompt length: "
        f"{json.dumps({k: round(v, 4) for k, v in ttft.items()})}")
    torch.cuda.empty_cache()

    check_generate(params, cfg, requests, done, window)
    teacher_forcing(params, cfg)
    corrupt_run(params, cfg)
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    serve_small()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        serve_kill_drill(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[serve] card: {smi}; pool {pool_bytes} bytes; peak memory {peak / 2**30:.2f} GiB "
        f"(engine run {engine_peak / 2**30:.2f} GiB); phase {time.perf_counter() - t_phase:.1f} s")


def phase_serve_moe(smi: str) -> None:
    """MoE serving: full-depth olmoe-1b-7b in fp32 behind the engine (the
    module docstring), its tokens against generate, decode against teacher
    forcing on the dropless config, the reduced MoE models card against
    CPU."""
    import dataclasses

    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    param_bytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
    kv_token_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2  # K, V in bf16
    log(f"[serve_moe] full-depth {MOE_ARCH}: {param_bytes // 4} fp32 parameters "
        f"({param_bytes / 1e9:.3f} GB), KV {kv_token_bytes} bytes a token in bf16")
    requests = serve_requests(cfg.vocab_size, MOE_SERVE_PROMPTS, MOE_SERVE_NEW, seed=3)
    done, window, pool_bytes, engine_peak = serve_engine_run(
        "serve_moe", params, cfg, MOE_SERVE_ENGINE, requests, param_bytes, kv_token_bytes,
        profile=PROFILE_STEPS)
    ttft = admission_walls(params, cfg, requests, MOE_SERVE_ENGINE)
    log(f"[serve_moe] TTFT wall (the engine's admission of the prompt alone: prefill, pool "
        f"copy, first token; synchronized), by prompt length: "
        f"{json.dumps({k: round(v, 4) for k, v in ttft.items()})}")
    torch.cuda.empty_cache()
    check_generate(params, cfg, requests, done, window, tag="serve_moe")
    # A full forward over t tokens drops other assignments than t decodes of
    # one: capacity_factor = E / top_k gives each expert every token.
    dropless = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    teacher_forcing(params, dropless, MOE_TF_PREFIX, MOE_TF_STEPS, tag="serve_moe")
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    for arch in MOE_SMALL_ARCHS:
        serve_small(arch, tag="serve_moe")
    log(f"[serve_moe] card: {smi}; pool {pool_bytes} bytes; peak memory {peak / 2**30:.2f} GiB "
        f"(engine run {engine_peak / 2**30:.2f} GiB); phase {time.perf_counter() - t_phase:.1f} s")


def check_generate(params, cfg, requests, done, window, tag: str = "serve") -> None:
    """Each request's engine tokens against the port's generate on its
    prompt alone, with the engine's window as max_len."""
    import torch

    from repro_torch.serving.serve_step import generate

    t0 = time.perf_counter()
    verdicts = {}
    for req in requests:
        prompt = torch.as_tensor(req.prompt, dtype=torch.long, device="cuda")[None]
        expect = generate(params, prompt, cfg, max_new_tokens=req.budget,
                          max_len=window)[0].tolist()
        verdicts[req.rid] = same_tokens(f"{req.rid} ({req.prompt_len} tokens)", params, cfg,
                                        req.prompt, done[req.rid].tokens, expect)
        torch.cuda.empty_cache()
    log(f"[{tag}] engine tokens against generate, request by request: {json.dumps(verdicts)} "
        f"({time.perf_counter() - t0:.1f} s)")


def teacher_forcing(params, cfg, prefix: int = TF_PREFIX, steps: int = TF_STEPS,
                    tag: str = "serve") -> None:
    """Prefill ``prefix`` tokens, then ``steps`` decode steps on an fp32
    cache, against the forward over the whole sequence."""
    import torch

    from repro_torch.models.model import decode_step, forward, prefill
    from repro_torch.serving.serve_step import cache_from_prefill

    total = prefix + steps
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, total), generator=gen).to("cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        full = forward(params, tokens, cfg)[0, prefix - 1:].clone()
        logits_p, pcache = prefill(params, {"tokens": tokens[:, :prefix]}, cfg)
        errs = [float((logits_p[0, -1] - full[0]).abs().max())]
        del logits_p
        cache = cache_from_prefill(pcache, cfg, total, dtype=torch.float32)
        del pcache
        for j in range(steps):
            t = prefix + j
            lg, cache = decode_step(params, tokens[:, t:t + 1], cache, t, cfg)
            errs.append(float((lg[0, 0] - full[j + 1]).abs().max()))
    rel = max(errs) / float(full.abs().max())
    log(f"[{tag}] decode after a {prefix}-token prefill, {steps} steps on an fp32 cache, "
        f"against teacher forcing: max abs diff {max(errs):.3e}, {rel:.3e} of max|logit| "
        f"(tol {DECODE_TOL:g}); {time.perf_counter() - t0:.1f} s")
    if not rel <= DECODE_TOL:
        fail("decode disagrees with teacher forcing")
    del full, cache
    torch.cuda.empty_cache()


def corrupt_run(params, cfg) -> None:
    """corrupt_cache at full width: exactly the victim cancelled (reason
    corrupt), the co-batched requests' tokens as in the fault-free run."""
    import torch

    runs = {}
    for plan in (None, CORRUPT_PLAN):
        requests = serve_requests(cfg.vocab_size, CORRUPT_PROMPTS, CORRUPT_NEW, seed=1)
        eng, _, _ = run_engine(params, cfg, SERVE_ENGINE, requests, plan)
        if eng.outstanding_blocks() != 0:
            fail(f"{plan}: {eng.outstanding_blocks()} blocks outstanding")
        runs[plan] = {r.rid: (r.state, r.reason, r.tokens) for r in eng.finished}
        del eng
        torch.cuda.empty_cache()
    clean, hit = runs[None], runs[CORRUPT_PLAN]
    victims = [rid for rid, (state, reason, _) in hit.items() if state != "done"]
    if victims != ["s0"] or hit["s0"][:2] != ("cancelled", "corrupt"):
        fail(f"{CORRUPT_PLAN} cancelled {victims}: {hit}")
    if any(hit[rid][2] != clean[rid][2] for rid in hit if rid != "s0"):
        fail(f"{CORRUPT_PLAN} changed a co-batched request's tokens")
    log(f"[serve] {CORRUPT_PLAN} at full width: s0 cancelled (corrupt) after "
        f"{len(hit['s0'][2])} tokens; s1, s2 token for token as without the fault")


def serve_small(arch: str = SERVE_ARCH, tag: str = "serve") -> None:
    """The reduced model's seeded trace on the card against the CPU."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(arch).reduced()
    base = init_params(cfg, seed=0, device="cpu")
    runs = {}
    for device in ("cpu", "cuda"):
        params = tree_lib.tree_map(lambda p: p.to(device), base)
        requests = serve_requests(cfg.vocab_size, SMALL_PROMPTS, SMALL_NEW, seed=2)
        eng, records, _ = run_engine(params, cfg, SMALL_ENGINE, requests)
        if eng.outstanding_blocks() != 0 or any(r.state != "done" for r in eng.finished):
            fail(f"reduced run on {device}: {[(r.rid, r.state) for r in eng.finished]}")
        events = [{k: v for k, v in r.items() if k not in ("ts", "dur_s")} for r in records]
        runs[device] = ({r.rid: r for r in eng.finished}, events)
    verdicts = {rid: same_tokens(f"reduced {rid}", base, cfg, req.prompt,
                                 runs["cuda"][0][rid].tokens, req.tokens)
                for rid, req in runs["cpu"][0].items()}
    same_events = runs["cuda"][1] == runs["cpu"][1]
    if all(v == "equal" for v in verdicts.values()) and not same_events:
        fail("reduced run: equal tokens on the card and the CPU but other events")
    log(f"[{tag}] reduced {arch}, engine {SMALL_ENGINE}, card against CPU: "
        f"{json.dumps(verdicts)}; event streams (no ts, dur_s) equal: {same_events}")


def serve_kill_drill(tmp: str) -> None:
    """serve_sim on the card, SIGKILLed in the decode loop: the JSONL trail
    holds every record stdout saw."""
    from repro_torch.scripts.chaos_run import telemetry_failures

    log_file = os.path.join(tmp, "serve_kill.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.scripts.serve_sim"] + SERVE_KILL_ARGV + [
        "--log-file", log_file]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=subprocess_env())
    recs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    failures = telemetry_failures(log_file, recs, "serve")
    if out.returncode != -9 or not any(r.get("event") == "admit" for r in recs) or failures:
        fail(f"serve kill drill: rc {out.returncode}, failures {failures}\n"
             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    log(f"[serve] kill drill: python -m repro_torch.scripts.serve_sim {' '.join(SERVE_KILL_ARGV)} "
        f"SIGKILLed (rc -9) with {len(recs)} records on stdout, all on disk; "
        f"{time.perf_counter() - t0:.1f} s")


def train_path(tag: str, argv: list, cfg, required=MAIN_PATH_KERNELS):
    """Drive the launcher over ``argv`` (``cfg``: a depth cut or None) with
    every kernel count set to 0 just before and read just after; a line a
    step with its loss, wall, launches and NS buckets. Returns (run,
    counts, per-step counts, peak bytes)."""
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core.muon import phase_for_step
    from repro_torch.launch import train
    from repro_torch.obs import get_bus

    per_step, last = [], {}

    def on_step(rec):
        counts = dict(kernels.launch_counts())
        counts["packed"] = kernels.packed_launches()
        counts.update({k: v for k, v in get_bus().counters.items() if k.startswith("ns_launch.")})
        step = {k: v - last.get(k, 0) for k, v in counts.items()}
        last.update(counts)
        per_step.append((rec["phase"], step))
        buckets = sum(v for k, v in step.items() if k.startswith("ns_launch."))
        launches = {k: v for k, v in step.items() if not k.startswith("ns_launch.")}
        log(f"[{tag}] step {rec['step']} phase {rec['phase']} loss {rec['loss']:.4f} "
            f"wall {rec['dur_s']:.3f} s (--obs-block) launches {launches} NS buckets {buckets}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}"
        + (f", cfg num_layers={cfg.num_layers}" if cfg is not None else ""))
    kernels.reset_launch_counts()
    run = train.run(argv, cfg=cfg, on_step=on_step)
    counts = dict(kernels.launch_counts())
    packed = kernels.packed_launches()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree_lib.leaves(run.state.params))
    log(f"[{tag}] {n_params} parameters; launches on the path: {counts}, {packed} of them "
        f"packed an operand (checked against the plain chain in the update below); peak "
        f"memory {peak / 2**30:.2f} GiB")
    phases = [r["phase"] for r in run.records]
    if phases != [phase_for_step(t, 5) for t in range(len(phases))]:
        fail(f"{tag}: unexpected phases {phases}")
    if not all(r["loss"] == r["loss"] and abs(r["loss"]) != float("inf") for r in run.records):
        fail(f"{tag}: non-finite loss {[r['loss'] for r in run.records]}")
    for name in required:
        if counts[name] <= 0:
            fail(f"{tag}: kernel {name} never launched on its path")
    for phase in dict.fromkeys(phases):
        step = next(c for p, c in per_step if p == phase)
        log(f"[{tag}] a {phase} step: launches "
            f"{ {k: v for k, v in step.items() if not k.startswith('ns_launch.')} }, NS buckets "
            f"{ {k.rsplit('.', 1)[1]: v for k, v in step.items() if k.startswith('ns_launch.')} }")
    return run, counts, per_step, peak


def phase_train_ssm(smi: str, errors: dict) -> None:
    """MuonBP on mamba2-1.3b at full width, cut to SSM_TRAIN_LAYERS layers:
    six steps through the launcher with the 8-way grid, the update from the
    kernels against the plain versions in both phases, and the kernels at
    the bucket shapes the SSM path adds."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_TRAIN_LAYERS)
    run, _, _, train_peak = train_path("train_ssm", SSM_TRAIN_ARGV, cfg)
    records = run.records
    walls = {p: [r["dur_s"] for r in records[1:] if r["phase"] == p] for p in ("block", "full")}
    breakdown = {"loss": [r["loss"] for r in records],
                 "step_wall_s": [r["dur_s"] for r in records],
                 "phases": [r["phase"] for r in records], "steady_step_wall_s": walls}
    check_update("muonbp", run, ("block", "full"), breakdown, tag="train_ssm")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train_ssm] breakdown {json.dumps(breakdown)}")
    del run
    torch.cuda.empty_cache()
    ssm_buckets(errors)
    log(f"[train_ssm] card: {smi}; {SSM_TRAIN_LAYERS} of {get_config(SSM_ARCH).num_layers} "
        f"layers; peak memory {peak / 2**30:.2f} GiB (the six steps {train_peak / 2**30:.2f} "
        f"GiB); phase {time.perf_counter() - t_phase:.1f} s")


def ssm_buckets(errors: dict) -> None:
    """Each NS kernel against its plain version at the bucket shapes the SSM
    paths add, and its time beside the plain version's and the bound."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.newton_schulz import PAPER_COEFFS
    from repro_torch.kernels.newton_schulz import fused
    from repro_torch.kernels.newton_schulz import newton_schulz as tiled

    a, b, c = PAPER_COEFFS
    times = {}

    def check(name, label, out, ref, tol):
        err, rel = rel_err(out, ref)
        log(f"[train_ssm] {name} {label}: max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
            f"{'ok' if rel <= tol else 'FAIL'}")
        errors[name] = max(errors.get(name, 0.0), err)
        if not rel <= tol:
            fail(f"{name} {label} disagrees with its plain version")
        return err, rel

    def timed(label, fn, plain, flops, nbytes, iters, **extra):
        ms, plain_ms = cuda_ms(fn, iters), cuda_ms(plain, iters)
        bms, kind = bound_ms(TC_PASSES * flops, nbytes, TF32_FLOPS)
        times[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": kind,
                        **extra}
        log(f"[train_ssm] time {label}: {ms:.3f} ms (plain {plain_ms:.3f}, 3xTF32 bound "
            f"{bms:.3f} ms by {kind}, {bms / ms:.1%} of bound)")

    for i, (what, shape) in enumerate(SSM_FUSED_BUCKETS.items()):
        x = unit_inputs(shape, 80 + i)
        label = f"{'x'.join(map(str, shape))} ({what})"
        before = kernels.packed_launches()
        out = fused.ns_chain(x, PAPER_COEFFS, NS_STEPS)
        packed = kernels.packed_launches() - before
        err, rel = check("ns_fused_chain", f"{label} x{NS_STEPS} steps", out,
                         fused.ns_chain_plain(x, PAPER_COEFFS, NS_STEPS), CHAIN_TOL)
        timed(f"ns_fused_chain {label} x{NS_STEPS}",
              lambda: fused.ns_chain(x, PAPER_COEFFS, NS_STEPS),
              lambda: fused.ns_chain_plain(x, PAPER_COEFFS, NS_STEPS),
              NS_STEPS * ns_step_flops(*shape), 4.0 * 2 * x.numel(), 3,
              max_abs_err=err, rel_err=rel, packed=packed)
        del x, out
    torch.cuda.empty_cache()

    B, m, n = SSM_TILED
    x = unit_inputs(SSM_TILED, 90)
    xt = x.transpose(-1, -2)
    label = f"{B}x{m}x{n}"
    gram = tiled.matmul(x, xt, symmetric=True)
    e1 = check("ns_matmul", f"gram {label}", gram, tiled.matmul_plain(x, xt), PRODUCT_TOL)
    poly = tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True)
    e2 = check("ns_fma_matmul", f"poly bA+cA^2 {B}x{m}x{m}", poly,
               tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c), PRODUCT_TOL)
    e3 = check("ns_fma_matmul", f"update aX+PX {label}",
               tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
               tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), PRODUCT_TOL)
    timed(f"ns_matmul gram {label}", lambda: tiled.matmul(x, xt, symmetric=True),
          lambda: tiled.matmul_plain(x, xt), B * m * (m + 1.0) * n,
          4.0 * (B * m * n + B * m * m), 3, max_abs_err=e1[0], rel_err=e1[1])
    timed(f"ns_fma_matmul poly {B}x{m}x{m}",
          lambda: tiled.fma_matmul(gram, gram, gram, alpha=b, beta=c, symmetric=True),
          lambda: tiled.fma_matmul_plain(gram, gram, gram, alpha=b, beta=c),
          B * m * m * (m + 1.0), 4.0 * 2 * B * m * m, 3, max_abs_err=e2[0], rel_err=e2[1])
    timed(f"ns_fma_matmul update {label}", lambda: tiled.fma_matmul(poly, x, x, alpha=a, beta=1.0),
          lambda: tiled.fma_matmul_plain(poly, x, x, alpha=a, beta=1.0), 2.0 * B * m * m * n,
          4.0 * (B * m * m + 2 * B * m * n), 3, max_abs_err=e3[0], rel_err=e3[1])
    del x, xt, gram, poly
    torch.cuda.empty_cache()
    log(f"[train_ssm] times at the SSM bucket shapes: {json.dumps(times)}")


def decode_against_forward(tag: str, params, cfg, prompt, extras: dict, new: int,
                           ring: bool = False) -> dict:
    """Prefill ``prompt`` (and the stub ``extras``), then ``new`` greedy
    decode steps on an fp32 cache, each fed the token it chose, timed one by
    one; the logits against the forward over the prompt and the fed tokens
    (teacher forcing) to DECODE_TOL of max|logit|. ``ring``: the same steps
    on a ring cache of the window filled from the same prefill, against the
    dense cache. Returns the walls and the decoded tokens."""
    import torch

    from repro_torch.models.encdec import encode
    from repro_torch.models.model import decode_step, forward, prefill
    from repro_torch.serving.serve_step import cache_from_prefill

    V = cfg.vision_tokens
    bsz, plen = prompt.shape

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with torch.no_grad():
        (logits_p, pcache), prefill_s = synced(
            lambda: prefill(params, {"tokens": prompt, **extras}, cfg))
        caches = {"dense": cache_from_prefill(pcache, cfg, V + plen + new, dtype=torch.float32)}
        if ring:
            caches["ring"] = cache_from_prefill(pcache, cfg, cfg.window_size,
                                                dtype=torch.float32)
        del pcache
        enc = encode(params["encoder"], extras["audio_frames"], cfg) if cfg.encoder_seq else None
        first = torch.argmax(logits_p[:, -1:, :].to(torch.float32), dim=-1)
        out = {"prefill_s": prefill_s, "walls": []}
        for kind, cache in caches.items():
            token, fed, rows = first, [], [logits_p[:, -1].to(torch.float32)]
            for i in range(new):
                fed.append(token)
                (lg, cache), wall = synced(lambda: decode_step(
                    params, token, cache, V + plen + i, cfg, ring_cache=kind == "ring",
                    encoder_out=enc))
                rows.append(lg[:, 0].to(torch.float32))
                token = torch.argmax(rows[-1], dim=-1)[:, None]
                if kind == "dense":
                    out["walls"].append(wall)
            out[kind] = (torch.stack(rows, 1), torch.cat(fed, 1))
            del cache
        del logits_p
        logits, fed = out["dense"]
        seq = torch.cat([prompt, fed], 1)
        full = forward(params, seq, cfg, extra_embeds=extras.get("vision_embeds"),
                       encoder_frames=extras.get("audio_frames"))
        full = full[:, V + plen - 1:].to(torch.float32)
        err = float((logits - full).abs().max())
        rel = err / float(full.abs().max())
        log(f"[{tag}] decode after a {plen}-token prefill (batch {bsz}), {new} steps on an fp32 "
            f"cache, against teacher forcing over {V + plen + new} positions: max abs diff "
            f"{err:.3e}, {rel:.3e} of max|logit| (tol {DECODE_TOL:g})")
        if not rel <= DECODE_TOL:
            fail(f"{tag}: decode disagrees with teacher forcing")
        if ring:
            r_logits, r_fed = out["ring"]
            r_err = float((r_logits - logits).abs().max()) / float(logits.abs().max())
            log(f"[{tag}] ring cache of {cfg.window_size} slots past the window (positions "
                f"{V + plen}..{V + plen + new - 1}) against the dense cache: {r_err:.3e} of "
                f"max|logit|, tokens equal: {torch.equal(r_fed, fed)}")
            if not r_err <= DECODE_TOL:
                fail(f"{tag}: the ring cache disagrees with the dense cache")
        del full
    out["tokens"] = fed
    torch.cuda.empty_cache()
    return out


def phase_serve_ssm(smi: str) -> None:
    """mamba2-1.3b at full depth in fp32 through generate: batch 4, a
    2048-token prompt, 64 new tokens; the same steps timed one by one and
    held to teacher forcing; the decode step against its byte bound."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import ssm_dims
    from repro_torch.serving.serve_step import generate

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SSM_ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    param_bytes = sum(t.numel() * t.element_size() for t in tree_lib.leaves(params))
    dims = ssm_dims(cfg)
    h_bytes = 4 * cfg.num_layers * SSM_SERVE_BATCH * dims.num_heads * dims.head_dim * \
        dims.state_size
    conv_bytes = 4 * cfg.num_layers * SSM_SERVE_BATCH * (dims.conv_kernel - 1) * \
        (dims.d_inner + 2 * dims.state_size)
    # A decode step reads every fp32 parameter once and reads and writes the state.
    step_bound_ms = (param_bytes + 2 * (h_bytes + conv_bytes)) / HBM_BYTES_S * 1e3
    log(f"[serve_ssm] full-depth {SSM_ARCH}: {param_bytes // 4} fp32 parameters "
        f"({param_bytes / 1e9:.3f} GB); state {h_bytes + conv_bytes} bytes at batch "
        f"{SSM_SERVE_BATCH}; decode step bound {step_bound_ms:.3f} ms")
    gen = torch.Generator().manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (SSM_SERVE_BATCH, SSM_SERVE_PROMPT),
                           generator=gen).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(params, prompt, cfg, max_new_tokens=SSM_SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if tokens.shape != (SSM_SERVE_BATCH, SSM_SERVE_NEW):
        fail(f"serve_ssm: generate gave {tuple(tokens.shape)}")
    log(f"[serve_ssm] generate: {SSM_SERVE_BATCH} x {SSM_SERVE_PROMPT} prompt tokens, "
        f"{SSM_SERVE_NEW} new, {gen_s:.3f} s")
    res = decode_against_forward("serve_ssm", params, cfg, prompt, {}, SSM_SERVE_NEW)
    same = torch.equal(res["tokens"], tokens)
    walls = sorted(res["walls"])
    p50, p95 = walls[len(walls) // 2], walls[min(len(walls) - 1, int(0.95 * len(walls)))]
    log(f"[serve_ssm] prefill wall {res['prefill_s']:.4f} s; decode step p50 {p50 * 1e3:.3f} "
        f"ms, p95 {p95 * 1e3:.3f} ms over {len(walls)} steps (synchronized), bound "
        f"{step_bound_ms:.3f} ms ({step_bound_ms / (p50 * 1e3):.1%} of it at p50); "
        f"{SSM_SERVE_BATCH / p50:.1f} tokens/s; the timed steps' tokens equal generate's: "
        f"{same}")
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    log(f"[serve_ssm] card: {smi}; peak memory {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_archs(smi: str) -> None:
    """hymba-1.5b, internvl2-1b and whisper-small at full width: two MuonBP
    steps each with the update checked, generate against teacher forcing
    (hymba also on its ring cache), then the reduced models of all four new
    archs on the card against the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.serve_step import generate

    t_phase = time.perf_counter()
    for arch in ARCHS_TRAINED:
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        tag = f"archs:{arch}"
        # whisper's full phase sends every bucket to the fused chain.
        required = ("ns_fused_chain",) if arch == "whisper-small" else MAIN_PATH_KERNELS
        run, _, _, train_peak = train_path(tag, ["--arch", arch] + ARCHS_ARGV, None, required)
        breakdown = {"loss": [r["loss"] for r in run.records],
                     "step_wall_s": [r["dur_s"] for r in run.records],
                     "phases": [r["phase"] for r in run.records]}
        check_update("muonbp", run, ("full", "block"), breakdown, tag=tag, batch_shape=(2, 1024))
        log(f"[{tag}] breakdown {json.dumps(breakdown)}")
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        gen = torch.Generator().manual_seed(17)
        prompt = torch.randint(0, cfg.vocab_size, (2, ARCHS_PROMPT), generator=gen).to("cuda")
        extras = {}
        if cfg.vision_tokens:
            extras["vision_embeds"] = 0.02 * torch.randn(
                (2, cfg.vision_tokens, cfg.d_model), generator=gen).to("cuda")
        if cfg.encoder_seq:
            extras["audio_frames"] = 0.02 * torch.randn(
                (2, cfg.encoder_seq, cfg.d_model), generator=gen).to("cuda")
        tokens = generate(params, prompt, cfg, max_new_tokens=ARCHS_NEW,
                          max_len=cfg.vision_tokens + ARCHS_PROMPT + ARCHS_NEW,
                          batch_extras=extras or None)
        res = decode_against_forward(tag, params, cfg, prompt, extras, ARCHS_NEW,
                                     ring=cfg.attention_pattern == "swa")
        walls = sorted(res["walls"])
        log(f"[{tag}] generate {ARCHS_NEW} tokens: equal to the timed steps' "
            f"{torch.equal(res['tokens'], tokens)}; prefill wall {res['prefill_s']:.4f} s, "
            f"decode step p50 {walls[len(walls) // 2] * 1e3:.3f} ms; peak memory "
            f"{max(train_peak, torch.cuda.max_memory_allocated()) / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t_arch:.1f} s")
        del params
        torch.cuda.empty_cache()
    for arch in NEW_ARCHS:
        arch_small(arch)
    log(f"[archs] card: {smi}; phase {time.perf_counter() - t_phase:.1f} s")


def arch_small(arch: str) -> None:
    """The reduced model on the card against the CPU: three fp32 launcher
    steps (losses to SMALL_LOSS_TOL), greedy generate of eight tokens (equal
    but at a near-tie) and the forward's logits over the CPU's prompt and
    tokens (to 1e-4)."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import forward, init_params
    from repro_torch.serving.serve_step import generate

    cfg = get_config(arch).reduced()
    base = init_params(cfg, seed=0, device="cpu")
    argv = ["--arch", arch, "--reduced", "--mesh-model", "4", "--steps", "3", "--period", "2",
            "--batch", "2", "--seq", "32", "--compute-dtype", "float32", "--log-every", "3"]
    losses = {dev: [r["loss"] for r in train.run(
        argv + ["--device", dev], params=tree_lib.tree_map(lambda p: p.to(dev), base)).records]
        for dev in ("cpu", "cuda")}
    loss_rel = max(abs(g - c) / max(1.0, abs(c)) for g, c in zip(losses["cuda"], losses["cpu"]))
    gen = torch.Generator().manual_seed(19)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    extras = {}
    if cfg.vision_tokens:
        extras["vision_embeds"] = 0.1 * torch.randn((2, cfg.vision_tokens, cfg.d_model),
                                                    generator=gen)
    if cfg.encoder_seq:
        extras["audio_frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                                   generator=gen)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = tree_lib.tree_map(lambda p: p.to(dev), base)
        ex = {k: v.to(dev) for k, v in extras.items()}
        runs[dev] = generate(params, prompt.to(dev), cfg, max_new_tokens=8,
                             max_len=cfg.vision_tokens + 16, batch_extras=ex or None).cpu()
        # Both devices' logits over the CPU's sequence.
        with torch.no_grad():
            runs[dev + "_logits"] = forward(
                params, torch.cat([prompt, runs["cpu"]], 1).to(dev), cfg,
                extra_embeds=ex.get("vision_embeds"), encoder_frames=ex.get("audio_frames")).cpu()
    logit_err = float((runs["cuda_logits"] - runs["cpu_logits"]).abs().max())
    verdicts = []
    for r in range(2):
        got, want = runs["cuda"][r].tolist(), runs["cpu"][r].tolist()
        if got == want:
            verdicts.append("equal")
            continue
        # The first differing token may differ only at a near-tie of the
        # logits that chose it.
        j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        row = runs["cpu_logits"][r, cfg.vision_tokens + 8 - 1 + j].to(torch.float32)
        top = torch.topk(row, 2).values
        gap = float(top[0] - top[1]) / float(row.abs().max())
        if not gap < TIE_REL:
            fail(f"reduced {arch} row {r}: token {j} differs where the top-2 gap is {gap:.3e}")
        verdicts.append(f"near-tie at token {j} (gap {gap:.3e})")
    log(f"[archs] reduced {arch}, card against CPU: losses {losses['cuda']} vs "
        f"{losses['cpu']} (max rel {loss_rel:.3e}, tol {SMALL_LOSS_TOL:g}); logits over the "
        f"CPU's generated sequence max abs diff {logit_err:.3e} (tol 1e-4); generate tokens "
        f"{verdicts}")
    if not loss_rel <= SMALL_LOSS_TOL or not logit_err <= 1e-4:
        fail(f"reduced {arch} on the card disagrees with the CPU")


def dist_argv(arch: str, mesh: str, batch: int, extra: list, steps: int) -> list:
    return (["--arch", arch] + DIST_ARGV + ["--mesh", mesh, "--batch", str(batch)] + extra
            + ["--steps", str(steps)])


def dist_cfg(arch: str, layers):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def dist_rank(rank: int, port: int, spec: tuple, out_dir: str) -> None:
    """One rank of the distributed phase (started by torch.multiprocessing):
    the fp32 step check (runs A and E), the launcher on the mesh, then the
    checks of :func:`dist_checks`; the results go to ``out_dir/rank<r>.json``.
    An exception fails the rank."""
    sys.path.insert(0, str(SRC))
    # Four processes share the card: expandable segments keep each one's
    # cached but unused blocks small (read at the rank's first allocation).
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=DIST_RANKS)
    try:
        res = dist_checks(rank, spec, out_dir)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        import traceback

        # A peer that dies takes the others' collectives down with it: each
        # rank's own error is kept for the parent to print.
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def first_batch(cfg, argv: list, rows=slice(None)) -> dict:
    """The launcher's first global batch for ``argv`` (its rows ``rows``) on
    the card."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    args = train.parser().parse_args(argv)
    batch = next(iter(SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)))
    return train.device_batch({k: v[rows] for k, v in batch.items()}, "cuda")


class recorded_routes:
    """Within it, every MoE layer's routing of the port is kept in ``self``
    as it runs: ``(top_idx (T, k), router logits (T, E))`` on the host, in
    layer order."""

    def __init__(self):
        self.routes = []

    def __enter__(self):
        from repro_torch.models import moe as moe_lib

        self.route = route = moe_lib._route

        def recording(logits, top_k, style):
            gates, idx = route(logits, top_k, style)
            self.routes.append((idx.reshape(-1, top_k).cpu(),
                                logits.detach().reshape(-1, logits.shape[-1]).cpu()))
            return gates, idx

        moe_lib._route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib

        moe_lib._route = self.route


def dist_fp32_reference(spec: tuple, path: str) -> None:
    """The single-process port's fp32 loss and gradients (TF32 off) of the
    run's first global batch on its weights (``--seed``), saved to ``path``.
    An MoE model's are the mean over the data shards' rows, each routed
    alone as on the mesh, whose routing is saved too."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.training.train_step import loss_and_grads

    label, arch, mesh, batch, extra, steps, layers, _, _ = spec
    argv = dist_argv(arch, mesh, batch, extra, steps)
    cfg = dist_cfg(arch, layers)
    params = init_params(cfg, seed=train.parser().parse_args(argv).seed, device="cuda")
    if not cfg.num_experts:
        loss, _, grads = loss_and_grads(params, first_batch(cfg, argv), cfg, torch.float32)
        routes = None
    else:
        from repro_torch.launch.mesh import parse_mesh_spec

        shards = math.prod(v for a, v in zip(*parse_mesh_spec(mesh)) if a != "model")
        rows, losses, routes, grads = batch // shards, [], [], None
        for d in range(shards):
            with recorded_routes() as rec:
                loss_d, _, g = loss_and_grads(
                    params, first_batch(cfg, argv, slice(d * rows, (d + 1) * rows)), cfg,
                    torch.float32)
            routes.append(rec.routes)
            losses.append(loss_d)
            g = tree_lib.tree_map(lambda x: x / shards, g)
            grads = g if grads is None else tree_lib.tree_map(torch.add, grads, g)
            del g
        loss = torch.stack(losses).mean()
    torch.save({"loss": float(loss), "routes": routes,
                "grads": {"/".join(k): g.cpu() for k, g in tree_lib.flatten_with_path(grads)}},
               path)
    del params, grads
    torch.cuda.empty_cache()


def routing_flips(routes: list, ref: list, top_k: int) -> dict:
    """Tokens whose top_k experts differ from the reference's, each layer,
    with the reference's gap between its k-th and (k+1)-th router logits."""
    import torch

    out = {"layers": len(routes), "tokens": 0, "flips": 0, "max_gap": None}
    if len(routes) != len(ref):
        fail(f"{len(routes)} routed layers on the mesh, {len(ref)} in the reference")
    for (idx, _), (r_idx, r_logits) in zip(routes, ref):
        out["tokens"] += idx.shape[0]
        flipped = (idx != r_idx).any(dim=-1)
        if bool(flipped.any()):
            top = torch.sort(r_logits[flipped], dim=-1, descending=True).values
            gap = float((top[:, top_k - 1] - top[:, top_k]).max())
            out["flips"] += int(flipped.sum())
            out["max_gap"] = gap if out["max_gap"] is None else max(out["max_gap"], gap)
    return out


def dist_fp32_check(rank: int, spec: tuple, ref_path: str) -> dict:
    """One fp32 step (TF32 off) of the tensor-parallel model on this rank's
    shards of the launcher's weights and rows: the loss, and every gradient
    after the reduce joined and held on rank 0 against the single-process
    port's (:func:`dist_fp32_reference`); for MoE each layer's routing on
    this rank against the reference's on its data shard."""
    import torch

    from repro_torch import tree as tree_lib
    from repro_torch.distributed import make_engine
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh_from_spec
    from repro_torch.models.model import init_params
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_step import loss_and_grads, reduce_grads

    label, arch, mesh_spec, batch_size, extra, steps, layers, _, _ = spec
    argv = dist_argv(arch, mesh_spec, batch_size, extra, steps)
    args = train.parser().parse_args(argv)
    cfg = dist_cfg(arch, layers)
    mesh = make_mesh_from_spec(args.mesh)
    sizes = sh.mesh_axis_sizes(mesh)
    full = init_params(cfg, seed=args.seed, device="cuda")
    engine = make_engine(full, sh.param_specs(full, cfg, sizes), mesh, tensor_parallel=True)
    params = tree_lib.map_with_path(
        lambda k, p: engine.cut(p, engine.pspec_by_path[k]).clone(), full)
    del full
    ctx = sh.make_ctx(cfg, engine, seq=args.seq)
    batch = first_batch(cfg, argv, train._batch_rows(engine, args.batch))
    with recorded_routes() as rec:
        loss, metrics, grads = loss_and_grads(params, batch, cfg, torch.float32, ctx=ctx)
    loss, _ = reduce_grads(engine, loss, metrics, grads, ctx)
    del params, batch
    res = {"loss": float(loss), "tp_bytes": engine.comm.trace.total_bytes("tp")}
    ref = torch.load(ref_path, mmap=True)
    if cfg.num_experts:
        data = sh.data_axes_for(sizes)
        res["routing"] = routing_flips(rec.routes, ref["routes"][engine.comm.index(data)],
                                       cfg.top_k)
    if rank:
        ref = None
    rel = {}
    for k, g in tree_lib.flatten_with_path(grads):
        whole = engine.join(g, engine.pspec_by_path[k], phase="check")
        if rank == 0:
            r = ref["grads"]["/".join(k)].to("cuda")
            rel["/".join(k)] = (float((whole - r).abs().max())
                                / max(float(r.abs().max()), 1e-30))
        del whole
    if rank == 0:
        res["ref_loss"], res["grad_rel"] = ref["loss"], rel
    del grads, ref
    torch.cuda.empty_cache()
    return res


class GuardChecks:
    """Run F's checks of the guarded step on the mesh, made as the launcher
    runs. It wraps the launcher's ``train_step``: each step's state and
    batch are kept just before the step, and its kernel launches counted
    around it. Before the next step (and after the last) the step is
    settled against the state it left: a skipped step must have left every
    state leaf ``torch.equal``; a healthy one is run again without the
    guard (the unguarded mesh step, on the kept state, batch and phase; its
    collectives traced apart, its spans on a bus of its own, its launches
    taken out of the run's), which must give that state bitwise."""

    def __init__(self, train_mod):
        self.train = train_mod
        self.step_fn = train_mod.train_step
        self.pending = None
        self.replay_launches: dict = {}
        self.results = {"healthy": {}, "launches": {}, "skip_equal": {}, "replay_equal": {}}
        train_mod.train_step = self._step

    def close(self) -> None:
        self.train.train_step = self.step_fn

    def _step(self, state, batch, **kw):
        from repro_torch import kernels

        step = state.step
        self.pending = (step, clone_state(state), {k: v.clone() for k, v in batch.items()}, kw)
        before = dict(kernels.launch_counts())
        new, metrics = self.step_fn(state, batch, **kw)
        after = kernels.launch_counts()
        self.results["launches"][step] = sum(v - before.get(k, 0) for k, v in after.items())
        self.results["healthy"][step] = int(metrics["healthy"])
        return new, metrics

    def before_step(self, step, state, batch) -> None:
        self._settle(state)

    def finish(self, run) -> None:
        self._settle(run.state)
        self.results = {k: [v[s] for s in sorted(v)] for k, v in self.results.items()}

    def _settle(self, after) -> None:
        import torch

        from repro_torch import kernels
        from repro_torch.obs import Bus, set_bus

        if self.pending is None:
            return
        step, before, batch, kw = self.pending
        self.pending = None
        if not self.results["healthy"][step]:
            self.results["skip_equal"][step] = states_equal(
                (before.params, before.opt_state), (after.params, after.opt_state))
            return
        trace = kw["engine"].comm.trace
        stamp, trace.step = trace.step, ("unguarded", step)
        bus = set_bus(Bus([]))
        counts = dict(kernels.launch_counts())
        try:
            new, _ = self.step_fn(before._replace(guard=None), batch,
                                  **{**kw, "guard": None, "fault": None})
        finally:
            set_bus(bus)
            trace.step = stamp
        for k, v in kernels.launch_counts().items():
            self.replay_launches[k] = self.replay_launches.get(k, 0) + v - counts.get(k, 0)
        self.results["replay_equal"][step] = states_equal(
            (new.params, new.opt_state), (after.params, after.opt_state))
        del new, before
        torch.cuda.empty_cache()


def dist_checks(rank: int, spec: tuple, out_dir: str) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core import label_tree, muon
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import assert_matches_plan_by_axes, plan_comm, tp_bytes
    from repro_torch.distributed import zero1 as zero1_lib
    from repro_torch.launch import train
    from repro_torch.obs import MemorySink
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_step import loss_and_grads, reduce_grads

    label, arch, mesh, batch, extra, steps, layers, _, _ = spec
    argv = dist_argv(arch, mesh, batch, extra, steps)
    cfg = dist_cfg(arch, layers)
    variant = "normuon" if "normuon" in extra else None
    zero1, flatten = "--zero1" in extra, "--zero1-flatten" in extra
    guarded = "--guard" in extra
    res = {}
    if label in DIST_FP32_RUNS:
        res["fp32"] = dist_fp32_check(rank, spec, os.path.join(out_dir, "fp32_ref.pt"))
    sink = MemorySink()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mem = []
    guard = GuardChecks(train) if guarded else None
    try:
        run = train.run(argv, cfg=cfg, sinks=[sink],
                        on_step=lambda rec: mem.append(torch.cuda.max_memory_allocated()),
                        before_step=guard.before_step if guarded else None)
    finally:
        if guard is not None:
            guard.close()
    if guard is not None:
        guard.finish(run)
        res["guard"] = guard.results
    launches = dict(kernels.launch_counts())
    if guard is not None:
        launches = {k: v - guard.replay_launches.get(k, 0) for k, v in launches.items()}
    res.update({"launches": launches,
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "losses": [r["loss"] for r in run.records],
                "phases": [r["phase"] for r in run.records],
                "healthy": [r.get("healthy", 1) for r in run.records],
                "escalation": [r.get("escalation") for r in run.records],
                "step_wall_s": [r["dur_s"] for r in run.records], "peak_by_step": mem})
    engine, params, ctx = run.engine, run.state.params, run.ctx
    res["tensor_parallel"] = tp = engine.tensor_parallel
    trace = engine.comm.trace
    sizes = engine.axis_sizes
    labels = label_tree(params)
    # The plan reads the leaves' global shapes; the ranks hold shards.
    shapes = tree_lib.map_with_path(
        lambda k, p: torch.empty(engine.full_shape(k, p.shape), device="meta"), params)
    plan = plan_comm(shapes, sh.param_specs(shapes, cfg, sizes), sizes,
                     block_specs=run.block_specs, zero1=zero1, zero1_flatten=flatten)
    data = math.prod(v for a, v in sizes.items() if a != "model")
    res["plan"] = {ph: plan.predicted_bytes(ph) for ph in ("block", "full", "apply")}
    res["tp_pred"] = tp_bytes(cfg, batch // data, DIST_SEQ, sizes)
    shard_bytes = sum(p.numel() * p.element_size() for p in tree_lib.leaves(params))
    # The gradient reduce: every shard (on the replicated path, every whole
    # leaf), then one vector of the loss and its metrics (ce; MoE's
    # load_balance and z_loss; loss).
    n_vals = 1 + 2 + (2 if cfg.num_experts else 0)
    res["grad_reduce_pred"] = shard_bytes + 4 * n_vals if data > 1 else 0
    # The replica gather (the replicated path only): each model-split leaf's
    # fp32 update gathered into the whole leaf.
    res["replica_pred"] = 0 if tp else sum(
        p.numel() * 4 for k, p in tree_lib.flatten_with_path(params)
        if engine.model_split(k, p.dim()))
    res["trace_errors"] = []
    res["per_step"] = []
    res["wall_per_step"] = []
    for step, phase in enumerate(res["phases"]):
        if res["healthy"][step]:
            for phases in (phase, "apply"):
                try:
                    assert_matches_plan_by_axes(trace, plan, phases, step=step)
                except AssertionError as e:
                    res["trace_errors"].append(f"step {step}: {e}")
        else:
            # A step the guard skipped issues no optimizer collective.
            classes = {e.phase for e in trace.select(None, step=step)}
            if not classes <= DIST_SKIP_CLASSES:
                res["trace_errors"].append(f"skipped step {step} issued {sorted(classes)}")
        if guarded and [(e.kind, e.bytes) for e in trace.select("guard", step=step)] != [
                ("all-reduce", 4)]:
            res["trace_errors"].append(f"step {step}: the guard's agreement is not one 4 B "
                                       "all-reduce")
        b = {cls: trace.total_bytes(cls, step=step) for cls in (
            "block", "full", "apply", "grad_reduce", "tp", "norm", "replica_gather", "normuon",
            "guard")}
        res["per_step"].append(b)
        # The full steps' gathers are asynchronous (no wall of their own):
        # the muonbp.full.s<i>.gather spans time them.
        res["wall_per_step"].append({cls: trace.wall_s(cls, step=step) for cls in (
            "tp", "grad_reduce", "apply", "replica_gather")})
        for cls, want in (("tp", res["tp_pred"]), ("grad_reduce", res["grad_reduce_pred"]),
                          ("replica_gather", res["replica_pred"])):
            if b[cls] != want:
                res["trace_errors"].append(f"step {step}: {cls} moved {b[cls]} B, not {want}")
    spans: dict = {}
    for r in sink.records:
        if r.get("event") == "span":
            spans.setdefault(r["name"], []).append(r["dur_s"])
    res["spans"] = spans
    muon_state = run.state.opt_state.inner["muon"]
    res["muon_state_bytes"] = zero1_lib.state_bytes(muon_state)
    # The stacks (ndim >= 3) split over model and ZeRO-1's data axes (a
    # lead dim of 1 stays whole); the 2-D norm gains stay whole.
    label_of = dict(tree_lib.flatten_with_path(labels))
    p_by_key = dict(tree_lib.flatten_with_path(params))
    stacks = [k for k, p in p_by_key.items() if label_of[k] == "muon" and p.dim() >= 3]
    res["muon_stack_bytes"] = sum(muon_state.momentum[k].numel() * 4 for k in stacks)
    res["planned_stack_bytes"] = sum(
        4 * math.prod(engine.local_shape(k, engine.full_shape(k, p_by_key[k].shape)))
        for k in stacks)
    res["unsharded_stack_bytes"] = sum(
        4 * math.prod(engine.state_shape_for(k, engine.full_shape(k, p_by_key[k].shape)))
        for k in stacks)

    # The update on the run's state and fresh gradients (this rank's rows
    # and shards, reduced), joined, against the single-process update on
    # the joined gradients, parameters and state. On the replicated path the
    # rank holds whole leaves, and its updates pay the replica gather.
    if label in DIST_NO_UPDATE_CHECK:
        res["update"] = None
        res["check_peak_bytes"] = torch.cuda.max_memory_allocated()
        return res
    rows = train._batch_rows(engine, batch)
    fresh = next(iter(SyntheticLM(cfg, batch, DIST_SEQ, seed=1)))
    fresh = train.device_batch({k: v[rows] for k, v in fresh.items()}, "cuda")
    loss, metrics, grads = loss_and_grads(params, fresh, cfg, ctx=ctx)
    reduce_grads(engine, loss, metrics, grads, ctx)
    del fresh
    only = lambda t: tree_lib.tree_map(lambda x, l: x if l == "muon" else None, t, labels)
    g_m, p_m = only(grads), only(params)
    del grads
    join = ((lambda k, t: engine.join(t, engine.pspec_by_path[k], phase="check")) if tp
            else (lambda k, t: t))
    whole = ((lambda k, u: join(k, engine.to_param_layout(k, u))) if tp
             else (lambda k, u: engine.replicate(k, engine.to_param_layout(k, u))))
    whole_g = {k: join(k, g) for k, g in tree_lib.flatten_with_path(g_m)}
    whole_p = {k: join(k, p) for k, p in tree_lib.flatten_with_path(p_m)}
    opt_kw = dict(period=5, weight_decay=0.1, block_specs=run.block_specs, variant=variant)
    # The single process keeps no flatten pad: drop the (zero) pad layers.
    full_state = zero1_lib.gather_state(muon_state, p_m, engine, phase="check")
    lead = {k: p.shape[0] for k, p in whole_p.items()}
    unpad = lambda d: d if d is None else {k: v[:lead[k]] for k, v in d.items()}
    full_state = full_state._replace(momentum=unpad(full_state.momentum),
                                     second_moment=unpad(full_state.second_moment))
    if rank:
        del whole_g, whole_p, full_state
    res["update"] = {}
    for phase in ("full", "block"):
        outs = {}
        for schedule in (("pipelined", "barrier") if phase == "full" else ("pipelined",)):
            opt = muon(0.02, 0.02, comm=engine, full_schedule=schedule, **opt_kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upd, _ = opt.update(g_m, muon_state, p_m, phase)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            outs[schedule] = {k: whole(k, u) for k, u in tree_lib.flatten_with_path(upd)}
            res["update"][f"{phase}_{schedule}_ms"] = ms
            del upd
        if "barrier" in outs:
            res["update"]["pipelined_equals_barrier"] = all(
                torch.equal(outs["pipelined"][k], outs["barrier"][k]) for k in outs["barrier"])
            del outs["barrier"]
        got = outs["pipelined"]
        res["update"][f"{phase}_checksum"] = sum(float(v.double().abs().sum())
                                                 for v in got.values())
        if rank == 0:
            ref, _ = muon(0.02, 0.02, **opt_kw).update(tree_lib.unflatten(list(whole_g.items())),
                                                       full_state,
                                                       tree_lib.unflatten(list(whole_p.items())),
                                                       phase)
            err = max(float((got[k].double() - v.double()).abs().max())
                      for k, v in tree_lib.flatten_with_path(ref))
            scale = max(float(v.abs().max()) for _, v in tree_lib.flatten_with_path(ref))
            res["update"][f"{phase}_rel_err"] = err / scale
            del ref
        del got, outs
        torch.cuda.empty_cache()
    res["check_peak_bytes"] = torch.cuda.max_memory_allocated()
    return res


def dist_guard_checks(tag: str, res: list) -> None:
    """Run F: steps 2 and 4 skipped on every rank, each leaving every state
    leaf torch.equal and launching no kernel, step 3 forced full, and each
    healthy step equal to the unguarded mesh step bitwise."""
    want_healthy = [int(t not in DIST_F_SKIPPED) for t in range(len(DIST_F_PHASES))]
    for rank, r in enumerate(res):
        g = r["guard"]
        log(f"[{tag}] rank {rank}: phases {r['phases']}, healthy {r['healthy']}, escalation "
            f"{r['escalation']}, kernel launches a step {g['launches']}")
        if r["phases"] != DIST_F_PHASES or r["healthy"] != want_healthy:
            fail(f"{tag}: rank {rank} ran {r['phases']} with healthy {r['healthy']}, not "
                 f"{DIST_F_PHASES} with {want_healthy}")
        if [r["escalation"][t] for t in DIST_F_SKIPPED] != ["force_full"] * len(DIST_F_SKIPPED):
            fail(f"{tag}: rank {rank}'s escalation {r['escalation']}")
        if (r["phases"], r["healthy"], r["escalation"]) != (
                res[0]["phases"], res[0]["healthy"], res[0]["escalation"]):
            fail(f"{tag}: rank {rank} took other branches than rank 0")
        if g["skip_equal"] != [True] * len(DIST_F_SKIPPED):
            fail(f"{tag}: rank {rank}: a skipped step changed the state ({g['skip_equal']})")
        if any(g["launches"][t] for t in DIST_F_SKIPPED) or not g["launches"][1]:
            fail(f"{tag}: rank {rank}'s kernel launches a step {g['launches']}: a skipped step "
                 "launched, or the healthy block step did not")
        if g["replay_equal"] != [True] * (len(DIST_F_PHASES) - len(DIST_F_SKIPPED)):
            fail(f"{tag}: rank {rank}: a healthy guarded step differs from the unguarded mesh "
                 f"step ({g['replay_equal']})")
    log(f"[{tag}] every rank: steps {list(DIST_F_SKIPPED)} skipped, each leaving every state "
        "leaf torch.equal with no kernel launch and no optimizer collective; step 3 forced "
        "full; each healthy guarded step torch.equal to the unguarded mesh step")


def phase_distributed(smi: str) -> None:
    """Four ranks on the one card, gloo, through the launcher, the dense
    and MoE models tensor-parallel: run A, full-width muonbp-960m at 12
    layers on data=2,model=2 with ZeRO-1, six steps (full, block x4, full),
    after the fp32 step held against one process; run B, NorMuon with the
    flatten fallback at 3 of its 12 layers, two steps; run C, 12 layers on
    model=4, three steps. Run D, mamba2-1.3b at DIST_D_LAYERS layers on the
    replicated path, data=2,model=2 with ZeRO-1, two steps. Run E,
    olmoe-1b-7b at DIST_E_LAYERS layers tensor-parallel, data=2,model=2 with
    ZeRO-1, three steps, after its fp32 step and routing held against one
    process. Run F, the guarded step on the mesh (see
    :func:`dist_guard_checks`). Every rank's exit code is checked. gloo
    copies through the host: its times measure no link."""
    import gc
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    for spec in DIST_RUNS:
        label, arch, mesh, batch, extra, steps, layers, want_tp, required = spec
        t_run = time.perf_counter()
        tag = f"distributed:{label}"
        # The ranks need the card's memory: tensors of earlier phases that
        # only a reference cycle keeps go first, then the parent's cache.
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[{tag}] before the ranks: card {free / 2**30:.2f} GiB free of "
            f"{total / 2**30:.2f}; this process {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        argv = dist_argv(arch, mesh, batch, extra, steps)
        log(f"[{tag}] {DIST_RANKS} ranks (gloo, one card): python -m repro_torch.launch.train "
            f"{' '.join(argv)}" + (f", cfg num_layers={layers}" if layers else ""))
        with tempfile.TemporaryDirectory() as out_dir:
            if label in DIST_FP32_RUNS:
                t0 = time.perf_counter()
                dist_fp32_reference(spec, os.path.join(out_dir, "fp32_ref.pt"))
                gc.collect()
                torch.cuda.empty_cache()
                log(f"[{tag}] fp32 single-process reference step: "
                    f"{time.perf_counter() - t0:.1f} s, freed before the ranks start")
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            # join=True raises if any rank raised or exited non-zero.
            try:
                mp.start_processes(dist_rank, args=(port, spec, out_dir),
                                   nprocs=DIST_RANKS, start_method="spawn", join=True)
            except Exception:
                for r in range(DIST_RANKS):
                    err = os.path.join(out_dir, f"rank{r}.err")
                    if os.path.exists(err):
                        log(f"[{tag}] rank {r} failed:\n{open(err).read()}")
                raise
            res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
                   for r in range(DIST_RANKS)]
        r0 = res[0]
        log(f"[{tag}] losses {r0['losses']} phases {r0['phases']}")
        if any(r["losses"] != r0["losses"] for r in res):
            fail(f"{tag}: the ranks' losses differ: {[r['losses'] for r in res]}")
        if not all(v == v and abs(v) != float("inf") for v in r0["losses"]):
            fail(f"{tag}: non-finite loss")
        if any(r["tensor_parallel"] != want_tp for r in res):
            fail(f"{tag}: {arch} ran " + ("replicated" if want_tp else "tensor-parallel"))
        if "fp32" in r0:
            fp = r0["fp32"]
            loss_rel = abs(fp["loss"] - fp["ref_loss"]) / abs(fp["ref_loss"])
            worst = max(fp["grad_rel"], key=fp["grad_rel"].get)
            log(f"[{tag}] fp32 step on the mesh vs one process: loss {fp['loss']!r} vs "
                f"{fp['ref_loss']!r} (rel {loss_rel:.3e}, tol {DIST_LOSS_TOL:g}); gradients "
                f"joined on rank 0, worst leaf {worst} {fp['grad_rel'][worst]:.3e} of its "
                f"max|grad| (tol {DIST_GRAD_TOL:g}); tp {fp['tp_bytes']} B")
            if any(r["fp32"]["loss"] != fp["loss"] for r in res):
                fail(f"{tag}: the ranks' fp32 losses differ")
            for rank, r in enumerate(res):
                if "routing" in r["fp32"]:
                    rt = r["fp32"]["routing"]
                    log(f"[{tag}] rank {rank} routing vs one process on its data shard: "
                        f"{rt['flips']} of {rt['tokens']} token routings flipped over "
                        f"{rt['layers']} layers" + (f", the widest k-th/(k+1)-th router logit "
                                                    f"gap among them {rt['max_gap']:.3e}"
                                                    if rt["flips"] else ""))
            if not loss_rel <= DIST_LOSS_TOL:
                fail(f"{tag}: the fp32 loss on the mesh disagrees with one process")
            if not fp["grad_rel"][worst] <= DIST_GRAD_TOL:
                fail(f"{tag}: the fp32 gradient of {worst} disagrees with one process")
        log(f"[{tag}] {'tensor-parallel' if want_tp else 'replicated'}; plan_comm a rank: "
            f"{r0['plan']} B; tp_bytes a rank and step {r0['tp_pred']} B; grad_reduce a rank "
            f"and step {r0['grad_reduce_pred']} B; replica gather a rank and step "
            f"{r0['replica_pred']} B")
        if not want_tp and not r0["replica_pred"]:
            fail(f"{tag}: the replicated run predicts no replica gather")
        if "guard" in r0:
            dist_guard_checks(tag, res)
        for rank, r in enumerate(res):
            if r["trace_errors"]:
                fail(f"{tag}: rank {rank}'s trace disagrees: {r['trace_errors']}")
            for step, (phase, b) in enumerate(zip(r["phases"], r["per_step"])):
                if phase == "block" and b["block"] != 0:
                    fail(f"{tag}: rank {rank} block step {step} moved {b['block']} B")
            for name in required:
                if r["launches"].get(name, 0) <= 0:
                    fail(f"{tag}: rank {rank} never launched {name} on the path")
            upd = r["update"]
            if upd is not None and not upd["pipelined_equals_barrier"]:
                fail(f"{tag}: rank {rank}'s pipelined full update differs from the barrier's")
            for phase in ("full", "block") if upd is not None else ():
                if upd[f"{phase}_checksum"] != r0["update"][f"{phase}_checksum"]:
                    fail(f"{tag}: rank {rank}'s {phase} update differs from rank 0's")
            log(f"[{tag}] rank {rank}: peak memory {r['peak_bytes'] / 2**30:.2f} GiB (by step "
                f"{[round(b / 2**30, 2) for b in r['peak_by_step']]}; with the checks "
                f"{r['check_peak_bytes'] / 2**30:.2f} GiB), muon state "
                f"{r['muon_state_bytes']} B, its stacks {r['muon_stack_bytes']} B of "
                f"{r['unsharded_stack_bytes']} B unsharded, launches {r['launches']}, step "
                f"walls {r['step_wall_s']}")
            for step, (b, w) in enumerate(zip(r["per_step"], r["wall_per_step"])):
                log(f"[{tag}] rank {rank} step {step} ({r['phases'][step]}): bytes {b}; "
                    f"collective walls (s, summed, --obs-block) "
                    f"{json.dumps({k: round(v, 4) for k, v in w.items()})}")
            if r["muon_stack_bytes"] != r["planned_stack_bytes"]:
                fail(f"{tag}: rank {rank} holds {r['muon_stack_bytes']} B of the muon "
                     f"stacks' momentum, not its shards' {r['planned_stack_bytes']}")
            if label in DIST_QUARTER_STACKS and (4 * r["muon_stack_bytes"]
                                                 != r["unsharded_stack_bytes"]):
                fail(f"{tag}: rank {rank} holds {r['muon_stack_bytes']} B of the muon "
                     f"stacks' momentum, not a quarter of {r['unsharded_stack_bytes']}")
            if ("train.replica_gather" in r["spans"]) == want_tp:
                fail(f"{tag}: rank {rank}'s spans {'have' if want_tp else 'lack'} "
                     "train.replica_gather")
        for phase in ("full", "block") if r0["update"] is not None else ():
            rel = r0["update"][f"{phase}_rel_err"]
            log(f"[{tag}] {phase} update, 4 ranks vs one process (kernels both): rel {rel:.3e} "
                f"(tol {UPDATE_TOL:g}); {r0['update'][f'{phase}_pipelined_ms']:.1f} ms on the "
                f"mesh" + (f", barrier {r0['update']['full_barrier_ms']:.1f} ms"
                           if phase == "full" else ""))
            if not rel <= UPDATE_TOL:
                fail(f"{tag}: the {phase} update on the mesh disagrees with one process")
        for rank, r in enumerate(res):
            split = {name: [round(v, 4) for v in vals] for name, vals in sorted(r["spans"].items())
                     if name.startswith(("train.", "muonbp."))}
            log(f"[{tag}] rank {rank} spans (s, --obs-block): {json.dumps(split)}")
        log(f"[{tag}] {time.perf_counter() - t_run:.1f} s; times measure no link (gloo copies "
            f"through the host); card: {smi}")
    log(f"[distributed] phase {time.perf_counter() - t_phase:.1f} s")


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
    phase_train_moe(device["smi"], errors)
    phase_resilience(device["smi"])
    phase_reference()
    phase_serve(device["smi"])
    phase_serve_moe(device["smi"])
    phase_train_ssm(device["smi"], errors)
    phase_serve_ssm(device["smi"])
    phase_archs(device["smi"])
    phase_distributed(device["smi"])
    rows = phase_times(errors, launches)
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    print(device["smi"], flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                             "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
