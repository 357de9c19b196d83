"""Smoke run of the PyTorch/CUDA port (`vibo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):
  1. device: a CUDA card is required (no CPU fallback);
  2. build: nvcc compiles every csrc/*.cu of the port, in parallel, and the
     special-function (MUFU) instructions a cell of each loglik kernel are
     counted in the libraries' SASS (cuobjdump);
  3. kernel checks: each hand-written kernel against its plain PyTorch
     version on the card, with CUDA-event times of the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call (timed only, never used by the port), for the 2PL and the 3PL
     link: the full-batch kernels at the flagship shape (10,240 students x
     1,024 items, K=4, hidden 256), the general masked loglik (both cell
     readers, a non-uniform cotangent, all-missing rows exactly inert) at
     the minibatch shape (4,096 x 1,024) as the ELBO steps call it, with the
     IWAE steps' 5 samples, and on the padded last batch, and all of them at
     a ragged shape and at K = 1 and 8 with M off the vector width, the
     masked loglik also with a leading sample axis and shared items, and
     both directions at their item split's edge (4,000 x 700: the last
     split shorter, B off the block; also with 2 samples), each direction's
     main kernel and second pass timed apart at the minibatch and a second
     launch of each bitwise equal to the first; the
     one-pass kernels also at the edges of their item split (M off the
     split's width, K = 4 and 12 at 777 x 301, all-missing student rows,
     which must give exactly 0 ll and dtheta, 10,240 x 700 with the last
     split shorter, 40 students), their main kernel and second pass timed
     apart at the flagship, a second launch bitwise equal to the first; the
     3PL kernels also at the extreme point theta = +-30, g_hat = -25; the GRM
     and the GPCM one-pass kernels (C = 5) at the flagship on each family's
     own data, at the ragged shape, at K = 1, 4, 8 and 12 with M off the
     vector width, at the split's edges, at C = 3, 5, 8 (both families'
     compile-time C), 9, 16, 17 and 32 (the run-time C), each check naming
     the link its kernel ran (from the profiler), through their autograd
     op with a
     non-uniform cotangent and with a sample axis of 3 (per-sample and
     shared items), and at the extreme points (|theta . a| beyond the
     clamp, a collapsing category, every cell in the first and in the last
     category); the first layer's two kernels in both modes (bf16, and f32
     against exact f32 products) at the flagship (timed beside the matmul of
     the decoded code, and each launched FIRST_LAYER_REPEATS times on one
     input, every launch bitwise equal to the first), at H = 512, at config 5's 5,520 x 680, at the
     ragged and the odd shape at H = 256 and 20, and on the GRM flagship's
     graded code, meeting all three code readers; every loglik kernel at K
     = 9, 12 and 16 (the wide variant) on the ragged shape; the deep-link kernel (csrc/deep_link.cu) at paper config 5
     (5,520 x 680, K = 2, link width 128, on its own code), at 10,240 x
     1,024 with K = 4, at 777 x 301 with K = 1 and 8, at widths 256, 384
     and 512 (the cluster kernel, each timed on config 5), through its
     autograd op (a non-uniform cotangent, a sample axis of 3 with per-
     sample and shared d) against the CPU, at the extreme points
     (|logit| > 30, rows with no observed cell, every cell right or wrong),
     at width 640 (the kernel's wide variant) on 777 x 301, and at width
     256 on 777 x 301 over 8 draws of its own (each s_theta and s_d row
     past 1e-4 explained by the relu flips its pairs can carry, counted in
     f64); every deep check launches the kernel twice, bitwise equal;
     the deep link's f32 kernel (csrc/deep_link_f32.cu, row 15f, the deep
     HMC potential's: split-bf16 products on the tensor cores at H = 128
     and, on a thread-block cluster, 256-512, whose SASS must hold HMMA
     lines) against the plain f32 version at the deep gold's 2,000 x 200
     with 4 chains on one code and at config 5 (both timed, beside the
     CUDA-core f32 bound and the split's), at 777 x 301 (K = 1, 8, empty
     rows), 40 students, at the deep gold's shape at widths 256, 384 and
     512 (timed), at 777 x 301 at 256 and 384 and at 300 x 200 at 512, a
     second launch of each bitwise equal to the first, with the pre2
     values the kernel recomputed in f64 (hinge_recomputes);
  4. small-shape checks of the packed ELBO, the decoded-data ELBO and the
     packed IWAE terms (S = 3, a fixed non-uniform cotangent a sample) and
     every gradient on the card against the CPU path, per link (deep: the
     one-pass op on the packed paths);
  5. full-batch path, per link: the flagship (bf16 encoder, conditional
     posterior) with the 2PL, the 3PL (theta transposed), the GRM and the
     GPCM (C = 5, theta (B, K)) link trains 40 steps through Trainer.step,
     launching the first layer and its link's one-pass loglik (once a
     step) and no other loglik kernel; then held-out imputation accuracy
     and AbilityScorer.score on fresh students (grm/gpcm: (B, M, C)
     category probabilities), and a torch.profiler window: device time by
     kernel; then the 2PL flagship at compute_dtype float32 (JAX's CLI
     configuration), 10 steps launching the f32 first layer and the 2PL
     one-pass loglik once a step;
  6. minibatch path, per link: Trainer.fit with batch_size 4,096 (3 steps
     an epoch, the last padded with 2,048 all-zero rows) trains 4 epochs on
     decoded data with the ELBO, launching its link's masked loglik (dense
     reader, once a step; grm/gpcm: no loglik kernel, as in JAX) and no
     other loglik kernel, then 3 IWAE steps (S = 5); the fit's host work
     (batch slicing, copy to the card) timed on its own, step times on
     device-resident batches and a profiler window;
  7. held-out IWAE-100 log-likelihood of the trained params (iwae_loglik).
Then config 5 (the deep link on the WordBank surrogate, the nonlinear
family): 40 full-batch steps with the one-pass deep kernel (launching the
first layer and deep_link_train once a step, nothing else), imputation and
scoring of 256 new students; 10 steps of JAX's default (the decoded code
and the plain link: the first layer only) with both step medians; 4
minibatch epochs at 4,096 (2 steps, the second padded with 2,672 empty
rows) and 3 IWAE steps (S = 5) on the plain link (no kernel at all), the
held-out IWAE-100 with its peak memory; profiles of the three; 5 fused
steps at link width 384 (the deep kernel's cluster of 8). Then the HMC
baseline (vibo_tpu_torch/models/hmc.py, fixed trajectories, 4 chains,
target accept 0.65), each run through run_hmc (its iterations replayed
from CUDA graphs, hmc.Sampler; the MAP init one graph) with its kernel
launched once a chain each potential evaluation and no other kernel: the
flagship gold (simulate_irt("2pl", 10,240, 1,024, K = 4, seed 0), 10 %
held out, row 4; 200 + 200 iterations at 64 leapfrogs) and the GRM gold
(2,000 x 100, K = 1, C = 5, the dense potential; 100 + 100 at 32) held
against the
JAX package's posteriors in artifacts/gold (theta-mean Pearson after
Procrustes >= 0.99, held-out accuracy within 0.003 / 0.01), short runs
of 1PL and 3PL (rows 4, 9) and of the opt-in GRM and GPCM kernels (rows
13, 14), and a decoder trained by Trainer.fit on synthetic-nonlinear
2,000 x 200 sampled through the dense deep potential and row 15f, and
one of link width 256 through row 15f (its cluster kernel); every
kernel potential held against the dense one (value, per-person loglik
and gradients, at the MAP and one sd off it, per-chain items); each
probed path with its hmc_graph gate (the sampler's graphs against its
eager steps from one state and generator seed over 6 iterations that
cross the warm-up's flags: every output and the end state bit for bit,
the replays under torch's sync debug mode "error"), the MAP's graph
against its eager Adam steps bit for bit on the k4, GRM and dense deep
paths, ms a potential evaluation, ms an iteration replayed beside the
eager one, and a profiler window of replays: busy and idle shares and
kernel calls an iteration. Then NUTS (trajectory="nuts", tree depth 7,
target 0.8) against the JAX package's NUTS golds at 2,000 x 200 (their
800 + 1,200 cut): k2-nuts (2PL, K = 2, row 4 through the chain axis,
launched once a chain each evaluation its trees took; 100 + 100),
grm-k2 and grm-k4 (C = 5, the dense potential; 50 + 50), each gated on
the theta means, a's means after theta's rotation and b's means (grm:
the threshold tables) at Pearson >= 0.99 and held-out accuracy within
0.01, k2-nuts and grm-k2 probed (hmc_graph: at most one host sync a tree
depth, the leaves the masked subtrees ran against those the eager loop
needed; evaluations and host syncs an iteration, busy and idle; whole
subtrees against blocks of 8 leaves on the same draws); and
the MLE/MAP baseline (fit_mle, 500 Adam steps) on k2-nuts's data, its
objective falling, with the card held against the CPU at 300 x 200; the EM
phases and checkpoint_resume. Then the command line (`vibo_tpu_torch.cli`),
as a user runs it: cli_cfg1, `python -m vibo_tpu_torch.cli train
synthetic-1pl ...` (cfg 1) in a process of its own with --out-dir and
--profile, its summary gated against the JAX CLI's run of the command and
its own trace naming the f32 first layer's kernels and the 2PL one-pass
kernel; cli_score, `score` from that best.npz on 256 new students (.npz
bitwise equal to AbilityScorer.from_checkpoint's scores, the same students
as a long CSV bitwise equal to the .npz, --refine-theta 50 finite);
cli_compare_grm, the GRM parity sweep in process (VIBO with rows 1f, 2f
and 13, MLE, EM, the HMC row a hit of the committed artifacts/gold/grm
cache that changes nothing there), each row gated against the JAX
package's recorded run; cli_deep, the deep command (plain link, no kernel;
IWAE-100 and the Laplace widths through the link's Jacobian); cli_items,
`train synthetic-2pl ... --item-encoder --eval-new-items 0.1` in process
(rows 1f, 2f and 3; held-out and new_item_acc gated on the JAX CLI's seed
spread, tests/cli_reference.jsonl) and `score --items` of its held-out
columns from its best.npz (bitwise equal to AbilityScorer.score_items, no
kernel); cli_k2nuts, the k2-nuts sweep (run_benchmark_configs.sh:104-111:
stats + laplace-w, rows 1f, 2f and 4; MLE, EM, the HMC row from the
committed artifacts/gold/k2-nuts), every VIBO key gated on the JAX CLI's
seed spread. Then the kernels summary line (each entry with its launches
in the in-process CLI phases and its device calls in cfg 1's trace), the
card's name and power limit, and the final status line {"ok": true,
"device": {...}}.

Fused phases (`fused`): after its eager phase, each full-batch path (the
2PL, 3PL, GRM and GPCM flagships, the 2PL at f32, config 5's one-pass
deep step and JAX's default deep route) trains through Trainer.fit with
fuse_epochs, each eval interval's steps one CUDA graph: 40 epochs at
eval_every 10 (the default deep route 10 at 5), every held-out accuracy
in [0, 1], the ELBO rising where the eager phase asserts it and its
trajectory beside the eager phase's (same init, seed and noise); then
FUSED_REPLAYS replays of a FUSED_CHECK_LEN-step graph held against eager
steps fed each replay's noise (params, Adam's state and aux bitwise
equal, every step's noise new), a chunk's replays timed by CUDA
events beside the eager steps' median, and a profiler window of replays
in which each kernel of DEVICE_KERNELS (the wrappers' main kernels and
the kernels they launch beside them) runs as many times a step as in a
window of eager steps of the same model, where each path kernel's calls
equal its wrapper's launches (the launch counters do not see replays).
The profile windows also give the device records' union on the timeline
beside their sum. Each link's flagship and config 5 run it
again with the IWAE bound (S = 5, 10 epochs at 5). Before them the card's
capturable Adam is held against the plain form.

The posterior families (`family` lines, after the fused paths): the K = 4
commands' width (10,240 x 1,024, K = 4, hidden 512, S = 5, f32 first
layer) on the 2PL flagship's data under stats + chol, stats + laplace,
stats + laplace-w and the item encoder (diagonal), and on the 3PL
flagship's under stats + chol: the packed objectives with the kernels
against the dense ones on the card at 300 x 200 (1e-4), then fused_phase
at 20 epochs of chunks of 2 (its profiler window one chunk), and the
one-pass op's launches by layout: row 4 (theta (B, K)) only under chol
and laplace (the 3PL's row 9), row 3 (theta (K, B)) only under the item
encoder.

The at-scale pipeline (`vibo_tpu_torch/scripts/run_at_scale.py`): a
kernel check at its shape (rows 1-2 bf16 at hidden 256 and row 3 at K = 1
on a random int8 code of 135,800 x 2,048 at 4 % density from a numpy seed,
timed, the tolerances of the flagship checks), and `at_scale` (after
`decoded_fused`): run() at the reference script's bounded size (2 M rows,
30,000 users, 2,048 lexemes, hidden 256, S = 5, 300 epochs in chunks of
100, IWAE-100) through a CSV it writes under build/; after its training,
rows 1-3 held against their plain versions on the run's own code (~29,100
x 2,048, the shape it drives, the same tolerances); gated on the ELBO
rising over the chunks, held-out accuracy >= base rate + 0.01, new-person
accuracy >= base rate - 0.05 (tests/test_at_scale.py's gates), IWAE a
cell in (-1, 0), and a profiler window of one chunk's replay in which
rows 1-2 run once a step (the encoder once, on the samples' axis, as
JAX's vmap runs it) and row 3 S times (once a sample), and no other
kernel of DEVICE_KERNELS beside their prologue and second pass. Its
checks draw from a generator of their own.

The decoded full batch and the mesh: `decoded_fused` (after the
fused paths) is fused_phase on fit(packed=False) at the 2PL flagship: each
chunk one CUDA graph of the decoded steps (rows 5-6, the dense reader,
once a step, no first-layer kernel), graph against eager bitwise. After
checkpoint_resume, `mesh_nccl`: a world of one NCCL rank in process
(a FileStore under build/), make_mesh, a 20-epoch fit of the 2PL flagship
through the mesh (eager steps) against the same fit without it (ELBOs and
params within 1e-6; bitwise reported), rows 1-3 once a step in a profiler
window of mesh steps (a window that lost a record opened again, each
window's records in the order they ran). `mesh_gloo2`: two ranks spawned
on the card over gloo (NCCL takes one rank a card), each holding only its
tile: the 2PL flagship's students-only step (2 x 1) and 2D step (1 x 2),
at f32 and at bf16, the 2D step at f32 of the GRM, 3PL and GPCM flagships
(rows 13, 9, 14) and at bf16 of config 5's deep model (row 15), from the state
after MESH_GLOO_WARMUP one-rank steps, held against the ordinary packed
step on one rank (no mesh, no tile code): the ELBO within 5e-5; at f32 the
params after the Adam steps within rtol 5e-4 and atol 5e-6; at bf16 one
step's raw gradient and the params after the steps, leaf by leaf, no
further from the one-rank run than the one-rank run at bf16 is from the
same run at f32 (MESH_BF16_GRAD_SHARE, MESH_BF16_PARAM_SHARE); the two
ranks' params identical, each rank's launches a step counted.

Bounds: the largest of three times, each at the H100 SXM's published peak:
the bytes the function must move over 3.35 TB/s of HBM; its operations
over 989 TFLOP/s bf16 on the tensor cores (first layer) or 67 TFLOP/s f32
outside them (loglik); and its special-function results (exp, log, the
reciprocals: the MUFU instructions counted in the SASS, a cell's times the
cells plus the per-item staging's once per item) over 16 a clock an SM, at
this card's SM count and maximum SM clock. A GPCM cell at C <= 8 has its
exponentials unrolled (C a template argument); above, they run in loops
over the C categories, so those MUFU.EX2 lines count C times a cell; a GRM
item stages its table in C + 1 steps, or at C <= 8 in C slots of the
prologue (grm_table_kernel), and a GRM cell counts GRM_CELL_MUFU, the
function's special functions whatever kernel computes it (the SASS's
count beside it), as a 2PL training cell counts TRAIN_2PL_CELL_MUFU and
a 2PL masked forward cell MASKED_FWD_2PL_CELL_MUFU. The
build phase also prints each one-pass kernel's and the masked forward's
and VJP's registers, spills and blocks an SM; the deep kernel's (and at
H = 256, 384, 512 its cluster size and resident clusters) are in its
timed checks. The deep kernel's operations are the larger of its three
products on the bf16 tensor cores (6 H^2 a pair at 989 TFLOP/s) and its
f32 work outside them (DEEP_PAIR_OPS a pair at 67 TFLOP/s); its MUFU
lines run once a pair (at H = 128 a lane's serve two; in the cluster
kernel each of a pair's lanes in every CTA runs them for the pair: the
bound counts them once).
"""

from __future__ import annotations

import itertools
import json
import re
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
MUFU_PER_CLOCK_PER_SM = 16                # compute capability 9.0

B, M, K, H = 10240, 1024, 4, 256          # flagship shape (bench.py)
C = 5                                     # categories (bench.py grm/gpcm)
BATCH = 4096                              # minibatch (cli.py --batch-size)
RAGGED = (1000, 300)                      # students, items: edge masking
ODD = (777, 301)                          # M off the 4-item vector width
STEPS = 40                                # full-batch steps
EPOCHS = 4                                # minibatch epochs (3 steps each)
IWAE_STEPS, IWAE_S = 3, 5                 # IWAE training steps, samples
FIRST_LAYER = ("first_layer_fwd", "first_layer_bwd")
FIRST_LAYER_F32 = ("first_layer_fwd_f32", "first_layer_bwd_f32")
F32_STEPS = 10                            # full-batch steps at f32 (JAX's CLI)
WIDE_K = (9, 12, 16)                      # K past the instantiated 1..8
CLUSTER_H = (256, 384, 512)               # deep widths of the cluster kernel
DEEP_WIDE_H = 640                         # a deep width of the wide variant
FAMILIES = ("grm", "gpcm")                # the polytomous links
GPCM_FIXED_C = 8                          # GPCM's compile-time C up to here
SPLIT_TAIL = (10240, 700)                 # 6 item splits, the last shorter
TINY = (40, 130)                          # fewer students than one block
# each link's kernels: the one-pass training loglik (full batch) and the
# general masked loglik's two directions (minibatch; the polytomous
# families have none, as in JAX)
LINK_KERNELS = {
    link: {"train": f"loglik_{link}_train",
           "masked": () if link in FAMILIES else (
               f"masked_loglik_{link}_fwd", f"masked_loglik_{link}_bwd")}
    for link in ("2pl", "3pl", *FAMILIES)}
# f32 operations a cell, from the cell math (csrc/irt_links.cuh,
# csrc/loglik_grm.cu, loglik_gpcm.cu), of K and C: the one-pass kernel, the
# masked forward and the masked backward
CELL_OPS = {"2pl": (lambda k, c: 6 * k + 16, lambda k: 2 * k + 9,
                    lambda k: 6 * k + 10),
            "3pl": (lambda k, c: 6 * k + 45, lambda k: 2 * k + 25,
                    lambda k: 6 * k + 40),
            "grm": (lambda k, c: 6 * k + 50,),
            "gpcm": (lambda k, c: 6 * k + 16 * c + 16,)}
# paper config 5 (`train wordbank --irt-model deep --ability-dim 2`): the
# WordBank surrogate's 5,520 students x 680 items, K = 2, item latent 16,
# link width 128 (vibo_tpu/cli.py, vibo_tpu/data/loaders.py)
DEEP_B, DEEP_M, DEEP_K, DEEP_D, DEEP_H = 5520, 680, 2, 16, 128
DEEP_DRAWS = 8                  # draws of the H = 256 check at ODD
DEEP_STEPS, DEEP_DEFAULT_STEPS = 40, 10   # fused, JAX-default full batch
# f32 operations a pair of the deep kernel outside the tensor cores, from
# csrc/deep_link.cu (the same work in the WMMA kernels and the mma.sync one
# at H = 128): per hidden column 2 (h1) + 4 (logit) + 7 (dpre2, db2, dwo) +
# 4 (mask, s_theta, s_d); per pair ~20 (the logit's reduction, ll, dlogit,
# dbo)
DEEP_PAIR_OPS = lambda h: 17 * h + 20   # noqa: E731
# the special functions a pair of the deep link needs (exp, log1p and the
# reciprocal of 1 + e): row 15f's bound
DEEP_F32_PAIR_MUFU = 3
# Row 15f's split at H = 128 (csrc/deep_link_f32.cu): each of the three
# products as six bf16 part products on the tensor cores (36 H^2 operations
# a pair), and outside them the split of h1 and dpre2 into three parts
# (~5.5 operations a value, 2 H values a pair) and the f32 add of each
# k-step's fresh product into its running sum (H^2 / 16 a pair for each
# product)
DEEP_SPLIT_PAIR_TC_OPS = lambda h: 36 * h * h   # noqa: E731
DEEP_SPLIT_PAIR_OPS = lambda h: 11 * h + 3 * h * h // 16   # noqa: E731
# row 15's kernel at width h, as its SASS names it
DEEP_KERNEL = lambda h: (   # noqa: E731
    "deep_link_kernelILi128E" if h == 128 else
    f"deep_link_cluster_kernelILi{h}E" if h in CLUSTER_H else
    "deep_link_wide_kernelILi32E")
# row 15f's kernel at width h, as its SASS names it: the split on the
# tensor cores at 128 and (a thread-block cluster) 256-512, f32 on the CUDA
# cores wider
DEEP_F32_KERNEL = lambda h: (   # noqa: E731
    "deep_link_f32_mma_kernel" if h == 128 else
    f"deep_link_f32_cluster_kernelILi{h}E" if h in CLUSTER_H else
    "deep_link_f32_kernelILb1EE" if h <= 384 else "deep_link_f32_kernelILb0EE")
# the widths of row 15f's split (HMMA lines in their SASS)
DEEP_SPLIT_H = (128, *CLUSTER_H)
# The HMC baseline (vibo_tpu_torch/models/hmc.py, fixed trajectories). The
# golds under artifacts/gold were sampled by the JAX package with 800
# warm-up and 1,600 draws a chain at 64 leapfrogs
# (scripts/run_benchmark_configs.sh:43-50, :98-102); the smoke cuts each
# gold's depth to HMC_GOLD_DEPTH (warm-up, draws, leapfrogs; NUTS golds:
# warm-up, draws; the smallest depth of hmc_depth.py's sweep that held
# every gate with margin), widths and data unchanged. A short run:
# HMC_SHORT.
# The NUTS golds (k2-nuts, grm-k2, grm-k4: 2,000 x 200, 800 + 1,200
# iterations at tree depth 7, target 0.8; run_benchmark_configs.sh:103-147)
# are cut to (warm-up, draws) at their tree depth and target.
GOLD_DIR = Path(__file__).resolve().parent / "artifacts" / "gold"
HMC_CHAINS, HMC_TARGET = 4, 0.65
NUTS_TREE_DEPTH, NUTS_TARGET = 7, 0.8
# the smoke's depths, raised when the sampler became CUDA graphs (an
# iteration 5-140 ms replayed where it took 89-766 eager; hmc_depth.py's
# sweep on the card: k4 R-hat 1.184 at 200 + 200 and 1.021 at the gold's
# own 800 + 1,600 in 124 s, every run of it within its gates). Before: k4
# 20 + 20, grm 30 + 30, k2-nuts and grm-k2 15 + 15 for the 600 s budget
# of the eager sampler, and grm-k4 in hmc_depth.py only
HMC_GOLD_DEPTH = {"k4": (200, 200, 64), "grm": (100, 100, 32),
                  "k2-nuts": (100, 100), "grm-k2": (50, 50),
                  "grm-k4": (50, 50)}
NUTS_GOLDS = {"k2-nuts": ("2pl", 2), "grm-k2": ("grm", 2),
              "grm-k4": ("grm", 4)}              # link, K at 2,000 x 200
# the smoke's NUTS golds (grm-k4 since the sampler's graphs; until then
# in hmc_depth.py only, for the 600 s budget) and those probed (grm-k4's
# dense potential and NUTS path are grm-k2's)
SMOKE_NUTS_GOLDS = ("k2-nuts", "grm-k2", "grm-k4")
PROBED_NUTS_GOLDS = ("k2-nuts", "grm-k2")
NUTS_GOLD_SHAPE = (2000, 200)
HMC_SHORT = (20, 20, 16)
HMC_PEARSON_MIN = 0.99                    # posterior means vs a gold's
HMC_ACC_TOL = {"k4": 0.003, "grm": 0.01,  # held-out accuracy vs a gold's
               "k2-nuts": 0.01, "grm-k2": 0.01, "grm-k4": 0.01}
# MLE/MAP on k2-nuts's data: the CLI's steps (cli.py:926); the card against
# the CPU from one start at MLE_CPU_SHAPE for MLE_CPU_STEPS steps
MLE_STEPS, MLE_CPU_SHAPE, MLE_CPU_STEPS, MLE_CPU_TOL = 500, (300, 200), 50, 1e-4
# The EM baseline (vibo_tpu_torch/models/em.py). em_flagship: the CLI's
# `baseline synthetic-2pl --num-persons 10240 --num-items 1024 --method em`
# data, held against the JAX package's fit_em on the CPU (EM_REFERENCE,
# tests/em_reference.py; a, b and theta_eap within EM_REF_TOL of the larger
# of 1 and the reference's largest magnitude, the log marginal within
# EM_LL_RTOL, the iterations within 1) and, like em_grm and em_k2, against
# the JAX package's recorded runs (RESULTS.md:185, :693, :838): held-out
# accuracy within EM_ACC_TOL; theta against the truth within EM_ACC_TOL of
# its Pearson, or against the gold at least EM_GOLD_MIN. em_k4: finite, the
# log marginal never falling by more than EM_RISE_SLACK of itself.
# em_card_vs_cpu: EM_CPU_ITERS iterations at EM_CPU_SHAPE on the card and
# on the CPU, every output within EM_CPU_TOL of the larger of 1 and its
# largest magnitude, the iterations equal.
EM_REFERENCE = (Path(__file__).resolve().parent / "artifacts" / "em"
                / "flagship_2pl_k1.npz")
EM_REF_TOL, EM_LL_RTOL, EM_ACC_TOL, EM_RISE_SLACK = 1e-3, 1e-5, 0.005, 1e-6
EM_RESULTS = {"em_flagship": {"heldout_acc": 0.6842, "theta_pearson": 0.9783},
              "em_grm": {"heldout_acc": 0.4527},
              "em_k2": {"heldout_acc": 0.7195}}
EM_GOLD_MIN = {"em_grm": {"theta": 0.999},
               "em_k2": {"theta": 0.995, "b": 0.999, "a": 0.995}}
EM_CPU_SHAPE, EM_CPU_ITERS, EM_CPU_TOL = (300, 200), 10, 1e-4
EM_CPU_CASES = (("1pl", 1), ("2pl", 1), ("2pl", 2), ("2pl", 4), ("3pl", 1),
                ("grm", 1), ("gpcm", 1))
# checkpoint_resume: the 2PL flagship fitted RESUME_EPOCHS, saved, resumed
# for RESUME_EPOCHS more, against one fit of twice as many (eval_every
# FUSED_EVAL_EVERY)
RESUME_EPOCHS = 20
# the fixed-trajectory probe: warm-up, timed and profiled iterations (2,
# 5, 3 until the families and their CLI phases joined the 600 s budget;
# 1, 2, 2 until the 3PL family and the 3PL, GPCM and deep tiles did; 1, 1,
# 1 until the iterations were graph replays of 5-140 ms; the window two,
# so that its chunk replays a graph twice)
HMC_PROBE_ITERS = (1, 5, 2)
# NUTS's probe: warm-up, timed and profiled iterations (a saturated
# depth-7 iteration holds 16,000-33,000 device records, more than 3 of the
# k4 flagship's fixed ones; 1, 2, 1 until PR 19)
NUTS_PROBE_ITERS = (1, 1, 1)
# hmc_graph: the warm-up flags of the graph-vs-eager iterations (adapt,
# collect, switch a row): a window of 4 draws, its metric switch, a draw
# past warm-up
HMC_GRAPH_FLAGS = ((1, 1, 1, 1, 1, 0), (1, 1, 1, 1, 0, 0),
                   (0, 0, 0, 1, 0, 0))
HMC_GRAPH_SEED = 7
HMC_FLIP_BOUND = 4e-4                     # a relu flip's gradient row, of
                                          # the largest magnitude (4 x 1e-4)
# the deep gold's shape (synthetic-nonlinear 2,000 x 200, K = 2; D = 16,
# H = 128 as config 5's decoder) and the decoder's fused training epochs
DEEP_GOLD_B, DEEP_GOLD_M, DEEP_DECODER_EPOCHS = 2000, 200, 200
# a wider decoder's HMC through row 15f: its width and depth (warm-up,
# draws, leapfrogs). At HMC_SHORT's 20 warm-up iterations the kernel
# route's chains diverge in the last step-size window and its draws accept
# none; from the same state and noise the dense potential diverges alike
# and accepts none of those draws either (`hmc_depth.py deep-H256`, which
# also runs both routes at 20, 30 and 50): at 50 both routes accept
DEEP_HMC_WIDE_H, DEEP_HMC_WIDE_DEPTH = 256, (50, 20, 16)
GRM_GOLD = (2000, 100)                    # the GRM gold's students, items
# the loglik kernels of DEVICE_KERNELS (the others are their helpers)
LOGLIK_DEVICE_KERNELS = ("loglik_2pl_train", "loglik_3pl_train",
                         "loglik_grm_train", "loglik_gpcm_train",
                         "deep_link_train", "deep_link_f32_train")
# cells one thread covers in one pass of a kernel's unrolled tile loop
# (students per warp x items per lane, csrc/loglik_tile.cuh)
CELLS_PER_PASS = {"loglik_train_kernel": 4 * 2, "loglik_2pl_kernel": 4 * 2,
                  "loglik_categorical_kernel": 4 * 2,
                  "masked_fwd_kernel": 4 * 2, "masked_bwd_kernel": 4 * 2}
# The special functions a 2PL training cell needs: exp and a reciprocal, as
# JAX's cost estimate counts them (transcendentals = 2 B M,
# vibo_tpu/ops/pallas_elbo.py:1274). The 2PL kernel (loglik_2pl_kernel)
# issues three (ex2, rcp and an lg2 for log1p); the bound reads the
# function's work, so it keeps this count and prints the SASS's beside it.
TRAIN_2PL_CELL_MUFU = 2
# Likewise the 2PL masked forward: one a cell (transcendentals = B M,
# vibo_tpu/ops/pallas_elbo.py:270), where its kernel issues two (ex2, lg2).
MASKED_FWD_2PL_CELL_MUFU = 1
# The special functions a GRM cell needs, as the run-time-C kernel issues
# them (its SASS: two exp and four reciprocals). The compile-time-C kernel
# computes the same function with fewer (one reciprocal for both sigmoids,
# one for both dkappa ratios); the bound reads the function's work, not the
# implementation's, so it keeps this count and prints the SASS's beside it.
GRM_CELL_MUFU = 6
GRM_FIXED_C = 8                           # GRM's compile-time C up to here
MASKED_SPLIT_TAIL = (4000, 700)           # masked loglik: 6 splits, the last
                                          # shorter; B off the 64-student block
# the kernel of each one-pass or masked call and its second pass (and the
# GRM prologue), told apart in a profiler window
# A profiler window closed right after its last launch completes now and
# then keeps none or only the first of its launches' records; held open
# PROFILER_PAD_S before its first launch and after its synchronize, it
# keeps them all. So every window is padded; the mean is taken over the
# records kept all the same, and a window that kept no record of a kernel
# it must show is taken again, up to PROFILER_TRIES times.
PROFILER_PAD_S = 0.02
PROFILER_TRIES = 5
LINK_OF_KERNEL = r"loglik_categorical_kernel<vibo::(\w+(?:<\d+>)?)"
PASS_KERNELS = (("reduce_ms", "sum_rows_kernel"),
                ("prologue_ms", "grm_table_kernel"),
                ("main_ms", r"loglik_(train|2pl|categorical)_kernel"
                            r"|masked_(fwd|bwd)_kernel"))
# The fused full-batch path (Trainer.fit under fuse_epochs: each eval
# interval's steps one CUDA graph). Its kernels run as graph replays, which
# the launch counters do not see (_build.Kernel), so a fused phase counts
# each kernel below by its device name in a profiler window of replays and
# in one of eager steps: the calls a step must be equal, and each path
# kernel's eager calls equal to its wrapper's launches. The first block is
# each wrapper's main kernel, the second the kernels a wrapper launches
# beside it.
DEVICE_KERNELS = {
    "first_layer_fwd": r"first_layer_fwd_kernel<1>",
    "first_layer_bwd": r"first_layer_bwd_kernel<1>",
    "first_layer_fwd_f32": r"first_layer_fwd_kernel<3>",
    "first_layer_bwd_f32": r"first_layer_bwd_kernel<3>",
    "loglik_2pl_train": r"loglik_2pl_kernel<",
    "loglik_3pl_train": r"loglik_train_kernel<vibo::Link3PL",
    "loglik_grm_train": r"loglik_categorical_kernel<vibo::LinkGRM",
    "loglik_gpcm_train": r"loglik_categorical_kernel<vibo::LinkGPCM",
    "deep_link_train": r"deep_link_(cluster_)?kernel<",
    "deep_link_f32_train": r"deep_link_f32_(mma_|cluster_)?kernel[<(]",
    "masked_loglik_2pl_fwd": r"masked_fwd_kernel<vibo::Link2PL",
    "masked_loglik_2pl_bwd": r"masked_bwd_kernel<vibo::Link2PL",
    "first_layer_prep": r"prep_kernel<1>",
    "first_layer_prep_f32": r"prep_kernel<3>",
    "sum_rows": r"sum_rows_kernel",
    "grm_table": r"grm_table_kernel",
    "deep_link_reduce": r"deep_link_reduce_kernel",
    "deep_link_f32_reduce": r"deep_link_f32_reduce_kernel"}
EAGER_COUNT_STEPS = 2                     # eager steps of a counting window
# objective_matches_cpu's IWAE cotangent, one weight a sample
IWAE_COTANGENT = (0.5, 0.3, 0.2)
# epochs and eval_every of the ELBO phases and of the default deep route's;
# epochs, eval_every and samples of the IWAE phases
FUSED_EPOCHS, FUSED_EVAL_EVERY = 40, 10
DEEP_DEFAULT_FUSED = (10, 5)
IWAE_FUSED = (10, 5, 5)
# graph against eager: FUSED_REPLAYS replays of a FUSED_CHECK_LEN-step graph,
# each replay's noise then fed to as many eager steps on a copy of the state
FUSED_REPLAYS, FUSED_CHECK_LEN = 5, 2
FUSED_TIMED_REPLAYS = 5                   # of a chunk, timed by CUDA events
# the first layer's kernels at the flagship: launches on one input, each
# bitwise equal to the first, in each mode
FIRST_LAYER_REPEATS = 200


def ptxas_lines(log: str) -> list:
    """ptxas's register and spill lines of a build log, each after the
    kernel it describes (kernel<link, K> for the templated loglik
    kernels, deep_link_kernel<H=...> and deep_link_cluster_kernel<H=...>,
    kernel<N> for one integer parameter:
    the first layer's bf16 parts, the wide deep kernel's students)."""
    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            m = re.search(r"([a-z][a-z_]*_kernel)I(?:N4vibo\d+)?(\w+?)ELi(\d+)E",
                          name)
            deep = re.search(r"(deep_link_(?:cluster_)?kernel)ILi(\d+)E",
                             name)
            one = re.search(r"([a-z][a-z_]*_kernel)ILi(\d+)E", name)
            out.append(f"{m.group(1)}<{m.group(2)}, {m.group(3)}>" if m
                       else f"{deep.group(1)}<H={deep.group(2)}>" if deep
                       else f"{one.group(1)}<{one.group(2)}>" if one
                       else name[-60:])
        elif "registers" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets t_s, the seconds since this
    module was imported (where the smoke's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| (0-d tensors included)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def max_abs(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of fn, with the 50 MB L2 flushed before every
    launch: the step's other work (dense layers, optimizer) passes far more
    than L2 between two launches of any one kernel. A ~1 ms spin on the
    card (torch.cuda._sleep) precedes the start event, so the card is still
    busy while the host enqueues fn (its allocations and the ctypes call):
    without it a slow host's enqueue time lands between the two events."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 15) -> float:
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled(fn, reps: int) -> list:
    """(kernel name, mean device ms of its launches) of every kernel `reps`
    calls of fn launch, from a torch.profiler window, each call after the
    L2 flush and the spin of Timer, in a window held open PROFILER_PAD_S at
    both ends. The mean is over the launches the window recorded."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(Timer.SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    return [(ev.key, ev.device_time_total / 1e3 / ev.count)
            for ev in prof.key_averages() if ev.device_time_total > 0]


def pass_times(fn, reps: int = 10) -> dict:
    """Device time of a one-pass loglik or masked loglik call's launches
    (one of each at K <= 8): its main kernel, its second pass
    (sum_rows_kernel) and, for the compile-time GRM, its prologue
    (grm_table_kernel), from a profiler window over `reps` calls (Timer
    times them together)."""
    for _ in range(PROFILER_TRIES):
        out = {}
        for name, ms in profiled(fn, reps):
            key = next((k for k, pat in PASS_KERNELS
                        if re.search(pat, name)), None)
            if key is not None:
                out[key] = out.get(key, 0.0) + ms
        if {"main_ms", "reduce_ms"} <= set(out):
            return out
    raise AssertionError(f"the profiler saw no main kernel or second pass "
                         f"in {PROFILER_TRIES} windows: {out}")


def ran_link(fn) -> str:
    """The link template argument of the one loglik_categorical_kernel one
    call of fn launches (demangled by the profiler), e.g. LinkGRMFixed<5>."""
    for _ in range(PROFILER_TRIES):
        found = (re.search(LINK_OF_KERNEL, name)
                 for name, _ in profiled(fn, 2))
        names = {m.group(1) for m in found if m}
        if names:
            break
    if len(names) != 1:
        raise AssertionError(f"not one categorical kernel launched: {names}")
    return names.pop()


def occupancy(family: str, k: int, c: int = 0) -> dict:
    """ptxas's registers and local (spill) bytes of the one-pass kernel a
    call of `family` at (K, C) launches first, and its resident blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its block size and
    shared memory), from the library's occupancy entry point; family "deep":
    the kernel of link width H = k (deep_link_kernel<128>, or
    deep_link_cluster_kernel<H> at 256, 384, 512, also its cluster size and
    the clusters the card holds at once); "masked_fwd_2pl",
    "masked_bwd_2pl" (and 3pl): the masked forward's or VJP's kernel, c = 0
    the dense reader, 1 int8."""
    import ctypes
    from vibo_tpu_torch.ops import _build
    out = (ctypes.c_int * 5)()
    if family.startswith("masked_"):
        _, direction, link = family.split("_")
        fn, lib = _build.bind("masked_loglik.cu",
                              f"masked_{direction}_occupancy",
                              [ctypes.c_int] * 3 + [ctypes.c_void_p])
        rc = fn(("2pl", "3pl").index(link), k, c, out)
    elif family == "deep":
        fn, lib = _build.bind("deep_link.cu", "deep_link_occupancy",
                              [ctypes.c_int, ctypes.c_void_p])
        rc = fn(k, out)
    elif family in FAMILIES:
        fn, lib = _build.bind(f"loglik_{family}.cu",
                              f"loglik_{family}_occupancy",
                              [ctypes.c_int] * 2 + [ctypes.c_void_p])
        rc = fn(k, c, out)
    else:
        fn, lib = _build.bind("loglik_train.cu", "loglik_train_occupancy",
                              [ctypes.c_int] * 2 + [ctypes.c_void_p])
        rc = fn(("2pl", "3pl").index(family), k, out)
    _build.check(rc, lib, f"occupancy query of {family} K={k} C={c}")
    occ = {"registers": out[0], "local_bytes": out[1],
           "blocks_per_sm": out[2]}
    if family == "deep":
        occ.update(cluster_size=out[3], resident_clusters=out[4])
    return occ


def inert_rows(pk, ll, dth) -> int:
    """Rows of the code with no observed cell must give exactly 0 ll (when
    per person) and 0 dtheta; returns how many there were."""
    empty = (pk == 0).all(1)
    if ll is not None and ll.ndim == 1 and not bool(ll[empty].eq(0).all()):
        raise AssertionError("an all-missing student row has ll != 0")
    if not bool(dth[empty].eq(0).all()):
        raise AssertionError("an all-missing student row has dtheta != 0")
    return int(empty.sum())


class Roofline:
    """The least time of a kernel's work on this card: the largest of its
    bytes over HBM, its operations over their peak, and its special-function
    results over the SMs' MUFU rate; the MUFU instructions a cell are read
    from the SASS of the built library (cuobjdump)."""

    def __init__(self):
        from vibo_tpu_torch.ops import _build
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.mufu_per_s = (MUFU_PER_CLOCK_PER_SM * self.sms
                           * self.max_sm_mhz * 1e6)
        self.cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
        self._sass: dict[str, list] = {}
        self.counts: dict[str, dict] = {}

    def _functions(self, source: str) -> list:
        """[(mangled name, SASS lines)] of csrc/<source>'s library."""
        if source not in self._sass:
            from vibo_tpu_torch.ops import _build
            text = subprocess.run(
                [str(self.cuobjdump), "-sass", str(_build.lib_path(source))],
                capture_output=True, text=True, check=True,
                timeout=300).stdout
            self._sass[source] = [
                (part.split("\n", 1)[0].strip(), part.splitlines())
                for part in re.split(r"\n\s*Function : ", text)[1:]]
        return self._sass[source]

    def mufu(self, source: str, kernel: str, link: str, k: int,
             packed: bool | None = None, loop_op: str | None = None,
             trips: int = 1, item_steps: int = 1,
             link_tag: str | None = None,
             tag: str | None = None) -> tuple[int, int]:
        """(MUFU a cell, MUFU an item) of one instantiation, from its SASS
        up to its last EXIT (the division's slow-path subroutines after it
        are left out). The tile loop stages the link's per-item constants
        before its first barrier: the MUFU lines before the first BAR.SYNC
        are a staging step's (item_steps of them an item), those after it
        the unrolled cells', which must divide evenly by the cells one pass
        covers; lines of the op loop_op (e.g. "EX2") after it sit in a loop
        a cell runs `trips` times. link_tag: the link's mangled name where
        it is a template (the compile-time-C GPCM). tag: the mangled
        template arguments, for a kernel not templated on a link."""
        if tag is None:
            tag = f"{link_tag or 'Link' + link.upper()}ELi{k}E"
            if packed is not None:
                tag += f"Lb{int(packed)}E"
            tag += "Lb0E"      # the fixed-K instantiation, not the wide one
        found = [lines for name, lines in self._functions(source)
                 if kernel in name and tag in name]
        if len(found) != 1:
            raise AssertionError(
                f"{len(found)} SASS functions match {kernel} {tag} in "
                f"{source}: {[n for n, _ in self._functions(source)]}")
        lines = found[0]
        exits = [i for i, ln in enumerate(lines) if "EXIT" in ln]
        body = lines[:exits[-1] if exits else None]
        bar = next(i for i, ln in enumerate(body) if "BAR.SYNC" in ln)
        per_item = sum("MUFU." in ln for ln in body[:bar]) * item_steps
        looped = (sum(f"MUFU.{loop_op}" in ln for ln in body[bar:])
                  if loop_op else 0)
        per_cell = 0
        for count, times in ((sum("MUFU." in ln for ln in body[bar:])
                              - looped, 1), (looped, trips)):
            n, rest = divmod(count, CELLS_PER_PASS[kernel])
            if rest:
                raise AssertionError(
                    f"{kernel} {tag}: {count} MUFU after the first barrier "
                    f"do not divide over {CELLS_PER_PASS[kernel]} cells a "
                    "pass")
            per_cell += n * times
        key = f"{kernel}<{tag}>" + (f" C={trips}" if loop_op else "")
        self.counts[key] = {"per_cell": per_cell, "per_item": per_item}
        return per_cell, per_item

    def _lines(self, source: str, kernel: str, op: str) -> int:
        """Instructions `op` of the one function of csrc/<source>'s SASS
        whose name holds `kernel`, up to its last EXIT (the division's
        slow-path subroutines after it are left out)."""
        found = [lines for name, lines in self._functions(source)
                 if kernel in name]
        if len(found) != 1:
            raise AssertionError(f"{len(found)} SASS functions match {kernel}"
                                 f" in {source}")
        exits = [i for i, ln in enumerate(found[0]) if "EXIT" in ln]
        return sum(op in ln for ln in found[0][:exits[-1] if exits
                                               else None])

    def mufu_lines(self, source: str, kernel: str) -> int:
        """MUFU instructions of a kernel (_lines)."""
        n = self._lines(source, kernel, "MUFU.")
        self.counts[kernel] = {"per_pair": n}
        return n

    def hmma_lines(self, source: str, kernel: str) -> int:
        """Tensor-core (HMMA) instructions of a kernel (_lines)."""
        return self._lines(source, kernel, "HMMA.")

    def bound(self, nbytes: float, ops: float, peak: float,
              special: float = 0.0, f32_ops: float = 0.0,
              terms: bool = False):
        """(ms, limiting resource) of the work: its operations are ops at
        `peak` or f32_ops outside the tensor cores, whichever takes longer;
        terms=True adds each term's ms."""
        t = {"bytes": nbytes / HBM_BYTES_PER_S,
             "tensor_or_main_operations": ops / peak,
             "f32_operations": f32_ops / F32_FLOPS,
             "special functions": special / self.mufu_per_s}
        times = {"bytes": t["bytes"],
                 "operations": max(t["tensor_or_main_operations"],
                                   t["f32_operations"]),
                 "special functions": t["special functions"]}
        by = max(times, key=times.get)
        if terms:
            return times[by] * 1e3, by, {k: v * 1e3 for k, v in t.items()}
        return times[by] * 1e3, by


def check_first_layer(timer, roof, pk, rng_gen, timed: bool, h: int = H,
                      cd=torch.bfloat16) -> dict:
    """The first layer's forward and backward kernels in the compute dtype's
    mode against the plain version at that dtype on the code pk: bf16
    (operands rounded to bf16, f32 sums; 1e-4 of the largest magnitude) or
    f32 (exact products from three bf16 parts against f32 products, TF32
    off; 1e-5: only the summation order differs, and the tensor cores do
    not round their f32 sums to nearest). Timed: beside the plain version
    and the one PyTorch call computing the same function (the matmul of the
    decoded code at that dtype), and each kernel launched
    FIRST_LAYER_REPEATS times on its input, every launch bitwise equal to
    the first."""
    from vibo_tpu_torch.ops import pallas_encoder as enc
    from vibo_tpu_torch.ops.packing import decode_packed
    bsz, m = pk.shape
    f32 = cd == torch.float32
    tag, tol, parts = ("_f32", 1e-5, 3) if f32 else ("", 1e-4, 1)
    wr = 0.05 * torch.randn((m, h), generator=rng_gen, device="cuda")
    wm = 0.05 * torch.randn((m, h), generator=rng_gen, device="cuda")
    dh = torch.randn((bsz, h), generator=rng_gen, device="cuda")
    h_k = enc.first_layer_fwd_cuda(pk, wr, wm, cd)
    h_p = enc.first_layer_plain(pk, wr, wm, cd)
    dwr_k, dwm_k = enc.first_layer_bwd_cuda(pk, dh, cd)
    dwr_p, dwm_p = enc.first_layer_bwd_plain(pk, dh, cd)
    torch.cuda.synchronize()
    fwd = {"rel_err": rel_err(h_k, h_p), "max_abs_err": max_abs(h_k, h_p)}
    bwd = {"rel_err": max(rel_err(dwr_k, dwr_p), rel_err(dwm_k, dwm_p)),
           "max_abs_err": max(max_abs(dwr_k, dwr_p), max_abs(dwm_k, dwm_p))}
    fwd["reader"] = bwd["reader"] = enc.code_reader(pk)
    for name, r in ((f"first_layer_fwd{tag}", fwd),
                    (f"first_layer_bwd{tag}", bwd)):
        if not r["rel_err"] <= tol:
            raise AssertionError(f"{name} at {tuple(pk.shape)}, H={h} "
                                 f"disagrees with its plain version: {r}")
    if timed:
        for name, r, launch, first in (
                (f"first_layer_fwd{tag}", fwd,
                 lambda: [enc.first_layer_fwd_cuda(pk, wr, wm, cd)], [h_k]),
                (f"first_layer_bwd{tag}", bwd,
                 lambda: enc.first_layer_bwd_cuda(pk, dh, cd),
                 [dwr_k, dwm_k])):
            r["repeats_differing"] = sum(
                not all(torch.equal(x, y) for x, y in zip(launch(), first))
                for _ in range(FIRST_LAYER_REPEATS - 1))
            r["repeats"] = FIRST_LAYER_REPEATS
            if r["repeats_differing"]:
                raise AssertionError(f"{name}: {r['repeats_differing']} of "
                                     f"{FIRST_LAYER_REPEATS} launches on one "
                                     f"input differ from the first")
        lib = torch.float32 if f32 else torch.bfloat16
        m_, rm_ = (x.to(lib) for x in decode_packed(pk))
        x_cat = torch.cat([rm_, m_], dim=1)                 # (B, 2M)
        w_cat = torch.cat([wr, wm]).to(lib)                 # (2M, H)
        dh_l = dh.to(lib)
        # the least exact work: 4 B M H on the bf16 tensor cores a part
        ops = parts * 4 * bsz * m * h
        fwd.update(ms=timer(lambda: enc.first_layer_fwd_cuda(pk, wr, wm, cd)),
                   plain_ms=timer(lambda: enc.first_layer_plain(
                       pk, wr, wm, cd)),
                   library_ms=timer(lambda: torch.matmul(x_cat, w_cat)))
        # no special function in a decode and a product
        fwd["bound_ms"], fwd["bound_by"] = roof.bound(
            bsz * m + 2 * m * h * 4 + bsz * h * 4, ops, BF16_FLOPS)
        bwd.update(ms=timer(lambda: enc.first_layer_bwd_cuda(pk, dh, cd)),
                   plain_ms=timer(lambda: enc.first_layer_bwd_plain(
                       pk, dh, cd)),
                   library_ms=timer(lambda: torch.matmul(x_cat.T, dh_l)))
        bwd["bound_ms"], bwd["bound_by"] = roof.bound(
            bsz * m + bsz * h * 4 + 2 * m * h * 4, ops, BF16_FLOPS)
    return {f"first_layer_fwd{tag}": fwd, f"first_layer_bwd{tag}": bwd}


def first_layer_checks(timer, roof, data: dict, deep: dict, ragged_pk,
                       odd_pk, gen) -> dict:
    """check_first_layer in both modes at every listed shape: the flagship
    (timed, and the repeat gate), H = 512, config 5's 5,520 x 680, the ragged and the odd shape
    at H = 256 and at a width off the 8-column step (20), and the GRM
    flagship's graded code. The three code readers are all met: cp16 (M =
    1,024), cp4 (M = 680, 300), bytes (M = 301)."""
    shapes = (("flagship", data["2pl"]["packed"], H, True),
              ("H512", data["2pl"]["packed"], 512, False),
              ("config5", deep["packed"], H, False),
              ("ragged", ragged_pk, H, False),
              ("ragged_H20", ragged_pk, 20, False),
              ("odd", odd_pk, H, False),
              ("odd_H20", odd_pk, 20, False),
              ("grm_graded", data["grm"]["packed"], H, False))
    out = {}
    for shape, pk, h, timed in shapes:
        out[shape] = {}
        for cd in (torch.bfloat16, torch.float32):
            out[shape].update(check_first_layer(timer, roof, pk, gen, timed,
                                                h, cd))
    readers = {r["reader"] for v in out.values() for r in v.values()}
    if readers != {"cp16", "cp4", "bytes"}:
        raise AssertionError(f"first-layer checks met the readers {readers}")
    return out


def check_loglik(timer, roof, pk, rng_gen, timed: bool,
                 link: str = "2pl", k: int = K, theta_t=None, a=None,
                 b=None, g_hat=None) -> dict:
    """The one-pass training loglik of `link` in both theta layouts against
    its plain version, and a second launch bitwise equal to the first;
    theta_t (k, B), a, b and g_hat default to random draws (the
    extreme-point check passes its own)."""
    from vibo_tpu_torch.ops import pallas_elbo as el
    bsz, m = pk.shape
    if theta_t is None:
        theta_t = torch.randn((k, bsz), generator=rng_gen, device="cuda")
        a = 0.5 * torch.randn((m, k), generator=rng_gen, device="cuda")
        b = torch.randn((m,), generator=rng_gen, device="cuda")
        if link == "3pl":
            g_hat = torch.randn((m,), generator=rng_gen,
                                device="cuda") - 1.5
    k = theta_t.shape[0]
    name = LINK_KERNELS[link]["train"]
    out = {}
    for layout in ("kb", "bk"):
        theta = theta_t.T if layout == "kb" else theta_t.T.contiguous()
        dth = torch.empty((k, bsz), device="cuda").T if layout == "kb" \
            else torch.empty((bsz, k), device="cuda")

        def launch():
            return el.loglik_train_cuda(theta, a, b, g_hat, pk, dth,
                                        per_person=layout == "bk")
        ll_k, grads_k = launch()
        first = [x.clone() for x in (ll_k, dth, *grads_k)]
        again = launch()
        repeat = all(torch.equal(x, y) for x, y in
                     zip(first, (again[0], dth, *again[1])))
        ll_k, grads_k = first[0], first[2:]
        ll_p, dth_p, *grads_p = el.loglik_train_plain(theta, a, b, g_hat, pk)
        if layout == "kb":
            ll_p = ll_p.sum()
        torch.cuda.synchronize()
        pairs = [(dth, dth_p), *zip(grads_k, grads_p)]
        r = {"ll_rel_err": rel_err(ll_k, ll_p),
             "grad_rel_err": max(rel_err(x, y) for x, y in pairs),
             "max_abs_err": max(max_abs(ll_k, ll_p),
                                *(max_abs(x, y) for x, y in pairs))}
        finite = bool(torch.isfinite(ll_k).all()) and all(
            bool(torch.isfinite(x).all()) for x, _ in pairs)
        if not (finite and r["ll_rel_err"] <= 1e-5
                and r["grad_rel_err"] <= 1e-4):
            raise AssertionError(f"{name} ({layout}) at {tuple(pk.shape)}, "
                                 f"K={k} disagrees with its plain version "
                                 f"or is not finite: {r}")
        if not repeat:
            raise AssertionError(f"{name} ({layout}) at {tuple(pk.shape)}, "
                                 f"K={k}: two launches on the same inputs "
                                 "differ")
        r["inert_rows"] = inert_rows(pk, ll_k, dth)
        if timed:
            r["ms"] = timer(launch)
            r.update(pass_times(launch))
            r["plain_ms"] = timer(
                lambda: el.loglik_train_plain(theta, a, b, g_hat, pk))
            r["library_ms"] = None
            items = 1 if g_hat is None else 2       # b[, g_hat] in, out
            cells = bsz * m
            if link == "2pl":      # its own kernel (k <= 8)
                per_cell, per_item = roof.mufu(
                    "loglik_train.cu", "loglik_2pl_kernel", link, k,
                    tag=f"ILi{k}EE")
                r["mufu_per_cell_sass"] = per_cell
                per_cell = TRAIN_2PL_CELL_MUFU
            else:
                per_cell, per_item = roof.mufu("loglik_train.cu",
                                               "loglik_train_kernel", link, k)
            r["bound_ms"], r["bound_by"] = roof.bound(
                cells + 2 * bsz * k * 4 + 2 * m * k * 4 + 2 * items * m * 4
                + 4, CELL_OPS[link][0](k, 2) * cells, F32_FLOPS,
                per_cell * cells + per_item * m)
        out[layout] = r
    return out


def masked_bound(roof, bsz: int, m: int, k: int, s: int, cell_bytes: int,
                 bwd: bool, link: str):
    """Bound of one masked loglik call over s samples: each cell's data read
    once (8 bytes dense, 1 int8) plus theta, the items (and g) read and ll
    (or dtheta and the item gradients) written once; the cell's f32
    operations (CELL_OPS); the MUFU results counted in the SASS, a cell's
    for every cell and an item's once for each of the s samples' items (the
    2PL forward's cell: MASKED_FWD_2PL_CELL_MUFU). Returns (ms, limiting
    resource, the SASS's MUFU a cell where the bound counts the
    function's instead, else None)."""
    items = 1 if link == "2pl" else 2                # b[, g_hat]
    small = 4 * (bsz * k + m * k + items * m)
    if bwd:
        small += 4 * (bsz + bsz * k + m * k + items * m)
    else:
        small += 4 * bsz
    cells = s * bsz * m
    ops = CELL_OPS[link][2 if bwd else 1](k) * cells
    kernel = "masked_bwd_kernel" if bwd else "masked_fwd_kernel"
    per_cell, per_item = roof.mufu("masked_loglik.cu", kernel, link, k,
                                   packed=cell_bytes == 1)
    sass = None
    if link == "2pl" and not bwd:
        sass, per_cell = per_cell, MASKED_FWD_2PL_CELL_MUFU
    return (*roof.bound(cell_bytes * bsz * m + s * small, ops, F32_FLOPS,
                        per_cell * cells + per_item * s * m), sass)


def check_masked(timer, roof, resp, mask, rng_gen, timed: bool,
                 samples: int | None = None, shared_items: bool = False,
                 k: int = K, link: str = "2pl", theta=None, items=None):
    """The general masked loglik's forward and backward kernels of `link`
    against their plain versions, dense and int8 readers, on (resp, mask)
    and a non-uniform cotangent, a second launch of each bitwise equal to
    the first, and all-missing rows exactly inert;
    samples: a leading sample axis of that length (per-sample items, or
    shared over the samples; the data is shared, as on the IWAE path); k:
    ability dims; theta (S, B, K) and items (a, b[, g_hat]) with their
    sample axis default to random draws."""
    from vibo_tpu_torch.ops import pallas_elbo as el
    from vibo_tpu_torch.ops.packing import decode_packed, pack_responses
    bsz, m = resp.shape
    s = samples or 1
    sa = 1 if shared_items else s
    if theta is None:
        theta = torch.randn((s, bsz, k), generator=rng_gen, device="cuda")
        items = [0.5 * torch.randn((sa, m, k), generator=rng_gen,
                                   device="cuda"),
                 torch.randn((sa, m), generator=rng_gen, device="cuda")]
        if link == "3pl":
            items.append(torch.randn((sa, m), generator=rng_gen,
                                     device="cuda") - 1.5)
    a, b = items[:2]
    g_hat = items[2] if link == "3pl" else None
    k = theta.shape[-1]
    g = 2.0 * torch.rand((s, bsz), generator=rng_gen, device="cuda") - 0.5
    pk = pack_responses(resp, mask)
    name = f"masked_loglik_{link}"
    out = {}
    for reader in ("dense", "int8"):
        data = ((resp[None], mask[None], None) if reader == "dense"
                else (None, None, pk[None]))

        def cells():
            if reader == "dense":
                return resp[None], mask[None]
            m_, r_ = decode_packed(pk[None])
            return r_, m_

        def fwd():
            return el.masked_fwd_cuda(theta, a, b, g_hat, *data)

        def bwd():
            return el.masked_bwd_cuda(g, theta, a, b, g_hat, *data)

        def fwd_plain():
            return el.masked_plain(theta, a, b, g_hat, *cells())

        def bwd_plain():
            return el.masked_vjp_plain(g, theta, a, b, g_hat, *cells())
        ll_k, grads_k = fwd(), bwd()
        repeat = (torch.equal(ll_k, fwd())
                  and all(torch.equal(x, y) for x, y in zip(grads_k, bwd())))
        ll_p, grads_p = fwd_plain(), bwd_plain()
        torch.cuda.synchronize()
        f = {"rel_err": rel_err(ll_k, ll_p), "max_abs_err": max_abs(ll_k,
                                                                    ll_p)}
        w = {"rel_err": max(rel_err(x, y) for x, y in zip(grads_k, grads_p)),
             "max_abs_err": max(max_abs(x, y)
                                for x, y in zip(grads_k, grads_p))}
        finite = bool(torch.isfinite(ll_k).all()) and all(
            bool(torch.isfinite(x).all()) for x in grads_k)
        if not (finite and f["rel_err"] <= 1e-5 and w["rel_err"] <= 1e-4):
            raise AssertionError(
                f"{name} ({reader}, S={s}, shared_items={shared_items}, "
                f"K={k}) at {(bsz, m)} disagrees with its plain version or "
                f"is not finite: fwd {f}, bwd {w}")
        if not repeat:
            raise AssertionError(f"{name} ({reader}, S={s}, K={k}) at "
                                 f"{(bsz, m)}: two launches on the same "
                                 "inputs differ")
        # rows with no observed cell (a last minibatch's zero padding) give
        # exactly 0 loglik and 0 dtheta
        empty = mask.sum(-1) == 0
        if not (ll_k[:, empty].eq(0).all()
                and grads_k[0][:, empty].eq(0).all()):
            raise AssertionError(f"{name} ({reader}) at {(bsz, m)}: an "
                                 f"all-missing row is not inert")
        f["inert_rows"] = int(empty.sum())
        if timed:
            nbytes = 8 if reader == "dense" else 1
            for r, kernel, plain, is_bwd in ((f, fwd, fwd_plain, False),
                                             (w, bwd, bwd_plain, True)):
                r.update(ms=timer(kernel), plain_ms=timer(plain),
                         library_ms=None)
                r["bound_ms"], r["bound_by"], sass = masked_bound(
                    roof, bsz, m, k, s, nbytes, is_bwd, link)
                if sass is not None:
                    r["mufu_per_cell_sass"] = sass
            # the profiler windows after both directions' CUDA-event times,
            # so that no window runs right before a timed launch
            for r, kernel in ((f, fwd), (w, bwd)):
                r.update(pass_times(kernel))
        out[reader] = {"fwd": f, "bwd": w}
    return out


def check_extreme(timer, roof, rng_gen) -> dict:
    """The 3PL kernels at the extreme point of tests/test_pallas.py: theta
    = +30, -30 and 0 (K = 1), a = 1, b = 0, g_hat = -25 on 128 items, every
    cell observed and right: finite, and equal to the plain versions."""
    theta = torch.tensor([[30.0, -30.0, 0.0]], device="cuda")    # (K, B)
    ones = torch.ones((3, 128), device="cuda")
    a = torch.ones((128, 1), device="cuda")
    b = torch.zeros((128,), device="cuda")
    g_hat = torch.full((128,), -25.0, device="cuda")
    pk = torch.full((3, 128), 2, dtype=torch.int8, device="cuda")
    return {
        "loglik_3pl_train": check_loglik(timer, roof, pk, rng_gen, False,
                                         "3pl", 1, theta, a, b, g_hat),
        "masked_loglik_3pl": check_masked(
            timer, roof, ones, ones, rng_gen, False, link="3pl",
            theta=theta.T[None], items=[a[None], b[None], g_hat[None]])}


def family_ops(fam: str):
    """(module, plain version) of a polytomous family's one-pass op."""
    from vibo_tpu_torch.ops import pallas_gpcm, pallas_grm
    mod = pallas_grm if fam == "grm" else pallas_gpcm
    return mod, getattr(mod, f"loglik_{fam}_train_plain")


def random_items(fam: str, m: int, k: int, c: int, rng_gen, lead=()):
    """a (lead + (M, K)) and the family's table (lead + (M, C-1)) from
    random unconstrained coordinates."""
    from vibo_tpu_torch.ops import links
    a = 0.5 * torch.randn(lead + (m, k), generator=rng_gen, device="cuda")
    b_free = torch.randn(lead + (m, c - 1), generator=rng_gen, device="cuda")
    return a, links.categorical_table(fam, b_free).contiguous()


def graded_code(shape, c: int, rng_gen):
    """A random int8 code of C categories: 0 (missing) .. C."""
    return torch.randint(0, c + 1, shape, generator=rng_gen, device="cuda",
                         dtype=torch.int8)


def check_categorical(timer, roof, fam: str, pk, c: int, rng_gen,
                      timed: bool = False, k: int = K, inputs=None) -> dict:
    """A polytomous family's one-pass kernel (csrc/loglik_{fam}.cu)
    against its plain version on the code pk of C categories: ll, dtheta,
    da and dkappa; inputs (theta (B, K), a, kappa) default to random
    draws."""
    from vibo_tpu_torch.ops.pallas_grm import train_cuda
    mod, plain = family_ops(fam)
    bsz, m = pk.shape
    if inputs is None:
        theta = torch.randn((bsz, k), generator=rng_gen, device="cuda")
        inputs = (theta, *random_items(fam, m, k, c, rng_gen))
    theta, a, kap = inputs
    k = theta.shape[1]

    def launch():
        return train_cuda(mod.TRAIN, theta, a, kap, pk)
    got, ref = launch(), plain(theta, a, kap, pk)
    torch.cuda.synchronize()
    r = {"ll_rel_err": rel_err(got[0], ref[0]),
         "grad_rel_err": max(rel_err(x, y) for x, y in zip(got[1:], ref[1:])),
         "max_abs_err": max(max_abs(x, y) for x, y in zip(got, ref))}
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    if not (finite and r["ll_rel_err"] <= 1e-5 and r["grad_rel_err"] <= 1e-4):
        raise AssertionError(f"loglik_{fam}_train at {tuple(pk.shape)}, K={k}"
                             f", C={c} disagrees with its plain version or "
                             f"is not finite: {r}")
    r["inert_rows"] = inert_rows(pk, got[0], got[1])
    r["link"] = ran_link(launch)
    fixed = k <= 8 and c <= (GPCM_FIXED_C if fam == "gpcm" else GRM_FIXED_C)
    want = ("Link" + fam.upper() + ("Fixed" if fixed else "")
            + (f"<{c}>" if fixed else ""))
    if r["link"] != want:
        raise AssertionError(f"loglik_{fam}_train at K={k}, C={c} ran "
                             f"{r['link']}, not {want}")
    if timed:
        r["ms"] = timer(launch)
        r.update(pass_times(launch))
        r["plain_ms"] = timer(lambda: plain(theta, a, kap, pk))
        r["library_ms"] = None
        cells = bsz * m
        # GPCM up to GPCM_FIXED_C: C unrolled, its table staged without
        # special functions; above: the exponentials in loops over C. GRM
        # up to GRM_FIXED_C: its table from the prologue, C slots an item
        tag = f"Link{fam.upper()}FixedILi{c}EE" if fixed else None
        per_cell, per_item = roof.mufu(
            f"loglik_{fam}.cu", "loglik_categorical_kernel", fam, k,
            loop_op="EX2" if fam == "gpcm" and not fixed else None, trips=c,
            item_steps=c + 1 if fam == "grm" else 1 if fixed else c,
            link_tag=tag)
        if fam == "grm" and fixed:
            per_item = c * roof.mufu_lines("loglik_grm.cu",
                                           "grm_table_kernel")
            r["mufu_per_cell_sass"] = per_cell
            per_cell = GRM_CELL_MUFU
        # the code, theta, a and kappa read once; ll, dtheta, da, dkappa
        # written once
        r["bound_ms"], r["bound_by"] = roof.bound(
            cells + 4 * (2 * bsz * k + bsz + 2 * m * k + 2 * m * (c - 1)),
            CELL_OPS[fam][0](k, c) * cells, F32_FLOPS,
            per_cell * cells + per_item * m)
    return r


def check_categorical_op(fam: str, pk, c: int, rng_gen,
                         samples: int | None = None,
                         shared_items: bool = False) -> dict:
    """The family's autograd op on the card against its plain version:
    without a sample axis under a non-uniform cotangent (ll and dtheta,
    which the contract keeps exact); with `samples` samples (per-sample or
    shared a and kappa, the code shared) under a uniform one, every
    gradient."""
    mod, plain = family_ops(fam)
    op = getattr(mod, f"masked_loglik_{fam}_packed_train")
    bsz, m = pk.shape
    s = samples or 1
    lead = () if samples is None or shared_items else (s,)
    theta = torch.randn(((s,) if samples else ()) + (bsz, K),
                        generator=rng_gen, device="cuda").requires_grad_()
    a, kap = (x.requires_grad_() for x in random_items(fam, m, K, c, rng_gen,
                                                       lead))
    g = (2.0 * torch.rand(theta.shape[:-1], generator=rng_gen, device="cuda")
         - 0.5 if samples is None else torch.ones(theta.shape[:-1],
                                                  device="cuda"))
    ll = op(theta, a, kap, pk)
    (ll * g).sum().backward()
    per = [plain(theta[i] if samples else theta,
                 a[i] if lead else a, kap[i] if lead else kap, pk)
           for i in range(s)]
    want_ll = torch.stack([x[0] for x in per]) if samples else per[0][0]
    want_dth = (torch.stack([x[1] for x in per]) if samples
                else g[:, None] * per[0][1])
    pairs = [(theta.grad, want_dth)]
    if samples:
        for i, x in ((2, a), (3, kap)):
            part = torch.stack([q[i] for q in per])
            pairs.append((x.grad, part if lead else part.sum(0)))
    torch.cuda.synchronize()
    r = {"ll_rel_err": rel_err(ll.detach(), want_ll),
         "grad_rel_err": max(rel_err(x, y) for x, y in pairs)}
    if not (r["ll_rel_err"] <= 1e-5 and r["grad_rel_err"] <= 1e-4):
        raise AssertionError(f"masked_loglik_{fam}_packed_train (S={samples}"
                             f", shared_items={shared_items}) disagrees "
                             f"with its plain version: {r}")
    return r


def check_categorical_extremes(fam: str, rng_gen) -> dict:
    """The family's kernel at the extreme points, C = 5, 128 items, K = 1:
    theta . a = +-40, +-31 (beyond the +-30 clamp) and 0; a collapsing
    category (kappa_2 = kappa_3 on every item: the GRM gap clamp); every
    cell in category 0, and every cell in category C - 1. Each finite and
    equal to the plain version."""
    theta = torch.tensor([[40.0], [-40.0], [31.0], [-31.0], [0.0]],
                         device="cuda")
    a = torch.ones((128, 1), device="cuda")
    kap = torch.sort(torch.randn((128, C - 1), generator=rng_gen,
                                 device="cuda"), dim=-1).values
    kap[:, 2] = kap[:, 1]
    codes = {"mixed": graded_code((5, 128), C, rng_gen),
             "first_category": torch.ones((5, 128), dtype=torch.int8,
                                          device="cuda"),
             "last_category": torch.full((5, 128), C, dtype=torch.int8,
                                         device="cuda")}
    return {name: check_categorical(None, None, fam, pk, C, rng_gen,
                                    inputs=(theta, a, kap.contiguous()))
            for name, pk in codes.items()}


def categorical_checks(timer, roof, fam: str, data: dict, rng_gen,
                       ragged, odd) -> dict:
    """Every check of one polytomous family's kernel (phase 3), at the item
    split's edges too: the flagship, 777 x 301 at K = 1, 4, 8 and 12, with
    all-missing rows, the split tail (the last split shorter), fewer
    students than a block, and C on both sides of GPCM_FIXED_C."""
    odd_empty = odd.clone()
    odd_empty[[0, 5, odd.shape[0] - 1]] = 0
    out = {"flagship": check_categorical(timer, roof, fam, data["packed"], C,
                                         rng_gen, timed=True),
           "ragged": check_categorical(timer, roof, fam, ragged, C, rng_gen),
           "odd_empty_rows": check_categorical(timer, roof, fam, odd_empty,
                                               C, rng_gen),
           "split_tail": check_categorical(
               timer, roof, fam, graded_code(SPLIT_TAIL, C, rng_gen), C,
               rng_gen),
           "tiny": check_categorical(timer, roof, fam,
                                     graded_code(TINY, C, rng_gen), C,
                                     rng_gen)}
    for k in (1, 4, 8, 12):
        out[f"odd_K{k}"] = check_categorical(timer, roof, fam, odd, C,
                                             rng_gen, k=k)
    for c in (3, 5, 8, 9, 16, 17, 32):
        out[f"ragged_C{c}"] = check_categorical(
            timer, roof, fam, graded_code(RAGGED, c, rng_gen), c, rng_gen)
    out["cotangent"] = check_categorical_op(fam, ragged, C, rng_gen)
    out["S3_per_sample"] = check_categorical_op(fam, ragged, C, rng_gen, 3)
    out["S3_shared_items"] = check_categorical_op(fam, ragged, C, rng_gen, 3,
                                                  shared_items=True)
    out["extremes"] = check_categorical_extremes(fam, rng_gen)
    return out


def objective_matches_cpu(mode: str, link: str = "2pl") -> float:
    """An objective and every gradient at a small shape on the card
    (kernels) against the CPU (plain versions), same params and noise.
    mode "packed": the packed full-batch ELBO (S = 1, transposed theta);
    "decoded": the decoded-data minibatch ELBO (S = 2, item_scale 0.4, an
    all-missing row); "iwae": the packed IWAE terms (S = 3, local and
    ratio a sample) and its bound, the gradients those of sum_s w_s
    (local_s + ratio_s) at the fixed non-uniform w = IWAE_COTANGENT. That
    is the IWAE bound's gradient at weights w; the bound's own weights at
    random params are one-hot to f32 (log weights hundreds apart), so they
    would drive one sample only. bf16 encoder, so 1e-2 of each array's
    largest magnitude (a bf16 rounding of an encoder operand may flip
    between the two). grm/gpcm: C = 5, theta (B, K); deep: item latent
    16, link width 128, the one-pass op on the packed path and the plain
    link in blocks of 256 items on the decoded one."""
    from vibo_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.ops import objectives
    from vibo_tpu_torch.ops.packing import packed_on_device
    n, m = 300, 200
    decoded = mode == "decoded"
    s = {"packed": 1, "decoded": 2, "iwae": len(IWAE_COTANGENT)}[mode]
    cats = C if link in FAMILIES else 2
    rng = np.random.default_rng(3)
    resp = rng.integers(0, cats, (n, m)).astype(np.float32)
    mask = (rng.random((n, m)) < 0.9).astype(np.float32)
    mask[7] = 0.0
    deep = (dict(item_latent_dim=DEEP_D, deep_hidden_dim=DEEP_H,
                 deep_fused_kernel=True) if link == "deep" else {})
    cfg = VIBOConfig(num_items=m, irt_model=link, ability_dim=K,
                     hidden_dim=64, use_pallas=True, compute_dtype="bfloat16",
                     num_categories=cats, **deep)
    model_cpu = VIBO(cfg, device="cpu")
    params_np = params_to_numpy(model_cpu.init_params(7))
    transposed = model_cpu.wants_transposed_theta()
    item_eps = ({"d": rng.standard_normal((s, m, DEEP_D)).astype(np.float32)}
                if link == "deep" else
                {"a": rng.standard_normal((s, m, K)).astype(np.float32),
                 "b": rng.standard_normal((s, m, cats - 1)
                                          ).astype(np.float32)})
    if link == "3pl":
        item_eps["g_hat"] = rng.standard_normal((s, m, 1)).astype(np.float32)
    theta_eps = rng.standard_normal(
        (s, K, n) if transposed and not decoded
        else (s, n, K)).astype(np.float32)
    results = []
    for dev in ("cuda", "cpu"):
        model = VIBO(cfg, device=dev)
        params = params_from_jax(params_np, dev)
        ie = {k: torch.from_numpy(v).to(dev) for k, v in item_eps.items()}
        te = torch.from_numpy(theta_eps).to(dev)
        if decoded:
            bound, aux = model.elbo_eps(
                params, torch.from_numpy(resp).to(dev),
                torch.from_numpy(mask).to(dev), ie, te, 0.4)
            terms = [aux[k] for k in ("loglik", "kl_theta", "kl_items")]
        elif mode == "packed":
            packed, rv = packed_on_device(resp, mask, dev)
            terms = model.elbo_packed_sums(params, packed, ie, te, rv,
                                           transposed=transposed)
            bound = objectives.elbo(*terms)
        else:
            packed, rv = packed_on_device(resp, mask, dev)
            local, ratio = model.iwae_packed_terms(params, packed, ie, te,
                                                   rv, transposed=transposed)
            terms = [local, ratio, objectives.iwae_bound(local + ratio)]
            w = torch.tensor(IWAE_COTANGENT, device=dev)
            bound = (w * (local + ratio)).sum()
        bound.backward()
        results.append([t.detach().cpu() for t in terms]
                       + [p.grad.cpu() for p in tree_leaves(params)])
    worst = max(rel_err(g, c) for g, c in zip(*results))
    if not worst <= 1e-2:
        raise AssertionError(f"{link} {mode} objective on the card "
                             f"disagrees with the CPU path: {worst}")
    return worst


def launch_counts() -> dict:
    from vibo_tpu_torch.ops import _build
    return {name: k.launches for name, k in _build.KERNELS.items()}


def reader_counts(masked: tuple) -> dict:
    """Launches of the masked loglik kernels `masked` by cell reader."""
    from vibo_tpu_torch.ops import _build
    return {n: dict(_build.KERNELS[n].launches_by) for n in masked}


def check_dense_only(phase: str, readers: dict) -> None:
    if any(set(r) != {"dense"} for r in readers.values()):
        raise AssertionError(f"{phase} used another reader than the dense "
                             f"one: {readers}")


def check_path(phase: str, launches: dict, ran: tuple,
               once_each: tuple = (), steps: int = 0) -> None:
    """The phase launched every kernel of its path, the kernels in
    once_each exactly `steps` times, and no other kernel."""
    missing = [n for n in ran if launches[n] == 0]
    stray = [n for n, c in launches.items() if n not in ran and c != 0]
    miscounted = [n for n in once_each if launches[n] != steps]
    if missing or stray or miscounted:
        raise AssertionError(
            f"{phase}: kernels of the path not launched {missing}, kernels "
            f"of another path launched {stray}, not launched once in each "
            f"of {steps} steps {miscounted}: {launches}")


def profile_steps(step, steps: int, med_ms: float, smi: str,
                  per_call: int = 1, counts: bool = False,
                  sequence: bool = False) -> dict:
    """Device time by kernel a training step over `steps` calls of step()
    (per_call training steps each: a graph replay of a chunk) in a
    torch.profiler window (padded as in profiled), the device records
    (kernels, memcpys, memsets) a step, and the device idle share against
    the unprofiled step time med_ms (the profiler slows the host, and the
    device too: a busy time above med_ms gives a negative share, reported
    as measured). The records' union on the device's timeline beside their
    sum (equal unless a record is counted twice or two overlap) and the
    idle share within the window's own wall time; counts: also every
    device record's name with its calls a step; sequence: also the
    DEVICE_KERNELS records in the order they ran (a record the window lost
    shows where in the window it is missing)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILER_PAD_S)
    n_steps = steps * per_call
    rows = []
    cuda = torch.autograd.DeviceType.CUDA

    def device_record(evt, host) -> bool:
        # device-side records only: an op's record, or a user annotation
        # such as the optimizer step's (its device record under the host
        # record's name), carries its kernels' time a second time. A
        # kernel's own name may hold '#' (a lambda's, "{lambda()#1}", in a
        # demangled template argument: about half the elementwise kernels
        # of a step), so names are matched whole, never searched for it
        return not (evt.device_type != cuda
                    or getattr(evt, "is_user_annotation", False)
                    or evt.key in host)

    averages = prof.key_averages()
    host = {evt.key for evt in averages if evt.device_type != cuda}
    for evt in averages:
        if not device_record(evt, host):
            continue
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt / 1e3 / n_steps, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if device_record(e, host)
                   and e.time_range.end > e.time_range.start)
    union, reach = 0.0, float("-inf")
    for a, b in spans:                   # us
        union += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    union_ms = union / 1e3 / n_steps
    out = {"steps": n_steps,
           "wall_ms_per_step": window_ms / n_steps,
           "device_ms_per_step": busy,
           "device_union_ms_per_step": union_ms,
           "device_records_per_step": sum(r[2] for r in rows) / n_steps,
           "device_idle_share": 1.0 - busy / med_ms,
           "device_idle_share_in_window": 1.0 - union_ms * n_steps
           / window_ms,
           "top": [{"ms_per_step": round(t, 4), "name": n[:80],
                    "calls": c} for t, n, c in rows[:14]], "card": smi}
    if counts:
        out["counts"] = {n: c / n_steps for _, n, c in rows}
    if sequence:
        out["sequence"] = [k for _, k in sorted(
            (e.time_range.start, k) for e in prof.events()
            if device_record(e, host)
            for k, rx in DEVICE_KERNELS.items() if re.search(rx, e.name))]
    return out


def full_batch_phase(tag: str, cfg, data: dict, smi: str, ran: tuple,
                     once_each: tuple, steps: int = STEPS, fresh=None,
                     must_rise: bool = True) -> dict:
    """Phase 5 for one model: `steps` packed full-batch steps, launching the
    kernels `ran` (those in once_each once a step) and no other; then, when
    `fresh` (new students' SyntheticIRT) is given, held-out imputation and
    scoring; a profile window. Returns its launch counts and step median."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.serve import AbilityScorer
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer

    ds, packed, row_valid = data["ds"], data["packed"], data["row_valid"]
    n, m = packed.shape
    model = VIBO(cfg)
    trainer = Trainer(model, TrainConfig(lr=5e-3, max_grad_norm=10.0))
    params = model.init_params(0)
    optimizer = make_optimizer(params, 5e-3)
    noise = torch.Generator(device="cuda")
    noise.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, auxs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        auxs.append(trainer.step(params, optimizer, packed, row_valid, noise))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    check_path(f"{tag} full-batch path", launches, ran, once_each, steps)
    elbos = [float(a["elbo"]) for a in auxs]
    if not np.isfinite(elbos).all():
        raise AssertionError(f"non-finite ELBO in the {tag} full-batch "
                             f"path: {elbos}")
    if must_rise and not np.mean(elbos[-5:]) > np.mean(elbos[:5]):
        raise AssertionError(f"{tag} ELBO did not rise: {elbos}")
    med = statistics.median(step_ms[3:])
    emit({"phase": "train", "link": tag, "steps": steps,
          "step_ms_median": med, "step_ms_first": step_ms[0],
          "cells_per_s": n * m / (med / 1e3), "elbo_first": elbos[0],
          "elbo_last": elbos[-1], "elbos": elbos, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})

    if fresh is not None:
        t0 = time.perf_counter()
        ev = evaluation.imputation_accuracy(model, params, ds)
        if not (ev["num_heldout"] > 0 and 0.0 <= ev["acc"] <= 1.0):
            raise AssertionError(f"bad {tag} imputation result {ev}")
        emit({"phase": "imputation", "link": tag, **ev,
              "seconds": time.perf_counter() - t0})

        rows = fresh.response.shape[0]
        t0 = time.perf_counter()
        out = AbilityScorer(model, params).score(fresh.response, fresh.mask)
        score_s = time.perf_counter() - t0
        shapes = {k: list(v.shape) for k, v in out.items()}
        polytomous = cfg.irt_model in FAMILIES
        k = cfg.ability_dim
        want = {"theta_mu": [rows, k], "theta_sigma": [rows, k],
                "prob": [rows, m] + ([cfg.num_categories] if polytomous
                                     else [])}
        if shapes != want:
            raise AssertionError(f"{tag} scorer shapes {shapes}")
        prob = out["prob"]
        # the deep link's sigmoid may round to 0 or 1 in f32
        in_range = (((prob >= 0) & (prob <= 1)).all() and np.abs(
            prob.astype(np.float64).sum(-1) - 1.0).max() <= 1e-5
            if polytomous else ((prob >= 0) & (prob <= 1)).all()
            if cfg.irt_model == "deep" else ((prob > 0) & (prob < 1)).all())
        if not (all(np.isfinite(v).all() for v in out.values())
                and (out["theta_sigma"] > 0).all() and in_range):
            raise AssertionError(f"{tag} scorer output out of range")
        emit({"phase": "score", "link": tag, "rows": rows,
              "prob_shape": shapes["prob"], "seconds": score_s,
              "theta_mu_std": float(out["theta_mu"].std())})

    emit({"phase": "profile", "link": tag, **profile_steps(
        lambda: trainer.step(params, optimizer, packed, row_valid, noise),
        10, med, smi)})
    return {"launches": launches, "step_ms_median": med, "elbos": elbos}


def adam_capturable_matches_plain() -> float:
    """The card's Adam (make_optimizer: capturable, step count and bias
    correction on the device) against torch.optim.Adam's plain form, which
    tests/test_torch_trainer.py holds against optax.adam on the CPU: 6
    steps on gradients of 1e-3 to 1e2. Returns the max relative error."""
    from vibo_tpu_torch.train import make_optimizer
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x0 = torch.randn((4, 3), generator=gen, device="cuda")
    grads = [torch.randn((4, 3), generator=gen, device="cuda") * 10 ** (i - 3)
             for i in range(6)]
    xs = [x0.clone().requires_grad_(True) for _ in range(2)]
    opts = (make_optimizer({"x": xs[0]}, 1e-2),
            torch.optim.Adam([xs[1]], lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                             capturable=False))
    if not opts[0].defaults["capturable"]:
        raise AssertionError("make_optimizer is not capturable on the card")
    for g in grads:
        for x, opt in zip(xs, opts):
            x.grad = g.clone()
            opt.step()
    err = rel_err(xs[0].detach(), xs[1].detach())
    if not err <= 1e-6:
        raise AssertionError(f"capturable Adam is {err} from the plain form")
    return err


def graph_matches_eager(tag: str, trainer, params, optimizer, x, y,
                        samples: int, decoded: bool = False) -> dict:
    """FUSED_REPLAYS replays of a FUSED_CHECK_LEN-step graph (make_scan;
    on (x, y) = (packed, row_valid), or (response, mask) when decoded),
    each replay's noise cloned from the graph's static buffers and fed to
    eager step_with_noise (minibatch_step_with_noise at item_scale 1 when
    decoded) on a copy of the params and Adam's state taken
    before: max |graph - eager| / max |eager| of the per-step aux, the
    params and Adam's moments and step count after all of them, which
    must all be bitwise equal, every replay's noise new (each step's
    against the step before it), and the eager steps' median time."""
    from vibo_tpu_torch.convert import tree_leaves, tree_map
    from vibo_tpu_torch.train import make_optimizer
    from vibo_tpu_torch.train.trainer import AUX_KEYS

    copy = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    copy_opt = make_optimizer(copy, trainer.cfg.lr)
    for p, q in zip(tree_leaves(params), tree_leaves(copy)):
        copy_opt.state[q] = {k: v.clone()
                             for k, v in optimizer.state[p].items()}
    scan = trainer.make_scan(1.0, samples, FUSED_CHECK_LEN, decoded=decoded)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    graph_aux, noises = [], []
    for _ in range(FUSED_REPLAYS):
        graph_aux.append(scan(params, optimizer, x, y, gen))
        noises.extend(tree_map(torch.clone, n) for n in scan.noise)
    stale = sum(torch.equal(a[1], b[1]) for a, b in zip(noises, noises[1:]))
    eager_aux, eager_ms = [], []
    for item_eps, theta_eps in noises:
        t0 = time.perf_counter()
        aux = (trainer.minibatch_step_with_noise(copy, copy_opt, x, y,
                                                 item_eps, theta_eps, 1.0)
               if decoded else
               trainer.step_with_noise(copy, copy_opt, x, y, item_eps,
                                       theta_eps))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_aux.append(torch.stack([aux[k] for k in AUX_KEYS]))
    pairs = {"aux": [(torch.cat(graph_aux), torch.stack(eager_aux))],
             "params": [(p.detach(), q.detach()) for p, q in
                        zip(tree_leaves(params), tree_leaves(copy))],
             "adam": [(optimizer.state[p][k], copy_opt.state[q][k])
                      for p, q in zip(tree_leaves(params), tree_leaves(copy))
                      for k in ("exp_avg", "exp_avg_sq", "step")]}
    out = {"steps": len(noises),
           **{f"{k}_max_rel": max(rel_err(a, b) for a, b in v)
              for k, v in pairs.items()},
           "bitwise": all(torch.equal(a, b) for v in pairs.values()
                          for a, b in v),
           "noise_repeats": stale,
           "eager_step_ms_median": statistics.median(eager_ms[2:])}
    if not out["bitwise"] or stale:
        raise AssertionError(f"{tag}: graph replays and eager steps "
                             f"disagree: {out}")
    return out


def device_counts(counts: dict) -> dict:
    """Calls a step of each kernel of DEVICE_KERNELS, from a profile_steps
    window's counts."""
    return {k: sum(c for n, c in counts.items() if re.search(rx, n))
            for k, rx in DEVICE_KERNELS.items()}


def eager_counts(tag: str, trainer, params, optimizer, x, y, ran: tuple,
                 med_ms: float, smi: str, decoded: bool = False) -> tuple:
    """EAGER_COUNT_STEPS eager steps of a fused phase's model in a profiler
    window: (each kernel wrapper's launches a step, each DEVICE_KERNELS
    kernel's device calls a step). The steps launch every kernel of `ran`
    and no other, and each path kernel's device calls equal its wrapper's
    launches (a window that lost records is opened again)."""
    from vibo_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for _ in range(PROFILER_TRIES):
        _build.reset_launches()
        prof = profile_steps(
            (lambda: trainer.minibatch_step(params, optimizer, x, y, 1.0,
                                            gen)) if decoded else
            (lambda: trainer.step(params, optimizer, x, y, gen)),
            EAGER_COUNT_STEPS, med_ms, smi, counts=True)
        launches = launch_counts()
        check_path(f"{tag} eager counting window", launches, ran)
        wrapper = {n: c / EAGER_COUNT_STEPS for n, c in launches.items()}
        dev = device_counts(prof["counts"])
        if all(dev[n] == wrapper[n] for n in ran):
            return wrapper, dev
    raise AssertionError(f"{tag}: device calls a step {dev} of the path's "
                         f"kernels differ from their wrappers' launches "
                         f"{wrapper}")


def fused_phase(tag: str, cfg, data: dict, smi: str, ran: tuple,
                epochs: int, eval_every: int, objective: str = "elbo",
                samples: int = 1, must_rise: bool = True,
                eager=None, profile_chunks: int = 3,
                decoded: bool = False) -> dict:
    """The fused full-batch path for one model: Trainer.fit with
    fuse_epochs (each chunk of eval_every steps one CUDA graph) for
    `epochs` at `objective`, every eval's held-out accuracy in [0, 1],
    the bound finite and, where must_rise, rising; graph_matches_eager;
    a chunk's replays timed by CUDA events; and a profiler window of
    `profile_chunks` chunks of replays, in which every kernel of
    DEVICE_KERNELS runs as many times a step as in eager steps of the same
    model (eager_counts), so every kernel of `ran` once a step where its
    wrapper launches it once a step.
    `eager`: full_batch_phase's result for the same
    model, whose steps (same init, seed and noise) the fit's first epochs
    repeat: their ELBOs' max difference is reported beside its step
    median. `decoded`: the decoded full batch (TrainConfig.packed=False,
    every step on data["decoded"], the (response, mask) on the card)."""
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.train import Trainer, TrainConfig

    ds = data["ds"]
    x, y = (data["decoded"] if decoded
            else (data["packed"], data["row_valid"]))
    model = VIBO(cfg)
    trainer = Trainer(model, TrainConfig(
        lr=5e-3, epochs=epochs, eval_every=eval_every, objective=objective,
        num_mc_samples=samples, log_every=1,
        packed=False if decoded else None))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = trainer.fit(ds)
    fit_s = time.perf_counter() - t0
    bounds = [h["elbo"] for h in res["history"] if h["event"] == "train"]
    accs = [h["acc"] for h in res["history"] if h["event"] == "eval"]
    if not (len(bounds) == epochs and np.isfinite(bounds).all()):
        raise AssertionError(f"{tag} fused fit: bad bounds {bounds}")
    if not (len(accs) == -(-epochs // eval_every)
            and all(0.0 <= a <= 1.0 for a in accs)):
        raise AssertionError(f"{tag} fused fit: bad held-out accuracy "
                             f"{accs}")
    if must_rise and not np.mean(bounds[-5:]) > np.mean(bounds[:5]):
        raise AssertionError(f"{tag} fused {objective} did not rise: "
                             f"{bounds}")
    params, optimizer = res["params"], res["optimizer"]
    equal = graph_matches_eager(tag, trainer, params, optimizer, x, y,
                                samples, decoded)
    wrapper, eager_dev = eager_counts(tag, trainer, params, optimizer, x, y,
                                      ran, equal["eager_step_ms_median"],
                                      smi, decoded)

    scan = trainer.make_scan(1.0, samples, eval_every, decoded=decoded)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def chunk():
        return scan(params, optimizer, x, y, gen)

    chunk()                                   # capture and a first replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FUSED_TIMED_REPLAYS):
        chunk()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / (FUSED_TIMED_REPLAYS * eval_every)
    for _ in range(PROFILER_TRIES):
        prof = profile_steps(chunk, profile_chunks, replay_ms, smi,
                             per_call=eval_every, counts=True)
        replay = device_counts(prof["counts"])
        if replay == eager_dev:
            break
    else:
        raise AssertionError(f"{tag} fused: device calls a step of the "
                             f"replays {replay} differ from eager steps' "
                             f"{eager_dev}")
    names = prof.pop("counts")
    seen = {name: [n for n in names if re.search(DEVICE_KERNELS[name], n)]
            for name in ran}
    launches = {k: {"replay": replay[k], "eager": eager_dev[k],
                    **({"wrapper": wrapper[k]} if k in wrapper else {})}
                for k in DEVICE_KERNELS if replay[k] or eager_dev[k]}
    emit({"phase": "fused", "link": tag, "objective": objective,
          "decoded": decoded,
          "samples": samples, "epochs": epochs, "eval_every": eval_every,
          "fit_seconds": fit_s, "train_seconds": res["train_seconds"],
          "warm_train_seconds": res["warm_train_seconds"],
          "bound_first": bounds[0], "bound_last": bounds[-1],
          "heldout_acc": accs, "graph_vs_eager": equal,
          "replay_step_ms": replay_ms,
          "eager_step_ms_median": equal["eager_step_ms_median"],
          "eager_over_replay": equal["eager_step_ms_median"] / replay_ms,
          "kernels_seen": {k: v[0][:60] for k, v in seen.items()},
          "launches_per_step": launches,
          **({} if eager is None else {
              "eager_phase_step_ms_median": eager["step_ms_median"],
              "eager_phase_elbo_max_abs": max(
                  abs(a - b) for a, b in zip(bounds, eager["elbos"]))}),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "profile": prof, "card": smi})
    return {"replay_step_ms": replay_ms,
            "eager_step_ms_median": equal["eager_step_ms_median"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "launches_per_step": launches}


def minibatch_phase(link: str, ds, smi: str, cfg=None, masked=None,
                    must_rise: bool = True):
    """Phases 6 and 7 for one model (default: the link's flagship, its
    masked loglik kernels): minibatch ELBO training through Trainer.fit
    (its last epoch's ELBO over the first one's unless must_rise is off),
    the fit's host work (batch slicing, copy to the card) timed on its own,
    IWAE steps, step times and a profile window on device-resident
    batches, and the held-out IWAE-100 bound. Returns the launch counts of
    the fit and the IWAE steps together, in all and by the masked loglik's
    reader."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.data import batch_iterator
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.train import Trainer, TrainConfig

    model = VIBO(flagship_config(link) if cfg is None else cfg)
    if masked is None:
        masked = LINK_KERNELS[link]["masked"]
    n, m = ds.shape
    item_scale = BATCH / n
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = Trainer(model, TrainConfig(lr=5e-3, epochs=EPOCHS,
                                     batch_size=BATCH, eval_every=EPOCHS,
                                     seed=0, log_every=1)).fit(ds)
    fit_s = time.perf_counter() - t0
    fit_launches, fit_readers = launch_counts(), reader_counts(masked)
    steps = EPOCHS * -(-n // BATCH)
    check_path(f"{link} minibatch path", fit_launches, masked, masked, steps)
    check_dense_only(f"{link} minibatch path", fit_readers)
    epoch_elbo = [h["elbo"] for h in res["history"] if h["event"] == "train"]
    if not (len(epoch_elbo) == EPOCHS and np.isfinite(epoch_elbo).all()):
        raise AssertionError(f"{link} minibatch epoch ELBOs {epoch_elbo}")
    if must_rise and not epoch_elbo[-1] > epoch_elbo[0]:
        raise AssertionError(f"{link} minibatch ELBO did not rise: "
                             f"{epoch_elbo}")
    emit({"phase": "minibatch_train", "link": link, "epochs": EPOCHS,
          "steps": steps, "batch_size": BATCH, "epoch_elbo": epoch_elbo,
          "fit_seconds": fit_s, "train_seconds": res["train_seconds"],
          "cells_per_s": res["cells_per_sec"],
          "heldout_acc": res["best"]["heldout_acc"],
          "launches": fit_launches, "launches_by_reader": fit_readers,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})

    # the fit's host work alone, the same epochs' batches: batch_iterator's
    # row slicing and padding, then the pageable copy of each to the card
    slice_ms, copy_ms = [], []
    for epoch in range(EPOCHS):
        it = batch_iterator(ds, BATCH, 0, epoch)
        while True:
            t0 = time.perf_counter()
            bm = next(it, None)
            if bm is None:
                break
            slice_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in bm:
                torch.from_numpy(x).to("cuda")
            torch.cuda.synchronize()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
    # means, as fit's step is its mean (the padded batch slices faster)
    host = {"fit_step_ms": res["train_seconds"] * 1e3 / steps,
            "slice_ms_mean": statistics.mean(slice_ms),
            "copy_ms_mean": statistics.mean(copy_ms),
            "slice_ms": slice_ms, "copy_ms": copy_ms}

    params, optimizer = res["params"], res["optimizer"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batches = [tuple(torch.from_numpy(x).cuda() for x in bm)
               for bm in batch_iterator(ds, BATCH, 0, EPOCHS)]
    iwae = Trainer(model, TrainConfig(lr=5e-3, batch_size=BATCH,
                                      objective="iwae",
                                      num_mc_samples=IWAE_S))
    _build.reset_launches()
    bounds = [float(iwae.minibatch_step(params, optimizer, r, m_,
                                        item_scale, gen)["elbo"])
              for r, m_ in itertools.islice(itertools.cycle(batches),
                                            IWAE_STEPS)]
    iwae_launches, iwae_readers = launch_counts(), reader_counts(masked)
    check_path(f"{link} IWAE steps", iwae_launches, masked, masked,
               IWAE_STEPS)
    check_dense_only(f"{link} IWAE steps", iwae_readers)
    if not np.isfinite(bounds).all():
        raise AssertionError(f"non-finite {link} IWAE training bound "
                             f"{bounds}")
    emit({"phase": "iwae_train", "link": link, "steps": IWAE_STEPS,
          "samples": IWAE_S, "bounds": bounds, "launches": iwae_launches,
          "launches_by_reader": iwae_readers})

    # step time on device-resident batches (ELBO), 3 epochs' worth
    elbo = Trainer(model, TrainConfig(lr=5e-3, batch_size=BATCH))
    step_ms = []
    for i in range(9):
        r, m_ = batches[i % len(batches)]
        t0 = time.perf_counter()
        elbo.minibatch_step(params, optimizer, r, m_, item_scale, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms[1:])
    # the fit's step against its parts measured here: host slicing, copy,
    # and the step on device-resident batches; the rest is what these do
    # not cover (the first epoch's warm-up among it)
    fit_ms = host["fit_step_ms"]
    parts = {"slice": host["slice_ms_mean"], "copy": host["copy_ms_mean"],
             "device_resident_step": statistics.mean(step_ms[1:])}
    host["share_of_fit_step"] = {
        **{k: v / fit_ms for k, v in parts.items()},
        "rest": 1.0 - sum(parts.values()) / fit_ms}
    # true cells: an epoch of len(batches) steps covers the N * M matrix
    emit({"phase": "minibatch_step", "link": link, "step_ms_median": med,
          "step_ms": step_ms,
          "cells_per_s": n * m / (med * len(batches) / 1e3),
          "fit_host": host, "card": smi})
    cycle = itertools.cycle(batches)
    emit({"phase": "minibatch_profile", "link": link, **profile_steps(
        lambda: elbo.minibatch_step(params, optimizer, *next(cycle),
                                    item_scale, gen), 6, med, smi)})

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev = evaluation.iwae_loglik(model, params, ds, num_samples=100,
                                on="heldout", generator=gen)
    torch.cuda.synchronize()
    iwae_s = time.perf_counter() - t0
    if not (np.isfinite(ev["loglik_per_cell"]) and ev["loglik_per_cell"] < 0
            and ev["num_cells"] > 0):
        raise AssertionError(f"bad {link} held-out IWAE-100 {ev}")
    emit({"phase": "iwae_heldout", "link": link, **ev, "seconds": iwae_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})
    readers = {n: {v: fit_readers[n].get(v, 0) + iwae_readers[n].get(v, 0)
                   for v in ("dense", "int8")} for n in masked}
    return ({n: fit_launches[n] + iwae_launches[n] for n in fit_launches},
            readers)


def flagship_config(link: str = "2pl", compute_dtype: str = "bfloat16"):
    """The flagship of bench.py with the given link (grm/gpcm: its default
    C = 5); compute_dtype float32 is JAX's CLI configuration."""
    from vibo_tpu_torch.models import VIBOConfig
    return VIBOConfig(num_items=M, irt_model=link, ability_dim=K,
                      hidden_dim=H, conditional_posterior=True,
                      condition_on="sample", use_pallas=True,
                      compute_dtype=compute_dtype,
                      num_categories=C if link in FAMILIES else 2)


def link_data(link: str) -> dict:
    """The link's flagship data (simulate_irt, seed 0, 10 % missing, 10 %
    held out; grm/gpcm C = 5) on the card as the paths take it: the int8
    code of the training cells, and epoch 0's first and last (padded)
    minibatch."""
    from vibo_tpu_torch.data import batch_iterator, holdout_split, simulate_irt
    from vibo_tpu_torch.ops.packing import packed_on_device
    cats = C if link in FAMILIES else 2
    sim = simulate_irt(link, B, M, ability_dim=K, seed=0, missing_rate=0.1,
                       num_categories=cats)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0,
                       num_categories=cats)
    packed, row_valid = packed_on_device(ds.response, ds.train_mask)
    epoch0 = list(batch_iterator(ds, BATCH, 0, 0))
    first = tuple(torch.from_numpy(x).cuda() for x in epoch0[0])
    last = tuple(torch.from_numpy(x).cuda() for x in epoch0[-1])
    pad_rows = int((last[1].sum(-1) == 0).sum())
    if pad_rows != len(epoch0) * BATCH - B:
        raise AssertionError(f"last batch has {pad_rows} empty rows")
    return {"ds": ds, "packed": packed, "row_valid": row_valid,
            "first": first, "last": last, "pad_rows": pad_rows}


def masked_checks(timer, roof, link: str, data: dict, gen, ragged, odd):
    """check_masked of one link at every shape the paths give it and at
    the edges: the minibatch (timed), the IWAE call, the padded batch, a
    ragged shape with sample axes and shared items, K = 1 and 8 at M off
    the vector width, and the VJP's item split's edge (the last split
    shorter, B off the block, also with 2 samples)."""
    kw = dict(link=link)
    tail = torch.randint(0, 3, MASKED_SPLIT_TAIL, generator=gen,
                         device="cuda", dtype=torch.int8)
    tail = ((tail == 2).float(), (tail > 0).float())
    return {
        "split_tail": check_masked(timer, roof, *tail, gen, False, **kw),
        "split_tail_S2": check_masked(timer, roof, *tail, gen, False,
                                      samples=2, **kw),
        "minibatch": check_masked(timer, roof, *data["first"], gen, True,
                                  **kw),
        # the IWAE steps' call: S samples, per-sample items, shared data
        f"minibatch_S{IWAE_S}": check_masked(timer, roof, *data["first"],
                                             gen, False, samples=IWAE_S,
                                             **kw),
        "minibatch_padded": check_masked(timer, roof, *data["last"], gen,
                                         False, **kw),
        "ragged": check_masked(timer, roof, *ragged, gen, False, **kw),
        "ragged_S2": check_masked(timer, roof, *ragged, gen, False,
                                  samples=2, **kw),
        "ragged_S3_shared_items": check_masked(timer, roof, *ragged, gen,
                                               False, samples=3,
                                               shared_items=True, **kw),
        "odd_K1_S2": check_masked(timer, roof, *odd, gen, False, samples=2,
                                  k=1, **kw),
        "odd_K8": check_masked(timer, roof, *odd, gen, False, k=8, **kw),
    }


def wide_k_checks(timer, roof, gen, ragged_pk, ragged, ragged_graded):
    """Every loglik kernel at K beyond its instantiated 1..8 (the wide
    variant: a pass a chunk of 8 ability dims) against its plain version on
    the ragged shape: the one-pass 2PL and 3PL kernels in both theta
    layouts, the masked 2PL and 3PL kernels with both readers (with a
    sample axis of 2 at K = 12), and the GRM and GPCM kernels (C = 5)."""
    out = {}
    for k in WIDE_K:
        r = {}
        for link in ("2pl", "3pl"):
            r[LINK_KERNELS[link]["train"]] = check_loglik(
                timer, roof, ragged_pk, gen, False, link, k)
            r[f"masked_loglik_{link}"] = check_masked(
                timer, roof, *ragged, gen, False, k=k, link=link,
                samples=2 if k == 12 else None)
        for fam in FAMILIES:
            r[LINK_KERNELS[fam]["train"]] = check_categorical(
                timer, roof, fam, ragged_graded, C, gen, k=k)
        out[f"K{k}"] = r
    return out


# ------------------------------------------------------------- deep link


def deep_link_params(k: int, h: int, gen, scale: float = 1.0) -> dict:
    """A random deep link (JAX's init_deep_link's scales, biases drawn too)
    on the card; scale multiplies the output layer (the extreme point)."""
    def uni(shape, fan):
        bound = (6.0 / fan) ** 0.5
        return (2.0 * torch.rand(shape, generator=gen, device="cuda")
                - 1.0) * bound
    return {"w_theta": uni((k, h), k + DEEP_D + h),
            "w_item": uni((DEEP_D, h), k + DEEP_D + h),
            "b1": 0.1 * torch.randn((h,), generator=gen, device="cuda"),
            "layer2": {"w": uni((h, h), 2 * h),
                       "b": 0.1 * torch.randn((h,), generator=gen,
                                              device="cuda")},
            "out": {"w": scale * uni((h, 1), h + 1),
                    "b": 0.1 * torch.randn((1,), generator=gen,
                                           device="cuda")}}


def deep_args(link: dict, theta, d, pk):
    """The kernel's inputs: t1, t2 (f32, as the op computes them), W2, b2,
    wo (H,), bo (1,), the code."""
    return (theta @ link["w_theta"] + link["b1"], d @ link["w_item"],
            link["layer2"]["w"], link["layer2"]["b"],
            link["out"]["w"].reshape(-1), link["out"]["b"], pk)


def deep_rows_f64(args, f32_dots: bool, axis: int, rows) -> tuple:
    """Rows of the deep link's s_theta (axis 0: students) or s_d (axis 1:
    items) in f64 from the function's own rounded operands (bf16 h1, W2 and
    dpre2; f32 with f32_dots), with exact sums and relu decisions -> (the
    rows (R, H), the most relu flips can move each row's largest entry).
    Two f32 versions of pre2_n = h1 . W2_n + b2_n differ from the exact one
    by at most (H + 2) 2^-23 (sum_j |h1_j W2_jn| + |b2_n|) each (summation
    and, f32_dots, product rounding, doubled for sums that truncate), so
    they can take opposite relu branches only where |pre2_n| lies inside
    that; each such pair and unit moves the row by at most
    |dl wo_n| (1 + 2^-7) max_j |W2_jn| (dl's own noise and dpre2's bf16
    rounding in the 2^-7)."""
    from vibo_tpu_torch._device import cast_through
    from vibo_tpu_torch.ops.packing import decode_packed
    t1, t2, w2, b2, wo, bo, pk = args
    cd = torch.float32 if f32_dots else torch.bfloat16
    h = t1.shape[1]
    w2c = cast_through(w2, cd).double()
    w2a, b2d, wod = w2c.abs(), b2.double(), wo.double()
    col_max = w2a.amax(0)
    mask, resp = (x.double() for x in decode_packed(pk))
    out, moves = [], []
    for r in rows.tolist():
        if axis == 0:
            pre1 = t1[r][None, :] + t2                       # (M, H) f32
            mk, rs = mask[r], resp[r]
        else:
            pre1 = t1 + t2[r][None, :]                       # (B, H) f32
            mk, rs = mask[:, r], resp[:, r]
        h1c = cast_through(pre1.clamp(min=0.0), cd).double()
        pre2 = h1c @ w2c + b2d
        noise = (h + 2) * 2.0 ** -23 * (h1c.abs() @ w2a + b2d.abs())
        logit = pre2.clamp(min=0.0) @ wod + float(bo)
        dl = mk * (rs - torch.sigmoid(logit))
        dpre2 = torch.where(pre2 > 0, dl[:, None] * wod, 0.0)
        dpc = cast_through(dpre2.float(), cd).double()
        out.append(torch.where(pre1 > 0, dpc @ w2c.T, 0.0).sum(0))
        move = dl.abs()[:, None] * (wod.abs() * col_max) * (1 + 2.0 ** -7)
        moves.append(float((move * (pre2.abs() <= noise)).sum()))
    return (torch.stack(out) if out else w2c.new_empty((0, h)),
            torch.tensor(moves, dtype=torch.float64))


def hinge_counts(args, h: int, rec: int) -> dict:
    """Row 15f's f64 recomputes of pre2 (the kernel's count, rec; -1 where
    the width's kernel does not count: printed as None) and their share of
    the B M H pre2 values; beside them the values its hinge test flags on
    the plain f32 version's pre2 (|pre2| <= hinge(H) max_k h1_k sum_k
    |W2_kn|; at 256-512 the kernel tests observed cells of the table only,
    at 128 every cell): an estimate of the kernel's count, which differs
    only where the split's pre2 and cuBLAS's part across the bound."""
    from vibo_tpu_torch.ops.packing import decode_packed
    if h not in DEEP_SPLIT_H:
        return {}
    t1, t2, w2, b2, wo, bo, pk = args
    bsz, m = pk.shape
    hinge = deep_f32_hinge(h)
    bound = hinge * w2.abs().sum(0)                         # (H,)
    observed = decode_packed(pk)[0] > 0
    flagged = 0
    block = max(1, (1 << 25) // max(1, bsz * h))
    with torch.no_grad():
        for s in range(0, m, block):
            h1 = (t1[:, None, :] + t2[None, s:s + block, :]).clamp(min=0.0)
            pre2 = h1 @ w2 + b2
            near = pre2.abs() <= h1.amax(-1, keepdim=True) * bound
            if h != 128:
                near &= observed[:, s:s + block, None]
            flagged += int(near.sum())
    values = bsz * m * h
    return {"hinge_recomputes": rec if rec >= 0 else None,
            "hinge_recompute_share": rec / values if rec >= 0 else None,
            "hinge_flagged_plain": flagged,
            "hinge_flagged_plain_share": flagged / values,
            "hinge": hinge}


def deep_f32_hinge(h: int) -> float:
    """Row 15f's hinge at width h, as its library states it
    (`deep_link_f32_hinge`: HINGE at 128, deep_hinge(H) at 256-512)."""
    import ctypes
    from vibo_tpu_torch.ops import _build
    fn, _ = _build.bind("deep_link_f32.cu", "deep_link_f32_hinge",
                        [ctypes.c_int])
    fn.restype = ctypes.c_float
    return float(fn(h))


def check_deep(timer, roof, pk, gen, k: int = DEEP_K, h: int = DEEP_H,
               timed: bool = False, link=None, theta=None, d=None,
               f32_dots: bool = False) -> dict:
    """The deep-link kernel (csrc/deep_link.cu; f32_dots: row 15f,
    csrc/deep_link_f32.cu, against the plain version's f32 mode; either
    launched a second time, bitwise equal to the first) against its plain
    version on
    the code pk: ll, s_theta, s_d, dW2, db2, dwo and dbo. Both round the
    same operands to bf16 (or, f32_dots, neither does: at H = 128 the
    kernel sums the six products of each operand's three bf16 parts, f32
    accuracy, elsewhere CUDA-core fmaf chains) and sum in different orders
    against cuBLAS's f32 product, so ll, dwo and dbo must agree to 1e-5,
    1e-4 and 1e-4 of their largest magnitude. The others also carry relu
    flips: a pre2 within that summation noise of 0 takes the other branch in
    one version, which moves its pair's dpre2_n by dlogit wo_n (|dlogit| <
    1): db2_n by at most max|wo|, dW2's column n by max|h1| max|wo|, and its
    student's s_theta row and its item's s_d row by max|wo| max|W2| (one
    `flip` each). Flips grow with the pairs and H (14 s_theta rows of 5,520
    at H = 256 in one run). So dW2 and db2 must agree to 1e-4 plus 4 flips;
    every row of s_theta and s_d to 1e-4 plus what the flips its pairs can
    carry move it (deep_rows_f64, counted in f64 for each row past 1e-4),
    and a row no flip can reach to 1e-4. Those rows are also held against
    the f64 rows, kernel and plain alike. Rows with no observed cell must
    give exactly 0."""
    from vibo_tpu_torch.ops import pallas_deep as pd
    bsz, m = pk.shape
    if link is None:
        link = deep_link_params(k, h, gen)
    if theta is None:
        theta = torch.randn((bsz, k), generator=gen, device="cuda")
        d = torch.randn((m, DEEP_D), generator=gen, device="cuda")
    args = deep_args(link, theta, d, pk)
    got = pd.train_cuda(*args, f32_dots=f32_dots, recomputes=f32_dots)
    ref = pd.fused_deep_plain(*args, f32_dots=f32_dots)
    again = pd.train_cuda(*args, f32_dots=f32_dots, recomputes=f32_dots)
    torch.cuda.synchronize()
    if f32_dots:   # the f64 recomputes of pre2 (-1: not counted)
        (*got, rec), (*again, rec2) = got, again
        rec, rec2 = int(rec), int(rec2)
    names = ("ll", "s_theta", "s_d", "dW2", "db2", "dwo", "dbo")
    by_output = {n: rel_err(x, y) for n, x, y in zip(names, got, ref)}
    wo_max = float(link["out"]["w"].abs().max())
    flip = {"s_theta": wo_max * float(link["layer2"]["w"].abs().max()),
            "dW2": wo_max * float(args[0].abs().max() + args[1].abs().max()),
            "db2": wo_max}
    flip["s_d"] = flip["s_theta"]
    flips = {}
    for axis, (i, n) in enumerate(((1, "s_theta"), (2, "s_d"))):
        row_err = (got[i] - ref[i]).abs().amax(1)
        tol = 1e-4 * float(ref[i].abs().max())
        far = torch.nonzero(row_err > tol).flatten()
        exact, moves = deep_rows_f64(args, f32_dots, axis, far)
        err = row_err[far].double().cpu()
        flips[n] = {"rows": len(far),
                    "rows_no_flip_reaches": int((moves == 0).sum()),
                    "unexplained": int((err > tol + moves).sum()),
                    "max_err_over_allowed": float(
                        (err / (tol + moves)).max()) if len(far) else 0.0,
                    "max_err_in_flips": float(row_err.max()) / flip[n]}
        if len(far):
            flips[n]["f64_max_abs"] = {
                "kernel": max_abs(got[i][far], exact),
                "plain": max_abs(ref[i][far], exact)}
    for i, n in ((3, "dW2"), (4, "db2")):
        excess = max_abs(got[i], ref[i]) - 1e-4 * float(ref[i].abs().max())
        flips[n] = {"excess_over_1e-4_in_flips": max(excess, 0.0) / flip[n]}
    r = {"ll_rel_err": by_output["ll"],
         "grad_rel_err": max(by_output[n] for n in names[3:]),
         "max_abs_err": max(max_abs(x, y) for x, y in zip(got, ref)),
         "rel_err_by_output": by_output, "relu_flips": flips}
    empty = (pk == 0).all(-1)
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    inert = bool(got[0][empty].eq(0).all() and got[1][empty].eq(0).all())
    flips_ok = (all(flips[n]["unexplained"] == 0
                    for n in ("s_theta", "s_d"))
                and all(flips[n]["excess_over_1e-4_in_flips"] <= 4.0
                        for n in ("dW2", "db2")))
    r["bitwise_repeat"] = all(bool(torch.equal(x, y))
                              for x, y in zip(got, again))
    if f32_dots:
        r["bitwise_repeat"] = r["bitwise_repeat"] and rec == rec2
        r.update(hinge_counts(args, h, rec))
    if not (finite and inert and flips_ok and by_output["ll"] <= 1e-5
            and by_output["dwo"] <= 1e-4 and by_output["dbo"] <= 1e-4
            and r["bitwise_repeat"]):
        raise AssertionError(f"deep_link_{'f32_' if f32_dots else ''}train "
                             f"at {tuple(pk.shape)}, K={k}, H={h} disagrees "
                             f"with its plain version, is not finite, does "
                             f"not repeat bitwise or an all-missing row is "
                             f"not inert: {r}")
    r["inert_rows"] = int(empty.sum())
    if timed and f32_dots:
        pairs = bsz * m
        r["ms"] = timer(lambda: pd.train_cuda(*args, f32_dots=True))
        r["plain_ms"] = timer(lambda: pd.fused_deep_plain(*args,
                                                          f32_dots=True))
        r["library_ms"] = None
        small = bsz * h + m * h + h * h + 2 * h + 1
        nbytes = pairs + 4 * small + 4 * (small + bsz)
        # three f32 products (6 H^2 a pair) and the cell work outside them,
        # all on the CUDA cores' f32 rate; the function's special functions
        # (exp, log1p, the reciprocal) a pair, the SASS's lines beside it
        r["bound_ms"], r["bound_by"], r["bound_terms_ms"] = roof.bound(
            nbytes, (6 * h * h + DEEP_PAIR_OPS(h)) * pairs, F32_FLOPS,
            DEEP_F32_PAIR_MUFU * pairs, terms=True)
        # the same work as the H = 128 kernel does it: the split's six bf16
        # products on the tensor cores, the split, the chunk adds and the
        # cell work at the f32 rate
        r["bound_split_ms"], r["bound_split_by"], r["bound_split_terms_ms"] = \
            roof.bound(nbytes, DEEP_SPLIT_PAIR_TC_OPS(h) * pairs, BF16_FLOPS,
                       DEEP_F32_PAIR_MUFU * pairs,
                       f32_ops=(DEEP_PAIR_OPS(h) + DEEP_SPLIT_PAIR_OPS(h))
                       * pairs, terms=True)
        kernel = DEEP_F32_KERNEL(h)
        r["sass_mufu_lines"] = roof.mufu_lines("deep_link_f32.cu", kernel)
        r["sass_hmma_lines"] = roof.hmma_lines("deep_link_f32.cu", kernel)
        if h in DEEP_SPLIT_H and not r["sass_hmma_lines"]:
            raise AssertionError(f"{kernel} has no HMMA line in its SASS: "
                                 "row 15f does not run on the tensor cores")
        r["occupancy"] = deep_f32_occupancy(h)
        if h in DEEP_SPLIT_H:
            # the f64 path's cost: the same launch with b2 raised past
            # every |h1 . W2_n| (h1 <= max t1 + max t2), so that no pre2
            # lies within the hinge; products, adds and exchanges the same
            t1, t2, w2, b2 = args[:4]
            lift = (2.0 * (t1.amax() + t2.amax()).clamp(min=0.0)
                    * w2.abs().sum(0) + b2.abs())
            lifted = (t1, t2, w2, b2 + lift, *args[4:])
            r["no_recompute_ms"] = timer(
                lambda: pd.train_cuda(*lifted, f32_dots=True))
            r["no_recompute_count"] = int(pd.train_cuda(
                *lifted, f32_dots=True, recomputes=True)[-1])
            r["recompute_share_of_ms"] = 1.0 - r["no_recompute_ms"] / r["ms"]
    elif timed:
        r["ms"] = timer(lambda: pd.train_cuda(*args))
        r["plain_ms"] = timer(lambda: pd.fused_deep_plain(*args))
        r["library_ms"] = None
        pairs = bsz * m
        # H = 128: one block a student tile; 256, 384, 512: a cluster;
        # other widths the wide variant (32 students a block up to H =
        # 832). At H = 128 a lane's special-function lines serve its two
        # pairs (rows g and g + 8 of its row tile); elsewhere a lane's
        # serve one pair (in the cluster kernel every lane of the pair in
        # every CTA runs them: the function's count is taken once)
        mufu = roof.mufu_lines("deep_link.cu", DEEP_KERNEL(h))
        if h == 128:
            mufu /= 2
        if h == 128 or h in CLUSTER_H:
            r["occupancy"] = occupancy("deep", h)
        # inputs t1, t2, W2, b2, wo, bo and the code read once; ll, s_theta,
        # s_d, dW2, db2, dwo, dbo written once
        small = bsz * h + m * h + h * h + 2 * h + 1
        r["bound_ms"], r["bound_by"], r["bound_terms_ms"] = roof.bound(
            pairs + 4 * small + 4 * (small + bsz), 6 * h * h * pairs,
            BF16_FLOPS, mufu * pairs, f32_ops=DEEP_PAIR_OPS(h) * pairs,
            terms=True)
        r["mufu_per_pair"] = mufu
    return r


def check_deep_op(pk, gen, samples: int | None = None,
                  shared_d: bool = False) -> dict:
    """The deep autograd op on the card against the kernel's own outputs
    put through the op's contract: without a sample axis under a
    non-uniform cotangent g, dtheta = (g s_theta) W_theta^T, dW_theta =
    theta^T (g s_theta) and db1 = sum g s_theta, each person's own g; dd =
    g0 s_d W_item^T, dW_item = g0 d^T s_d, and dW2, db2, dwo, dbo times g0,
    g0 the first entry of g; with `samples` samples (d per sample or
    shared, the code shared) under a uniform one, each sample's terms
    summed where the parameter is shared. Same arithmetic on both sides:
    1e-5 of each array's largest magnitude."""
    from vibo_tpu_torch.convert import tree_leaves, tree_map
    from vibo_tpu_torch.ops import pallas_deep as pd
    bsz, m = pk.shape
    lead = (samples,) if samples else ()
    per_d = samples is not None and not shared_d
    link = tree_map(lambda t: t.requires_grad_(),
                    deep_link_params(DEEP_K, DEEP_H, gen))
    theta = torch.randn(lead + (bsz, DEEP_K), generator=gen,
                        device="cuda").requires_grad_()
    d = torch.randn(((samples,) if per_d else ()) + (m, DEEP_D),
                    generator=gen, device="cuda").requires_grad_()
    g = (2.0 * torch.rand(lead + (bsz,), generator=gen, device="cuda") - 0.5
         if samples is None else torch.ones(lead + (bsz,), device="cuda"))
    ll = pd.masked_loglik_deep_packed_train(theta, d, link, pk)
    (ll * g).sum().backward()
    with torch.no_grad():
        lk = tree_map(lambda t: t.detach(), link)
        want = {"ll": [], "theta": [], "d": [],
                "link": tree_map(torch.zeros_like, lk)}
        for s in range(samples or 1):
            th = theta[s] if samples else theta
            ds = d[s] if per_d else d
            gs = g[s] if samples else g
            out = pd.train_cuda(*deep_args(lk, th.detach(), ds.detach(), pk))
            sth, sd, dw2, db2, dwo, dbo = out[1:]
            gsth, g0 = gs[:, None] * sth, gs[0]
            want["ll"].append(out[0])
            want["theta"].append(gsth @ lk["w_theta"].T)
            want["d"].append(g0 * (sd @ lk["w_item"].T))
            for (key, sub), v in ((("w_theta", None), th.detach().T @ gsth),
                                  (("w_item", None), g0 * (ds.detach().T @ sd)),
                                  (("b1", None), gsth.sum(0)),
                                  (("layer2", "w"), g0 * dw2),
                                  (("layer2", "b"), g0 * db2),
                                  (("out", "w"), g0 * dwo[:, None]),
                                  (("out", "b"), g0 * dbo)):
                node = want["link"][key]
                if sub is None:
                    want["link"][key] = node + v
                else:
                    node[sub] = node[sub] + v
        stack = (lambda x: torch.stack(x)) if samples else (lambda x: x[0])
        want_d = (torch.stack(want["d"]) if per_d
                  else sum(want["d"]))
        pairs = [(ll.detach(), stack(want["ll"])),
                 (theta.grad, stack(want["theta"])), (d.grad, want_d)]
        pairs += list(zip([p.grad for p in tree_leaves(link)],
                          tree_leaves(want["link"])))
    torch.cuda.synchronize()
    r = {"ll_rel_err": rel_err(*pairs[0]),
         "grad_rel_err": max(rel_err(x, y) for x, y in pairs[1:])}
    if not (r["ll_rel_err"] <= 1e-5 and r["grad_rel_err"] <= 1e-5):
        raise AssertionError(f"masked_loglik_deep_packed_train (S={samples}, "
                             f"shared_d={shared_d}) does not give the "
                             f"kernel's outputs through its contract: {r}")
    return r


def deep_extremes(gen) -> dict:
    """The kernel at the extreme points, 96 students x 200 items, K = 2:
    |logit| > 30 (the output layer scaled by 400), a mixed code with rows
    that have no observed cell (ll exactly 0), every cell right, every
    cell wrong. Each finite and equal to the plain version."""
    from vibo_tpu_torch.models import networks
    link = deep_link_params(DEEP_K, DEEP_H, gen, scale=400.0)
    mixed = torch.randint(0, 3, (96, 200), generator=gen, device="cuda",
                          dtype=torch.int8)
    mixed[[5, 64, 95]] = 0
    codes = {"mixed_empty_rows": mixed,
             "all_right": torch.full((96, 200), 2, dtype=torch.int8,
                                     device="cuda"),
             "all_wrong": torch.ones((96, 200), dtype=torch.int8,
                                     device="cuda")}
    out = {}
    for name, pk in codes.items():
        theta = 3.0 * torch.randn((96, DEEP_K), generator=gen, device="cuda")
        d = torch.randn((200, DEEP_D), generator=gen, device="cuda")
        out[name] = check_deep(None, None, pk, gen, link=link, theta=theta,
                               d=d)
        logit = networks.apply_deep_link(link, theta, d).abs().max()
        if not float(logit) > 30.0:
            raise AssertionError(f"the extreme point reaches |logit| "
                                 f"{float(logit)} only")
        out[name]["logit_abs_max"] = float(logit)
    return out


def deep_kernel_checks(timer, roof, data: dict, gen) -> dict:
    """Every check of the deep-link kernel (phase 3): config 5 on its own
    code (timed), the 10,240 x 1,024 table shape at K = 4 (timed), the
    ragged 777 x 301 at K = 1 and 8, the cluster kernel at H = 256, 384 and
    512 on config 5 (timed) and 777 x 301, the wide variant at H = 640 on
    777 x 301, the autograd op with a non-uniform cotangent and with a
    sample axis of 3 (per-sample and shared d), the extreme points, and the
    H = 256 check at 777 x 301 on DEEP_DRAWS draws of its own
    (deep_draws)."""
    big = torch.randint(0, 3, (B, M), generator=gen, device="cuda",
                        dtype=torch.int8)
    odd = torch.randint(0, 3, ODD, generator=gen, device="cuda",
                        dtype=torch.int8)
    return {
        "config5": check_deep(timer, roof, data["packed"], gen, timed=True),
        "table_shape_K4": check_deep(timer, roof, big, gen, k=K, timed=True),
        "odd_K1": check_deep(timer, roof, odd, gen, k=1),
        "odd_K8": check_deep(timer, roof, odd, gen, k=8),
        # the cluster kernel (W2 and dW2 outgrow one SM)
        "config5_H256": check_deep(timer, roof, data["packed"], gen, h=256,
                                   timed=True),
        "odd_H256": check_deep(timer, roof, odd, gen, h=256),
        "config5_H384": check_deep(timer, roof, data["packed"], gen, h=384,
                                   timed=True),
        "config5_H512": check_deep(timer, roof, data["packed"], gen, h=512,
                                   timed=True),
        "odd_H384_K8": check_deep(timer, roof, odd, gen, k=8, h=384),
        "odd_H512": check_deep(timer, roof, odd, gen, h=512),
        # the wide variant (past the cluster's shared memory and registers)
        f"odd_H{DEEP_WIDE_H}": check_deep(timer, roof, odd, gen,
                                          h=DEEP_WIDE_H),
        "cotangent": check_deep_op(odd, gen),
        "S3_per_sample": check_deep_op(odd, gen, 3),
        "S3_shared_d": check_deep_op(odd, gen, 3, shared_d=True),
        "extremes": deep_extremes(gen),
        "odd_H256_draws": deep_draws(timer, roof),
    }


def deep_draws(timer, roof) -> dict:
    """check_deep at 777 x 301, K = 2, H = 256 (bf16) on DEEP_DRAWS draws,
    each code, link and input from a generator of its own (seeded 100 +
    the draw): the rows past 1e-4, how many a flip can reach, the largest
    error over its allowance and, on those rows, kernel and plain against
    f64, draw by draw."""
    out = []
    for i in range(DEEP_DRAWS):
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + i)
        pk = torch.randint(0, 3, ODD, generator=g, device="cuda",
                           dtype=torch.int8)
        flips = check_deep(timer, roof, pk, g, h=256)["relu_flips"]
        out.append({n: flips[n] for n in ("s_theta", "s_d")})
    return {"seeds": [100 + i for i in range(DEEP_DRAWS)], "draws": out,
            "rows_past_1e-4": sum(d[n]["rows"] for d in out
                                  for n in ("s_theta", "s_d")),
            "rows_no_flip_reaches": sum(d[n]["rows_no_flip_reaches"]
                                        for d in out
                                        for n in ("s_theta", "s_d"))}


def deep_f32_occupancy(h: int) -> dict:
    """Row 15f's kernel at width h: ptxas's registers, local (spill) bytes,
    resident blocks an SM, cluster size (1 without clusters) and the
    clusters (blocks, without) the device holds at once
    (`deep_link_f32_occupancy`)."""
    import ctypes
    from vibo_tpu_torch.ops import _build
    out = (ctypes.c_int * 5)()
    fn, lib = _build.bind("deep_link_f32.cu", "deep_link_f32_occupancy",
                          [ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(h, out), lib, f"deep_link_f32_occupancy H={h}")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "cluster_size": out[3],
            "resident_clusters": out[4]}


def check_deep_f32_chains(timer, roof, pk, gen, k: int, chains: int,
                          timed: bool) -> dict:
    """Row 15f (csrc/deep_link_f32.cu) as the deep HMC potential calls it:
    `chains` draws of theta (B, K) and d (M, D) under one link on one code,
    one launch a chain, each against the plain f32 version (check_deep's
    gates, f32_dots), the first timed."""
    link = deep_link_params(k, DEEP_H, gen)
    bsz, m = pk.shape
    per = []
    for c in range(chains):
        theta = torch.randn((bsz, k), generator=gen, device="cuda")
        d = torch.randn((m, DEEP_D), generator=gen, device="cuda")
        per.append(check_deep(timer, roof, pk, gen, k, DEEP_H,
                              timed and c == 0, link, theta, d,
                              f32_dots=True))
    r = dict(per[0])
    for key in ("ll_rel_err", "grad_rel_err", "max_abs_err"):
        r[key] = max(x[key] for x in per)
    r["chains"] = chains
    r["relu_flip_rows"] = [{n: x["relu_flips"][n]["rows"]
                            for n in ("s_theta", "s_d")} for x in per]
    return r


def deep_f32_checks(timer, roof, deep: dict, gen) -> dict:
    """Row 15f at the deep gold's shape (2,000 x 200, K = 2, H = 128) with
    4 chains (timed), at config 5's (timed), at the edges: 777 x 301 at K =
    1 and 8 with empty rows, 40 students; the cluster kernel at the deep
    gold's shape at widths 256, 384 and 512 (one chain, timed), at 777 x
    301 at 256 and 384 and at 300 x 200 at 512; the CUDA-core kernel at
    width 640 on 777 x 301; every check with a second launch bitwise equal
    to the first."""
    gold_pk = torch.randint(0, 3, (DEEP_GOLD_B, DEEP_GOLD_M), generator=gen,
                            device="cuda", dtype=torch.int8)
    odd = torch.randint(0, 3, ODD, generator=gen, device="cuda",
                        dtype=torch.int8)
    odd[[0, 5, ODD[0] - 1]] = 0
    tiny = torch.randint(0, 3, TINY, generator=gen, device="cuda",
                         dtype=torch.int8)
    return {
        "deep_gold_4_chains": check_deep_f32_chains(
            timer, roof, gold_pk, gen, DEEP_K, HMC_CHAINS, timed=True),
        "config5": check_deep(timer, roof, deep["packed"], gen, timed=True,
                              f32_dots=True),
        "odd_K1": check_deep(timer, roof, odd, gen, k=1, f32_dots=True),
        "odd_K8": check_deep(timer, roof, odd, gen, k=8, f32_dots=True),
        "tiny": check_deep(timer, roof, tiny, gen, f32_dots=True),
        "odd_H256": check_deep(timer, roof, odd, gen, h=256, f32_dots=True),
        "gold_H512": check_deep(timer, roof, gold_pk[:300], gen, h=512,
                                f32_dots=True),
        "odd_H384": check_deep(timer, roof, odd, gen, h=384, f32_dots=True),
        # wider widths: f32 on the CUDA cores, the buffers in the scratch
        f"odd_H{DEEP_WIDE_H}": check_deep(timer, roof, odd, gen,
                                          h=DEEP_WIDE_H, f32_dots=True),
        **{f"deep_gold_H{h}": check_deep(timer, roof, gold_pk, gen, h=h,
                                         timed=True, f32_dots=True)
           for h in CLUSTER_H},
    }


def load_gold(name: str) -> dict:
    """artifacts/gold/<name>/baseline_hmc.npz: the JAX package's posterior
    summary (theta_hat, theta_sd; a_hat and b_hat, the item posterior
    means, where it has them) and its summary line."""
    z = np.load(GOLD_DIR / name / "baseline_hmc.npz")
    return {"theta_hat": z["theta_hat"], "theta_sd": z["theta_sd"],
            **{k: z[k] for k in ("a_hat", "b_hat") if k in z.files},
            "summary": json.loads(str(z["summary_json"])),
            "shape": [int(v) for v in z["shape"]], "seed": int(z["seed"])}


def heldout_accuracy(prob: np.ndarray, ds) -> float:
    """The CLI's held-out accuracy of posterior-predictive probabilities:
    p > 0.5, or the most probable category of (N, M, C)."""
    pred = (prob.argmax(-1) if prob.ndim == 3 else prob > 0.5
            ).astype(np.float32)
    h = ds.heldout_mask
    return float((h * (pred == ds.response)).sum() / h.sum())


def hmc_cfg(model: str, k: int, c: int = 2, depth: tuple = HMC_SHORT,
            **kw):
    """The smoke's HMCConfig: depth (warm-up, draws, leapfrogs), HMC_CHAINS
    chains at HMC_TARGET, seed 0; or depth (warm-up, draws), NUTS at
    NUTS_TREE_DEPTH and NUTS_TARGET, as the NUTS golds."""
    from vibo_tpu_torch.models import hmc
    if len(depth) == 2:
        kw = dict(trajectory="nuts", max_tree_depth=NUTS_TREE_DEPTH,
                  target_accept=NUTS_TARGET, **kw)
        depth = (*depth, hmc.HMCConfig.num_leapfrog)
    warm, draws, leap = depth
    kw.setdefault("target_accept", HMC_TARGET)
    return hmc.HMCConfig(irt_model=model, ability_dim=k, num_categories=c,
                         num_warmup=warm, num_samples=draws,
                         num_leapfrog=leap, num_chains=HMC_CHAINS, seed=0,
                         **kw)


def depth_cut(depth: tuple, gold: bool = False) -> str:
    if len(depth) == 2:
        return (f"{depth[0]} warm-up + {depth[1]} draws a chain, NUTS at "
                f"tree depth {NUTS_TREE_DEPTH} (the gold: 800 + 1,200 at "
                f"depth 7); widths and data the gold's")
    warm, draws, leap = depth
    return (f"{warm} warm-up + {draws} draws a chain at {leap} leapfrogs"
            + (" (the gold: 800 + 1,600 at 64); widths and data the gold's"
               if gold else ""))


def hmc_evals_per_iter(cfg) -> int:
    """Potential evaluations an iteration of a fixed trajectory: its
    leapfrogs and the refresh after the ridge or rotation moves (NUTS's
    are counted, `hmc.counts`)."""
    ridge = cfg.ridge_moves > 0 and cfg.irt_model != "deep"
    rot = cfg.ability_dim > 1 and cfg.irt_model in ("2pl", "3pl", "grm",
                                                    "gpcm")
    return cfg.num_leapfrog + int(ridge or rot)


def same_bits(a, b) -> bool:
    """Bit for bit (NaN and inf where the other has them too)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.bool_:
        return bool((a == b).all())
    return bool((a.view(f"u{a.itemsize}") == b.view(f"u{b.itemsize}")).all())


def tree_numpy(tree, prefix: str = "") -> dict:
    """A dict tree of tensors as {path: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_numpy(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def hmc_graph_gate(tag: str, prog, state: dict, data: dict, smi: str
                   ) -> dict:
    """The sampler's graphs (`hmc.Sampler`: the chunk program, NUTS's
    depth and merge graphs) against the eager steps (`prog.step`, NUTS's
    per-leaf loop) from the same state and a generator of the same seed,
    over HMC_GRAPH_FLAGS' iterations: every output (pos, accept,
    divergent, eps, dh, steps; NUTS depth) and every field of the end
    state (u, g, the step size's and the metric's state) bit for bit. A
    fixed trajectory's replays run under torch's sync debug mode "error"
    (any host sync inside the chunk raises); NUTS's host syncs are
    counted, at most one a depth, and the leaves the masked subtrees ran
    against those the eager loop needed (which must equal the graph's
    count of them). Times: ms an iteration eager (host clock, adapting)
    and replayed, and the capture's seconds."""
    from vibo_tpu_torch.models import hmc
    flags = np.asarray(HMC_GRAPH_FLAGS, np.float32)
    n = flags.shape[1]
    nuts = prog.cfg.trajectory == "nuts"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HMC_GRAPH_SEED)
    st, eager = hmc._clone(state), []
    hmc.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n):
            st, o = prog.step(st, *flags[:, i].tolist(), data, gen)
            eager.append(o)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n
    eager_counts = hmc.counts()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(HMC_GRAPH_SEED)
    sampler = hmc.Sampler(prog, state, data, gen, flags, n)
    t0 = time.perf_counter()
    sampler.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    hmc.reset_counts()
    t0 = time.perf_counter()
    if not nuts:
        torch.cuda.set_sync_debug_mode("error")
    try:
        sampler.advance(n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / n
    got = sampler.fetch(n)
    counted = hmc.counts()
    keys = hmc.OUT_KEYS[1:] + (("depth",) if nuts else ())
    want = {k: torch.stack([o[k] for o in eager], 1).cpu().numpy()
            for k in keys}
    for k in prog.names:
        want["pos." + k] = torch.stack([o["pos"][k] for o in eager],
                                       1).cpu().numpy()
        got["pos." + k] = got["pos"][k]
    got.pop("pos")
    mism = [k for k in want if not same_bits(got[k], want[k])]
    end_g, end_e = tree_numpy(sampler.state), tree_numpy(st)
    mism += [f"state.{k}" for k in end_e if not same_bits(end_g[k], end_e[k])]
    r = {"phase": "hmc_graph", "path": tag, "iterations": n,
         "trajectory": prog.cfg.trajectory, "bitwise": not mism,
         "mismatched": mism, "eager_ms_per_iteration": eager_ms,
         "graph_ms_per_iteration": graph_ms, "capture_s": capture_s,
         "graphs": len(sampler.graphs),
         "evaluations_per_draw": counted["evaluations"] / n,
         "eager_evaluations_per_draw": eager_counts["evaluations"] / n,
         "host_syncs_per_draw": counted["syncs"] / n,
         "eager_host_syncs_per_draw": eager_counts["syncs"] / n,
         "accept": want["accept"].mean(0).tolist(), "card": smi}
    ok = not mism
    if nuts:
        r.update(leaves_run=counted["leaves"],
                 leaves_needed=counted["leaves_needed"],
                 eager_leaves=eager_counts["leaves"],
                 depth=want["depth"].mean(0).tolist())
        ok = (ok and counted["leaves_needed"] == eager_counts["leaves"]
              and counted["syncs"] <= n * prog.max_d)
    else:
        ok = ok and counted["syncs"] == 0
    emit(r)
    if not ok:
        raise AssertionError(f"{tag}: the sampler's graphs part from its "
                             f"eager steps: {r}")
    return r


def hmc_probe(tag: str, cfg, ds, samples: dict, kernel, smi: str,
              deep_params=None, step_size: float | None = None) -> dict:
    """The chain programs at the run's posterior mean (the run's own MAP
    stays inside run_hmc), with HMC_CHAINS chains from x = 0: first
    hmc_graph_gate (the graphs against the eager steps, bit for bit); then
    ms a potential evaluation of all chains (CUDA events, L2 flushed), and
    on a Sampler of sampling iterations (replayed graphs, as run_hmc runs
    them): ms an iteration (host clock over a synchronized run of
    HMC_PROBE_ITERS' timed iterations after its warm-up ones; NUTS:
    NUTS_PROBE_ITERS', at the run's step size) and a profiler window of a
    whole chunk of replayed iterations (advance, then its one fetch): busy
    and idle shares, and each loglik kernel's device calls an iteration,
    which must be C times the evaluations for the path's kernel (its
    helpers beside it) and 0 for every other, and equal each wrapper's
    launches in the window (which the graphs count as captured launches
    times replays, so the device backs that accounting). NUTS: its
    evaluations, host syncs and leaves run and needed counted in each
    window (`hmc.counts`)."""
    import dataclasses
    from vibo_tpu_torch.models import hmc
    from vibo_tpu_torch.ops.packing import pack_responses
    n, m = ds.response.shape
    packed = kernel is not None
    run_cfg = dataclasses.replace(cfg, use_packed_kernel=packed)
    if cfg.irt_model == "deep":
        run_cfg = dataclasses.replace(
            run_cfg, deep_latent_dim=int(deep_params["w_item"].shape[0]),
            deep_hidden_dim=int(deep_params["w_theta"].shape[1]))
    prog = hmc._chain_programs(run_cfg, n, m)
    if packed:
        base = {"pk": torch.from_numpy(pack_responses(
            ds.response, ds.train_mask)).cuda()}
    else:
        base = {"resp": torch.from_numpy(ds.response).cuda(),
                "mask": torch.from_numpy(ds.train_mask).cuda()}
    if deep_params is not None:
        base["deep"] = deep_params
    center = {k: torch.from_numpy(np.ascontiguousarray(
        samples[k].mean(0), np.float32)).cuda() for k in prog.names}
    scale = hmc.fisher_scale(ds.train_mask, prog.spec, "cuda")
    data = dict(base, center=center, scale=scale,
                ll_ref=prog.ll_ref_fn(center, base))
    state = prog.init({k: torch.zeros((HMC_CHAINS,) + v, device="cuda")
                       for k, v in prog.spec.items()}, data)
    nuts = cfg.trajectory == "nuts"
    if nuts:
        state["log_eps"] = state["log_eps_bar"] = torch.full_like(
            state["log_eps"], float(np.log(step_size)))
    gate = hmc_graph_gate(tag, prog, state, data, smi)
    warm, reps, window_iters = (NUTS_PROBE_ITERS if nuts
                                else HMC_PROBE_ITERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    iters = warm + reps + window_iters * PROFILER_TRIES
    sampler = hmc.Sampler(prog, state, data, gen, np.zeros((3, iters)),
                          max(warm, reps, window_iters))
    vg_ms = Timer()(lambda: prog.vg(state["pos"], data), reps=10)
    sampler.capture()
    sampler.advance(warm)
    torch.cuda.synchronize()
    hmc.reset_counts()
    t0 = time.perf_counter()
    sampler.advance(reps)
    torch.cuda.synchronize()
    iter_ms = (time.perf_counter() - t0) * 1e3 / reps
    sampler.fetch(reps)
    timed = {k: v / reps for k, v in hmc.counts().items()}
    evals = timed["evaluations"]
    def chunk():
        sampler.advance(window_iters)
        sampler.fetch(window_iters)
    for _ in range(PROFILER_TRIES):
        hmc.reset_counts()
        before = launch_counts()
        prof = profile_steps(chunk, 1, iter_ms, smi, per_call=window_iters,
                             counts=True)
        window = hmc.counts()
        wrapper = {n: (c - before[n]) / window_iters
                   for n, c in launch_counts().items()
                   if n in LOGLIK_DEVICE_KERNELS}
        dev = device_counts(prof["counts"])
        calls = {n: dev[n] for n in LOGLIK_DEVICE_KERNELS}
        want = {n: (HMC_CHAINS * window["evaluations"] / window_iters
                    if n == kernel else 0)
                for n in LOGLIK_DEVICE_KERNELS}
        if calls == want:
            break
    else:
        raise AssertionError(f"{tag}: loglik kernels an iteration in the "
                             f"profiler window {calls}, want {want}")
    if wrapper != calls:
        raise AssertionError(f"{tag}: the wrappers' launches (captured x "
                             f"replays) {wrapper} are not the device's "
                             f"calls {calls} in the window")
    prof.pop("counts")
    out = {"ms_per_potential_eval": vg_ms, "ms_per_iteration": iter_ms,
           "eager_ms_per_iteration": gate["eager_ms_per_iteration"],
           "evals_per_iteration": evals,
           "ms_per_eval_in_iteration": iter_ms / evals,
           "host_syncs_per_iteration": timed["syncs"],
           "graphs": len(sampler.graphs),
           "window_iterations": window_iters,
           "device_calls_per_iteration": {n: v for n, v in dev.items()
                                          if v},
           "wrapper_launches_per_iteration": {n: v for n, v in
                                              wrapper.items() if v},
           "profile": prof}
    if nuts:
        out.update(step_size=step_size,
                   leaves_run_per_iteration=timed["leaves"],
                   leaves_needed_per_iteration=timed["leaves_needed"],
                   window_evals_per_iteration=window["evaluations"]
                   / window_iters,
                   window_syncs_per_iteration=window["syncs"]
                   / window_iters)
    return out


def gold_agreement(samples: dict, heldout_acc: float, gold: str) -> dict:
    """A run's posterior against a gold of the JAX package: the
    Procrustes-aligned Pearson of the theta means (gated at
    HMC_PEARSON_MIN), the held-out accuracy's distance (gated at
    HMC_ACC_TOL) and the theta sds' Pearson after rotate_diag_sigma
    (reported); where the gold keeps item means, also the Pearson of b's
    mean (grm: its threshold table, flattened) and of a's after the theta
    means' Procrustes rotation, both gated at HMC_PEARSON_MIN (the CLI's
    b_vs_hmc and a_vs_hmc, vibo_tpu/cli.py:662-688)."""
    from vibo_tpu_torch import evaluation
    g = load_gold(gold)
    mean = samples["theta"].mean(0)
    rot = evaluation.procrustes_rotation(mean, g["theta_hat"])
    sd = evaluation.rotate_diag_sigma(samples["theta"].std(0), rot)
    r = {"gold": f"artifacts/gold/{gold}",
         "gold_heldout_acc": g["summary"]["heldout_acc"],
         "theta_mean_pearson_vs_gold": evaluation.correlation(
             mean, g["theta_hat"], align_rotation=True)["pearson"],
         "theta_sd_pearson_vs_gold": evaluation.correlation(
             sd, g["theta_sd"], align_sign=False)["pearson"],
         "heldout_acc_minus_gold": heldout_acc - g["summary"]["heldout_acc"]}
    r.update(item_agreement(samples["a"].mean(0) if "a" in samples else None,
                            samples["b"].mean(0), rot, g))
    r["gold_gates_hold"] = (
        r["theta_mean_pearson_vs_gold"] >= HMC_PEARSON_MIN
        and abs(r["heldout_acc_minus_gold"]) <= HMC_ACC_TOL[gold]
        and all(r[k] >= HMC_PEARSON_MIN for k in ("b_pearson_vs_gold",
                                                  "a_pearson_vs_gold")
                if k in r))
    return r


def item_agreement(a, b, rot, g: dict) -> dict:
    """Item means a (M, K) and b ((M,), or grm's (M, C-1) unconstrained
    coordinates) against a gold's a_hat and b_hat: b's Pearson (grm: the
    threshold tables, flattened) and a's after rot, the theta means'
    Procrustes rotation onto the gold's (the links' O(K) gauge)."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.ops import links
    out = {}
    if "b_hat" in g:
        b, b_ref = np.asarray(b, np.float32), g["b_hat"].astype(np.float32)
        if b.ndim == 2:
            b, b_ref = (links.grm_thresholds(torch.from_numpy(x)).numpy()
                        for x in (b, b_ref))
        out["b_pearson_vs_gold"] = evaluation.correlation(
            b.ravel(), b_ref.ravel())["pearson"]
    if "a_hat" in g and a is not None:
        out["a_pearson_vs_gold"] = evaluation.correlation(
            (np.asarray(a) @ rot).ravel(), g["a_hat"].ravel())["pearson"]
    return out


def hmc_phase(tag: str, cfg, ds, smi: str, kernel=None, gold: str = None,
              deep_params=None, probe: bool = False,
              cut: str = "") -> dict:
    """One run_hmc on the card (the entry point a user calls) with its
    launches counted: the path's kernel (None: no kernel at all) once a
    chain each potential evaluation, map_init_steps times for the MAP (no
    chain axis) and once for ll_ref, and no other kernel; every draw
    finite; the accept rate in (0, 1]. With a gold: the Procrustes-aligned
    Pearson of the posterior theta means against the gold's >=
    HMC_PEARSON_MIN and the held-out accuracy of posterior_mean_prob within
    HMC_ACC_TOL of the gold's (and the item means where the gold has them,
    gold_agreement); the sd agreement after rotate_diag_sigma is reported.
    NUTS: its evaluations and host syncs counted (`hmc.counts`), its
    leapfrogs a draw measured."""
    from vibo_tpu_torch.models import hmc
    from vibo_tpu_torch.ops import _build
    nuts = cfg.trajectory == "nuts"
    _build.reset_launches()
    hmc.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = hmc.run_hmc(ds.response, ds.train_mask, cfg,
                      deep_params=deep_params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    counted = hmc.counts()
    iters = cfg.num_warmup + cfg.num_samples
    # the chains' first evaluation (init), the graphs' eager warm-up's
    # and those of every iteration (a graph's at each replay)
    evals_run = counted["evaluations"]
    evals = (evals_run - 1 - counted["warmup_evaluations"]) / iters
    if not nuts and evals != hmc_evals_per_iter(cfg):
        raise AssertionError(f"{tag}: {evals} evaluations an iteration, "
                             f"want {hmc_evals_per_iter(cfg)}: {counted}")
    if kernel is None:
        check_path(f"{tag} HMC path", launches, ())
        expected = 0
    else:
        # the MAP's Adam steps, ll_ref once, and every chain's evaluations
        # (the graphs': captured launches x replays, which the probe's
        # profiler window holds against the device's calls)
        expected = cfg.map_init_steps + 1 + HMC_CHAINS * evals_run
        check_path(f"{tag} HMC path", launches, (kernel,), (kernel,),
                   expected)
    samples = out["samples"]
    d = out["diagnostics"]
    if not (all(np.isfinite(v).all() for v in samples.values())
            and 0.0 < out["accept_rate"] <= 1.0):
        raise AssertionError(f"{tag}: non-finite draws or accept rate "
                             f"{out['accept_rate']}")
    t1 = time.perf_counter()
    prob = hmc.posterior_mean_prob(samples, cfg.irt_model,
                                   deep_params=deep_params)
    r = {"phase": "hmc", "path": tag, "model": cfg.irt_model,
         "shape": list(ds.response.shape), "K": cfg.ability_dim,
         "chains": cfg.num_chains, "warmup": cfg.num_warmup,
         "samples": cfg.num_samples, "trajectory": cfg.trajectory,
         **({"max_tree_depth": cfg.max_tree_depth} if nuts
            else {"leapfrog": cfg.num_leapfrog}),
         "target_accept": cfg.target_accept, "depth_cut": cut,
         "potential": kernel or "dense PyTorch (no kernel)",
         "kernel_launches": launches.get(kernel, 0) if kernel else 0,
         "launches_expected": expected, "evals_per_iteration": evals,
         "leapfrogs_per_draw": d["leapfrogs_per_draw"],
         "seconds": seconds, "posterior_mean_prob_seconds":
         time.perf_counter() - t1,
         "seconds_per_iteration": seconds / iters,
         "accept_rate": out["accept_rate"], "step_size": out["step_size"],
         "rhat_max": d["rhat_max"], "ess_min": d["ess_min"],
         "divergences": d["divergences"],
         "theta_sd_split_half_r": d["theta_sd_split_half_r"],
         "heldout_acc": heldout_accuracy(prob, ds), "card": smi}
    r.update(host_syncs_per_iteration=counted["syncs"] / iters,
             warmup_evaluations=counted["warmup_evaluations"],
             kernel_launches_per_iteration=(
                 HMC_CHAINS * evals if kernel else 0))
    if nuts:
        r.update(leaves_run=counted["leaves"],
                 leaves_needed=counted["leaves_needed"])
    if gold is not None:
        r.update(gold_agreement(samples, r["heldout_acc"], gold))
        if not r["gold_gates_hold"]:
            raise AssertionError(f"{tag}: the posterior does not reproduce "
                                 f"the gold: {r}")
    if probe:
        t1 = time.perf_counter()
        r["probe"] = hmc_probe(tag, cfg, ds, samples, kernel, smi,
                               deep_params, out["step_size"])
        r["probe"]["seconds"] = time.perf_counter() - t1
    emit(r)
    r["samples"] = samples
    return r


def deep_decoder(smi: str, width: int = DEEP_H) -> tuple:
    """A deep decoder trained by the port's Trainer.fit (fused full batch,
    DEEP_DECODER_EPOCHS epochs, config 5's widths: K = 2, item latent 16,
    link width 128, or `width`) on synthetic-nonlinear at the deep gold's
    shape, 10 % held out -> (dataset, the decoder's params)."""
    import dataclasses
    from vibo_tpu_torch.data import holdout_split, simulate_irt
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.train import Trainer, TrainConfig
    sim = simulate_irt("nonlinear", DEEP_GOLD_B, DEEP_GOLD_M,
                       ability_dim=DEEP_K, seed=0, missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    cfg = dataclasses.replace(deep_config(True, width),
                              num_items=DEEP_GOLD_M)
    t0 = time.perf_counter()
    res = Trainer(VIBO(cfg), TrainConfig(
        lr=5e-3, epochs=DEEP_DECODER_EPOCHS, eval_every=100)).fit(ds)
    torch.cuda.synchronize()
    emit({"phase": "hmc_deep_decoder", "shape": [DEEP_GOLD_B, DEEP_GOLD_M],
          "width": width, "epochs": DEEP_DECODER_EPOCHS,
          "seconds": time.perf_counter() - t0,
          "best_heldout_acc": res["best"]["heldout_acc"],
          "final_elbo": res["final_elbo"],
          "card": smi})
    if not np.isfinite(res["final_elbo"]):
        raise AssertionError("the deep decoder's ELBO is not finite")
    return ds, {k: (v.detach() if isinstance(v, torch.Tensor) else
                    {kk: vv.detach() for kk, vv in v.items()})
                for k, v in res["params"]["deep_link"].items()}


def deep_potential_f64(x, data, link) -> tuple:
    """The deep HMC potential of the chain programs (U(x) = -sum_i (ll_i(q)
    - ll_ref_i) + |q|^2 / 2 at q = center + scale x) and its gradient in
    x, from the dense route's data (resp, mask, center, scale, ll_ref) and
    the decoder, as the kernel route evaluates it but exactly: its first
    layer's operands t1 = theta W_theta + b1 and t2 = d W_item take the
    values the op computes in f32 (with their exact derivatives), every
    later product, sum and relu branch is f64; a chain at a time -> ((C,)
    U, {"d", "theta": (C, ...) dU/dx})."""
    import torch.nn.functional as F
    w_t, w_i, b1 = (link[k].double() for k in ("w_theta", "w_item", "b1"))
    w2, b2 = (link["layer2"][k].double() for k in ("w", "b"))
    wo, bo = (link["out"][k].double() for k in ("w", "b"))
    resp, mask = data["resp"].double(), data["mask"].double()
    ll_ref = data["ll_ref"].double()
    us, gs = [], {"d": [], "theta": []}
    for c in range(x["theta"].shape[0]):
        with torch.enable_grad():
            xs = {k: x[k][c].detach().double().requires_grad_() for k in gs}
            q = {k: data["center"][k].double()
                 + data["scale"][k].double() * xs[k] for k in gs}
            qf = {k: data["center"][k] + data["scale"][k] * x[k][c].detach()
                  for k in gs}
            t1 = q["theta"] @ w_t + b1
            t2 = q["d"] @ w_i
            t1 = t1 + ((qf["theta"] @ link["w_theta"] + link["b1"]).double()
                       - t1).detach()
            t2 = t2 + ((qf["d"] @ link["w_item"]).double() - t2).detach()
            h1 = torch.relu(t1[:, None, :] + t2[None])
            logits = (torch.relu(h1 @ w2 + b2) @ wo + bo)[..., 0]
            ll = (mask * (resp * logits - F.softplus(logits))).sum(-1)
            u = (-(ll - ll_ref).sum()
                 + 0.5 * sum(v.square().sum() for v in q.values()))
            grads = torch.autograd.grad(u, [xs[k] for k in gs])
        us.append(u.detach())
        for k, g in zip(gs, grads):
            gs[k].append(g)
    return torch.stack(us), {k: torch.stack(v) for k, v in gs.items()}


def exact_rows(x, prior, g0, g1, data, link) -> tuple:
    """The deep potential's gradient in f64 (deep_potential_f64) and, for
    each of its blocks, each route's rows (a student's theta or an item's d
    in a chain; kernel g1, dense g0) against it: the largest row distance
    and the rows past 1e-5, of the f64 gradient's largest magnitude and of
    its loglik part's (the gradient less the prior's, `prior`); and the
    rows where the routes part past 1e-5 of g0's largest magnitude, with
    how many of them the dense route is the farther from f64 -> (the f64
    gradient, {block: those counts})."""
    _, g64 = deep_potential_f64(x, data, link)
    out = {}
    for k in g64:
        scales = {"grad": float(g64[k].abs().max()),
                  "loglik_part": float((g64[k] - prior[k]).abs().max())}
        dist = {"kernel": (g1[k].double() - g64[k]).abs().amax(-1),
                "dense": (g0[k].double() - g64[k]).abs().amax(-1)}
        part = ((g1[k] - g0[k]).abs().amax(-1)
                > 1e-5 * float(g0[k].abs().max()))
        out[k] = {route: {f"{n}_max": float(d.max()) / v
                          for n, v in scales.items()}
                  | {f"{n}_rows_past_1e-5": int((d > 1e-5 * v).sum())
                     for n, v in scales.items()}
                  for route, d in dist.items()}
        out[k]["parting_rows"] = int(part.sum())
        out[k]["parting_dense_farther"] = int(
            (part & (dist["dense"] > dist["kernel"])).sum())
    return g64, out


def potentials_agree(tag: str, cfg, ds, deep_params=None,
                     exact: bool = False) -> dict:
    """An HMC potential's two routes through the chain programs (what
    run_hmc evaluates): dense PyTorch and the kernel (rows 4 and 9 through
    _TrainChains, 13 and 14 through their per-sample loop, 15f), on the
    same x with C = HMC_CHAINS chains: at the dense route's MAP (x = 0) and
    one whitened sd around it (x ~ N(0, I), a chain each, so every chain
    has its own a, b, g_hat or d). Gated, every link:
    - the per-person loglik (C, N) within 1e-5 of its largest magnitude;
    - the value U within 1e-6 of |U| + sum_i |ll_i| (U subtracts the MAP's
      loglik, so at 10,240 x 1,024 it is ~1e-3 of the sum it is taken from
      and its f32 error is that sum's);
    - every gradient within 1e-4 of its largest magnitude; at the MAP of
      its loglik part's (the gradient less the prior's, which is the same
      in both routes): there U's gradient is the MAP's residual, 0 but
      for Adam's last steps.
    The deep link keeps its stricter gates: U within 1e-5 of |U|, the
    gradient within 1e-5 of U's at the MAP; off it a pre2 within f32
    rounding of 0 takes the other relu branch in one route now and then
    (check_deep's allowance), moving its student's and its item's rows,
    so there all but 1 % of the rows (a student's theta or an item's d in
    a chain; at least 2) within 1e-5 and every row within HMC_FLIP_BOUND
    of U's gradient's largest magnitude.
    exact (deep, the cluster kernel's widths): the gradient gates hold the
    kernel route against the exact gradient of the function it evaluates
    (deep_potential_f64: the kernel's own f32 t1 and t2, every later
    product, sum and relu branch exact, as the cluster kernel's f64
    recompute takes h1 = t1 + t2) in place of the dense route's f32 one,
    whose pre2 near 0 takes the other relu branch now and then; each
    route's rows against it are reported (exact_rows). The value and
    loglik gates stay on the dense route. (The H = 128 kernel recomputes
    from h1 rounded to f32, as the dense route computes it, and keeps the
    dense route as its reference.)"""
    import dataclasses
    from vibo_tpu_torch.models import hmc
    from vibo_tpu_torch.ops.packing import pack_responses
    n, m = ds.response.shape
    deep = cfg.irt_model == "deep"
    if deep:
        cfg = dataclasses.replace(
            cfg, deep_latent_dim=int(deep_params["w_item"].shape[0]),
            deep_hidden_dim=int(deep_params["w_theta"].shape[1]))
    dense = hmc._chain_programs(dataclasses.replace(
        cfg, use_packed_kernel=False), n, m)
    fused = hmc._chain_programs(dataclasses.replace(
        cfg, use_packed_kernel=True), n, m)
    base_dense = {"resp": torch.from_numpy(ds.response).cuda(),
                  "mask": torch.from_numpy(ds.train_mask).cuda()}
    base_fused = {"pk": torch.from_numpy(pack_responses(
        ds.response, ds.train_mask)).cuda()}
    if deep:
        base_dense["deep"] = base_fused["deep"] = deep_params
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    p0 = {k: 0.1 * torch.randn(v, generator=gen, device="cuda")
          for k, v in dense.spec.items()}
    center = dense.map_run(p0, base_dense)
    scale = hmc.fisher_scale(ds.train_mask, dense.spec, "cuda")
    ll_ref = dense.ll_ref_fn(center, base_dense)
    out = {"phase": "hmc_potentials", "path": tag, "model": cfg.irt_model,
           "shape": [n, m], "K": cfg.ability_dim, "chains": HMC_CHAINS}
    failed = []
    for where, x in (("center", {k: torch.zeros((HMC_CHAINS,) + v,
                                                device="cuda")
                                 for k, v in dense.spec.items()}),
                     ("one_sd", {k: torch.randn((HMC_CHAINS,) + v,
                                                generator=gen,
                                                device="cuda")
                                 for k, v in dense.spec.items()})):
        q = {k: center[k] + scale[k] * x[k] for k in x}
        ll0 = dense.ll_ref_fn(q, base_dense)
        ll1 = fused.ll_ref_fn(q, base_fused)
        (u0, g0), (u1, g1) = (
            prog.vg(x, dict(base, center=center, scale=scale,
                            ll_ref=ll_ref))
            for prog, base in ((dense, base_dense), (fused, base_fused)))
        # the prior's gradient in x: scale * q (U's prior is 0.5 |q|^2)
        ll_part = {k: g0[k] - scale[k] * q[k] for k in g0}
        r = {"loglik_rel_err": rel_err(ll1, ll0),
             "value_rel_err": rel_err(u1, u0),
             "value_err_of_loglik_sum": float(
                 ((u1 - u0).abs() / (u0.abs() + ll0.abs().sum(-1))).max()),
             "grad_rel_err": {k: rel_err(g1[k], g0[k]) for k in g0},
             "grad_err_of_loglik_part": {
                 k: max_abs(g1[k], g0[k])
                 / float(ll_part[k].abs().max()) for k in g0},
             "value": u0.tolist()}
        ok = (r["loglik_rel_err"] <= 1e-5
              and r["value_err_of_loglik_sum"] <= 1e-6)
        if exact:
            r["dense"] = {n: r[n] for n in ("grad_rel_err",
                                            "grad_err_of_loglik_part")}
            g0, vs_exact = exact_rows(x, {
                k: scale[k] * q[k] for k in g0}, g0, g1, dict(
                base_dense, center=center, scale=scale, ll_ref=ll_ref),
                deep_params)
            ll_part = {k: g0[k] - scale[k] * q[k] for k in g0}
            r.update(vs_exact=vs_exact, grad_rel_err={
                k: rel_err(g1[k], g0[k]) for k in g0},
                grad_err_of_loglik_part={
                k: max_abs(g1[k], g0[k]) / float(ll_part[k].abs().max())
                for k in g0})
        if deep and where == "one_sd":
            far = {}
            for k in g0:
                row_err = (g1[k] - g0[k]).abs().amax(-1).flatten()
                far[k] = {"rows": int((row_err > 1e-5 * g0[k].abs().max()
                                       ).sum()),
                          "allowed": max(2, int(0.01 * row_err.numel()))}
            r["grad_rows_past_1e-5"] = far
            ok = ok and all(far[k]["rows"] <= far[k]["allowed"]
                            and r["grad_rel_err"][k] <= HMC_FLIP_BOUND
                            for k in g0)
        else:
            grad = r["grad_err_of_loglik_part" if where == "center"
                     else "grad_rel_err"]
            ok = ok and all(v <= 1e-4 for v in grad.values())
        if deep:
            ok = ok and r["value_rel_err"] <= 1e-5 and (
                where != "center"
                or all(v <= 1e-5 for v in r["grad_rel_err"].values()))
        out[where] = r
        if not ok:
            failed.append(where)
    if failed:
        raise AssertionError(f"{tag}: the HMC potentials disagree at "
                             f"{', '.join(failed)}: {out}")
    emit(out)
    return out


def gold_data(gold: str):
    """A gold's data as its command made it (vibo_tpu/cli.py:67-78
    defaults): k4, simulate_irt("2pl", 10,240, 1,024, K = 4); grm, ("grm",
    2,000, 100, K = 1, C = 5); k2-nuts, ("2pl", 2,000, 200, K = 2);
    grm-k2 and grm-k4, ("grm", 2,000, 200, K = 2 or 4, C = 5); missing rate
    0, seed 0, 10 % held out with seed 0."""
    from vibo_tpu_torch.data import holdout_split, simulate_irt
    if gold in ("k4", "k2-nuts"):
        shape, k = ((B, M), K) if gold == "k4" else (NUTS_GOLD_SHAPE, 2)
        sim = simulate_irt("2pl", *shape, ability_dim=k, seed=0,
                           missing_rate=0.0)
        return holdout_split(sim.response, sim.mask, 0.1, seed=0)
    shape, k = ((GRM_GOLD, 1) if gold == "grm"
                else (NUTS_GOLD_SHAPE, NUTS_GOLDS[gold][1]))
    sim = simulate_irt("grm", *shape, ability_dim=k, seed=0,
                       missing_rate=0.0, num_categories=C)
    return holdout_split(sim.response, sim.mask, 0.1, seed=0,
                         num_categories=C)


def hmc_phases(smi: str) -> dict:
    """The HMC baseline on the card: the flagship gold (2PL, 10,240 x 1,024,
    K = 4, row 4) and the GRM gold (2,000 x 100, C = 5, dense) against the
    JAX package's posteriors, depth cut to HMC_GOLD_DEPTH; short runs of
    the opt-in GRM and GPCM potentials (rows 13, 14), of 3PL (row 9) and
    1PL (row 4 at unit a); a decoder trained by Trainer.fit and the deep
    potential's two routes (dense; row 15f), and row 15f's route on a
    decoder of link width 256 (DEEP_HMC_WIDE_H: the cluster kernel). Every
    kernel potential is held against the dense one on its run's data
    (potentials_agree). Returns each path's result."""
    from vibo_tpu_torch.data import holdout_split, simulate_irt
    short = depth_cut(HMC_SHORT)
    runs = {}
    t0 = time.perf_counter()
    ds = gold_data("k4")
    emit({"phase": "hmc_data", "path": "hmc_2pl_k4", "shape": [B, M],
          "seconds": time.perf_counter() - t0})
    runs["hmc_2pl_k4"] = hmc_phase(
        "hmc_2pl_k4", hmc_cfg("2pl", K, depth=HMC_GOLD_DEPTH["k4"]), ds,
        smi, "loglik_2pl_train", gold="k4", probe=True,
        cut=depth_cut(HMC_GOLD_DEPTH["k4"], gold=True))
    potentials_agree("hmc_2pl_k4", hmc_cfg("2pl", K), ds)
    sim = simulate_irt("1pl", B, M, ability_dim=1, seed=0, missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    runs["hmc_1pl"] = hmc_phase("hmc_1pl", hmc_cfg("1pl", 1), ds, smi,
                                "loglik_2pl_train", cut=short)
    potentials_agree("hmc_1pl", hmc_cfg("1pl", 1), ds)
    sim = simulate_irt("3pl", B, M, ability_dim=K, seed=0, missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    runs["hmc_3pl"] = hmc_phase("hmc_3pl", hmc_cfg("3pl", K), ds, smi,
                                "loglik_3pl_train", probe=True, cut=short)
    potentials_agree("hmc_3pl", hmc_cfg("3pl", K), ds)
    for fam in FAMILIES:
        if fam == "grm":
            ds = gold_data("grm")
            runs["hmc_grm"] = hmc_phase(
                "hmc_grm", hmc_cfg("grm", 1, C, depth=HMC_GOLD_DEPTH["grm"]),
                ds, smi, gold="grm", probe=True,
                cut=depth_cut(HMC_GOLD_DEPTH["grm"], gold=True))
        else:
            sim = simulate_irt(fam, *GRM_GOLD, ability_dim=1, seed=0,
                               num_categories=C)
            ds = holdout_split(sim.response, sim.mask, 0.1, seed=0,
                               num_categories=C)
        runs[f"hmc_{fam}_packed"] = hmc_phase(
            f"hmc_{fam}_packed", hmc_cfg(fam, 1, C, use_packed_kernel=True),
            ds, smi, f"loglik_{fam}_train", probe=True, cut=short)
        potentials_agree(f"hmc_{fam}_packed", hmc_cfg(fam, 1, C), ds)
    ds, decoder = deep_decoder(smi)
    runs["hmc_deep_dense"] = hmc_phase(
        "hmc_deep_dense", hmc_cfg("deep", DEEP_K), ds, smi,
        deep_params=decoder, probe=True, cut=short)
    runs["hmc_deep_f32"] = hmc_phase(
        "hmc_deep_f32", hmc_cfg("deep", DEEP_K, use_packed_kernel=True), ds,
        smi, "deep_link_f32_train", deep_params=decoder, probe=True,
        cut=short)
    potentials_agree("hmc_deep_f32", hmc_cfg("deep", DEEP_K), ds, decoder)
    runs[f"hmc_deep_f32_H{DEEP_HMC_WIDE_H}"] = hmc_deep_wide(smi)
    return runs


def hmc_deep_wide(smi: str) -> dict:
    """Row 15f's cluster kernel on the sampler's graphs: a decoder of link
    width DEEP_HMC_WIDE_H trained as deep_decoder's, sampled through the
    f32 kernel's potential (DEEP_HMC_WIDE_DEPTH, probed) and held against
    the dense potential (potentials_agree)."""
    tag = f"hmc_deep_f32_H{DEEP_HMC_WIDE_H}"
    ds, decoder = deep_decoder(smi, DEEP_HMC_WIDE_H)
    run = hmc_phase(
        tag, hmc_cfg("deep", DEEP_K, depth=DEEP_HMC_WIDE_DEPTH,
                     use_packed_kernel=True), ds, smi,
        "deep_link_f32_train", deep_params=decoder, probe=True,
        cut=depth_cut(DEEP_HMC_WIDE_DEPTH))
    potentials_agree(tag, hmc_cfg("deep", DEEP_K), ds, decoder,
                     exact=True)
    return run


def nuts_phases(smi: str, golds: tuple = SMOKE_NUTS_GOLDS) -> dict:
    """NUTS on the card against the JAX package's NUTS golds, each at its
    link, K, tree depth and target with HMC_GOLD_DEPTH's iterations: k2-nuts
    (2PL, K = 2) on row 4 through the chain axis, the binary links' default
    on the card; grm-k2 (and, given, grm-k4; C = 5) on the dense potential,
    JAX's default. Every run is probed (NUTS's evaluations and host syncs an
    iteration, busy ms and the idle share). Returns each path's result."""
    runs = {}
    for gold in golds:
        t0 = time.perf_counter()
        ds = gold_data(gold)
        model, k = NUTS_GOLDS[gold]
        tag = f"hmc_nuts_{gold.split('-nuts')[0].replace('-', '_')}"
        emit({"phase": "hmc_data", "path": tag,
              "shape": list(NUTS_GOLD_SHAPE),
              "seconds": time.perf_counter() - t0})
        runs[tag] = hmc_phase(
            tag, hmc_cfg(model, k, C if model == "grm" else 2,
                         depth=HMC_GOLD_DEPTH[gold]), ds, smi,
            "loglik_2pl_train" if model == "2pl" else None, gold=gold,
            probe=gold in PROBED_NUTS_GOLDS,
            cut=depth_cut(HMC_GOLD_DEPTH[gold], gold=True))
    return runs


def mle_phase(smi: str) -> dict:
    """The MLE/MAP baseline (`fit_mle`, plain PyTorch as JAX's is plain
    XLA) on k2-nuts's data, MLE_STEPS Adam steps from the seed's start,
    without and with the prior: seconds, the final objective (finite, below
    the start's), held-out accuracy (in [0, 1]), and theta, a and b against
    the gold's posterior means (theta's Pearson after Procrustes, a's after
    theta's rotation). Then MLE_CPU_STEPS steps at MLE_CPU_SHAPE on the
    card and on the CPU from one start: every parameter within
    MLE_CPU_TOL."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.models import mle
    ds = gold_data("k2-nuts")
    g = load_gold("k2-nuts")
    t_phase = time.perf_counter()
    out = {"phase": "mle_k2", "shape": list(NUTS_GOLD_SHAPE), "K": 2,
           "steps": MLE_STEPS, "card": smi}
    for map_prior in (False, True):
        cfg = mle.MLEConfig(irt_model="2pl", ability_dim=2,
                            map_prior=map_prior, steps=MLE_STEPS, seed=0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg.seed)
        start = mle.init_point_params(gen, *ds.response.shape, cfg)
        start_loss = float(mle.neg_log_posterior(
            start, torch.from_numpy(ds.response).cuda(),
            torch.from_numpy(ds.train_mask).cuda(), cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = mle.fit_mle(ds.response, ds.train_mask, cfg,
                                   params0=start)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        acc = heldout_accuracy(mle.response_prob(params, cfg).cpu().numpy(),
                               ds)
        p = {k: v.cpu().numpy() for k, v in params.items()}
        rot = evaluation.procrustes_rotation(p["theta"], g["theta_hat"])
        r = {"seconds": seconds, "ms_per_step": seconds * 1e3 / MLE_STEPS,
             "start_loss": start_loss, "final_loss": loss,
             "heldout_acc": acc,
             "gold_heldout_acc": g["summary"]["heldout_acc"],
             "theta_pearson_vs_gold": evaluation.correlation(
                 p["theta"], g["theta_hat"], align_rotation=True)["pearson"],
             **item_agreement(p["a"], p["b"], rot, g)}
        out["map" if map_prior else "mle"] = r
        if not (np.isfinite(loss) and loss < start_loss and 0.0 <= acc <= 1.0):
            raise AssertionError(f"mle_k2: the objective did not fall or "
                                 f"the accuracy is out of range: {out}")
    cfg = mle.MLEConfig(irt_model="2pl", ability_dim=2,
                        steps=MLE_CPU_STEPS, seed=0)
    resp, mask = (x[:MLE_CPU_SHAPE[0], :MLE_CPU_SHAPE[1]]
                  for x in (ds.response, ds.train_mask))
    start = mle.init_point_params(torch.Generator().manual_seed(1),
                                  *resp.shape, cfg)
    card, card_loss = mle.fit_mle(resp, mask, cfg, params0=start)
    cpu, cpu_loss = mle.fit_mle(resp, mask, cfg, params0=start,
                                device="cpu")
    # within MLE_CPU_TOL absolutely, or of the largest magnitude past 1
    errs = {k: max_abs(card[k].cpu(), cpu[k])
            / max(1.0, float(cpu[k].abs().max())) for k in cpu}
    errs["loss"] = abs(card_loss - cpu_loss) / max(1.0, abs(cpu_loss))
    out["card_vs_cpu"] = {"shape": list(MLE_CPU_SHAPE),
                          "steps": MLE_CPU_STEPS, "max_err": errs,
                          "tol": MLE_CPU_TOL}
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(out)
    if max(errs.values()) > MLE_CPU_TOL:
        raise AssertionError(f"mle_k2: the card and the CPU part: {out}")
    return out


def em_fit(cfg, resp, mask) -> tuple:
    """fit_em on the card with its time: (result, timing: seconds,
    iterations, the iterations computed (a chunk runs to its end), ms an
    iteration computed (the final E-step and the result's copy included),
    host fetches) and every computed iteration's marginal log-lik."""
    from vibo_tpu_torch.models import em
    em.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = em.fit_em(resp, mask, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = em.stats()
    computed = len(st["log_liks"])
    return res, {"seconds": seconds, "iterations": res["iterations"],
                 "iterations_computed": computed,
                 "ms_per_iteration": seconds * 1e3 / max(computed, 1),
                 "host_fetches": st["host_fetches"]}, st["log_liks"]


def em_finite(tag: str, res: dict, lls: list) -> dict:
    """Every output finite and the marginal log-lik never falling by more
    than EM_RISE_SLACK of itself from one iteration to the next."""
    falls = [b - a for a, b in zip(lls, lls[1:])
             if b < a - EM_RISE_SLACK * abs(a)]
    finite = all(np.isfinite(v).all() for v in res.values()
                 if isinstance(v, (np.ndarray, float)))
    out = {"finite": bool(finite), "log_lik_falls": falls,
           "log_lik_first": lls[0], "log_lik_last": lls[-1]}
    if not finite or falls:
        raise AssertionError(f"{tag}: not finite or the marginal log-lik "
                             f"fell: {out}")
    return out


def em_recorded(tag: str, r: dict) -> None:
    """Gate r's numbers on the JAX package's recorded run (EM_RESULTS,
    within EM_ACC_TOL) and on a gold (EM_GOLD_MIN)."""
    bad = {k: r[k] for k, v in EM_RESULTS.get(tag, {}).items()
           if not abs(r[k] - v) <= EM_ACC_TOL}
    bad.update({k: r[f"{k}_pearson_vs_gold"]
                for k, v in EM_GOLD_MIN.get(tag, {}).items()
                if not r[f"{k}_pearson_vs_gold"] >= v})
    if bad:
        raise AssertionError(f"{tag}: off the recorded run or the gold "
                             f"{bad}: {r}")


def em_card_vs_cpu(smi: str) -> dict:
    """EM_CPU_ITERS iterations of every family (2PL at K = 1, 2, 4) at
    EM_CPU_SHAPE from the same data on the card and on the CPU: every
    output within EM_CPU_TOL of the larger of 1 and its largest magnitude
    (the log marginal of its own), the iterations equal. Runs first, so
    the timed phases after it find cuSOLVER and the kernels of torch.func
    loaded."""
    from vibo_tpu_torch.data import simulate_irt
    from vibo_tpu_torch.models import em
    out = {}
    for model, k in EM_CPU_CASES:
        cats = C if model in FAMILIES else 2
        sim = simulate_irt(model, *EM_CPU_SHAPE, ability_dim=k, seed=0,
                           missing_rate=0.1, num_categories=cats)
        cfg = em.EMConfig(irt_model=model, ability_dim=k,
                          num_categories=cats, max_iters=EM_CPU_ITERS)
        card, timing, _ = em_fit(cfg, sim.response, sim.mask)
        cpu = em.fit_em(sim.response, sim.mask, cfg, device="cpu")
        errs = {key: max_abs(torch.as_tensor(card[key]),
                             torch.as_tensor(v))
                / max(1.0, float(np.abs(v).max()))
                for key, v in cpu.items() if isinstance(v, np.ndarray)}
        errs["log_marginal"] = (abs(card["log_marginal"] - cpu["log_marginal"])
                                / max(1.0, abs(cpu["log_marginal"])))
        out[f"{model}_k{k}"] = {**timing, "max_err": max(errs.values()),
                                "worst": max(errs, key=errs.get),
                                "iterations": [card["iterations"],
                                               cpu["iterations"]]}
        if model == "3pl":
            out["3pl_k1"]["one_iteration"] = em_3pl_iterations(sim, cfg)
    line = {"phase": "em_card_vs_cpu", "shape": list(EM_CPU_SHAPE),
            "max_iters": EM_CPU_ITERS, "C": C, "tol": EM_CPU_TOL,
            "cases": out, "card": smi,
            "note_3pl": "f32 end to end not gated: the f32 M-step is "
            "ill-conditioned at some iterates (one iteration from the same "
            "state ~1e-2 off the f64 one on either device) and one item's "
            "Fisher scoring then bifurcates (a to the clip at 10 or at "
            "0.05), the JAX package's and the port's CPU runs parting the "
            "same way; gated instead: each iteration from the CPU's "
            "iterates in f64, card against CPU"}
    emit(line)
    bad = [case for case, r in out.items()
           if (r["one_iteration"]["f64_card_vs_cpu"] if case == "3pl_k1"
               else r["max_err"]) > EM_CPU_TOL
           or (case != "3pl_k1"
               and r["iterations"][0] != r["iterations"][1])]
    if bad:
        raise AssertionError(f"em_card_vs_cpu: the card and the CPU part "
                             f"in {bad}")
    return line


def em_3pl_iterations(sim, cfg) -> dict:
    """3PL EM one iteration at a time: from each of the CPU's first
    EM_CPU_ITERS iterates (fit_em with max_iters i, one iteration a chunk),
    one e_step and m_step_3pl on the card and on the CPU, in f64 and in
    f32. Returns the largest error (of the larger of 1 and each output's
    largest magnitude; a, b, g_hat and the E-step's log-lik) of the card's
    f64 iteration against the CPU's (gated), and of each device's f32
    iteration against the CPU's f64 one (reported: the f32 iteration is
    ill-conditioned at some iterates, up to ~1e-2 off the f64 one)."""
    import dataclasses
    from vibo_tpu_torch.models import em
    step_cfg = dataclasses.replace(cfg, host_chunk=1, tol=0.0)

    def one(start: dict, dev: str, dtype) -> dict:
        resp, mask = (torch.from_numpy(x).to(dev, dtype)
                      for x in (sim.response, sim.mask))
        nodes, w = (t.to(dtype) for t in
                    em.gauss_hermite_nodes(cfg.num_quadrature, dev))
        a, b, g = (torch.from_numpy(start[k]).to(dev, dtype)
                   for k in ("a", "b", "g_hat"))
        post, ll = em.e_step(resp, mask, nodes, torch.log(w), a, b, g)
        out = em.m_step_3pl(resp, mask, post, nodes, a, b, g,
                            cfg.newton_steps, cfg.g_prior_mean,
                            cfg.g_prior_var)
        return {"a": out[0], "b": out[1], "g_hat": out[2], "log_lik": ll}

    def err(got: dict, ref: dict) -> float:
        return max(max_abs(got[k].cpu().double(), ref[k].double())
                   / max(1.0, float(ref[k].abs().max())) for k in ref)

    worst = {"f64_card_vs_cpu": 0.0, "f32_card_vs_f64": 0.0,
             "f32_cpu_vs_f64": 0.0}
    for i in range(EM_CPU_ITERS):
        start = em.fit_em(sim.response, sim.mask,
                          dataclasses.replace(step_cfg, max_iters=i),
                          device="cpu")
        ref = one(start, "cpu", torch.float64)
        for key, dev, dtype in (("f64_card_vs_cpu", "cuda", torch.float64),
                                ("f32_card_vs_f64", "cuda", torch.float32),
                                ("f32_cpu_vs_f64", "cpu", torch.float32)):
            worst[key] = max(worst[key], err(one(start, dev, dtype), ref))
    return worst


def em_phases(smi: str) -> dict:
    """The EM baseline on the card (fit_em, plain PyTorch as JAX's is plain
    XLA): em_card_vs_cpu, then em_flagship (the CLI's synthetic-2pl at K =
    1) against the JAX package's fit_em (EM_REFERENCE) and RESULTS.md:185;
    em_grm (the GRM gold's data, C = 5) and em_k2 (k2-nuts's, K = 2, 21^2
    nodes) against their recorded runs and golds; em_k4 (the k4 gold's
    data, 9^4 nodes), finite and its marginal log-lik never falling, with
    its accuracy and theta beside the gold's. Each with its timing."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.data import holdout_split, simulate_irt
    from vibo_tpu_torch.models import em
    runs = {"em_card_vs_cpu": em_card_vs_cpu(smi)}

    t0 = time.perf_counter()
    sim = simulate_irt("2pl", B, M, ability_dim=1, seed=0, missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    data_s = time.perf_counter() - t0
    res, timing, lls = em_fit(em.EMConfig(), ds.response, ds.train_mask)
    ref = np.load(EM_REFERENCE)
    errs = {k: float(np.abs(res[k] - ref[k]).max()
                     / max(1.0, float(np.abs(ref[k]).max())))
            for k in ("a", "b", "theta_eap")}
    ll_ref = float(ref["log_marginal"])
    r = {"phase": "em_flagship", "shape": [B, M], "K": 1, "nodes": 61,
         "data_seconds": data_s, **timing,
         "reference": "artifacts/em/flagship_2pl_k1.npz",
         "reference_iterations": int(ref["iterations"]),
         "max_err_vs_reference": errs,
         "log_marginal": res["log_marginal"],
         "reference_log_marginal": ll_ref,
         "log_marginal_rel_err": abs(res["log_marginal"] - ll_ref)
         / abs(ll_ref),
         "heldout_acc": heldout_accuracy(em.response_prob(res), ds),
         "theta_pearson": evaluation.correlation(
             res["theta_eap"], sim.theta[:, 0])["pearson"],
         "recorded": EM_RESULTS["em_flagship"],
         **em_finite("em_flagship", res, lls), "card": smi}
    emit(r)
    if (max(errs.values()) > EM_REF_TOL
            or r["log_marginal_rel_err"] > EM_LL_RTOL
            or abs(res["iterations"] - r["reference_iterations"]) > 1):
        raise AssertionError(f"em_flagship: off the JAX reference: {r}")
    em_recorded("em_flagship", r)
    runs["em_flagship"] = r

    for tag, gold, k in (("em_grm", "grm", 1), ("em_k2", "k2-nuts", 2),
                         ("em_k4", "k4", K)):
        ds = gold_data(gold)
        g = load_gold(gold)
        model = "grm" if gold == "grm" else "2pl"
        cfg = em.EMConfig(irt_model=model, ability_dim=k,
                          num_categories=C if model == "grm" else 2)
        res, timing, lls = em_fit(cfg, ds.response, ds.train_mask)
        theta = res["theta_eap"].reshape(ds.shape[0], -1)
        rot = evaluation.procrustes_rotation(theta, g["theta_hat"])
        a = res["a"].reshape(ds.shape[1], -1)
        r = {"phase": tag, "shape": list(ds.shape), "K": k,
             "nodes": int(res["nodes"].shape[0]), **timing,
             "log_marginal": res["log_marginal"],
             "heldout_acc": heldout_accuracy(em.response_prob(res), ds),
             "gold": f"artifacts/gold/{gold}",
             "gold_heldout_acc": g["summary"]["heldout_acc"],
             "theta_pearson_vs_gold": evaluation.correlation(
                 theta, g["theta_hat"], align_rotation=True)["pearson"],
             **item_agreement(a, res["b"], rot, g),
             "recorded": EM_RESULTS.get(tag),
             **em_finite(tag, res, lls), "card": smi}
        emit(r)
        em_recorded(tag, r)
        runs[tag] = r
    return runs


def checkpoint_resume(smi: str, data: dict) -> dict:
    """fit with checkpoints and exact resume on the card: the 2PL flagship
    (bf16, use_pallas, fused, eval_every FUSED_EVAL_EVERY) fitted
    RESUME_EPOCHS with out_dir (best.npz and metrics.jsonl must exist),
    its state saved; a new Trainer resumes it for RESUME_EPOCHS more in a
    profiler window, in which rows 1-3 (the first layer's two kernels and
    the 2PL one-pass loglik) run once a step (the replayed steps and the
    capture's WARMUP_STEPS eager ones; their wrappers count only the
    eager); its params, Adam's state, generator and final ELBO bitwise
    equal to one fit of 2 x RESUME_EPOCHS; AbilityScorer.from_checkpoint
    on a checkpoint of the result scores 256 new students bitwise equal to
    AbilityScorer on the result's params."""
    import tempfile
    from vibo_tpu_torch.convert import tree_leaves
    from vibo_tpu_torch.data import simulate_irt
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.serve import AbilityScorer
    from vibo_tpu_torch.train import Trainer, TrainConfig
    from vibo_tpu_torch.train import checkpoint as ckpt
    from vibo_tpu_torch.train.trainer import WARMUP_STEPS

    ds = data["ds"]
    model = VIBO(flagship_config("2pl"))
    path_kernels = ("first_layer_fwd", "first_layer_bwd", "loglik_2pl_train")
    out = {"phase": "checkpoint_resume", "epochs": [RESUME_EPOCHS] * 2,
           "eval_every": FUSED_EVAL_EVERY, "card": smi}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        def cfg(epochs, **kw):
            return TrainConfig(lr=5e-3, epochs=epochs,
                               eval_every=FUSED_EVAL_EVERY, **kw)

        t0 = time.perf_counter()
        full = Trainer(model, cfg(2 * RESUME_EPOCHS)).fit(ds)
        out["full_fit_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = Trainer(model, cfg(RESUME_EPOCHS, out_dir=tmp)).fit(ds)
        out["first_fit_seconds"] = time.perf_counter() - t0
        out["out_dir_files"] = sorted(p.name for p in Path(tmp).iterdir())
        mid = str(Path(tmp) / "mid.npz")
        ckpt.save_checkpoint(mid, ckpt.train_state(first["params"],
                                                   first["optimizer"]),
                             first["generator"], RESUME_EPOCHS)
        box = {}

        def resumed():
            box["res"] = Trainer(model, cfg(RESUME_EPOCHS)).fit(ds,
                                                                resume=mid)

        for _ in range(PROFILER_TRIES):
            _build.reset_launches()
            t0 = time.perf_counter()
            # only the window's device calls are read (no idle share)
            prof = profile_steps(resumed, 1, 1.0, smi, counts=True)
            out["resumed_fit_seconds"] = time.perf_counter() - t0
            launches = launch_counts()
            check_path("checkpoint_resume", launches, path_kernels,
                       path_kernels, WARMUP_STEPS)
            dev = device_counts(prof["counts"])
            out["device_calls"] = {k: dev[k] for k in path_kernels}
            if all(dev[k] == RESUME_EPOCHS + WARMUP_STEPS
                   for k in path_kernels):
                break
        else:
            raise AssertionError(f"checkpoint_resume: rows 1-3 not once a "
                                 f"step: {out}")
        res = box["res"]
        out["wrapper_launches"] = {k: launches[k] for k in path_kernels}
        pairs = list(zip(
            tree_leaves(ckpt.train_state(res["params"], res["optimizer"])),
            tree_leaves(ckpt.train_state(full["params"], full["optimizer"]))))
        out["state_leaves"] = len(pairs)
        out["state_max_abs"] = max(max_abs(a.detach(), b.detach())
                                   for a, b in pairs)
        out["bitwise"] = bool(
            all(torch.equal(a.detach(), b.detach()) for a, b in pairs)
            and res["final_elbo"] == full["final_elbo"]
            and torch.equal(res["generator"].get_state(),
                            full["generator"].get_state()))
        out["final_elbo"] = [res["final_elbo"], full["final_elbo"]]

        end = str(Path(tmp) / "end.npz")
        trainer = Trainer(model, cfg(1))
        ckpt.save_checkpoint(end, ckpt.train_state(res["params"],
                                                   res["optimizer"]),
                             res["generator"], 2 * RESUME_EPOCHS,
                             extra={"model_cfg": trainer._cfg_json(),
                                    "opt_cfg": trainer._opt_cfg_json()})
        fresh = simulate_irt("2pl", 256, M, ability_dim=K, seed=1,
                             missing_rate=0.1)
        t0 = time.perf_counter()
        loaded = AbilityScorer.from_checkpoint(end)
        out["from_checkpoint_seconds"] = time.perf_counter() - t0
        got = loaded.score(fresh.response, fresh.mask)
        want = AbilityScorer(model, res["params"]).score(fresh.response,
                                                         fresh.mask)
        out["from_checkpoint_bitwise"] = all(
            np.array_equal(got[k], want[k]) for k in want)
    emit(out)
    if not (out["bitwise"] and out["from_checkpoint_bitwise"]
            and {"best.npz", "metrics.jsonl"} <= set(out["out_dir_files"])):
        raise AssertionError(f"checkpoint_resume: {out}")
    return out


# ------------------------------------------------- the posterior families

# the K = 4 commands' families at their width (run_benchmark_configs.sh
# :34-65: 10,240 x 1,024, K = 4, hidden 512, S = 5, the CLI's f32
# compute): the tag, the config's family fields, the one-pass op the step
# must run: "bk" the per-person op on theta (B, K) (row 4; the 3PL's row
# 9), "kb" the scalar op on theta (K, B) (row 3); one device kernel serves
# both, so the wrapper's launches_by tells them apart; and the link (its
# flagship data)
FAMILY_RUNS = (("stats_chol", {"condition_on": "stats",
                               "theta_posterior": "chol"}, "bk", "2pl"),
               ("stats_laplace", {"condition_on": "stats",
                                  "theta_posterior": "laplace"}, "bk", "2pl"),
               ("stats_laplace_w", {"condition_on": "stats",
                                    "theta_posterior": "laplace-w"}, "bk",
                "2pl"),
               ("item_encoder", {"item_encoder": True}, "kb", "2pl"),
               ("3pl_stats_chol", {"condition_on": "stats",
                                   "theta_posterior": "chol"}, "bk", "3pl"))
FAMILY_H, FAMILY_S = 512, 5
FAMILY_FUSED = (20, 2)                    # epochs, eval_every (40, 10 cut for
                                          # the 600 s budget: a chunk's
                                          # capture and profile scale with
                                          # its steps)
FAMILY_PATH = {"2pl": (*FIRST_LAYER_F32, "loglik_2pl_train"),
               "3pl": (*FIRST_LAYER_F32, "loglik_3pl_train")}
# a window of one chunk: a laplace step is ~5,400 device records, whose
# processing the profiler takes its time over
FAMILY_PROFILE_CHUNKS = 1
FAMILY_ROWS = {("2pl", "bk"): "row 4 (vibo_tpu/ops/pallas_elbo.py:613 "
                            "_fused_train_fwd)",
               ("2pl", "kb"): "row 3 (vibo_tpu/ops/pallas_elbo.py:1244 "
                            "_fused_train_fwd_t)",
               ("3pl", "bk"): "row 9 (vibo_tpu/ops/pallas_elbo.py:741 "
                            "_fused_train_fwd_3pl)"}


def family_config(extra: dict, use_pallas: bool = True, m: int = M,
                  hidden: int = FAMILY_H, link: str = "2pl"):
    from vibo_tpu_torch.models import VIBOConfig
    return VIBOConfig(num_items=m, irt_model=link, ability_dim=K,
                      hidden_dim=hidden, use_pallas=use_pallas,
                      compute_dtype="float32", **extra)


def family_packed_matches_dense(extra: dict, link: str = "2pl") -> dict:
    """A family's packed objectives on the card with the kernels
    (use_pallas: the f32 first layer and the link's one-pass op) against
    the same objectives on the decoded code without them (use_pallas off:
    plain PyTorch on the card), at 300 x 200, hidden 64, S = 3, same params
    and noise: the ELBO terms and the IWAE (local, ratio), and the
    gradients of the ELBO and of sum_s w_s (local_s + ratio_s) at w =
    IWAE_COTANGENT, each within 1e-4 of its largest magnitude (f32)."""
    from vibo_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import objectives
    from vibo_tpu_torch.ops.packing import packed_on_device
    n, m, s = 300, 200, len(IWAE_COTANGENT)
    rng = np.random.default_rng(8)
    resp = (rng.random((n, m)) < 0.6).astype(np.float32)
    mask = (rng.random((n, m)) < 0.9).astype(np.float32)
    mask[7] = 0.0
    fused = VIBO(family_config(extra, True, m, 64, link))
    params_np = params_to_numpy(fused.init_params(7))
    item_eps = {name: torch.from_numpy(rng.standard_normal(
        (s, m, d)).astype(np.float32)).cuda()
        for name, d in sorted(fused._head_spec.items())}
    theta_eps = torch.from_numpy(rng.standard_normal(
        (s, n, K)).astype(np.float32)).cuda()
    packed, rv = packed_on_device(resp, mask)
    results = []
    for use_pallas in (True, False):
        model = VIBO(family_config(extra, use_pallas, m, 64, link))
        tp = model.wants_transposed_theta()
        te = theta_eps.transpose(1, 2).contiguous() if tp else theta_eps
        out = []
        for objective in ("elbo", "iwae"):
            params = params_from_jax(params_np, "cuda")
            if objective == "elbo":
                terms = model.elbo_packed_sums(params, packed, item_eps, te,
                                               rv, transposed=tp)
                bound = objectives.elbo(*terms)
            else:
                terms = model.iwae_packed_terms(params, packed, item_eps, te,
                                                rv, transposed=tp)
                w = torch.tensor(IWAE_COTANGENT, device="cuda")
                bound = (w * (terms[0] + terms[1])).sum()
            bound.backward()
            out += [t.detach() for t in terms]
            out += [p.grad for p in tree_leaves(params)]
        results.append(out)
    worst = max(rel_err(a, b) for a, b in zip(*results))
    if not worst <= 1e-4:
        raise AssertionError(f"family {link} {extra}: the packed objectives "
                             f"with the kernels are {worst} from the dense "
                             "ones")
    return {"shape": [n, m], "samples": s, "max_rel_err": worst}


def families_phase(smi: str, data: dict) -> dict:
    """The posterior and conditioning families of the K = 4 commands
    (FAMILY_RUNS) at their width on their link's flagship data (`data`:
    link_data by link): for each, the packed objectives with the kernels
    against the dense ones at 300 x 200 (family_packed_matches_dense),
    then fused_phase: FAMILY_FUSED[0] steps through Trainer.fit at S =
    FAMILY_S (the ELBO finite and rising), the graph replays bitwise equal
    to eager steps, the replay step's ms and the device's busy and idle
    time, and a profiler window of one chunk in which the first layer's
    f32 kernels (once a step) and the one-pass kernel (S a step) run as
    many times a step as in eager steps. The eager steps' launches by
    layout must be the run's row only: row 4 under chol and laplace (the
    3PL's row 9), row 3 under the item encoder (diagonal)."""
    from vibo_tpu_torch.ops import _build
    out = {}
    for tag, extra, layout, link in FAMILY_RUNS:
        agree = family_packed_matches_dense(extra, link)
        path = FAMILY_PATH[link]
        res = fused_phase(f"family_{tag}", family_config(extra, link=link),
                          data[link], smi, path, *FAMILY_FUSED,
                          samples=FAMILY_S,
                          profile_chunks=FAMILY_PROFILE_CHUNKS)
        by = dict(_build.KERNELS[path[-1]].launches_by)
        row = {"phase": "family", "family": tag, "link": link,
               "config": extra, "packed_vs_dense": agree,
               "hidden": FAMILY_H, "samples": FAMILY_S,
               "loglik_launches_by_layout": by,
               "row": FAMILY_ROWS[link, layout], **res, "card": smi}
        emit(row)
        if set(by) != {layout}:
            raise AssertionError(f"family {tag} launched the one-pass op in "
                                 f"the layouts {by}, not {layout} only")
        out[tag] = row
    return out


# ------------------------------------- the decoded full batch and the mesh

# the decoded full batch (TrainConfig.packed=False): epochs, eval_every, and
# its path, the masked 2PL loglik's two kernels (rows 5-6, dense reader)
DECODED_FUSED = (20, 10)
DECODED_PATH = ("masked_loglik_2pl_fwd", "masked_loglik_2pl_bwd")
# mesh_nccl: a students-only fit over a world of one NCCL rank against the
# fit without a mesh (ELBOs and params), and the eager mesh steps timed and
# profiled; its path, rows 1-3 once a step
MESH_NCCL_FIT = (20, 10)                  # epochs, eval_every
MESH_NCCL_TOL = 1e-6
MESH_DP_PATH = (*FIRST_LAYER, "loglik_2pl_train")
MESH_TIMED_STEPS = 5
# mesh_gloo2: two spawned ranks on the card, gloo on CUDA tensors: (tag,
# link, item_axis, steps, compute dtype); each run held against one rank's
# run of the same step on the card (Trainer.step_with_noise without a mesh,
# theta (K, B) on a 2 x 1 mesh where the link takes it, (B, K) on a 2D
# tile as the tile runs it), so the reference runs none of the tile's code.
# The link's flagship model and data; deep: config 5's (mesh_config), at
# its own bf16: the deep link's one-pass op (row 15) rounds its operands to
# bf16 at any compute dtype, so the f32 params' tolerance cannot hold for
# it (deep_one_ulp) and it is held as the bf16 runs are
MESH_GLOO_RUNS = (("2pl_2x1", "2pl", 1, 10, "float32"),
                  ("2pl_1x2", "2pl", 2, 10, "float32"),
                  ("grm_1x2", "grm", 2, 5, "float32"),
                  ("3pl_1x2", "3pl", 2, 5, "float32"),
                  ("gpcm_1x2", "gpcm", 2, 5, "float32"),
                  ("2pl_2x1_bf16", "2pl", 1, 10, "bfloat16"),
                  ("2pl_1x2_bf16", "2pl", 2, 10, "bfloat16"),
                  ("deep_1x2_bf16", "deep", 2, 5, "bfloat16"))
# the f32 runs at JAX's test_train_step_sharded_equals_replicated
# tolerances (an f32 test's)
MESH_ELBO_RTOL = 5e-5
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-4, 5e-6
# the bf16 runs (the flagship's own dtype): the ELBO at MESH_ELBO_RTOL, and
# one step's raw gradient (no clipping) and the params after the Adam
# steps, leaf by leaf, against what bf16 itself does to them: the L2 norm
# of (two ranks - one rank) at most this share of the norm of (one rank at
# bf16 - one rank at f32) on the same params and noise. JAX's f32
# tolerances do not apply there: every product at bf16 rounds its
# operands, the cotangent of a weight read through a bf16 cast is rounded
# to bf16 where each rank's partial sum ends (two roundings of two halves
# where one rank rounds their total once), and a last-bit difference in an
# f32 intermediate (another summation order) flips the bf16 rounding of
# an operand element; Adam then turns such gradient differences into
# params ~5e-5 past rtol 5e-4 / atol 5e-6 in 10 steps at lr 1e-4. On the
# card the shares read at most 0.49 (gradient) and 0.60 (params), every
# 2 x 1 encoder element's difference within u (|partial 0| + |partial 1|
# + |total|), u = 2^-8, with partials that do not cancel (their sizes sum
# to ~1.0 of the total's); a factor of 2 in the gradient would read each
# leaf's gradient norm over its bf16 difference (`grad_l2` beside
# `grad_bf16_l2`)
MESH_BF16_GRAD_SHARE = 1.0
MESH_BF16_PARAM_SHARE = 1.0
MESH_GRAD_SEED = 3                        # the gradient step's noise
# the runs' Adam rate: at the smoke's 5e-3 the flagship's first Adam steps
# move each of the first layer's 7,168 input rows by +-lr, its
# pre-activations by ~10, and the ELBO triples in a step; such a
# trajectory amplifies the f32 summation order of two shards (4e-7 of the
# first step's ELBO) to 1e-2 of the ELBO in 10 steps (a probe on the
# card), which would test the flagship's early dynamics, not the mesh
MESH_GLOO_LR = 1e-4
# one-rank steps before the compared ones, which then start from Adam's
# warmed moments: Adam's first step moves every element by +-lr whatever
# its gradient's size, so an element whose gradient is rounding noise
# (a hidden unit's sum over 10,240 students that nearly cancels) takes
# opposite signs in the two runs and parts by 2 lr (measured on the card:
# 2.2e-4 to 5.4e-4 past the params' tolerance after 10 steps from the
# init); with the moments warmed the update is continuous in the gradient
MESH_GLOO_WARMUP = 5
# each run's kernels a step: rows 1-3 (1f-2f at f32) on the students-only
# step's shards, the one-pass loglik on theta (B, K) (rows 4, 9, 13, 14,
# 15) and no first layer on a 2D tile
MESH_GLOO_PATHS = {"2pl_2x1": {"first_layer_fwd_f32": 1,
                               "first_layer_bwd_f32": 1,
                               "loglik_2pl_train": 1},
                   "2pl_1x2": {"loglik_2pl_train": 1},
                   "grm_1x2": {"loglik_grm_train": 1},
                   "3pl_1x2": {"loglik_3pl_train": 1},
                   "gpcm_1x2": {"loglik_gpcm_train": 1},
                   "2pl_2x1_bf16": {"first_layer_fwd": 1,
                                    "first_layer_bwd": 1,
                                    "loglik_2pl_train": 1},
                   "2pl_1x2_bf16": {"loglik_2pl_train": 1},
                   "deep_1x2_bf16": {"deep_link_train": 1}}
# the layout the 2PL / 3PL one-pass kernel must run in (its launches_by)
MESH_GLOO_LAYOUT = {"2pl_2x1": ("loglik_2pl_train", "kb"),
                    "2pl_1x2": ("loglik_2pl_train", "bk"),
                    "3pl_1x2": ("loglik_3pl_train", "bk"),
                    "2pl_2x1_bf16": ("loglik_2pl_train", "kb"),
                    "2pl_1x2_bf16": ("loglik_2pl_train", "bk")}


def mesh_config(link: str, dtype: str):
    """A mesh_gloo2 run's model: the link's flagship, or for the deep link
    config 5's (the one-pass deep kernel, width DEEP_H), at `dtype`."""
    import dataclasses
    if link == "deep":
        return dataclasses.replace(deep_config(True), compute_dtype=dtype)
    return flagship_config(link, dtype)


def decoded_fused(smi: str, data: dict) -> dict:
    """fit(packed=False) on the 2PL flagship: the decoded full batch, each
    chunk one CUDA graph of DECODED_FUSED[1] steps on the (response, mask)
    on the card (fused_phase: graph against eager bitwise, replay and eager
    step, busy and idle share); the masked 2PL loglik's two kernels (rows
    5-6) run once a step and no first-layer kernel."""
    ds = data["ds"]
    decoded = tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                    .cuda() for x in (ds.response, ds.train_mask))
    res = fused_phase("2pl_decoded", flagship_config("2pl"),
                      {**data, "decoded": decoded}, smi, DECODED_PATH,
                      *DECODED_FUSED, decoded=True)
    wrapper = {k: v.get("wrapper") for k, v in
               res["launches_per_step"].items()}
    if any(wrapper.get(k) != 1.0 for k in DECODED_PATH) or any(
            k.startswith("first_layer") for k in wrapper):
        raise AssertionError(f"decoded_fused: not rows 5-6 once a step "
                             f"alone: {res['launches_per_step']}")
    emit({"phase": "decoded_fused", "epochs": DECODED_FUSED[0],
          "eval_every": DECODED_FUSED[1], **res, "card": smi})
    return res


def tree_paths(tree, prefix: str = "") -> list:
    """Each leaf's path, in convert.tree_leaves order (dict keys sorted,
    lists in order)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _mesh_params_close(got: list, want: list, names: list,
                       grad_rms: list) -> tuple:
    """(max over leaves of max(|got - want| - atol - rtol |want|), the
    largest |got - want| / max |want|, and for each leaf with elements
    past the tolerance: their count, the leaf's size, the largest excess,
    and the RMS gradient (Adam's sqrt(exp_avg_sq)) at those elements
    against the leaf's median) at MESH_PARAM_RTOL/ATOL."""
    excess, over = float("-inf"), {}
    for a, b, name, rms in zip(got, want, names, grad_rms):
        e = ((a.double() - b.double()).abs() - MESH_PARAM_ATOL
             - MESH_PARAM_RTOL * b.double().abs())
        excess = max(excess, float(e.max()))
        bad = e > 0
        if bad.any():
            over[name] = {"count": int(bad.sum()), "size": e.numel(),
                          "excess_max": float(e.max()),
                          "grad_rms_max_there": float(rms[bad].max()),
                          "grad_rms_median": float(rms.median())}
    return excess, max(rel_err(a, b) for a, b in zip(got, want)), over


def mesh_nccl(smi: str, data: dict) -> dict:
    """A world of one NCCL rank, started in process through a file store:
    make_mesh (students only) and a fit of MESH_NCCL_FIT on the 2PL
    flagship through it (eager steps, one host fetch a chunk) against the
    same fit without a mesh (CUDA graphs): the per-epoch ELBOs and the
    params within MESH_NCCL_TOL (and whether bitwise equal); rows 1-3 once
    in each step, by their wrappers and in a profiler window of the mesh
    fit (read for its device calls only, as checkpoint_resume's); then
    MESH_TIMED_STEPS mesh steps timed and a profiler window of them for
    their busy and idle time."""
    import tempfile

    import torch.distributed as dist

    from vibo_tpu_torch import parallel
    from vibo_tpu_torch.convert import tree_leaves
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.train import Trainer, TrainConfig

    ds = data["ds"]
    model = VIBO(flagship_config("2pl"))
    cfg = TrainConfig(lr=5e-3, epochs=MESH_NCCL_FIT[0],
                      eval_every=MESH_NCCL_FIT[1], log_every=1)
    ref = Trainer(model, cfg).fit(ds)
    out = {"phase": "mesh_nccl", "world": 1, "backend": "nccl",
           "epochs": MESH_NCCL_FIT[0], "eval_every": MESH_NCCL_FIT[1],
           "card": smi}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(
                device=torch.device("cuda", torch.cuda.current_device()))
            out["mesh"] = dict(mesh.shape)
            trainer = Trainer(model, cfg, mesh=mesh)
            box = {}

            def mesh_fit():
                box["res"] = trainer.fit(ds)

            for _ in range(PROFILER_TRIES):
                _build.reset_launches()
                t0 = time.perf_counter()
                prof = profile_steps(mesh_fit, 1, 1.0, smi, counts=True)
                out["fit_seconds"] = time.perf_counter() - t0
                launches = launch_counts()
                check_path("mesh_nccl", launches, MESH_DP_PATH,
                           MESH_DP_PATH, MESH_NCCL_FIT[0])
                dev = device_counts(prof["counts"])
                out["device_calls_in_fit"] = {k: dev[k]
                                              for k in MESH_DP_PATH}
                if all(dev[k] == MESH_NCCL_FIT[0] for k in MESH_DP_PATH):
                    break
            else:
                raise AssertionError(f"mesh_nccl: rows 1-3 not once a "
                                     f"step in the fit: {out}")
            res = box["res"]
            out["wrapper_launches"] = {k: launches[k] for k in MESH_DP_PATH}
            elbos = [[h["elbo"] for h in r["history"]
                      if h["event"] == "train"] for r in (res, ref)]
            got = [p.detach() for p in tree_leaves(res["params"])]
            want = [p.detach() for p in tree_leaves(ref["params"])]
            out["elbo_max_rel"] = max(abs(a - b) / abs(b)
                                      for a, b in zip(*elbos))
            out["params_max_rel"] = max(rel_err(a, b)
                                        for a, b in zip(got, want))
            out["bitwise"] = bool(elbos[0] == elbos[1] and all(
                torch.equal(a, b) for a, b in zip(got, want)))
            out["heldout_acc"] = [[h["acc"] for h in r["history"]
                                   if h["event"] == "eval"]
                                  for r in (res, ref)]

            packed, row_valid = trainer._full_batch_data(ds, True)
            params, optimizer = res["params"], res["optimizer"]
            gen = torch.Generator(device="cuda")
            gen.manual_seed(7)

            def step():
                return trainer.step(params, optimizer, packed, row_valid,
                                    gen, B)

            times = []
            for _ in range(MESH_TIMED_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["step_ms_median"] = statistics.median(times[1:])
            # a window that lost a record of the path is opened again (as
            # eager_counts does); each window's path records in the order
            # they ran show where a lost one was
            out["profile_windows"] = []
            for _ in range(PROFILER_TRIES):
                _build.reset_launches()
                prof = profile_steps(step, MESH_TIMED_STEPS,
                                     out["step_ms_median"], smi, counts=True,
                                     sequence=True)
                wrapper = launch_counts()
                dev = device_counts(prof.pop("counts"))
                out["profile_windows"].append({
                    "device_calls": {k: v * MESH_TIMED_STEPS
                                     for k, v in dev.items() if v},
                    "sequence": prof.pop("sequence")})
                out["window_complete"] = all(
                    dev[k] * MESH_TIMED_STEPS == wrapper[k]
                    for k in MESH_DP_PATH)
                if out["window_complete"]:
                    break
            out["device_calls_per_step"] = {k: v for k, v in dev.items()
                                            if v}
            out["profile"] = prof
        finally:
            dist.destroy_process_group()
    emit(out)
    if not (out["elbo_max_rel"] <= MESH_NCCL_TOL
            and out["params_max_rel"] <= MESH_NCCL_TOL):
        raise AssertionError(f"mesh_nccl: the mesh fit is not the fit: "
                             f"{out}")
    return out


def tree_leaves_of(params) -> list:
    """convert.tree_leaves (imported when called)."""
    from vibo_tpu_torch.convert import tree_leaves
    return tree_leaves(params)


def _gloo_step(trainer, params, optimizer, packed, row_valid, gen,
               axis: int) -> dict:
    """One one-rank step of a mesh_gloo2 run: noise for the whole batch
    from `gen` in the layout the run's mesh step draws (theta (K, B) where
    the link takes it on a 2 x 1 mesh, (B, K) on a 2D tile), then
    Trainer.step_with_noise without a mesh."""
    tp = trainer.model.wants_transposed_theta() if axis == 1 else False
    noise = trainer.model.sample_noise(packed.shape[0], 1, transposed=tp,
                                       generator=gen)
    return trainer.step_with_noise(params, optimizer, packed, row_valid,
                                   *noise, transposed=tp)


def _one_rank_run(model, start: str, steps: int, x: tuple, axis: int,
                  nudge: bool = False) -> tuple:
    """`steps` one-rank steps (_gloo_step) of `model` from a mesh_gloo2
    run's warmed checkpoint `start` (params, Adam's moments, the
    generator), the first layer's weights moved one ulp up first where
    `nudge` -> (ELBOs, params, Adam's RMS gradient), leaf by leaf."""
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
    from vibo_tpu_torch.train import checkpoint as ckpt
    params = model.init_params(0)
    optimizer = make_optimizer(params, MESH_GLOO_LR)
    gen = torch.Generator(device="cuda")
    state, gen_state, _, _ = ckpt.load_checkpoint(
        start, ckpt.train_state(params, optimizer))
    ckpt.restore_train_state(state, params, optimizer)
    gen.set_state(gen_state)
    if nudge:
        with torch.no_grad():
            w = params["encoder"][0]["w"]
            w.copy_(torch.nextafter(w, torch.full_like(w, float("inf"))))
    trainer = Trainer(model, TrainConfig(lr=MESH_GLOO_LR))
    elbos = [float(_gloo_step(trainer, params, optimizer, *x, gen,
                              axis)["elbo"]) for _ in range(steps)]
    leaves = tree_leaves_of(params)
    return (elbos, [p.detach() for p in leaves],
            [optimizer.state[p]["exp_avg_sq"].sqrt() for p in leaves])


def _raw_grads(trainer, params, step) -> list:
    """One step's gradient, leaf by leaf: `step(sgd)` runs the trainer's
    step with an SGD at rate 0 (the params stay) and the trainer's clipping
    off, so each leaf's .grad is the step's raw (all-reduced) gradient."""
    sgd = torch.optim.SGD(tree_leaves_of(params), lr=0.0)
    if trainer.cfg.max_grad_norm is not None:
        raise ValueError("_raw_grads needs a trainer without clipping")
    step(sgd)
    return [p.grad.detach().clone() for p in tree_leaves_of(params)]


def _bf16_shares(ref, ranks: list, names: list) -> dict:
    """A bf16 run's gate readings, leaf by leaf: the L2 norm of (two ranks
    - one rank) over that of (one rank at bf16 - one rank at f32), for one
    step's raw gradient and for the params after the Adam steps; and at the
    gradient's worst element, where the two ranks and one rank part most:
    the one-rank gradient there against the leaf's median magnitude, the
    ranks' partial sums' magnitudes over it (a near-cancelling sum gives a
    large ratio), and the difference in units of bf16's unit roundoff
    (2^-8) times |partial 0| + |partial 1| + |total|, the size of the
    rounding of three sums; and the leaf's elements whose difference is
    beyond that size."""
    u = 2.0 ** -8
    out = {}
    for i, name in enumerate(names):
        row = {}
        for what, mesh_key, one_key, f32_key in (
                ("grad", "grad", "grad_one", "grad_f32"),
                ("params", "params", "params_one", "params_f32")):
            got = torch.from_numpy(ranks[0][f"{mesh_key}_{i}"]).double()
            one = torch.from_numpy(ref[f"{one_key}_{i}"]).double()
            f32 = torch.from_numpy(ref[f"{f32_key}_{i}"]).double()
            d_mesh = float((got - one).norm())
            d_bf16 = float((one - f32).norm())
            row[f"{what}_l2"] = float(one.norm())
            row[f"{what}_mesh_l2"] = d_mesh
            row[f"{what}_bf16_l2"] = d_bf16
            row[f"{what}_share"] = (0.0 if d_mesh == 0.0 else
                                    d_mesh / d_bf16 if d_bf16 else
                                    float("inf"))
        got = torch.from_numpy(ranks[0][f"grad_{i}"]).double()
        one = torch.from_numpy(ref[f"grad_one_{i}"]).double()
        parts = [torch.from_numpy(r[f"local_{i}"]).double() for r in ranks]
        diff = (got - one).abs().reshape(-1)
        size = u * (sum(q.abs() for q in parts) + one.abs()).reshape(-1)
        j = int(diff.argmax())
        g = float(one.reshape(-1)[j].abs())
        p = sum(float(q.reshape(-1)[j].abs()) for q in parts)
        row.update({
            "worst_diff": float(diff[j]),
            "worst_grad": g,
            "leaf_median_grad": float(one.abs().median()),
            "worst_partials_over_grad": p / g if g else float("inf"),
            "worst_diff_in_roundings":
                float(diff[j]) / (u * (p + g)) if p + g else 0.0,
            "beyond_roundings": int((diff > size).sum()),
            "size": diff.numel()})
        out[name] = row
    return out


def mesh_gloo2(smi: str, data: dict) -> dict:
    """Two spawned ranks share the card over gloo (NCCL takes one rank a
    card): MESH_GLOO_RUNS, the 2PL flagship's students-only step (2 x 1:
    each rank 5,120 x 1,024 of the code) and 2D step (1 x 2: 10,240 x 512),
    at f32 and at bf16, the 2D step at f32 of the GRM, 3PL and GPCM
    flagships, and at bf16 of config 5's deep model (`data` holds its data
    under "deep"; 5,520 x 340 a rank), each rank copying only its tile. This process first runs each one on one rank without a
    mesh (_gloo_step: the ordinary packed step) from the same init and
    generator; Adam at MESH_GLOO_LR; both start from the state after
    MESH_GLOO_WARMUP one-rank steps (a checkpoint: params, Adam's moments,
    the generator). Each rank holds its run against the one-rank run (the
    ELBOs at MESH_ELBO_RTOL; at f32 the params after the Adam steps at
    MESH_PARAM_RTOL / MESH_PARAM_ATOL), gathers the other rank's params'
    digest (they must be equal), and counts its kernels' launches a step
    (MESH_GLOO_PATHS). A bf16 run also takes one step's raw gradient on
    both sides, and this process holds it and the params, leaf by leaf,
    against the one-rank run at f32 from the same state (_bf16_shares,
    MESH_BF16_GRAD_SHARE, MESH_BF16_PARAM_SHARE). For the deep run it also
    reads the f32 params' gate on the one-rank f32 run against itself with
    its first layer's weights one ulp up (`deep_one_ulp`, reported)."""
    import tempfile

    import torch.multiprocessing as mp

    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops.packing import pack_responses
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
    from vibo_tpu_torch.train import checkpoint as ckpt

    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    out = {"phase": "mesh_gloo2", "world": 2, "backend": "gloo",
           "card": smi}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        for link in {run[1] for run in MESH_GLOO_RUNS}:
            ds = data[link]["ds"]
            np.save(tmp / f"{link}_code.npy",
                    pack_responses(ds.response, ds.train_mask))
            np.save(tmp / f"{link}_rows.npy",
                    (ds.train_mask.sum(-1) > 0).astype(np.float32))
        names = {}
        for tag, link, axis, steps, dtype in MESH_GLOO_RUNS:
            d = data[link]
            x = (d["packed"], d["row_valid"])
            model = VIBO(mesh_config(link, dtype))
            trainer = Trainer(model, TrainConfig(lr=MESH_GLOO_LR))
            params = model.init_params(0)
            names[tag] = tree_paths(params)
            optimizer = make_optimizer(params, MESH_GLOO_LR)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1)
            for _ in range(MESH_GLOO_WARMUP):
                _gloo_step(trainer, params, optimizer, *x, gen, axis)
            start = str(tmp / f"{tag}_start.npz")
            ckpt.save_checkpoint(start, ckpt.train_state(params, optimizer),
                                 gen, MESH_GLOO_WARMUP)
            ref = {}
            if dtype != "float32":
                # one raw gradient at bf16 and at f32 on the same params
                # and noise, then the f32 trajectory from the same state
                f32_model = VIBO(mesh_config(link, "float32"))
                for key, m in (("one", model), ("f32", f32_model)):
                    raw = Trainer(m, TrainConfig(max_grad_norm=None))
                    g = torch.Generator(device="cuda")
                    g.manual_seed(MESH_GRAD_SEED)
                    grads = _raw_grads(raw, params, lambda sgd: _gloo_step(
                        raw, params, sgd, *x, g, axis))
                    ref.update({f"grad_{key}_{i}": v.cpu().numpy()
                                for i, v in enumerate(grads)})
                f_elbos, f_params, f_rms = _one_rank_run(f32_model, start,
                                                         steps, x, axis)
                ref.update({f"params_f32_{i}": p.cpu().numpy()
                            for i, p in enumerate(f_params)})
                if link == "deep":
                    # the f32 one-rank run against itself with its first
                    # layer's weights one ulp up: how far row 15's bf16
                    # operands and relu hinges, through Adam, carry a
                    # rounding-level difference (the f32 gate's reading)
                    n_elbos, n_params, _ = _one_rank_run(
                        f32_model, start, steps, x, axis, nudge=True)
                    excess, rel, over = _mesh_params_close(
                        n_params, f_params, names[tag], f_rms)
                    out["deep_one_ulp"] = {
                        "elbo_max_rel": max(abs(a - b) / abs(b) for a, b
                                            in zip(n_elbos, f_elbos)),
                        "params_max_rel": rel,
                        "params_excess_over_tol": excess,
                        "params_over_tol": over}
            elbos = [float(_gloo_step(trainer, params, optimizer, *x, gen,
                                      axis)["elbo"]) for _ in range(steps)]
            np.savez(tmp / f"{tag}_ref.npz", elbos=np.asarray(elbos),
                     **ref,
                     **{f"params_one_{i}": p.detach().cpu().numpy()
                        for i, p in enumerate(tree_leaves_of(params))})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.start_processes(mesh_rank, args=(2, str(tmp)), nprocs=2,
                           join=True, start_method="spawn")
        out["spawn_seconds"] = time.perf_counter() - t0
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
        out["runs"] = {tag: [r[tag] for r in ranks]
                       for tag, *_ in MESH_GLOO_RUNS}
        for tag, _, _, _, dtype in MESH_GLOO_RUNS:
            if dtype == "float32":
                continue
            ref = np.load(tmp / f"{tag}_ref.npz")
            saved = [np.load(tmp / f"{tag}_rank{r}.npz") for r in range(2)]
            shares = _bf16_shares(ref, saved, names[tag])
            worst = {what: max(row[f"{what}_share"]
                               for row in shares.values())
                     for what in ("grad", "params")}
            bf16_ok = (worst["grad"] <= MESH_BF16_GRAD_SHARE
                       and worst["params"] <= MESH_BF16_PARAM_SHARE)
            for r in out["runs"][tag]:
                r["bf16_shares_max"] = worst
                r["ok"] = bool(r["ok"] and bf16_ok)
            out["runs"][tag][0]["bf16_shares"] = shares
    emit(out)
    bad = [(tag, r) for tag, rs in out["runs"].items() for r in rs
           if not r["ok"]]
    if bad:
        raise AssertionError(f"mesh_gloo2: runs that failed their gates "
                             f"{bad}")
    return out


def mesh_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of mesh_gloo2 (a spawned process on the card): each run of
    MESH_GLOO_RUNS on its mesh (gloo over CUDA tensors), its tile of the
    code on the card, the steps from the one-rank run's warmed state
    (params, Adam's moments, generator); writes rank<r>.json, and for a
    bf16 run rank<r>.npz: its raw gradient of one step (all-reduced, and
    its own partial before the all-reduce) and its params after the
    steps."""
    import torch.distributed as dist

    from vibo_tpu_torch import parallel
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.parallel import mesh as meshlib
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
    from vibo_tpu_torch.train import checkpoint as ckpt

    dev = resolve_device("cuda:0")
    torch.cuda.set_device(dev)
    tmp = Path(tmp)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp / "store"), world), rank=rank,
        world_size=world)
    results = {}
    for tag, link, axis, steps, dtype in MESH_GLOO_RUNS:
        mesh = parallel.make_mesh(axis, backend="gloo", device=dev)
        code = np.load(tmp / f"{link}_code.npy", mmap_mode="r")
        rows, items = code.shape
        lo, hi = mesh.student_rows(rows)
        c0, c1 = mesh.item_block(items)
        packed = torch.from_numpy(np.array(code[lo:hi, c0:c1])).to(dev)
        row_valid = torch.from_numpy(np.load(
            tmp / f"{link}_rows.npy")[lo:hi]).to(dev)
        model = VIBO(mesh_config(link, dtype), device=dev)
        trainer = Trainer(model, TrainConfig(lr=MESH_GLOO_LR), mesh=mesh)
        params = model.init_params(0)
        optimizer = make_optimizer(params, MESH_GLOO_LR)
        gen = torch.Generator(device=dev)

        def restore():
            state, gen_state, _, _ = ckpt.load_checkpoint(
                str(tmp / f"{tag}_start.npz"),
                ckpt.train_state(params, optimizer))
            ckpt.restore_train_state(state, params, optimizer)
            gen.set_state(gen_state)

        restore()
        saved = {}
        if dtype != "float32":
            raw = Trainer(model, TrainConfig(max_grad_norm=None), mesh=mesh)
            g = torch.Generator(device=dev)
            g.manual_seed(MESH_GRAD_SEED)
            reduce = meshlib.all_reduce_grads

            def keep_partials(leaves, group):
                saved.update({f"local_{i}": (torch.zeros_like(p)
                                             if p.grad is None else p.grad)
                              .detach().cpu().numpy()
                              for i, p in enumerate(leaves)})
                reduce(leaves, group)

            meshlib.all_reduce_grads = keep_partials
            try:
                grads = _raw_grads(raw, params, lambda sgd: raw.step(
                    params, sgd, packed, row_valid, g, rows))
            finally:
                meshlib.all_reduce_grads = reduce
            saved.update({f"grad_{i}": v.cpu().numpy()
                          for i, v in enumerate(grads)})
            restore()
        _build.reset_launches()
        elbos, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = trainer.step(params, optimizer, packed, row_valid, gen,
                               rows)
            elbos.append(float(aux["elbo"]))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v / steps for k, v in launch_counts().items() if v}
        kernel, layout = MESH_GLOO_LAYOUT.get(tag, (None, None))
        by = dict(_build.KERNELS[kernel].launches_by) if kernel else {}
        ref = np.load(tmp / f"{tag}_ref.npz")
        leaves = tree_leaves_of(params)
        want = [torch.from_numpy(ref[f"params_one_{i}"]).to(dev)
                for i in range(len(leaves))]
        got = [p.detach() for p in leaves]
        excess, params_rel, over = _mesh_params_close(
            got, want, tree_paths(params),
            [optimizer.state[p]["exp_avg_sq"].sqrt() for p in leaves])
        elbo_rel = max(abs(a - b) / abs(b) for a, b in zip(elbos,
                                                           ref["elbos"]))
        digest = zlib.crc32(b"".join(p.cpu().numpy().tobytes()
                                     for p in got))
        digests = [None] * world
        dist.all_gather_object(digests, digest, group=mesh.world)
        path_ok = (launches == MESH_GLOO_PATHS[tag]
                   and (kernel is None or set(by) == {layout}))
        f32 = dtype == "float32"
        if not f32:
            saved.update({f"params_{i}": p.cpu().numpy()
                          for i, p in enumerate(got)})
            np.savez(tmp / f"{tag}_rank{rank}.npz", **saved)
        results[tag] = {
            "rank": rank, "mesh": dict(mesh.shape), "dtype": dtype,
            "tile": [hi - lo, c1 - c0], "steps": steps,
            "step_ms_median": statistics.median(times[1:]),
            "step_ms_first": times[0], "elbo_first": elbos[0],
            "elbo_last": elbos[-1], "elbo_max_rel": elbo_rel,
            "params_max_rel": params_rel,
            "params_excess_over_tol": excess, "params_over_tol": over,
            "digests_equal": len(set(digests)) == 1,
            "launches_per_step": launches, "loglik_by_layout": by,
            # a bf16 run's params are gated by _bf16_shares instead
            "ok": bool(elbo_rel <= MESH_ELBO_RTOL
                       and (excess <= 0.0 or not f32)
                       and len(set(digests)) == 1 and path_ok)}
    (tmp / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()


# ------------------------------------------------------------ the CLI phases

REPO_DIR = Path(__file__).resolve().parent
CLI_CFG1 = ("train", "synthetic-1pl", "--irt-model", "1pl", "--num-persons",
            "1000", "--num-items", "100", "--epochs", "200", "--eval-every",
            "100")                        # run_benchmark_configs.sh:8-9
CLI_CFG1_KERNELS = ("first_layer_fwd_f32", "first_layer_bwd_f32",
                    "loglik_2pl_train")
CLI_CFG1_REPORTS = ("ece", "brier", "peak_hbm_mb")
CLI_SCORE_STUDENTS, CLI_SCORE_BATCH, CLI_SCORE_SEED = 256, 100, 11
CLI_REFINE_STEPS = 50
CLI_GRM = ("compare", "synthetic-grm", "--irt-model", "grm",
           "--num-categories", "5", "--num-persons", "2000", "--num-items",
           "100", "--epochs", "500", "--num-posterior-samples", "5",
           "--restarts", "2", "--steps", "600", "--hmc-warmup", "800",
           "--hmc-samples", "1600", "--hmc-chains", "4", "--hmc-leapfrog",
           "64", "--hmc-target-accept", "0.65", "--hmc-cache",
           str(REPO_DIR / "artifacts" / "gold" / "grm"))
                                          # run_benchmark_configs.sh:98-102
CLI_GRM_KERNELS = ("first_layer_fwd_f32", "first_layer_bwd_f32",
                   "loglik_grm_train")
CLI_DEEP = ("train", "synthetic-nonlinear", "--num-persons", "2000",
            "--num-items", "200", "--ability-dim", "2", "--irt-model",
            "deep", "--epochs", "300", "--eval-every", "100",
            "--iwae-samples", "100", "--restarts", "2",
            "--num-posterior-samples", "5")   # run_benchmark_configs.sh:77-79
CLI_K2NUTS = ("compare", "synthetic-2pl", "--num-persons", "2000",
              "--num-items", "200", "--ability-dim", "2", "--epochs", "500",
              "--num-posterior-samples", "5", "--restarts", "2",
              "--condition-on", "stats", "--theta-posterior", "laplace-w",
              "--methods", "mle,em,hmc", "--hmc-warmup", "800",
              "--hmc-samples", "1200", "--hmc-chains", "4",
              "--hmc-trajectory", "nuts", "--hmc-tree-depth", "7",
              "--hmc-target-accept", "0.8", "--hmc-cache",
              str(REPO_DIR / "artifacts" / "gold" / "k2-nuts"))
                                          # run_benchmark_configs.sh:104-111
# laplace-w at K = 2 runs theta (B, K): the 2PL one-pass kernel of row 4
CLI_K2NUTS_KERNELS = ("first_layer_fwd_f32", "first_layer_bwd_f32",
                      "loglik_2pl_train")
CLI_ITEMS = ("train", "synthetic-2pl", "--num-persons", "2000",
             "--num-items", "200", "--item-encoder", "--eval-new-items",
             "0.1")
CLI_ITEMS_KERNELS = ("first_layer_fwd_f32", "first_layer_bwd_f32",
                     "loglik_2pl_train")
# the JAX package's values and the allowed distance (the port draws other
# random streams): a tuple holds the JAX CLI's own runs of the command on
# the CPU at training seeds 0-3 (tests/cli_reference.jsonl, written by
# `python tests/cli_reference.py --seeds 4 --out tests/cli_reference.jsonl
# cfg1 grm`) and the gate is their range widened by the tolerance; a number
# is the JAX package's recorded run (RESULTS.md:37, :616, :693). cfg 1's
# held-out: RESULTS.md's 0.7161 is not what the package gives today
CLI_CFG1_RECORDED = 0.7161
CLI_GATES = {
    "cli_cfg1": {"heldout_acc": ((0.7016, 0.7029, 0.7122, 0.7130), 0.01),
                 "b_pearson": (0.9412, 0.02),
                 "heldout_base_rate": (0.512, 0.0),
                 "theta_pearson_min": 0.955},
    # the Laplace widths' agreement with the gold's sds moves with the
    # restart that training selects (0.8813-0.9371 across seeds)
    "vibo": {"heldout_acc": (0.4465, 0.01), "theta_vs_hmc_min": 0.985,
             "laplace_sigma_vs_hmc": ((0.8977, 0.8813, 0.9371, 0.9371),
                                      0.02)},
    "mle": {"heldout_acc": (0.4527, 0.005), "theta_vs_hmc_min": 0.998},
    "em": {"heldout_acc": (0.4527, 0.002), "ece": (0.0054, 0.001),
           "theta_vs_hmc_min": 0.9995},
    "hmc": {"heldout_acc": (0.45309, 0.00001)},
    "cli_deep": {"heldout_acc": (0.6979, 0.01),
                 "iwae_loglik_per_cell": (-0.68519, 0.01)}}


def gate(row: dict, gates: dict) -> dict:
    """Each gate of `gates` on `row`: (value, tolerance) pairs within the
    tolerance, (values, tolerance) within it of the values' range,
    `<key>_min` floors. Returns {key: passed}."""
    out = {}
    for key, want in gates.items():
        if key.endswith("_min"):
            got = row.get(key[:-4])
            out[key] = got is not None and got >= want
        else:
            got = row.get(key)
            vals = want[0] if isinstance(want[0], tuple) else (want[0],)
            out[key] = (got is not None
                        and min(vals) - want[1] <= got <= max(vals) + want[1])
    return out


def gates_hold(gates: dict) -> bool:
    return all(v if isinstance(v, bool) else gates_hold(v)
               for v in gates.values())


def trace_kernel_calls(trace_dir: Path) -> dict:
    """Calls of each kernel of DEVICE_KERNELS in the Chrome trace(s) that
    the CLI's --profile wrote into trace_dir (device records only)."""
    names = []
    for path in sorted(trace_dir.glob("trace_*.json")):
        with open(path) as f:
            names += [e.get("name", "") for e in json.load(f)["traceEvents"]
                      if e.get("cat") in ("kernel", "Kernel")]
    if not names:
        raise AssertionError(f"no device record in the traces of {trace_dir}")
    return {k: sum(bool(re.search(rx, n)) for n in names)
            for k, rx in DEVICE_KERNELS.items()}, len(names)


def files_digest(root: Path) -> dict:
    """sha256 and mtime of every file under root."""
    import hashlib
    return {str(p.relative_to(root)): (hashlib.sha256(p.read_bytes())
                                       .hexdigest(), p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*")) if p.is_file()}


def cli_cfg1(smi: str, tmp: Path) -> dict:
    """cfg 1 through the port's command line as a user runs it: a fresh
    `python -m vibo_tpu_torch.cli` process on the card with --out-dir and
    --profile; its last line is the summary. The trace must name the f32
    first layer's two kernels and the 2PL one-pass kernel (1PL runs the
    2PL kernel with unit loadings) and no other loglik kernel."""
    torch.cuda.empty_cache()
    out_dir, trace_dir = tmp / "cfg1", tmp / "cfg1_trace"
    cmd = [sys.executable, "-m", "vibo_tpu_torch.cli", *CLI_CFG1,
           "--out-dir", str(out_dir), "--profile", str(trace_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=600)
    seconds = time.perf_counter() - t0
    (tmp / "cfg1.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"cli_cfg1 exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1])
    calls, records = trace_kernel_calls(trace_dir)
    out = {"phase": "cli_cfg1", "command": " ".join(CLI_CFG1),
           "seconds": seconds, "summary": summary,
           "heldout_acc_minus_recorded": summary["heldout_acc"]
           - CLI_CFG1_RECORDED,
           "trace_kernel_calls": {k: v for k, v in calls.items() if v},
           "trace_device_records": records,
           "out_dir_files": sorted(p.name for p in out_dir.iterdir()),
           "card": smi}
    out["gates"] = gate(summary, CLI_GATES["cli_cfg1"])
    emit(out)
    stray = [k for k in LOGLIK_DEVICE_KERNELS
             if k not in CLI_CFG1_KERNELS and calls[k]]
    if (not gates_hold(out["gates"])
            or any(calls[k] == 0 for k in CLI_CFG1_KERNELS) or stray
            or not {"best.npz", "metrics.jsonl"} <= set(out["out_dir_files"])
            or not all(k in summary for k in CLI_CFG1_REPORTS)):
        raise AssertionError(f"cli_cfg1: {out}")
    return out


def cli_score(smi: str, tmp: Path) -> dict:
    """`score` from cli_cfg1's best.npz on 256 new 1PL students of cfg 1's
    items (a new seed, 10 % of the cells unobserved), in batches of
    CLI_SCORE_BATCH: the .npz input bitwise equal to
    AbilityScorer.from_checkpoint(best).score batch by batch, the same
    students as a long CSV (integer item ids) bitwise equal to the .npz's,
    and --refine-theta CLI_REFINE_STEPS finite of the right shapes."""
    import csv

    from vibo_tpu_torch import cli
    from vibo_tpu_torch.data import simulate_irt
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.serve import AbilityScorer

    ckpt = str(tmp / "cfg1" / "best.npz")
    items = simulate_irt("1pl", 1000, 100, seed=0).b     # cfg 1's items
    rng = np.random.default_rng(CLI_SCORE_SEED)
    n = CLI_SCORE_STUDENTS
    theta = rng.standard_normal((n, 1))
    prob = 1.0 / (1.0 + np.exp(-(theta - items[None, :])))
    mask = (rng.random((n, 100)) < 0.9).astype(np.float32)
    resp = (rng.random((n, 100)) < prob).astype(np.float32) * mask
    np.savez(tmp / "new.npz", response=resp, mask=mask)
    with open(tmp / "new.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("student_id", "item_id", "correct"))
        w.writerows((f"s{p:03d}", j, int(resp[p, j]))
                    for p in range(n) for j in range(100) if mask[p, j])
    bs = ["--batch-size", str(CLI_SCORE_BATCH)]
    outs, seconds = {}, {}
    _build.reset_launches()
    for tag, inp, extra in (("npz", "new.npz", []), ("csv", "new.csv", []),
                            ("refine", "new.npz",
                             ["--refine-theta", str(CLI_REFINE_STEPS)])):
        path = str(tmp / f"score_{tag}.npz")
        t0 = time.perf_counter()
        cli.main(["score", "--checkpoint", ckpt, "--input", str(tmp / inp),
                  "--output", path, *bs, *extra])
        seconds[tag] = time.perf_counter() - t0
        with np.load(path) as z:
            outs[tag] = {k: z[k] for k in z.files}
    launches = launch_counts()
    scorer = AbilityScorer.from_checkpoint(ckpt)
    direct = [scorer.score(resp[s:s + CLI_SCORE_BATCH],
                           mask[s:s + CLI_SCORE_BATCH])
              for s in range(0, n, CLI_SCORE_BATCH)]
    direct = {k: np.concatenate([d[k] for d in direct]) for k in direct[0]}
    ref = outs["refine"]
    out = {"phase": "cli_score", "students": n, "batch": CLI_SCORE_BATCH,
           "seconds": seconds, "card": smi,
           "npz_bitwise_vs_scorer": all(
               np.array_equal(outs["npz"][k], direct[k]) for k in direct),
           "csv_bitwise_vs_npz": all(
               np.array_equal(outs["csv"][k], outs["npz"][k])
               for k in ("theta_mu", "theta_sigma")),
           "refined_shapes": {k: list(ref[f"refined_{k}"].shape)
                              for k in ("theta_mu", "theta_sigma",
                                        "theta_tril")},
           "refined_finite": all(np.isfinite(ref[f"refined_{k}"]).all()
                                 for k in ("theta_mu", "theta_sigma",
                                           "theta_tril")),
           "refined_vs_amortized_max_abs": float(np.abs(
               ref["refined_theta_mu"] - ref["theta_mu"]).max()),
           "launches": {k: v for k, v in launches.items() if v}}
    emit(out)
    check_path("cli_score", launches, ())
    if not (out["npz_bitwise_vs_scorer"] and out["csv_bitwise_vs_npz"]
            and out["refined_finite"]
            and out["refined_shapes"] == {"theta_mu": [n, 1],
                                          "theta_sigma": [n, 1],
                                          "theta_tril": [n, 1, 1]}):
        raise AssertionError(f"cli_score: {out}")
    return out


def cli_compare_grm(smi: str) -> dict:
    """The GRM parity sweep in process (cli.main): VIBO (2 restarts, S = 5,
    use_pallas: the f32 first layer and row 13), MLE, EM, and the HMC row
    from the committed artifacts/gold/grm cache, which must be a hit that
    writes nothing; every row held to the JAX package's recorded run."""
    from vibo_tpu_torch import cli
    from vibo_tpu_torch.ops import _build

    artifacts = REPO_DIR / "artifacts"
    before = files_digest(artifacts)
    torch.cuda.empty_cache()
    _build.reset_launches()
    t0 = time.perf_counter()
    table = cli.main(list(CLI_GRM))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    rows = {r["method"]: r for r in table}
    out = {"phase": "cli_compare_grm", "command": " ".join(CLI_GRM),
           "seconds": seconds, "rows": table,
           "row_seconds": {m: r["seconds"] for m, r in rows.items()},
           "artifacts_unchanged": files_digest(artifacts) == before,
           "launches": {k: v for k, v in launches.items() if v},
           "card": smi}
    out["gates"] = {m: gate(rows[m], CLI_GATES[m])
                    for m in ("vibo", "mle", "em", "hmc")}
    emit(out)
    check_path("cli_compare_grm", launches, CLI_GRM_KERNELS)
    if not (gates_hold(out["gates"]) and rows["hmc"].get("cached") is True
            and out["artifacts_unchanged"]
            and [r["method"] for r in table] == ["vibo", "mle", "em", "hmc"]):
        raise AssertionError(f"cli_compare_grm: {out}")
    return out


def cli_deep(smi: str) -> dict:
    """The deep command in process: the plain link (no kernel, as the JAX
    CLI leaves it), 2 restarts of 300 epochs at S = 5, IWAE-100, and the
    Laplace widths through the link's Jacobian (laplace_sigma_deep on the
    card): finite factors with positive diagonals."""
    from vibo_tpu_torch import cli
    from vibo_tpu_torch.ops import _build

    torch.cuda.empty_cache()
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = cli.main(list(CLI_DEEP))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    lap = summary["_theta_laplace_tril"]
    diag = np.diagonal(lap, axis1=1, axis2=2)
    out = {"phase": "cli_deep", "command": " ".join(CLI_DEEP),
           "seconds": seconds, "summary": cli._public(summary),
           "laplace_tril_shape": list(lap.shape),
           "laplace_finite": bool(np.isfinite(lap).all()),
           "laplace_diag_min": float(diag.min()),
           "laplace_sd_mean": float(np.sqrt((lap ** 2).sum(-1)).mean()),
           "launches": {k: v for k, v in launches.items() if v},
           "card": smi}
    out["gates"] = gate(summary, CLI_GATES["cli_deep"])
    emit(out)
    check_path("cli_deep", launches, ())
    if not (gates_hold(out["gates"]) and out["laplace_finite"]
            and out["laplace_diag_min"] > 0
            and out["laplace_tril_shape"][1:] == [2, 2]):
        raise AssertionError(f"cli_deep: {out}")
    return out


def reference_spread(name: str) -> dict:
    """{key: (values, ...)} of the JAX CLI's runs of the reference `name`
    at training seeds 0-3 (tests/cli_reference.jsonl)."""
    with open(REPO_DIR / "tests" / "cli_reference.jsonl") as f:
        line = next(x for x in map(json.loads, f) if x["reference"] == name)
    runs = list(line["by_training_seed"].values())
    return {k: tuple(r[k] for r in runs) for k in runs[0]}


# the tolerance each key of a reference's seed spread is widened by
CLI_K2NUTS_TOL = {"heldout_acc": 0.01, "theta_vs_hmc": 0.005,
                  "sigma_vs_hmc": 0.03, "laplace_sigma_vs_hmc": 0.02,
                  "b_vs_hmc": 0.01, "a_vs_hmc": 0.01}
CLI_ITEMS_TOL = {"heldout_acc": 0.01, "new_item_acc": 0.02,
                 "new_item_base_rate": 0.0}
# the k2-nuts baselines, JAX's own run of the command (the port's MLE and
# EM are plain PyTorch, the HMC row the cached gold)
CLI_K2NUTS_BASELINES = {
    "mle": {"heldout_acc": (0.7194, 0.005), "theta_vs_hmc_min": 0.995},
    "em": {"heldout_acc": (0.7197, 0.002), "theta_vs_hmc_min": 0.997},
    "hmc": {"heldout_acc": (0.71965, 0.00001)}}


def spread_gates(name: str, tol: dict) -> dict:
    return {k: (v, tol[k]) for k, v in reference_spread(name).items()}


def cli_k2nuts(smi: str) -> dict:
    """The k2-nuts sweep (run_benchmark_configs.sh:104-111) in process:
    VIBO under stats + laplace-w (2 restarts, S = 5; use_pallas: the f32
    first layer and the 2PL one-pass op on theta (B, K), row 4), MLE, EM,
    and the HMC row from the committed artifacts/gold/k2-nuts cache, which
    must be a hit that writes nothing. Every VIBO key is gated on the JAX
    CLI's seed spread widened by CLI_K2NUTS_TOL."""
    from vibo_tpu_torch import cli
    from vibo_tpu_torch.ops import _build

    artifacts = REPO_DIR / "artifacts"
    before = files_digest(artifacts)
    torch.cuda.empty_cache()
    _build.reset_launches()
    t0 = time.perf_counter()
    table = cli.main(list(CLI_K2NUTS))
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    by = dict(_build.KERNELS["loglik_2pl_train"].launches_by)
    rows = {r["method"]: r for r in table}
    out = {"phase": "cli_k2nuts", "command": " ".join(CLI_K2NUTS),
           "seconds": seconds, "rows": table,
           "row_seconds": {m: r["seconds"] for m, r in rows.items()},
           "artifacts_unchanged": files_digest(artifacts) == before,
           "launches": {k: v for k, v in launches.items() if v},
           "loglik_launches_by_layout": by, "card": smi}
    out["gates"] = {"vibo": gate(rows["vibo"],
                                 spread_gates("k2nuts", CLI_K2NUTS_TOL)),
                    **{m: gate(rows[m], g)
                       for m, g in CLI_K2NUTS_BASELINES.items()}}
    emit(out)
    check_path("cli_k2nuts", launches, CLI_K2NUTS_KERNELS)
    if not (gates_hold(out["gates"]) and rows["hmc"].get("cached") is True
            and out["artifacts_unchanged"] and set(by) == {"bk"}
            and [r["method"] for r in table] == ["vibo", "mle", "em",
                                                 "hmc"]):
        raise AssertionError(f"cli_k2nuts: {out}")
    return out


def cli_items(smi: str, tmp: Path) -> dict:
    """The item encoder's cold start through the command line, in process:
    CLI_ITEMS with --out-dir (10 % of the items held out by split_items,
    the rest trained on with the item encoder: use_pallas, the f32 first
    layer and the 2PL one-pass op on theta (K, B), row 3), its held-out and
    new_item_acc gated on the JAX CLI's seed spread; then `score --items`
    of the held-out columns (their train-visible cells) from its best.npz,
    bitwise equal to AbilityScorer.from_checkpoint(best).score_items,
    finite, with positive sds and no kernel launched."""
    import argparse

    from vibo_tpu_torch import cli
    from vibo_tpu_torch.data.masking import split_items
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.serve import AbilityScorer

    torch.cuda.empty_cache()
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = cli.main([*CLI_ITEMS, "--out-dir", str(tmp / "items")])
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    by = dict(_build.KERNELS["loglik_2pl_train"].launches_by)
    check_path("cli_items train", launches, CLI_ITEMS_KERNELS)
    # the held-out columns, as cmd_train split them
    ns = argparse.Namespace(dataset="synthetic-2pl", num_persons=2000,
                            num_items=200, ability_dim=1, num_categories=5,
                            artificial_missing_perc=0.1, missing_rate=0.0,
                            data_dir=None, seed=0, irt_model="2pl")
    _, new_ds = split_items(cli._load(ns)[0], test_frac=0.1, seed=0)
    np.savez(tmp / "new_items.npz", response=new_ds.response,
             mask=new_ds.train_mask)
    ckpt = str(tmp / "items" / "best.npz")
    _build.reset_launches()
    t1 = time.perf_counter()
    score = cli.main(["score", "--checkpoint", ckpt, "--input",
                      str(tmp / "new_items.npz"), "--items", "--output",
                      str(tmp / "items_scored.npz")])
    score_s = time.perf_counter() - t1
    score_launches = launch_counts()
    with np.load(tmp / "items_scored.npz") as z:
        got = {k: z[k] for k in z.files}
    direct = AbilityScorer.from_checkpoint(ckpt).score_items(
        new_ds.response, new_ds.train_mask)
    out = {"phase": "cli_items", "command": " ".join(CLI_ITEMS),
           "seconds": seconds, "summary": cli._public(summary),
           "launches": {k: v for k, v in launches.items() if v},
           "loglik_launches_by_layout": by,
           "score_items": {"summary": score, "seconds": score_s,
                           "shapes": {k: list(v.shape)
                                      for k, v in got.items()},
                           "bitwise_vs_scorer": sorted(got) == sorted(direct)
                           and all(np.array_equal(got[k], direct[k])
                                   for k in direct),
                           "finite": all(np.isfinite(v).all()
                                         for v in got.values()),
                           "sigma_min": float(min(got[k].min() for k in got
                                                  if k.endswith("_sigma"))),
                           "launches": {k: v for k, v in
                                        score_launches.items() if v}},
           "card": smi}
    out["gates"] = gate(summary, spread_gates("items", CLI_ITEMS_TOL))
    emit(out)
    check_path("cli_items score", score_launches, ())
    si = out["score_items"]
    if not (gates_hold(out["gates"]) and set(by) == {"kb"}
            and si["bitwise_vs_scorer"] and si["finite"]
            and si["sigma_min"] > 0
            and si["shapes"] == {"a_mu": [new_ds.shape[1], 1],
                                 "a_sigma": [new_ds.shape[1], 1],
                                 "b_mu": [new_ds.shape[1], 1],
                                 "b_sigma": [new_ds.shape[1], 1]}):
        raise AssertionError(f"cli_items: {out}")
    return out


def cli_phases(smi: str) -> dict:
    """The six CLI phases, in a temporary directory under build/."""
    import tempfile
    scratch = REPO_DIR / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        runs = {"cli_cfg1": cli_cfg1(smi, tmp),
                "cli_score": cli_score(smi, tmp),
                "cli_items": cli_items(smi, tmp)}
    runs["cli_compare_grm"] = cli_compare_grm(smi)
    runs["cli_deep"] = cli_deep(smi)
    runs["cli_k2nuts"] = cli_k2nuts(smi)
    return runs


def deep_config(fused: bool = True, width: int = DEEP_H):
    """Paper config 5 (`train wordbank --irt-model deep --ability-dim 2`)
    with the CLI's widths: encoder hidden 256, item latent 16, link width
    128 (or `width`); bf16 encoder, the fused pipeline; the one-pass op when
    fused, else JAX's default (decoded code, the plain link in blocks of 256
    items)."""
    from vibo_tpu_torch.models import VIBOConfig
    return VIBOConfig(num_items=DEEP_M, irt_model="deep", ability_dim=DEEP_K,
                      hidden_dim=H, item_latent_dim=DEEP_D,
                      deep_hidden_dim=width, conditional_posterior=True,
                      condition_on="sample", use_pallas=True,
                      compute_dtype="bfloat16", deep_fused_kernel=fused)


def deep_data() -> dict:
    """Config 5's data: the WordBank surrogate of the JAX loaders
    (simulate_irt("nonlinear", 5,520, 680, K = 2, seed 0 + crc32("wordbank")
    % 9973 = 6628, every cell observed), 10 % held out, on the card as the
    paths take it: the int8 code of the training cells, and epoch 0's first
    and last (padded) minibatch."""
    from vibo_tpu_torch.data import batch_iterator, holdout_split, simulate_irt
    from vibo_tpu_torch.ops.packing import packed_on_device
    seed = zlib.crc32(b"wordbank") % 9973
    sim = simulate_irt("nonlinear", DEEP_B, DEEP_M, ability_dim=DEEP_K,
                       seed=seed, missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    packed, row_valid = packed_on_device(ds.response, ds.train_mask)
    epoch0 = list(batch_iterator(ds, BATCH, 0, 0))
    pad_rows = len(epoch0) * BATCH - DEEP_B
    if int((epoch0[-1][1].sum(-1) == 0).sum()) != pad_rows:
        raise AssertionError("the deep last batch's padding is not empty")
    return {"ds": ds, "packed": packed, "row_valid": row_valid, "seed": seed,
            "pad_rows": pad_rows, "steps_per_epoch": len(epoch0)}


# the at-scale pipeline: its kernels' shape (the default run's training
# students x lexemes; K = 1, hidden 256), the code's density there (13 M
# rows over 140,000 x 2,048 cells), and the smoke's bounded run of it
# (scripts/run_at_scale.py's --rows 2000000 --users 30000)
AT_SCALE_SHAPE = (135_800, 2_048)
AT_SCALE_DENSITY = 0.04
AT_SCALE_RUN = {"rows": 2_000_000, "users": 30_000, "lexemes": 2048,
                "epochs": 300, "chunk": 100, "hidden_dim": 256,
                "num_samples": 5, "iwae_samples": 100}
AT_SCALE_PATH = (*FIRST_LAYER, "loglik_2pl_train")
# their device calls a step: the encoder once (its first layer once on the
# code, on the samples' axis as JAX's vmap runs it), the loglik once a
# sample
AT_SCALE_CALLS = {"first_layer_fwd": 1, "first_layer_bwd": 1,
                  "loglik_2pl_train": AT_SCALE_RUN["num_samples"]}


def at_scale_code(seed: int = 21) -> torch.Tensor:
    """A random (135,800, 2,048) int8 code on the card from a numpy seed:
    each cell observed with probability AT_SCALE_DENSITY, right or wrong
    alike."""
    rng = np.random.default_rng(seed)
    per = int(round(2 / AT_SCALE_DENSITY))
    v = rng.integers(0, per, size=AT_SCALE_SHAPE, dtype=np.int8)
    code = np.where(v < 2, v + 1, 0).astype(np.int8)
    return torch.from_numpy(code).cuda()


def at_scale_kernel_checks(timer, roof, smi: str) -> dict:
    """Rows 1-2 (bf16, hidden 256) and row 3 (K = 1, both layouts) on
    at_scale_code, timed, with the flagship checks' tolerances. Their
    weights and abilities come from a generator of their own, so every
    other check draws the inputs it drew before these were added."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    pk = at_scale_code()
    out = {"first_layer": check_first_layer(timer, roof, pk, gen, True, H),
           "loglik_2pl_train": check_loglik(timer, roof, pk, gen, True,
                                            "2pl", 1),
           "density": float((pk > 0).float().mean())}
    emit({"phase": "kernel_check", "kernel": "at-scale shape (rows 1-3)",
          "dims": [*AT_SCALE_SHAPE, 1, H], "results": out, "card": smi})
    del pk
    torch.cuda.empty_cache()
    return out


def at_scale_phase(smi: str) -> dict:
    """run_at_scale.run on the card at AT_SCALE_RUN (module doc): its JSON,
    the gates, rows 1-3 held against their plain versions on the run's own
    code (the shape the run drives, untimed, the flagship tolerances;
    weights and abilities from a generator of their own), the wrappers'
    launches over the run (the capture's eager warm-up steps; replays are
    not counted) and the device calls a step of a profiler window over one
    chunk's replay (put back afterwards)."""
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.scripts import run_at_scale
    from vibo_tpu_torch.train.trainer import _restore, _snapshot

    chunk = AT_SCALE_RUN["chunk"]
    seen = {}

    def after_train(state, out):
        code = state["code"]
        check_gen = torch.Generator(device="cuda")
        check_gen.manual_seed(22)
        seen["checks"] = {
            "dims": [*code.shape, 1, AT_SCALE_RUN["hidden_dim"]],
            "first_layer": check_first_layer(
                None, None, code, check_gen, False,
                AT_SCALE_RUN["hidden_dim"]),
            "loglik_2pl_train": check_loglik(None, None, code, check_gen,
                                             False, "2pl", 1)}
        gen = state["generator"]
        saved = _snapshot(state["params"], state["optimizer"], gen)
        args = (state["params"], state["optimizer"], state["code"],
                state["row_valid"], gen)
        for _ in range(PROFILER_TRIES):
            prof = profile_steps(lambda: state["scan"](*args), 1,
                                 out["ms_per_epoch"], smi, per_call=chunk,
                                 counts=True)
            calls = device_counts(prof.pop("counts"))
            if all(calls[n] == c for n, c in AT_SCALE_CALLS.items()):
                break
        _restore(saved, state["params"], state["optimizer"], gen)
        seen.update(profile=prof, device_calls_per_step={
            k: v for k, v in calls.items() if v})

    _build.reset_launches()
    t0 = time.perf_counter()
    out = run_at_scale.run(**AT_SCALE_RUN, after_train=after_train)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    calls = seen["device_calls_per_step"]
    elbos = out["chunk_elbos"]
    gates = {
        "elbo_rises": all(b > a for a, b in zip(elbos, elbos[1:])),
        "heldout_acc": out["heldout_acc"] >= out["heldout_base_rate"] + 0.01,
        "new_person_acc":
            out["new_person_acc"] >= out["heldout_base_rate"] - 0.05,
        "iwae_per_cell": -1.0 < out["iwae100_loglik_per_cell"] < 0.0,
        "rows_1_2_once_row_3_s_a_step": all(
            calls.get(n, 0) == c for n, c in AT_SCALE_CALLS.items()),
        "no_other_kernel": not any(
            calls.get(n, 0) for n in DEVICE_KERNELS
            if n not in (*AT_SCALE_PATH, "first_layer_prep", "sum_rows"))}
    emit({"phase": "at_scale", "seconds": seconds, "result": out,
          "gates": gates, "launches": {k: v for k, v in launches.items()
                                       if v},
          "device_calls_per_step": calls, "profile": seen["profile"],
          "kernel_checks": seen["checks"], "card": smi})
    if not all(gates.values()):
        raise AssertionError(f"at_scale: gates failed {gates}")
    check_path("at_scale", launches, AT_SCALE_PATH)
    return {"launches": launches, "device_calls_per_step": calls,
            "result": out, "checks": seen["checks"]}


def kernel_entry(name, replaces, source, launches, r, **extra) -> dict:
    """One entry of the kernels line; r holds the kernel check's numbers."""
    return {"name": name, "route": "cuda",
            "source": f"vibo_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches,
            **{k: v for k, v in r.items() if k != "rel_err"}, **extra}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.data import simulate_irt
    from vibo_tpu_torch.ops import _build

    resolve_device(None)           # the card, with TF32 off
    smi = nvidia_smi("name,power.limit")
    card = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {s: ptxas_lines(open(v["log"]).read()) for s, v in built.items()}
    roof = Roofline()
    # the one-pass kernels' registers, spills and blocks an SM, at every
    # instantiated K and the wide variant (GRM/GPCM at C = 5 and the
    # run-time path at C = 9, GPCM also at its largest compile-time C); the
    # masked forward's and VJP's, both readers
    occ = {f"{fam} K={k}" + (f" C={c}" if fam in FAMILIES else ""):
           occupancy(fam, k, c)
           for fam in LINK_KERNELS for k in (*range(1, 9), 12)
           for c in ((C, GPCM_FIXED_C, GPCM_FIXED_C + 1) if fam == "gpcm"
                     else (C, GRM_FIXED_C + 1) if fam == "grm" else (C,))}
    occ.update({f"masked_{direction}_{link} K={k} {reader}":
                occupancy(f"masked_{direction}_{link}", k, packed)
                for direction in ("fwd", "bwd") for link in ("2pl", "3pl")
                for k in (*range(1, 9), 12)
                for packed, reader in ((0, "dense"), (1, "int8"))})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {s: v["seconds"] for s, v in built.items()},
          "ptxas": ptxas, "sms": roof.sms, "max_sm_mhz": roof.max_sm_mhz,
          "one_pass_occupancy": occ})

    t0 = time.perf_counter()
    data = {link: link_data(link) for link in LINK_KERNELS}
    deep = deep_data()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "shape": [B, M], "observed_train_frac":
          {link: float(d["ds"].train_mask.mean())
           for link, d in data.items()},
          "deep_config5": {"shape": [DEEP_B, DEEP_M], "seed": deep["seed"],
                           "observed_train_frac":
                           float(deep["ds"].train_mask.mean()),
                           "right_frac": float(deep["ds"].response.mean()),
                           "padded_rows_last_batch": deep["pad_rows"]}})

    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {}
    ragged_pk = torch.randint(0, 3, RAGGED, generator=gen, device="cuda",
                              dtype=torch.int8)
    # M = 301: rows off the vector boundary take the scalar reader
    odd_pk = torch.randint(0, 3, ODD, generator=gen, device="cuda",
                           dtype=torch.int8)
    first_layer = first_layer_checks(timer, roof, data, deep, ragged_pk,
                                     odd_pk, gen)
    emit({"phase": "kernel_check", "kernel": "first_layer (bf16 and f32)",
          "dims": {"flagship": [B, M, H], "H512": [B, M, 512],
                   "config5": [DEEP_B, DEEP_M, H], "ragged": list(RAGGED),
                   "odd": list(ODD), "H20": 20},
          "results": first_layer, "card": smi})
    # (shape, int8 code (None: each link's flagship data), K); timed at the
    # flagship; the rest the item split's edges: M off the split's and the
    # vector's width, K = 1, 4, 8 and 12 (wide), all-missing student rows,
    # the last split shorter, fewer students than a block
    binary = [link for link in LINK_KERNELS if link not in FAMILIES]
    odd_empty_pk = odd_pk.clone()
    odd_empty_pk[[0, 5, ODD[0] - 1]] = 0
    edge_codes = {name: torch.randint(0, 3, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
                  for name, shape in (("split_tail", SPLIT_TAIL),
                                      ("tiny", TINY))}
    for shape, pk, k in (("flagship", None, K), ("ragged", ragged_pk, K),
                         ("odd_K1", odd_pk, 1), ("odd_K4", odd_pk, 4),
                         ("odd_K8", odd_pk, 8), ("odd_K12", odd_pk, 12),
                         ("odd_empty_rows", odd_empty_pk, K),
                         ("split_tail", edge_codes["split_tail"], K),
                         ("tiny", edge_codes["tiny"], K)):
        timed = shape == "flagship"
        codes = {link: data[link]["packed"] if pk is None else pk
                 for link in binary}
        res = {}
        for link in binary:
            res[LINK_KERNELS[link]["train"]] = check_loglik(
                timer, roof, codes[link], gen, timed, link, k)
        checks[shape] = res
        emit({"phase": "kernel_check", "shape": shape,
              "dims": list(codes["2pl"].shape) + [k, H], "results": res,
              "card": smi})
    at_scale_checks = at_scale_kernel_checks(timer, roof, smi)
    ragged = ((ragged_pk == 2).float(), (ragged_pk > 0).float())
    odd = ((odd_pk == 2).float(), (odd_pk > 0).float())
    ragged_graded, odd_graded = (graded_code(shape, C, gen)
                                 for shape in (RAGGED, ODD))
    categorical = {}
    for fam in FAMILIES:
        categorical[fam] = categorical_checks(timer, roof, fam, data[fam],
                                              gen, ragged_graded, odd_graded)
        emit({"phase": "kernel_check", "kernel": f"loglik_{fam}_train",
              "dims": {"flagship": [B, M, K, C], "ragged": list(RAGGED),
                       "odd": list(ODD)},
              "results": categorical[fam], "card": smi})
    masked = {}
    for link in binary:
        masked[link] = masked_checks(timer, roof, link, data[link], gen,
                                     ragged, odd)
        emit({"phase": "kernel_check", "kernel": f"masked_loglik_{link}",
              "dims": {"minibatch": [BATCH, M, K],
                       "padded_rows": data[link]["pad_rows"],
                       "split_tail": list(MASKED_SPLIT_TAIL),
                       "ragged": list(RAGGED) + [K], "odd": list(ODD)},
              "results": masked[link], "card": smi})
    emit({"phase": "kernel_check", "kernel": "3pl extreme point",
          "results": check_extreme(timer, roof, gen), "card": smi})
    emit({"phase": "kernel_check", "kernel": "every loglik kernel at K > 8",
          "dims": {"ragged": list(RAGGED), "K": list(WIDE_K)},
          "results": wide_k_checks(timer, roof, gen, ragged_pk, ragged,
                                   ragged_graded), "card": smi})
    deep_checks = deep_kernel_checks(timer, roof, deep, gen)
    emit({"phase": "kernel_check", "kernel": "deep_link_train",
          "dims": {"config5": [DEEP_B, DEEP_M, DEEP_K, DEEP_H],
                   "table_shape": [B, M, K, DEEP_H], "odd": list(ODD),
                   **{f"H{h}": [DEEP_B, DEEP_M, DEEP_K, h]
                      for h in CLUSTER_H},
                   f"odd_H{DEEP_WIDE_H}": [*ODD, DEEP_K, DEEP_WIDE_H]},
          "results": deep_checks, "card": smi})
    deep_f32 = deep_f32_checks(timer, roof, deep, gen)
    emit({"phase": "kernel_check", "kernel": "deep_link_f32_train (row 15f)",
          "dims": {"deep_gold": [DEEP_GOLD_B, DEEP_GOLD_M, DEEP_K, DEEP_H,
                                 HMC_CHAINS],
                   "config5": [DEEP_B, DEEP_M, DEEP_K, DEEP_H],
                   "odd": list(ODD), "tiny": list(TINY),
                   "odd_H256": [*ODD, DEEP_K, 256],
                   "odd_H384": [*ODD, DEEP_K, 384],
                   f"odd_H{DEEP_WIDE_H}": [*ODD, DEEP_K, DEEP_WIDE_H],
                   "gold_H512": [300, DEEP_GOLD_M, DEEP_K, 512],
                   **{f"deep_gold_H{h}": [DEEP_GOLD_B, DEEP_GOLD_M, DEEP_K, h]
                      for h in CLUSTER_H}},
          "results": deep_f32, "card": smi})
    emit({"phase": "special_functions", "counts": roof.counts,
          "mufu_per_s": roof.mufu_per_s})

    for link in (*LINK_KERNELS, "deep"):
        emit({"phase": "objective_vs_cpu", "link": link,
              **{f"{mode}_max_rel_err": objective_matches_cpu(mode, link)
                 for mode in ("packed", "decoded", "iwae")}})

    emit({"phase": "adam_capturable_vs_plain",
          "max_rel_err": adam_capturable_matches_plain()})
    full, mini, mini_readers, fused = {}, {}, {}, {}
    for link in LINK_KERNELS:
        d = data[link]
        train = LINK_KERNELS[link]["train"]
        full[link] = full_batch_phase(
            link, flagship_config(link), d, smi, (*FIRST_LAYER, train),
            (train,), fresh=simulate_irt(link, 256, M, ability_dim=K, seed=1,
                                         missing_rate=0.1, num_categories=C))
        fused[link] = fused_phase(
            link, flagship_config(link), d, smi, (*FIRST_LAYER, train),
            FUSED_EPOCHS, FUSED_EVAL_EVERY, eager=full[link])
        fused[f"{link}_iwae"] = fused_phase(
            f"{link}_iwae", flagship_config(link), d, smi,
            (*FIRST_LAYER, train), *IWAE_FUSED[:2], "iwae", IWAE_FUSED[2],
            must_rise=False)
        mini[link], mini_readers[link] = minibatch_phase(link, d["ds"], smi)
    # JAX's CLI configuration: use_pallas at compute_dtype float32, so the
    # f32 first layer and the 2PL one-pass loglik once a step
    f32_path = (*FIRST_LAYER_F32, LINK_KERNELS["2pl"]["train"])
    full["2pl_f32"] = full_batch_phase(
        "2pl_f32", flagship_config("2pl", "float32"), data["2pl"], smi,
        f32_path, f32_path, F32_STEPS)
    fused["2pl_f32"] = fused_phase(
        "2pl_f32", flagship_config("2pl", "float32"), data["2pl"], smi,
        f32_path, FUSED_EPOCHS, FUSED_EVAL_EVERY, eager=full["2pl_f32"])
    # config 5: the one-pass deep kernel, then JAX's default (the decoded
    # code and the plain link: no loglik kernel), then minibatches (the
    # plain link, as in JAX: no kernel at all)
    deep_path = (*FIRST_LAYER, "deep_link_train")
    full["deep"] = full_batch_phase(
        "deep", deep_config(True), deep, smi, deep_path, deep_path,
        DEEP_STEPS, fresh=simulate_irt("nonlinear", 256, DEEP_M,
                                       ability_dim=DEEP_K, seed=1))
    fused["deep"] = fused_phase(
        "deep", deep_config(True), deep, smi, deep_path, FUSED_EPOCHS,
        FUSED_EVAL_EVERY, eager=full["deep"])
    fused["deep_iwae"] = fused_phase(
        "deep_iwae", deep_config(True), deep, smi, deep_path,
        *IWAE_FUSED[:2], "iwae", IWAE_FUSED[2], must_rise=False)
    deep_default = full_batch_phase(
        "deep_default", deep_config(False), deep, smi, FIRST_LAYER,
        FIRST_LAYER, DEEP_DEFAULT_STEPS, must_rise=False)
    fused["deep_default"] = fused_phase(
        "deep_default", deep_config(False), deep, smi, FIRST_LAYER,
        *DEEP_DEFAULT_FUSED, must_rise=False, eager=deep_default)
    # a width of the deep kernel's cluster of 8, a few steps
    full["deep_H384"] = full_batch_phase(
        "deep_H384", deep_config(True, CLUSTER_H[1]), deep, smi, deep_path,
        deep_path, 5, must_rise=False)
    emit({"phase": "deep_full_batch_paths", "card": smi,
          "fused_step_ms_median": full["deep"]["step_ms_median"],
          "default_step_ms_median": deep_default["step_ms_median"],
          "default_over_fused": deep_default["step_ms_median"]
          / full["deep"]["step_ms_median"]})
    # its ELBO falls over the first steps at lr 5e-3 and climbs back (the
    # full-batch trajectories; the JAX package does the same): 8 steps do
    # not get back to the first epoch's
    minibatch_phase("deep", deep["ds"], smi, deep_config(True), (),
                    must_rise=False)
    emit({"phase": "fused_paths", "card": smi, "paths": fused})
    decoded = decoded_fused(smi, data["2pl"])
    at_scale = at_scale_phase(smi)
    families = families_phase(smi, data)
    full = {k: v["launches"] for k, v in full.items()}
    hmc_runs = hmc_phases(smi)
    hmc_runs.update(nuts_phases(smi))
    mle_phase(smi)
    em_phases(smi)
    checkpoint_resume(smi, data["2pl"])
    nccl = mesh_nccl(smi, data["2pl"])
    gloo2 = mesh_gloo2(smi, {**data, "deep": deep})
    cli_runs = cli_phases(smi)
    hmc_launches = {
        name: {tag: hmc_runs[tag]["kernel_launches"] for tag in tags}
        for name, tags in (("loglik_2pl_train", ("hmc_2pl_k4", "hmc_1pl",
                                                 "hmc_nuts_k2")),
                           ("loglik_3pl_train", ("hmc_3pl",)),
                           ("loglik_grm_train", ("hmc_grm_packed",)),
                           ("loglik_gpcm_train", ("hmc_gpcm_packed",)))}

    fl = checks["flagship"]
    fl1 = first_layer["flagship"]
    int8_note = ("int8 reader: on no model path, so checked and timed in "
                 "kernel_check; launches are its count over the minibatch "
                 "fit and the IWAE steps")
    kernels = []
    for name, line in (("first_layer_fwd", 142), ("first_layer_bwd", 167)):
        for mode in ("", "_f32"):
            kernels.append(kernel_entry(
                name + mode, f"vibo_tpu/ops/pallas_encoder.py:{line}",
                "first_layer.cu",
                full["2pl_f32" if mode else "2pl"][name + mode],
                fl1[name + mode],
                launches_by_path={path: full[path][name + mode]
                                  for path in full}))
    train_lines = {"2pl": ("1244", "613"), "3pl": ("1374", "741")}
    masked_lines = {"2pl": {"fwd": (247, 445), "bwd": (319, 468)},
                    "3pl": {"fwd": (959, 959), "bwd": (985, 985)}}
    for link in binary:
        name = LINK_KERNELS[link]["train"]
        kb, bk = train_lines[link]
        kernels.append(kernel_entry(
            name, f"vibo_tpu/ops/pallas_elbo.py:{kb} (and :{bk}, the (B, K) "
            "layout)", "loglik_train.cu", full[link][name],
            fl[name]["kb"], bk_layout=fl[name]["bk"],
            occupancy=occ[f"{link} K={K}"],
            hmc_launches=hmc_launches[name],
            hmc_note=f"HMC: the (B, K) layout (:{bk}), {HMC_CHAINS} "
            "launches (one a chain) a potential evaluation, once for each "
            "of the MAP's Adam steps and for ll_ref; the sampler's CUDA "
            "graphs' launches are worked out, not counted at launch: the "
            "launches captured in a graph times its replays, plus their "
            "eager warm-up's; the probes' profiler windows hold that "
            "accounting against the device's calls of the kernel"
            + ("; hmc_nuts_k2: NUTS, the evaluations its trees took"
               if link == "2pl" else ""),
            family_launches_by_layout={
                tag: r["loglik_launches_by_layout"]
                for tag, r in families.items() if r["link"] == link},
            family_note=f"the families phase's eager steps (its counting "
            f"window and the capture's warm-up): bk the (B, K) layout "
            f"(:{bk}), kb the (K, B) one (:{kb}), {FAMILY_S} a step (the "
            "first layer's f32 kernels once a step)"))
    for fam, line in (("grm", 198), ("gpcm", 148)):
        name = LINK_KERNELS[fam]["train"]
        kernels.append(kernel_entry(
            name, f"vibo_tpu/ops/pallas_{fam}.py:{line}",
            f"loglik_{fam}.cu", full[fam][name],
            categorical[fam]["flagship"],
            occupancy=occ[f"{fam} K={K} C={C}"],
            hmc_launches=hmc_launches[name],
            library_note="no single PyTorch call gives the graded or "
            "partial-credit loglik and its gradients from the code"))
    for link in binary:
        mb = masked[link]["minibatch"]
        for direction in ("fwd", "bwd"):
            name = f"masked_loglik_{link}_{direction}"
            line, int8_line = masked_lines[link][direction]
            int8 = {k: v for k, v in mb["int8"][direction].items()
                    if k != "rel_err"}
            extra = {"occupancy":
                     occ[f"masked_{direction}_{link} K={K} dense"],
                     "occupancy_int8":
                     occ[f"masked_{direction}_{link} K={K} int8"]}
            kernels.append(kernel_entry(
                name, f"vibo_tpu/ops/pallas_elbo.py:{line} (dense reader; "
                f"int8 reader :{int8_line})", "masked_loglik.cu",
                mini[link][name], mb["dense"][direction],
                int8_reader={**int8,
                             "launches": mini_readers[link][name]["int8"],
                             "note": int8_note},
                launches_by_reader=mini_readers[link][name], **extra))
    dc = deep_checks["config5"]
    kernels.append(kernel_entry(
        "deep_link_train", "vibo_tpu/ops/pallas_deep.py:154 (_fused_deep_fwd;"
        " kernel _fused_deep_kernel :75)", "deep_link.cu",
        full["deep"]["deep_link_train"], dc,
        table_shape=deep_checks["table_shape_K4"],
        h256=deep_checks["config5_H256"],
        h384=deep_checks["config5_H384"],
        h512=deep_checks["config5_H512"],
        library_note="no single PyTorch call gives the deep link's loglik "
        "and its gradients"))
    kernels.append(kernel_entry(
        "deep_link_f32_train", "vibo_tpu/ops/pallas_deep.py:154 "
        "(_fused_deep_fwd with f32_dots=True; kernel _fused_deep_kernel :75, "
        "dot_dtype f32 :175)", "deep_link_f32.cu",
        hmc_runs["hmc_deep_f32"]["kernel_launches"],
        deep_f32["deep_gold_4_chains"], config5=deep_f32["config5"],
        **{f"h{h}": deep_f32[f"deep_gold_H{h}"] for h in CLUSTER_H},
        launches_path="hmc_deep_f32: the deep HMC potential, "
        "use_packed_kernel=True",
        launches_by_path={tag: hmc_runs[tag]["kernel_launches"]
                          for tag in ("hmc_deep_f32",
                                      f"hmc_deep_f32_H{DEEP_HMC_WIDE_H}")},
        gold_note="the decoder is trained here (Trainer.fit), not the one "
        "behind artifacts/gold/deep (other RNG streams; only its "
        "fingerprint is stored): the deep gold is not compared",
        library_note="no single PyTorch call gives the deep link's loglik "
        "and its gradients"))
    for entry in kernels:
        # the at-scale pipeline's kernels: their check at its shape, the
        # wrappers' launches over its run and the device calls a step of
        # its replayed chunk
        if entry["name"] in AT_SCALE_PATH:
            check = (at_scale_checks["first_layer"].get(entry["name"])
                     or at_scale_checks[entry["name"]])
            driven = at_scale["checks"]
            entry["at_scale"] = {
                "dims": [*AT_SCALE_SHAPE, 1, H], "check": check,
                "driven_dims": driven["dims"],
                "driven_check": (driven["first_layer"].get(entry["name"])
                                 or driven[entry["name"]]),
                "launches": at_scale["launches"][entry["name"]],
                "device_calls_per_step":
                    at_scale["device_calls_per_step"][entry["name"]],
                "expected_calls_per_step": AT_SCALE_CALLS[entry["name"]],
                "samples_per_step": AT_SCALE_RUN["num_samples"]}
        # the CLI phases: launches in process (score, compare, deep) and
        # the device calls in cfg 1's own trace (a separate process)
        entry["cli_launches"] = {
            tag: run["launches"].get(entry["name"], 0)
            for tag, run in cli_runs.items() if "launches" in run}
        entry["cli_cfg1_trace_calls"] = cli_runs["cli_cfg1"][
            "trace_kernel_calls"].get(entry["name"], 0)
        # the mesh and decoded paths: device calls a step of the
        # NCCL mesh's fit, each gloo run's wrapper launches a step on its
        # rank 0, the decoded full batch's eager wrapper launches
        entry["mesh_launches_per_step"] = {
            "mesh_nccl_2pl_1x1": nccl["device_calls_in_fit"].get(
                entry["name"], 0) / MESH_NCCL_FIT[0],
            **{f"mesh_gloo2_{tag}": runs[0]["launches_per_step"].get(
                entry["name"], 0)
               for tag, runs in gloo2["runs"].items()}}
        entry["decoded_launches_per_step"] = decoded[
            "launches_per_step"].get(entry["name"], {}).get("wrapper", 0)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
