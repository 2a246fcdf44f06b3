#!/usr/bin/env python3
"""Drive pathtracker_torch's serving, training, eval, training-loop,
resident-window, attribution, export and RBP paths, the recurrent zoo, the
video ResNets, SlowFast, the transformer baselines and the canonical
warm-start chain on one CUDA card (an H100) and hold every CUDA kernel on
those paths against its plain PyTorch version.

    python3 chip_smoke.py

Phases, printed in order; any failure exits non-zero before the last line:
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from pathtracker_torch/csrc (one nvcc per source, all
     started together); print the build seconds and each kernel's registers,
     shared memory and spill bytes (ptxas -v);
  3. K1, K2 and K3 forward at the main paths' width (batch 128 x 32 x 32 =
     131,072 rows of 32 channels) on seeded inputs: each kernel, through its
     wrapper, against its plain version on the card, with the max error and
     the stated tolerance; the device time of kernel and plain version (CUDA
     graph of 20 calls, replayed, timed by CUDA events) and the wrapper's
     time per call from Python; the bound (the larger of bytes over the
     memory rate and operations over the peak rate), from these inputs;
  4. load the in-tree chainE checkpoint with the port's reader and serve 3
     requests of 128 uint8 clips (T=64), rendered from seeds as chainE was
     trained (dist 14, speed 1, 2-pixel dots), through make_inference_fn
     with InT(32, k=7, bf16, fused): finite scores in [0, 1], each forward
     kernel's launch count up by exactly T per request, agreement with the
     same weights on the eager mixed cell (fused=False) within stated
     tolerances, accuracy against the clips' labels well above chance;
     both mixed paths' distance to the f32 parity path; p50 request
     latency and clips/s of both mixed paths;
  5. K1, K2 and K3 backward at the same width on seeded inputs and
     cotangents, K1 with and without a cotangent for the attention map:
     the same comparisons, times and bounds as phase 3, and bit-identical
     outputs on two launches; each backward launch finishes its sums over
     the rows with a second kernel, so the device time of each CUDA kernel
     of a call is printed by name (torch.profiler), and the main kernel
     alone is told from the wrapper-level time;
  6. gradients of sum(logit^2) for every parameter, fused cell against eager
     mixed cell, normalised by each gradient's largest entry: held at batch
     128, T=8 from the seeded init; printed at T=64 with the chainE weights;
     then stage A's plateau (the JAX chainA's epoch 38): two Adam steps of
     stage A's flags at batch 128 through each cell, the fused cell's move
     of the weights held to the eager cell's in length and cosine;
  7. train chainE for 10 steps at batch 128, T=64, mixed bf16, fused,
     Adam(3e-4), through make_train_step on one batch of the rendered clips:
     finite stats, per step 2T launches of each forward kernel and T of each
     backward kernel, the first loss against the eager path's from the same
     weights, the last loss below the first, the unused parameter unchanged;
     then, over the three batches in turn, p50 step latency, clips/s and peak
     memory of the fused and the eager (recomputing) path, the number of
     CUDA kernels one fused step launches (torch.profiler), and one batch-180
     step;
  8. the three correlation kernels (csrc/correlation.cu) at the rntsm serving
     path's size (N = 8 clips x 63 frame pairs = 504 images of 32x32x64,
     patch 15) on seeded L2-normalised features and an N(0,1) cotangent:
     each through its wrapper against its plain version with the max error
     and the stated tolerance, each kernel bit-identical on two launches,
     one dilated and one odd-sized case at small N, and the same times and
     bounds as phase 3; then the same checks and times at the train step's
     size (N = 4 x 63 = 252); each kernel's registers and spills (ptxas -v)
     beside its times;
  9. serve rntsm (TSM-ResNet50 + MotionSqueeze at the registry's width, f32,
     seeded init: the repository has no rntsm checkpoint) through
     serve.build and make_inference_fn: 3 requests of 8 rendered uint8 clips
     (T=64): finite scores in [0, 1], one forward-kernel launch per request,
     logits against the same weights through the plain correlation
     (fused=False), the count of pixels whose argmax over the volume differs
     between kernel and plain version, p50 request latency, clips/s, peak
     memory;
 10. train rntsm through make_train_step with remat=True, Adam(3e-4): parameter
     gradients through the kernels against the plain correlation at T=8, then
     3 steps of batch 4, T=64 on one batch: finite stats, one launch of each
     of the three kernels per step, the last loss below the first, step
     latency, clips/s, peak memory;
 11. the held-out eval path (python -m pathtracker_torch.eval.test_model):
     write a 512-clip test split (T=64, dist 14, speed 1, 2-pixel dots,
     seed 8, empty train shards) with make_synthetic_dataset, decode it with
     the port's reader (the native C++ one where it builds, else Python;
     the codec and its MB/s are printed), byte-equal to the same clips
     rendered in memory; evaluate chainE (InT, dims 32, k 7, --bf16, batch
     128, prep_gifs=0) with evaluate_model: the test_perf npz holds arr_0
     and arr_1, the loss is finite, accuracy at least 0.6, each forward
     kernel launched T times a batch; the eval step's logits bit-equal to
     make_inference_fn(probs=False) on seeded loader batches; eval clips/s
     end to end beside serving's, and the share of the loop spent waiting
     on the loader;
 12. the training loop (python -m pathtracker_torch.train) with train_InT.sh's
     flags (batch 180, T=64, dims 32, kernel 7) on a rendered root of 360 +
     360 clips, each run capped at 2 steps an epoch: (a) loop.main with
     --bf16 --epochs 1 --auto-resume, warm-started from chainE: finite
     losses, the JAX package's artifact set, each forward kernel launched
     2T per step plus T per val batch and each backward kernel T per step,
     the rolling checkpoint read back bit-equal to the returned weights and
     its Adam count; the loop's step times (batch_time and data_time) beside
     phase 7's bare step, validation seconds, the rolling checkpoint's write
     time and size, peak memory, the val balanced accuracy; (b) the same
     with --epochs 2: "optimizer state restored", epoch 1, cumulative logs,
     the count continued; (c) the CLI as a subprocess, sent SIGTERM after
     its first logged step: exit 0, the terminated line, the rolling
     checkpoint; (d) train_InT.sh as written (f32, the eager cell, seeded
     init): no kernel launch, finite losses, step time and peak memory;
 13. the resident path (--device-data, --fused-steps K): (a) render 1,440 +
     360 clips (dist 14, speed 1, T=64, 2-pixel dots) with
     make_synthetic_dataset in parallel processes and upload them with
     load_resident (seconds, bytes); (b) chainE's InT (bf16, fused) at batch
     180 through make_resident_train_step: a graph of one step and a
     window of 4 captured under cuDNN's default algorithms against eager
     steps, held at ten times the gap between two eager runs (the step's
     loss and moments, the window's losses; its moments printed); then, under
     cudnn.deterministic, the first window (warm-up, capture, replay; each
     K1-K3 wrapper launched twice a window's count) and a second replay,
     each against 4 eager steps of make_train_step from the same weights on
     the batches the window gathers (bit-identity printed, held as stated),
     and --accum-steps 2 over two windows of 3, the second at phase 1; (c)
     one replay under torch.profiler: K x 2T launches of each K1-K3 forward
     kernel and K x T of each backward one; (d) python -m
     pathtracker_torch.train with train_InT.sh's flags, --epochs 2 --bf16
     --device-data --fused-steps 4: exit 0, 16 finite losses, 2 val
     entries, the rolling checkpoint's Adam count 16; (e) warm-step medians
     over at least 15 steps, clips/s, the device's idle share (profiled busy
     time against the unprofiled median) and peak memory of the streaming
     loop (steps inside an epoch; each epoch's first apart) and of resident
     K = 1, 4, 8 over 15-step epochs that leave train_InT.sh's tails, with
     each graph's capture seconds; (f) train_InT.sh as written (f32, the
     eager cell) at batch 180, T=64 under the remat policies 'full', 'conv'
     and 'conv_gates': gradients against each other, step medians over 5
     warm steps, peak memory; (g) rntsm (batch 4, T=8, f32, remat) through
     a window of 2 against eager steps, counts from 0: the three correlation
     wrappers held against their plain versions at the shapes the window
     gave them, and each one's launches in a replay; (h) data-parallel
     training on (a)'s clips: (h1) two ranks on the one card, each a process
     of this script (gloo with CUDA tensors: NCCL takes one card a rank),
     each taking 90 of train_InT.sh's 180 clips a step with chainE's
     weights through make_train_step under the data group, counts from 0,
     bf16 (fused, the main path) and f32 (the eager cell), 2 steps under
     cudnn.deterministic, held by PARALLEL_PATHS' tolerances: bf16 against
     one process computing the global batch as the ranks do (_as_ranks),
     f32 against one process on it; the bf16 ranks' loss gaps to one
     process beside those of one process on the reversed rows and with
     each piece of PARALLEL_PIECES computed as the ranks compute it; the
     ranks bit-equal to each other, each rank's K1-K3 launches 2T a step
     forward and T backward in bf16, none in f32; each rank's bf16 step ms
     beside one process's; (h2) NCCL, a world of one
     (COORDINATOR_ADDRESS, NUM_PROCESSES=1): loop.main with train_InT.sh's
     flags, --epochs 2 --bf16 --device-data --fused-steps 4 --profile, against
     the same run without a group, under cudnn.deterministic: losses and
     validation bit-equal, the window's all-reduces in its graph (counted
     at capture; the group run's profiled replay holds a device copy more
     than the run alone for each, but the gradient buckets'), the K1-K3
     launches, the replayed steps' ms beside phase 13's; the phase's
     seconds; (i) model-parallel training, each rank a process of this
     script (``--model-parallel-rank``, gloo on the card): (i1) rntsm at the
     registry's width under FSDP over 2 ranks, global batch 4, T=64, f32, 2
     SGD steps under cudnn.deterministic against one process computing the
     batch as the ranks do (_as_data_ranks), by MP_RNTSM_TOL, one process
     on the batch printed; every layer-4 kernel split in halves over
     'data'; each rank's correlation launches; (i2) chainE's InT (dims 32,
     kernel 7, T=64, --bf16) under dp x tp and dp x sp as 1 x 2, one step
     of 32 clips, against one process computing the batch as the ranks do
     (_as_model_ranks, _as_space_ranks) by PARALLEL_PATHS["bf16"], one
     process printed,
     all six K1-K3 kernels 2T/T times on every rank; (i3) python -m
     pathtracker_torch.parallel.dryrun --ranks 4 on the card; (i4) FSDP, TP
     and SP meshes of one rank over NCCL, each step bit-equal to no group;
     each gap beside its tolerance and the phase's seconds;
 14. attribution (python -m pathtracker_torch.eval.viz, viz_InT.sh's command:
     gen_1_25_64, dist 25, T=64, batch 40, chainE): the K1-K3 wrappers
     against their plain versions at its 40,960 rows; a rendered 120-clip
     split; the greedy-proxy responses bit-equal over two passes; viz.main
     in-process with --bf16 (each forward kernel 2T launches a batch, the
     forward and its recompute, each backward kernel T; K1's without the
     attention map's cotangent) and as written (f32, the eager cell, no
     launch): the npz's keys and shapes, finite gradients, clips/s, peak
     memory; fused against f32 and against the eager cell under --bf16 on
     one batch, held at T=8, printed at T=64 with each clip's residual sign;
 15. the serving export: chainE fused at T=EXPORT_T (8, the length of
     the chain's stage A; depth cut from 64) through torch.export with a
     symbolic batch, its .pt2 written and loaded, run at batch 128 and 40:
     bit-equal to make_inference_fn, T launches of each forward kernel
     inside the program's call; export seconds, graph nodes, bytes, p50 at
     batch 128 beside the live model's and phase 4's; --platforms: that
     program (saved for cpu,cuda, the default) loaded with device="cpu" and
     run on EXPORT_CPU_BATCH of the clips there without a launch, its
     scores held to the card's by phase 4's fused-vs-eager rule; the same
     program saved for cuda alone refused on the CPU; chainE at
     T=EXPORT_CPU_T exported on the CPU, served on the card (T launches of
     each K1-K3 forward kernel), held to the live model there by that rule;
 16. InT under --algo rbp (batch 180, T=64, --bf16, chainE): 3 steps on the
     eager cell, no K1-K3 launch, the Neumann terms of each step, step
     times and peak memory beside phase 12's BPTT step; hgru, hgru_v2,
     clock_hgru and gru at the registry's width (T=64, batch 32) with and
     without --bf16: 2 steps on one batch (a falling loss; gru at the
     smaller rate of ZOO_RATES) and one request;
     ConvLSTM through its direct contract with the Jacobian penalty (BPTT)
     and with RBP;
 17. the rest of the recurrent zoo (stlstm, fflstm, lrcn, lrcn_last, ffnet)
     and the video ResNets (r3d, mc3, r2plus1, nostride_r3d,
     nostride_r3d_pos, nostride_r3d_cc, nostride_video_cc_small) at the
     registry's width: for each, the card's f32 logits against the CPU's
     from the same weights (batch 2, T=8); 2 Adam steps on one batch of 32
     rendered clips (T=64; fflstm and ffnet at T=8, RZOO_LENGTH) through
     make_train_step (ffnet at the smaller rate of ZOO_RATES), a falling
     loss, and 2 requests (fflstm: 1) through
     make_inference_fn, scores in [0, 1]; --bf16 for r3d and nostride_r3d
     with its logits against f32; step median, request p50, clips/s, peak
     memory and the batch used (halved while it does not fit), beside the
     card's name and power limit; python -m pathtracker_torch.train with
     --model r3d and lrcn for one capped epoch and the eval CLI on the
     rolling checkpoint; no csrc kernel launched; the phase's seconds;
 18. SlowFast (slowfast, slowfast_nl, slow: R50 [3,4,6,3] at width 64 and
     their yaml's alpha, beta and fusion kernel) and the transformer
     baselines (timesformer, performer with chunked causal FAVOR+, lambda)
     at the registry's width and depth: for each, the card's f32 logits
     against the CPU's from the same weights (batch 2, T=8); 2 Adam steps
     on one batch of 32 rendered clips (T=64) through make_train_step, with
     SlowFast's dropout live through the step's generator (shown by a
     forward with the generator against one without), a falling loss, and
     2 requests through make_inference_fn, scores in [0, 1]; step median,
     request p50, clips/s, peak memory and the batch used (halved while it
     does not fit), beside the card's name and power limit; python -m
     pathtracker_torch.train with --model slowfast and performer for one
     capped epoch and the eval CLI on the rolling checkpoint; no csrc
     kernel launched; the phase's seconds;
 19. the canonical warm-start chain (scripts/torch_reproduce_canonical.py)
     at full width, depth cut by CHAIN_DEPTH: its stages' roots and the
     matrix's other configs rendered in parallel processes behind phases
     17 and 18; the driver's command (stages A, B, C at T=8, 32, 64 on
     1,536 + 128 clips, batch
     128, --bf16 --device-data --fused-steps 12, each a train CLI process
     on the card reporting its kernel launches through
     PATHTRACKER_LAUNCHES): the JAX package's artifacts in each run folder,
     each hp_dict.npz naming the previous stage's best checkpoint, each
     stage's K1-K3 launches exact (a warm-up and a capture of its 12-step
     window, validation's forward), its stage seconds, then the report's
     held-out results; the chain again in this process, without the
     report: A and B skipped untouched, C resumed without --ckpt and
     nothing left to train; stage A again on the eager mixed cell
     (CELL=eager --until A, a process of the chain script through loop.main):
     no K1-K3 launch, a finite loss every epoch;
     scripts/torch_eval_matrix.py over C's best checkpoint in this process
     (8 configs, T=64 first, CHAIN_MATRIX_CLIPS test clips each, the
     forward kernels' launches exact); the phase's seconds;
 20. one JSON line naming every kernel with its numbers (launches summed over
     the main paths, with each path's count beside), after a line that
     counts the processes this script started that still ran (stopped and
     reaped there; the script is its descendants' subreaper, so orphaned
     grandchildren are found too; at exit, on a failure or on SIGTERM, the
     same is done).
After each phase a line "time: ..." gives its seconds and the seconds
since the script began. The last line is {"ok": true, "device": {...}}. It needs a CUDA card and
the repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import contextlib
import glob
import json
import os
import re
import shlex
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

STARTED = time.perf_counter()

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "build")
CHECKPOINT = os.path.join(ROOT, "results_conv", "64_1_14", "chainE", "saved_models",
                          "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
BATCH, TIMESTEPS, SIDE, C = 128, 64, 32, 32
ROWS = BATCH * SIDE * SIDE
REQUESTS = 3
TIMED_REQUESTS = 6  # per path, interleaved, after the counted run
TRAIN_STEPS = 10  # counted steps of the fused path
TIMED_STEPS = 5  # per path, interleaved, after the counted steps
GRAD_TIMESTEPS = 8  # depth of the held fused-vs-eager gradient comparison
REFERENCE_BATCH = 180  # train_InT.sh's batch
REFERENCE_STEPS = 5  # timed bare steps at that batch, here and on each side of the loop's window
LEARNING_RATE = 3e-4
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
MEMORY_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# Kernel vs its plain version on the card. f32 outputs: CUDA's expf/log1pf
# and FMA contraction differ from PyTorch's elementwise kernels by ulps
# through at most three transcendental layers. bf16 outputs: f32 values that
# differ by ulps may round to neighbouring bf16 values.
ATOL_F32 = 1e-5
BF16_ULPS = 1
# Fused vs eager mixed cell, per served score over all 384 clips. The fused
# gate products keep f32 outputs where the eager cell rounds them to bf16
# (as in the JAX package), and the trained 64-step recurrence carries such
# differences on; a few clips sit where it amplifies them, so the maximum
# is printed but the mean and the 99th percentile are held.
MEAN_SCORE_ATOL = 0.01
P99_SCORE_ATOL = 0.1
# Backward kernels vs their plain versions (cotangents are O(1)). Each
# transposed product takes its cotangent rounded to bf16, so where kernel and
# plain version differ by f32 ulps before that rounding, one operand moves by
# a bf16 ulp (2^-8 relative) and the row output by that times a gate weight:
# every element is held to 2^-8 of the output's largest entry, and all but
# one in a thousand to the f32 (or one-bf16-ulp) tolerance above.
FLIP_RTOL = 2.0 ** -8
FLIP_SHARE = 1e-3
# Reductions over the 131,072 rows (weight gradients, per-channel sums): f32
# sums taken in another order, relative to the largest entry; the bf16 weight
# gradients also round once more.
REDUCTION_RTOL = 1e-3
# Fused vs eager gradients, each normalised by its largest entry. The two
# paths round their bf16 cotangents at different points; a bf16 ulp is 2^-8 =
# 3.9e-3 of the value. At tests/test_int_fused.py's size (4 clips of 16x16,
# T=5) the gap stays under that file's 6e-3; at batch 128 of 32x32, T=8 it
# measures 8.6e-3, while the eager mixed cell itself sits 5.4e-3 from the f32
# path (both printed below): held to 2e-2.
GRAD_ATOL = 2e-2
# Stage A's chance plateau: the JAX package's chainA at epoch 38, its last
# checkpoint before the escape. Two Adam steps of stage A's flags (T=8, dist
# 1, lr 2e-3) at the chain's batch, through the fused and the eager cell
# from the same weights: the fused cell's move of the weights, as one
# vector, within PLATEAU_RTOL of the eager cell's in length
# (tests/test_torch_chain_steps.py's bound, there against the JAX
# package's default cell, two clips a step), at cosine at least
# PLATEAU_COS_MIN. Here the batch norm's direct input cotangent and its
# statistics' part nearly cancel. A first Adam step is about lr * sign(g),
# so the two cells' other roundings (the fused gate products stay f32)
# flip near-zero entries: on an H100 80GB HBM3 at 700 W the fused cell
# measured 1.00476 / 0.98297 (ratio / cosine) at 128 clips a step, 0.99994
# / 0.98720 at 32 and 1.00241 / 0.99952 at 2, and the same cell with the two
# cotangent parts rounded to bf16 apart 0.97716 / 0.89339, 1.07928 /
# 0.79878 and 1.03892 / 0.93462 (scripts/torch_bwd_compare.py --phases
# plateau).
PLATEAU_CKPT = os.path.join(ROOT, "results_conv", "8_1_1", "chainA", "saved_models",
                            "model_val_acc_0056_epoch_38_checkpoint.pth.tar")
PLATEAU_T, PLATEAU_DIST, PLATEAU_LR = 8, 1, 2e-3
PLATEAU_BATCH, PLATEAU_STEPS = 128, 2
PLATEAU_RTOL, PLATEAU_COS_MIN = 0.02, 0.95
# First training loss, fused vs eager from the same weights: a mean over 128
# clips of BCE terms whose scores differ by 0.002 on average (phase 4).
LOSS_ATOL = 0.01
# chainE's held-out accuracy is 69.08% at dist 14 (ROADMAP.md); chance is
# 50%, and over 384 clips one standard deviation is 2.4 points.
MIN_ACCURACY = 0.6
# The backward wrappers whose main kernel is also timed alone (phase 5), and
# the calls profiled for that.
ALONE = {"k1_attention_bwd": "k1_bwd_kernel", "k2_inhibition_bwd": "k2_bwd_kernel",
         "k3_excitation_bwd": "k3_bwd_kernel"}
ALONE_CALLS = 10
# The __global__ functions of csrc/int_cell.cu and csrc/int_cell_bwd.cu.
INT_CELL_KERNELS = ("k1_kernel", "k2_kernel", "k3_kernel", "k1_bwd_kernel",
                    "k2_bwd_kernel", "k3_bwd_kernel", "finish_kernel")
# The arguments of K1, K2 and K3 (forward, and backward before the cotangents).
K1_ARGS = ("exc", "att_x", "a_u", "a_u_b")
K2_ARGS = ("conv_i", "mean0", "rstd0", "scale0", "bias0", "inp", "gi_x", "inh",
           "i_u", "i_u_b", "alpha", "mu")
K3_ARGS = ("conv_e", "mean1", "rstd1", "scale1", "bias1", "new_inh", "inh", "gated",
           "exc", "e_w", "e_w_b", "e_u", "e_u_b", "kappa", "gamma")
# Noise clips (bench.py's uniform uint8) are off the training distribution:
# there the trained recurrence is chaotic and f32 rounding differences grow
# to O(1) by T=64, so the clips are rendered.
DOT_SIZE, DISTRACTORS = 2, 14

# rntsm (TSM-ResNet50 + MotionSqueeze), f32 as in the JAX package.
TSM_BATCH = 8  # clips per served request: 8 x 63 frame pairs = 504 images
TSM_TRAIN_BATCH, TSM_TRAIN_STEPS = 4, 3
TSM_TIMED_REQUESTS = 3  # per path, interleaved, after the counted run
PATCH, CORR_C = 15, 64
CORR_N = TSM_BATCH * (TIMESTEPS - 1)
CORR_TRAIN_N = TSM_TRAIN_BATCH * (TIMESTEPS - 1)
# Correlation kernels vs their plain versions. Forward: an f32 sum of 64
# products of L2-normalised features (|sum| <= 1) taken in another order.
# Backward: an f32 sum of 225 terms g*f, g ~ N(0,1) and |f| <= 1, entries of
# magnitude up to ~8, in another order.
CORR_ATOL_FWD = 1e-5
CORR_ATOL_BWD = 5e-5
# rntsm logits, kernels vs plain correlation on the same weights and clips.
# The two volumes differ by f32 rounding; where a pixel's two largest entries
# are that close the argmax flips and its soft-argmax window moves by whole
# displacements (the count is printed), which the flow refinement, the BNs
# and the average over 64 x 1024 positions per clip carry to the logit.
TSM_LOGIT_ATOL = 1e-3
# rntsm gradients, kernels vs plain correlation, each normalised by its
# largest entry: besides the argmax flips, a ReLU input within rounding of
# zero takes another mask in the two runs, which moves one channel's gradient
# by percents and everything upstream by ~1e-3 (tests/test_torch_tsm_resnet.py);
# at batch 4, T=8 the largest gap measured 1.6e-2 and the largest mean gap
# 1.1e-2. A wiring error moves the gradients by O(1).
TSM_GRAD_MAX, TSM_GRAD_MEAN = 0.2, 5e-2
TSM_GRAD_TIMESTEPS = 8

# The held-out eval path: a rendered test split of 4 batches (the shards'
# seed is not the serving clips'), evaluated as test_model.py does.
EVAL_CLIPS, EVAL_SEED = 4 * BATCH, 8

# The training loop: train_InT.sh's flags on a root of two reference batches
# a split (rendered at ~17.6 ms a clip on the card's host), LOOP_STEPS steps
# an epoch; the window of timed steps is one run of WINDOW_EPOCHS such epochs
# that logs every step.
LOOP_CLIPS, LOOP_STEPS, WINDOW_EPOCHS = 2 * REFERENCE_BATCH, 2, 6
# A step's log line: epoch, index, batch_time and data_time (s).
STEP_LINE = re.compile(r"^Epoch: \[(\d+)\]\[(\d+)/\d+\].*?Time: ([\d.]+) .*?Data: ([\d.]+)",
                       re.M)
ROLLING_NAME = "model_last_epoch_checkpoint.pth.tar"

# The resident phase: train_InT.sh's shape (batch 180, T=64) on a root of 8
# batches to train on and 2 to validate, rendered in parallel, held on the
# card (~354 MB of uint8). Windows of RESIDENT_K steps against eager steps.
# Each mode of RESIDENT_KS is timed over epochs of RESIDENT_EPOCH steps (the
# 1,440 clips and 1,260 of them again), so that K=4 and K=8 end an epoch with
# train_InT.sh's tails: its 20,000 clips make 111 steps of 180, 3 past a
# multiple of 4 and 7 past one of 8. One epoch warms a mode up (the capture
# of its window and of its tail), then at least RESIDENT_TIMED steps are
# timed.
RESIDENT_TRAIN, RESIDENT_VAL = 8 * REFERENCE_BATCH, 2 * REFERENCE_BATCH
RESIDENT_K, RESIDENT_KS, RESIDENT_TIMED, RESIDENT_EPOCH = 4, (1, 4, 8), 15, 15
RENDER_WORKERS = 8
# Graph windows vs eager steps from the same weights, optimizer state and
# batches: bit-identical unless cuDNN's weight-gradient algorithm is
# nondeterministic; then Adam's sign-like update can move an entry whose
# gradient sits at rounding distance from zero by up to 2*lr a step, so every
# entry is held within 2*lr*steps and all but WINDOW_SHARE of them within
# lr/100, the moments all but that share within 1e-3 of their largest entry,
# and the losses within WINDOW_LOSS_ATOL. A rate baked into the graph at
# capture moves nearly every entry by a tenth of lr or more.
WINDOW_SHARE, WINDOW_LOSS_ATOL = 0.01, 1e-4
# These comparisons run under torch.backends.cudnn.deterministic: with
# cuDNN's default choice two eager runs of the same steps from chainE's
# weights already differ (a weight-gradient algorithm sums in a varying
# order, and the 64-step recurrence carries a rounding difference to O(1)
# gradient differences within a few steps). The timed graphs and the CLI's
# are captured under the default choice; graphs of those are held against
# eager steps from equal weights, each gap at SPREAD_FACTOR times the gap
# between two eager runs of the same steps, or of SPREAD_FLOORS (loss,
# relative moment gap) where larger. A graph of one step: its loss and its
# Adam moments, which are then (1 - beta) g and (1 - beta2) g^2 of one
# gradient from equal weights, where a reordered sum moves the relative gap
# by rounding alone. A window of RESIDENT_K steps: its losses (two eager runs
# on an H100 measured a loss gap of 1.19e-3 by the fourth step), its first
# loss within WINDOW_LOSS_ATOL, every weight within 2*lr*steps; its moment
# gap is printed beside the eager runs' and not held: after the first update
# each reordered sum has moved the weights, and two eager runs on an NVIDIA
# H100 80GB HBM3 at 700 W have parted by a relative moment gap of 5.19 in
# one call and 0.00633 in another. That catches a graph that computes
# something else (a NaN, an algorithm that misbehaves under capture), not a
# rounding-level difference.
SPREAD_FACTOR, SPREAD_FLOORS = 10, (1e-3, 1e-2)
# The remat policies on train_InT.sh as written (f32, the eager cell):
# gradients held at the JAX package's bound between policies
# (tests/test_int_parity.py:189-217), bit-identity printed (under
# cudnn.deterministic, as the window comparisons).
REMAT_STEPS, REMAT_ATOL, REMAT_RTOL = 3, 1e-5, 1e-4
# rntsm through a resident window, at a depth that keeps the phase short.
TSM_RESIDENT_CLIPS, TSM_RESIDENT_T, TSM_RESIDENT_K = 8, 8, 2

# Phase 14, the attribution viz: viz_InT.sh's set (gen_1_25_64: dist 25,
# speed 1, T=64) and batch, over VIZ_BATCHES batches of a rendered split.
VIZ_SET, VIZ_DIST, VIZ_BATCH, VIZ_BATCHES, VIZ_SEED = "gen_1_25_64", 25, 40, 3, 9
# Fused (--bf16) input gradients of chainE against f32 and against the eager
# cell under --bf16 (the same precision in plain PyTorch) on the same clips,
# per clip by cosine. Over 64 steps the backward carries rounding to O(1)
# map differences in the plain paths alike: on an NVIDIA H100 80GB HBM3 at
# 700 W the maps' mean cosine at T=64 measured 0.34 fused vs f32, 0.39
# eager bf16 vs f32 and 0.70 fused vs eager bf16, each pair with a clip near
# -1, and no clip's residual (logit - human logit) changed sign. So T=64 is
# printed and the comparisons are held on the clips' first VIZ_GATE_T
# frames, as phase 6 holds the parameter gradients at T=8: there a relative
# L2 gap of the ~1e-2 phase 6 measures is a cosine of ~0.9999, and a wiring
# error (a K1-K3 gradient term missing, a cotangent misrouted) moves it by
# O(1). A clip whose map is small carries more of the rounding, so its own
# floor is lower.
VIZ_GATE_T, VIZ_MIN_MEAN_COSINE, VIZ_MIN_COSINE = 8, 0.99, 0.9
# Phase 16: InT under --algo rbp at train_InT.sh's batch; the recurrent zoo
# at the registry's width (dims 32; gru twice that) and ConvLSTM (its
# reference depth, T=8, through its direct contract).
RBP_STEPS = 3
ZOO_MODELS = ("hgru", "hgru_v2", "clock_hgru", "gru")
ZOO_BATCH, ZOO_STEPS, CONVLSTM_T = 32, 2, 8
# Each zoo model trains at train_InT.sh's rate, and its loss on the repeated
# batch must fall, except the ConvGRU: Adam's first steps move each of its
# 1.2 M conv weights (three 7x7 convs of 128 -> 64 channels) by about the
# rate, all at once, and at 3e-4 its loss jumped (0.699 -> 1.033 -> 0.709 on
# an NVIDIA H100 80GB HBM3 at 700 W). The JAX package's GRU does the same
# from the port's init: tests/torch_gru_rate_witness.py --init port
# --clip-seed 31 (T=16, batch 8, CPU) gives 0.662148 -> 1.122506 -> 0.685124
# in JAX and 0.662148 -> 1.122510 -> 0.685123 in the port at 3e-4, and a
# falling loss in both at 3e-6 (from JAX's init both fall at 3e-4: the jump
# belongs to the init and the batch, not to either package). ffnet (phase
# 17) likewise: its last Linear reads 2*T*32*32 features, and at 3e-4 its
# loss rose on the card (0.770 -> 2.078 -> 4.175, batch 32, T=64) and rises
# in both packages from the port's init (--model ffnet --init port --length
# 8 --batch 4 --clip-seed 33: 0.754525 -> 0.985580 -> 2.193712 in JAX,
# 0.754526 -> 0.985621 -> 2.191448 in the port), and falls in both at 3e-6
# (0.754525 -> 0.152693 -> 0.040884 and 0.754526 -> 0.152712 -> 0.040886);
# from JAX's init both fall at 3e-4 (0.745114 -> 0.594537 -> 0.244087 and
# 0.745114 -> 0.594875 -> 0.216529).
ZOO_RATES = {"gru": 3e-6, "ffnet": 3e-6}
# Phase 17: the rest of the recurrent zoo and the video ResNets at the
# registry's width on phase 16's rendered clips (T=64, batch 32; a name
# that does not fit halves its batch), f32, and --bf16 for RZOO_BF16.
RZOO_MODELS = ("stlstm", "fflstm", "lrcn", "lrcn_last", "ffnet", "r3d", "mc3", "r2plus1",
               "nostride_r3d", "nostride_r3d_pos", "nostride_r3d_cc",
               "nostride_video_cc_small")
RZOO_BF16 = ("r3d", "nostride_r3d")
# Two steps show the loss falling; two requests give a median. Phases 17
# and 18 keep within the script's time with these depths.
RZOO_STEPS, RZOO_REQUESTS = 2, 2
# fflstm's time grows with T squared and ffnet's with T (4.5 s and 6.4 s a
# step at T=32 on the H100, PERF.md); both train and serve at T=8, the
# length of the chain's stage A, so that the phase keeps its time.
RZOO_LENGTH = {"fflstm": 8, "ffnet": 8}
# fflstm re-feeds its T*H*W-token sequence T times through a 2-layer
# bidirectional LSTM: ~8.4 M sequential cell steps a T=64 forward, so
# cuDNN's step latency sets its time (~6.6 s a request, ~18 s a step on the
# H100: PERF.md); it takes one request.
RZOO_FFLSTM_REQUESTS = 1
# The card's f32 logits against the port's own CPU logits from the same
# weights (cuDNN's conv3d and LSTM against the CPU's), batch 2, T=8: f32
# sums in another order, held at the f32 parity bound of
# tests/test_int_parity.py:93.
RZOO_PARITY_BATCH, RZOO_PARITY_T, RZOO_PARITY_ATOL, RZOO_PARITY_RTOL = 2, 8, 1e-3, 5e-3
# bf16 logits against f32 from the same init on the card: every conv, BN and
# residual output rounded to bf16 (2^-8 relative) through ~20 layers; on the
# CPU at one block a stage the gap measured 8.0e-3 on logits of 0.09-0.28
# (tests/test_torch_video_resnet.py).
RZOO_BF16_ATOL = 2e-2
# The CLI: one capped epoch of RZOO_CLI_STEPS steps on a rendered root of
# two batches a split, then the eval CLI on the rolling checkpoint.
RZOO_CLI, RZOO_CLI_STEPS = ("r3d", "lrcn"), 2
# Phase 18: SlowFast and the transformer baselines at the registry's width
# and depth on rendered clips (T=64, batch 32, halved while it does not
# fit), f32, with phase 17's parity, steps, requests and CLI steps.
SFZOO_MODELS = ("slowfast", "slowfast_nl", "slow", "timesformer", "performer", "lambda")
SFZOO_DROPOUT = ("slowfast", "slowfast_nl", "slow")
SFZOO_CLI = ("slowfast", "performer")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


PR_SET_CHILD_SUBREAPER = 36
STOP_GRACE_S = 5.0  # from SIGTERM to SIGKILL for a process left running


def adopt_orphans() -> None:
    """Make this process the subreaper of its descendants (prctl), so a
    process whose parent ended before it is re-parented here and
    ``stop_children`` still finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed: "
              f"{os.strerror(ctypes.get_errno())}", file=sys.stderr)


def _descendants() -> dict[int, str]:
    """The live (not zombie) processes under this one, from /proc: pid to
    command line."""
    parent, state = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        state[int(entry)], parent[int(entry)] = fields[0], int(fields[1])
    found, todo = [], [os.getpid()]
    while todo:
        pid = todo.pop()
        kids = [p for p, pp in parent.items() if pp == pid]
        found += kids
        todo += kids
    out = {}
    for pid in found:
        if state[pid] == "Z":
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                out[pid] = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            pass
    return out


def _reap() -> None:
    """Collect the exit status of every child that has ended (orphans
    re-parented here included)."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children() -> dict[int, str]:
    """Stop every process this script started that still runs: the
    multiprocessing resource tracker (which ignores SIGTERM) by closing its
    pipe, every other descendant by SIGTERM, then SIGKILL after
    STOP_GRACE_S; reap them. Returns those that were running."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    left = _descendants()
    if getattr(tracker, "_pid", None) is not None and hasattr(tracker, "_stop"):
        tracker._stop()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        running = _descendants()
        for pid in running:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, sig)
        deadline = time.monotonic() + STOP_GRACE_S
        while running and time.monotonic() < deadline:
            _reap()
            running = _descendants()
            time.sleep(0.05)
        if not running:
            break
    _reap()
    return left


def _stop_children_at_exit() -> None:
    left = stop_children()
    if left:
        print(f"chip_smoke: stopped {len(left)} processes left running at exit: "
              f"{sorted(left.values())}", file=sys.stderr)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


_LAST_MARK = [STARTED]


def mark(phase: str) -> None:
    """Print the seconds since the last mark (the phase just ended) and
    since the script began."""
    now = time.perf_counter()
    print(f"time: {phase} {now - _LAST_MARK[0]:.1f} s; {now - STARTED:.1f} s since the start",
          flush=True)
    _LAST_MARK[0] = now


def call_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Milliseconds per call of back-to-back calls from Python (CUDA events):
    the device time, or the host's where the host is slower."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call: ``calls`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def device_kernels(fn, calls: int = 1) -> dict:
    """The device activities (kernels, copies, memsets) of ``calls`` warm
    calls of ``fn`` under torch.profiler: {name: (count, total us)}. Device
    activity only, as profile_window: with the CPU's too, a call's first
    kernel was missing from the records in some H100 calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            count, us = seen.get(e.name, (0, 0.0))
            seen[e.name] = (count + 1, us + e.time_range.elapsed_us())
    if not seen:
        fail("torch.profiler recorded no device kernels")
    return seen


def _short(kernel_name: str) -> str:
    name = kernel_name.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[<(]", name)[0]


def kernel_inputs(gen: torch.Generator, dev, n_rows: int = ROWS) -> dict:
    """Seeded inputs of ``n_rows`` rows (the serving batch's by default), in
    the cell's ranges."""
    def r(*shape, scale=1.0, pos=False, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return (torch.nn.functional.softplus(x) if pos else x).to(dtype)

    bf, rows = torch.bfloat16, (n_rows, C)
    d = dict(exc=r(*rows, pos=True), inh=r(*rows, pos=True), new_inh=r(*rows, pos=True),
             att_x=r(*rows, dtype=bf), inp=r(*rows, pos=True, dtype=bf),
             gi_x=r(*rows, dtype=bf), conv_i=r(*rows, scale=2.0, dtype=bf),
             conv_e=r(*rows, scale=2.0, dtype=bf), gated=r(*rows, pos=True, dtype=bf),
             rstd0=r(C, pos=True), rstd1=r(C, pos=True))
    for k in ("a_u", "i_u", "e_w", "e_u"):
        d[k] = r(C, C, scale=C ** -0.5, dtype=bf)
    for k in ("a_u_b", "i_u_b", "e_w_b", "e_u_b", "mean0", "mean1", "scale0",
              "bias0", "scale1", "bias1", "alpha", "mu", "kappa", "gamma"):
        d[k] = r(C, scale=0.5)
    return d


def max_error(got, want) -> float:
    """Max abs error; fails past the stated tolerance."""
    err = 0.0
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"output {a.dtype} {tuple(a.shape)} vs plain {b.dtype} {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            fail("kernel output is not finite")
        diff = (a.float() - b.float()).abs()
        if a.dtype == torch.bfloat16:
            mag = torch.maximum(a.float().abs(), b.float().abs())
            ulp = torch.pow(2.0, torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            if (diff > BF16_ULPS * ulp).any():
                fail(f"bf16 output off by more than {BF16_ULPS} ulp")
        elif diff.max().item() > ATOL_F32:
            fail(f"f32 output off by {diff.max().item():.3g} > {ATOL_F32}")
        err = max(err, diff.max().item())
    return err


def kernel_phase(F) -> list[dict]:
    dev = torch.device(DEVICE)
    d = kernel_inputs(torch.Generator(device=dev).manual_seed(0), dev)
    # (name, wrapper, plain, argument names, TPU kernel, gate products,
    #  f32 elementwise operations per element counted from the code)
    specs = [
        ("k1_attention", F.k1_attention, F.k1_attention_plain, K1_ARGS,
         "pathtracker_tpu/ops/int_fused.py:184", 1, 6),
        ("k2_inhibition", F.k2_inhibition, F.k2_inhibition_plain, K2_ARGS,
         "pathtracker_tpu/ops/int_fused.py:305", 1, 30),
        ("k3_excitation", F.k3_excitation, F.k3_excitation_plain, K3_ARGS,
         "pathtracker_tpu/ops/int_fused.py:443", 2, 22),
    ]
    rows = []
    for name, wrapper, plain, keys, replaces, n_products, f32_ops in specs:
        args = [d[k] for k in keys]
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_error(got, want)
        ms = device_ms(lambda: wrapper(*args))
        plain_ms = device_ms(lambda: plain(*args))
        per_call_ms = call_ms(lambda: wrapper(*args))
        # Each input read once, each output written once; the products'
        # 2*R*C*C FLOPs at the bf16 tensor rate (their operands' type) plus
        # the elementwise f32 operations.
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *got))
        bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
        ops_ms = (n_products * 2 * ROWS * C * C / BF16_TENSOR_FLOP_PER_S
                  + f32_ops * ROWS * C / F32_FLOP_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append(dict(name=name, route="cuda",
                         source="pathtracker_torch/csrc/int_cell.cu",
                         replaces=replaces, launches=0, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                         library_ms=None))
        print(f"kernel {name}: max_abs_err {err:.3g} (tolerance: f32 {ATOL_F32}, "
              f"bf16 {BF16_ULPS} ulp) | device {ms * 1e3:.2f} us/launch, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.1f} MB; {bound_ms / ms:.0%} of bound) | "
              f"wrapper {per_call_ms * 1e3:.2f} us/call from Python", flush=True)
    return rows


def _gap(a, b) -> str:
    d = (a - b).abs()
    return (f"mean {d.mean().item():.4g} p99 {d.quantile(0.99).item():.4g} "
            f"max {d.max().item():.4g}")


def serve_phase(serve, F, kernel_rows: list[dict], rendered) -> None:
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    models = {
        "fused": serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True, device=dev),
        "eager": serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True,
                             fused=False, device=dev),
        "f32": serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, device=dev),
    }
    if not models["fused"].use_fused or models["eager"].use_fused:
        fail("the bf16 InT did not dispatch to the fused cell (or fused=False did)")
    infer = {k: serve.make_inference_fn(m, "InT") for k, m in models.items()}
    batches = [torch.from_numpy(clips).to(dev) for clips, _ in rendered]
    labels = torch.from_numpy(np.concatenate([y for _, y in rendered])).to(dev)
    for path in infer:  # warm-up: cuDNN plans, kernel load
        infer[path](batches[0])
    torch.cuda.synchronize()
    print(f"serve: loaded chainE, built 3 models, rendered {labels.numel()} clips, "
          f"warmed up in {time.perf_counter() - t0:.2f} s", flush=True)

    # The main path: counts from 0, three requests, each +T per kernel.
    for k in F.KERNELS:
        k.launches = 0
    scores = {"fused": []}
    expected = [TIMESTEPS] * len(F.FORWARD_KERNELS) + [0] * len(F.BACKWARD_KERNELS)
    for i, batch in enumerate(batches):
        before = [k.launches for k in F.KERNELS]
        out = infer["fused"](batch)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        if rose != expected:
            fail(f"request {i}: kernel launches rose by {rose}, expected {expected}")
        if out.shape != (BATCH,) or out.dtype != torch.float32:
            fail(f"request {i}: scores {out.dtype} {tuple(out.shape)}")
        if not (torch.isfinite(out).all() and (out >= 0).all() and (out <= 1).all()):
            fail(f"request {i}: scores not finite in [0, 1]")
        scores["fused"].append(out)
    for row, k in zip(kernel_rows, F.KERNELS):
        row["launches_serve"] = k.launches
    print(f"serve: {REQUESTS} requests through the fused cell, kernel launches "
          f"{[k.launches for k in F.KERNELS]} (K1, K2, K3 forward; backward)",
          flush=True)

    for path in ("eager", "f32"):
        scores[path] = [infer[path](batch) for batch in batches]
    s = {k: torch.cat(v) for k, v in scores.items()}
    diff = (s["fused"] - s["eager"]).abs()
    agree = ((s["fused"] > 0.5) == (s["eager"] > 0.5)).float().mean().item()
    print(f"serve: fused vs eager scores {_gap(s['fused'], s['eager'])} "
          f"(held: mean <= {MEAN_SCORE_ATOL}, p99 <= {P99_SCORE_ATOL}); "
          f"decisions agree {agree:.4f}", flush=True)
    if diff.mean().item() > MEAN_SCORE_ATOL or diff.quantile(0.99).item() > P99_SCORE_ATOL:
        fail("fused and eager scores differ past the tolerance")
    for path in ("fused", "eager"):
        print(f"serve: {path} vs f32 parity path scores {_gap(s[path], s['f32'])}",
              flush=True)
    for path, out in s.items():
        acc = ((out > 0.5).long() == labels).float().mean().item()
        print(f"serve {path}: accuracy {acc:.4f} on {labels.numel()} rendered clips "
              f"(minimum {MIN_ACCURACY})", flush=True)
        if acc < MIN_ACCURACY:
            fail(f"{path} accuracy {acc:.4f} < {MIN_ACCURACY}")

    times = {"fused": [], "eager": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TIMED_REQUESTS):
        for path in (("fused", "eager") if i % 2 == 0 else ("eager", "fused")):
            batch = batches[i % REQUESTS]
            torch.cuda.synchronize()
            t = time.perf_counter()
            infer[path](batch)
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t)
    for path, ts in times.items():
        print(f"serve {path}: p50 request latency {statistics.median(ts) * 1e3:.2f} ms, "
              f"{BATCH * len(ts) / sum(ts):.1f} clips/s over {len(ts)} requests "
              f"of {BATCH} clips (T={TIMESTEPS})", flush=True)
    print(f"serve: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "over the timed requests", flush=True)
    return (BATCH * len(times["fused"]) / sum(times["fused"]),
            statistics.median(times["fused"]) * 1e3)


def _bf16_ulp(a, b):
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)


def backward_errors(name: str, rows: int, got, want) -> tuple[float, float, float]:
    """(max abs error over the row outputs, max error of the reductions
    relative to their largest entry, largest share of a row output's
    elements past the tight tolerance); fails past the stated tolerances."""
    row_err = red_err = worst_share = 0.0
    if len(got) != len(want):
        fail(f"{name}: {len(got)} outputs vs plain {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{name}[{i}]: {a.dtype} {tuple(a.shape)} vs plain "
                 f"{b.dtype} {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            fail(f"{name}[{i}]: not finite")
        a32, b32 = a.float(), b.float()
        diff = (a32 - b32).abs()
        scale = max(b32.abs().max().item(), 1.0)
        if a.shape[0] != rows:  # a reduction over the rows
            tol = REDUCTION_RTOL + (2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0)
            if diff.max().item() > tol * scale:
                fail(f"{name}[{i}]: reduction off by {diff.max().item():.3g} "
                     f"> {tol:.3g} x {scale:.3g}")
            red_err = max(red_err, diff.max().item() / scale)
            continue
        tight = (BF16_ULPS * _bf16_ulp(a32, b32) if a.dtype == torch.bfloat16
                 else ATOL_F32 * scale)
        loose = torch.maximum(torch.as_tensor(FLIP_RTOL * scale, device=a.device),
                              torch.as_tensor(tight, device=a.device))
        if (diff > loose).any():
            fail(f"{name}[{i}]: row output off by {diff.max().item():.3g} "
                 f"> {FLIP_RTOL:.3g} x {scale:.3g}")
        share = (diff > tight).float().mean().item()
        if share > FLIP_SHARE:
            fail(f"{name}[{i}]: {share:.3g} of the elements past the tight "
                 f"tolerance (allowed {FLIP_SHARE})")
        row_err = max(row_err, diff.max().item())
        worst_share = max(worst_share, share)
    return row_err, red_err, worst_share


def backward_kernel_phase(F) -> list[dict]:
    dev = torch.device(DEVICE)
    d = kernel_inputs(torch.Generator(device=dev).manual_seed(0), dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    dgated = torch.randn((ROWS, C), generator=gen, device=dev).to(torch.bfloat16)
    datt = torch.randn((ROWS, C), generator=gen, device=dev)
    dnew = torch.randn((ROWS, C), generator=gen, device=dev)
    k1, k2, k3 = K1_ARGS, K2_ARGS, K3_ARGS
    # (name, wrapper, plain, arguments, TPU kernel, products (recomputed,
    #  transposed and weight-gradient), f32 elementwise operations per
    #  element counted from the code, whether it is the training path's case)
    specs = [
        ("k1_attention_bwd+datt", F.k1_attention_bwd, F.k1_attention_bwd_plain,
         [d[k] for k in k1] + [dgated, datt], "pathtracker_tpu/ops/int_fused.py:206",
         3, 14, False),
        ("k1_attention_bwd", F.k1_attention_bwd, F.k1_attention_bwd_plain,
         [d[k] for k in k1] + [dgated], "pathtracker_tpu/ops/int_fused.py:206",
         3, 13, True),
        ("k2_inhibition_bwd", F.k2_inhibition_bwd, F.k2_inhibition_bwd_plain,
         [d[k] for k in k2] + [dnew], "pathtracker_tpu/ops/int_fused.py:332",
         3, 70, True),
        ("k3_excitation_bwd", F.k3_excitation_bwd, F.k3_excitation_bwd_plain,
         [d[k] for k in k3] + [dnew], "pathtracker_tpu/ops/int_fused.py:467",
         6, 55, True),
    ]
    rows = []
    for name, wrapper, plain, args, replaces, n_products, f32_ops, on_path in specs:
        got = wrapper(*args)
        again = wrapper(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name}: two launches on the same inputs differ")
        want = plain(*args)
        row_err, red_err, share = backward_errors(name, ROWS, got, want)
        ms = device_ms(lambda: wrapper(*args))
        plain_ms = device_ms(lambda: plain(*args), calls=5, replays=4)
        per_call_ms = call_ms(lambda: wrapper(*args))
        # Each input and cotangent read once, each output written once (the
        # [32, 32] and [32] results, not the per-block workspaces).
        nbytes = sum(t.numel() * t.element_size() for t in (*args, *got))
        bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
        ops_ms = (n_products * 2 * ROWS * C * C / BF16_TENSOR_FLOP_PER_S
                  + f32_ops * ROWS * C / F32_FLOP_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {name}: bit-identical on two launches; row outputs "
              f"max_abs_err {row_err:.3g} (held: {FLIP_RTOL:.3g} of the largest "
              f"entry, and all but {FLIP_SHARE} within f32 {ATOL_F32} / bf16 "
              f"{BF16_ULPS} ulp: {share:.3g} are not), reductions rel err "
              f"{red_err:.3g} (held {REDUCTION_RTOL}) | device {ms * 1e3:.2f} us/launch, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes / 1e6:.1f} MB; {bound_ms / ms:.0%} of bound) | "
              f"wrapper {per_call_ms * 1e3:.2f} us/call from Python", flush=True)
        if on_path:
            rows.append(dict(name=name, route="cuda",
                             source="pathtracker_torch/csrc/int_cell_bwd.cu",
                             replaces=replaces, launches=0, max_abs_err=row_err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                             library_ms=None, reduction_rel_err=red_err))
        main_kernel = ALONE.get(name)
        if main_kernel:  # the call's kernels one by one: main kernel vs epilogue
            # torch.profiler lost one record on the card (9 of 10
            # k2_bwd_kernel beside 10 finish_kernel, two H100 calls): a
            # second profile is taken before the exact count fails.
            for _ in range(2):
                seen = device_kernels(lambda: wrapper(*args), calls=ALONE_CALLS)
                mains = [v for k, v in seen.items() if main_kernel in k]
                if len(mains) == 1 and mains[0][0] == ALONE_CALLS:
                    break
            else:
                fail(f"{name}: expected one {main_kernel} a call, saw {seen}")
            alone_ms = mains[0][1] / ALONE_CALLS / 1e3
            rows[-1]["kernel_alone_ms"] = alone_ms
            parts = ", ".join(
                f"{_short(k)} x{n / ALONE_CALLS:g} {us / n:.2f} us"
                for k, (n, us) in sorted(seen.items(), key=lambda kv: -kv[1][1]))
            print(f"kernel {name}: {sum(n for n, _ in seen.values()) / ALONE_CALLS:g} "
                  f"CUDA kernels a call, {sum(us for _, us in seen.values()) / ALONE_CALLS:.2f} "
                  f"us of kernel time; {main_kernel} alone {alone_ms * 1e3:.2f} us "
                  f"({bound_ms / alone_ms:.0%} of bound) | {parts}", flush=True)
    return rows


def loop_shape_kernel_check(F, batch: int = REFERENCE_BATCH, tag: str = "loop") -> None:
    """Every K1-K3 wrapper against its plain version at a path's rows
    (``batch`` clips of 32x32; train_InT.sh's batch by default), at phases 2
    and 5's tolerances: the row count sets each kernel's grid, its tail and
    the per-block partial sums that finish_kernel adds."""
    dev = torch.device(DEVICE)
    rows = batch * SIDE * SIDE
    d = kernel_inputs(torch.Generator(device=dev).manual_seed(1), dev, rows)
    gen = torch.Generator(device=dev).manual_seed(8)
    dgated = torch.randn((rows, C), generator=gen, device=dev).to(torch.bfloat16)
    datt = torch.randn((rows, C), generator=gen, device=dev)
    dnew = torch.randn((rows, C), generator=gen, device=dev)
    k1, k2, k3 = ([d[k] for k in keys] for keys in (K1_ARGS, K2_ARGS, K3_ARGS))

    def outputs(wrapper, plain, args):
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        return ((got if isinstance(got, tuple) else (got,)),
                (want if isinstance(want, tuple) else (want,)))

    forward = [f"{name} {max_error(*outputs(wrapper, plain, args)):.3g}"
               for name, wrapper, plain, args in (
                   ("k1_attention", F.k1_attention, F.k1_attention_plain, k1),
                   ("k2_inhibition", F.k2_inhibition, F.k2_inhibition_plain, k2),
                   ("k3_excitation", F.k3_excitation, F.k3_excitation_plain, k3))]
    backward = []
    for name, wrapper, plain, args in (
            ("k1_attention_bwd+datt", F.k1_attention_bwd, F.k1_attention_bwd_plain,
             k1 + [dgated, datt]),
            ("k1_attention_bwd", F.k1_attention_bwd, F.k1_attention_bwd_plain,
             k1 + [dgated]),
            ("k2_inhibition_bwd", F.k2_inhibition_bwd, F.k2_inhibition_bwd_plain,
             k2 + [dnew]),
            ("k3_excitation_bwd", F.k3_excitation_bwd, F.k3_excitation_bwd_plain,
             k3 + [dnew])):
        errors = backward_errors(name, rows, *outputs(wrapper, plain, args))
        backward.append(f"{name} {' / '.join(f'{e:.3g}' for e in errors)}")
    print(f"{tag}: kernels at {rows:,} rows (batch {batch}) against their "
          f"plain versions, held as phases 2 and 5: forward max_abs_err "
          f"{', '.join(forward)}; backward row max_abs_err / reductions rel err / "
          f"share past the tight tolerance {', '.join(backward)}", flush=True)


def _loss_gradients(model, imgs) -> dict:
    """Gradients of sum(logit^2) (tests/test_int_fused.py's loss) by name;
    the model returns (logit, penalty) or the logits alone."""
    out = model(imgs)
    logit = out[0] if isinstance(out, tuple) else out
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(logit.square().sum(), list(params.values()),
                                allow_unused=True)
    return dict(zip(params, grads))


def _gradient_gap(got: dict, want: dict) -> tuple[float, str]:
    """Largest |got - want| gradient entry, each gradient normalised by
    ``want``'s largest entry; and the parameter it is in."""
    worst, where = 0.0, ""
    for key, ref in want.items():
        if (ref is None) != (got[key] is None):
            fail(f"gradient of {key}: one path has none")
        if ref is None:
            continue
        if not torch.isfinite(got[key]).all():
            fail(f"gradient of {key} is not finite")
        gap = ((got[key] - ref).abs().max() / ref.abs().max().clamp_min(1e-3)).item()
        if gap > worst:
            worst, where = gap, key
    return worst, where


def gradient_phase(serve, F, rendered) -> None:
    from pathtracker_torch.data.prepare import prepare_batch

    dev = torch.device(DEVICE)
    clips = torch.from_numpy(rendered[0][0]).to(dev)
    imgs, _ = prepare_batch(clips, torch.zeros(BATCH, dtype=torch.uint8, device=dev))
    for label, length, ckpt in (("seeded init", GRAD_TIMESTEPS, None),
                                ("chainE weights", TIMESTEPS, CHECKPOINT)):
        x = imgs[:, :, :length]
        before = [k.launches for k in F.KERNELS]
        grads = {
            "fused": _loss_gradients(serve.build(
                ckpt=ckpt, length=length, bf16=True, device=dev), x),
            "eager": _loss_gradients(serve.build(
                ckpt=ckpt, length=length, bf16=True, fused=False, device=dev), x),
            "f32": _loss_gradients(serve.build(ckpt=ckpt, length=length, device=dev), x),
        }
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        if rose != [2 * length] * 3 + [length] * 3:
            fail(f"gradients, {label}: kernel launches rose by {rose}")
        gap, where = _gradient_gap(grads["fused"], grads["eager"])
        held = ckpt is None
        print(f"gradients, {label}, batch {BATCH}, T={length}: largest normalised "
              f"gap fused vs eager {gap:.4g} (in {where}) "
              f"{'(held: <= ' + str(GRAD_ATOL) + ')' if held else '(printed, not held)'}; "
              f"fused vs f32 {_gradient_gap(grads['fused'], grads['f32'])[0]:.4g}, "
              f"eager vs f32 {_gradient_gap(grads['eager'], grads['f32'])[0]:.4g}",
              flush=True)
        if held and gap > GRAD_ATOL:
            fail(f"fused and eager gradients differ by {gap:.4g} > {GRAD_ATOL}")


def plateau_check(serve, F) -> tuple[float, float]:
    """Stage A's steps from PLATEAU_CKPT through the fused and the eager
    cell: (the fused move's length over the eager one's, their cosine);
    fails past PLATEAU_RTOL / PLATEAU_COS_MIN or if the fused steps did not
    launch K1-K3."""
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    dev = torch.device(DEVICE)
    clips, labels = render_batch(11, PLATEAU_BATCH * PLATEAU_STEPS, PLATEAU_T,
                                 n_distractors=PLATEAU_DIST, dot_size=DOT_SIZE)
    clips = torch.from_numpy(clips).to(dev).view(PLATEAU_STEPS, PLATEAU_BATCH, *clips.shape[1:])
    labels = torch.from_numpy(labels).to(dev).view(PLATEAU_STEPS, PLATEAU_BATCH)
    moves, losses = {}, {}
    for cell, kw in (("fused", {}), ("eager", {"fused": False})):
        model = serve.build(ckpt=PLATEAU_CKPT, length=PLATEAU_T, bf16=True, device=dev,
                            **kw).train()
        if model.use_fused != (cell == "fused"):
            fail(f"plateau: the {cell} model did not dispatch to the {cell} cell")
        params = [p for p in model.parameters() if p.requires_grad]
        start = [p.detach().clone() for p in params]
        step = make_train_step(model, "InT", make_optimizer(PLATEAU_LR))
        before = [k.launches for k in F.KERNELS]
        losses[cell] = [float(step(clips[i], labels[i])["loss"]) for i in range(PLATEAU_STEPS)]
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        want = ([2 * PLATEAU_T * PLATEAU_STEPS] * 3 + [PLATEAU_T * PLATEAU_STEPS] * 3
                if cell == "fused" else [0] * 6)
        if rose != want:
            fail(f"plateau, {cell}: kernel launches rose by {rose}, expected {want}")
        moves[cell] = torch.cat([(p.detach() - s).flatten().double()
                                 for p, s in zip(params, start)])
    fused, eager = moves["fused"], moves["eager"]
    ratio = (fused.norm() / eager.norm()).item()
    cosine = (fused @ eager / fused.norm() / eager.norm()).item()
    print(f"gradients, stage A's plateau (the JAX chainA's epoch 38, {PLATEAU_STEPS} steps "
          f"of {PLATEAU_BATCH} clips, T={PLATEAU_T}, lr {PLATEAU_LR}): the fused cell moves "
          f"the weights {ratio:.5f} times as far as the eager cell, cosine {cosine:.5f} "
          f"(held: within {PLATEAU_RTOL} and >= {PLATEAU_COS_MIN}); losses fused "
          f"{' '.join(f'{v:.5f}' for v in losses['fused'])}, eager "
          f"{' '.join(f'{v:.5f}' for v in losses['eager'])}", flush=True)
    if abs(ratio - 1.0) > PLATEAU_RTOL or cosine < PLATEAU_COS_MIN:
        fail(f"plateau: fused vs eager move ratio {ratio:.5f}, cosine {cosine:.5f}")
    return ratio, cosine


def train_phase(serve, F, kernel_rows: list[dict], rendered):
    """The InT train step. Returns bare_steps(n): the seconds of n more bare
    fused steps on one batch of REFERENCE_BATCH clips."""
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.train.steps import (TRAIN_KEYS, make_optimizer,
                                               make_train_step)

    dev = torch.device(DEVICE)
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
               for x, y in rendered]
    steps, models = {}, {}
    for path, kw in (("fused", {}), ("eager", {"fused": False})):
        model = serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True,
                            device=dev, **kw).train()
        # Warm cuDNN's backward plans and the kernels' load; weights untouched.
        model(torch.zeros((BATCH, 3, TIMESTEPS, SIDE, SIDE), device=dev))[0].sum().backward()
        model.zero_grad(set_to_none=True)
        models[path] = model
        steps[path] = make_train_step(model, "InT", make_optimizer(LEARNING_RATE))
    if not models["fused"].use_fused or models["eager"].use_fused:
        fail("the bf16 InT did not dispatch to the fused cell (or fused=False did)")
    unused = models["fused"].unit1.w.detach().clone()
    torch.cuda.synchronize()

    # The main path: counts from 0; each step 2T forward launches (the step
    # and its recompute in backward) and T backward launches per kernel.
    for k in F.KERNELS:
        k.launches = 0
    expected = [2 * TIMESTEPS] * 3 + [TIMESTEPS] * 3
    losses = []
    for i in range(TRAIN_STEPS):
        before = [k.launches for k in F.KERNELS]
        stats = steps["fused"](*batches[0])
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        if rose != expected:
            fail(f"train step {i}: kernel launches rose by {rose}, expected {expected}")
        if set(stats) != set(TRAIN_KEYS) or not all(np.isfinite(v) for v in stats.values()):
            fail(f"train step {i}: stats {stats}")
        losses.append(float(stats["loss"]))
    for row, k in zip(kernel_rows, F.KERNELS):
        row["launches_train"] = k.launches
        row["launches"] = row.get("launches_serve", 0) + k.launches
    print(f"train: {TRAIN_STEPS} steps through the fused cell, kernel launches "
          f"{[k.launches for k in F.KERNELS]} (K1, K2, K3 forward; backward); "
          f"losses {' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not losses[-1] < losses[0]:  # every counted step saw the same batch
        fail(f"loss on the repeated batch did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not torch.equal(models["fused"].unit1.w, unused):
        fail("unit1.w, which the forward never reads, changed")

    eager_first = float(steps["eager"](*batches[0])["loss"])
    print(f"train: first loss fused {losses[0]:.5f}, eager {eager_first:.5f} "
          f"(held: within {LOSS_ATOL})", flush=True)
    if abs(eager_first - losses[0]) > LOSS_ATOL:
        fail("fused and eager first losses differ past the tolerance")

    times = {"fused": [], "eager": []}
    peaks = {}
    for i in range(TIMED_STEPS):
        for path in (("fused", "eager") if i % 2 == 0 else ("eager", "fused")):
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            steps[path](*batch)
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t)
            peaks[path] = max(peaks.get(path, 0), torch.cuda.max_memory_allocated())
    for path, ts in times.items():
        print(f"train {path}: p50 step latency {statistics.median(ts) * 1e3:.2f} ms, "
              f"{BATCH * len(ts) / sum(ts):.1f} clips/s over {len(ts)} steps of "
              f"{BATCH} clips (T={TIMESTEPS}); peak device memory "
              f"{peaks[path] / 2**30:.2f} GiB", flush=True)

    seen = device_kernels(lambda: steps["fused"](*batches[0]))
    ours = {_short(k): n for k, (n, _) in seen.items() if _short(k) in INT_CELL_KERNELS}
    print(f"train fused: one step launches {sum(n for n, _ in seen.values())} CUDA kernels "
          f"and copies, {sum(us for _, us in seen.values()) / 1e3:.2f} ms of device time "
          f"(torch.profiler); of them {ours}", flush=True)

    # Bare steps at the reference batch (printed, nothing held to them).
    clips, labels = render_batch(REQUESTS, REFERENCE_BATCH, TIMESTEPS,
                                 n_distractors=DISTRACTORS, dot_size=DOT_SIZE)
    big = (torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev))

    def bare_steps(n: int) -> list[float]:
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            steps["fused"](*big)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return times

    steps["fused"](*big)  # warm at this shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    big_times = bare_steps(REFERENCE_STEPS)
    big_p50 = statistics.median(big_times)
    print(f"train fused, {REFERENCE_STEPS} batch-{REFERENCE_BATCH} steps: "
          f"{_ms(big_times)} ms, p50 {big_p50 * 1e3:.2f} ms "
          f"({REFERENCE_BATCH / big_p50:.1f} clips/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return bare_steps


def _bound(nbytes: int, f32_ops: float) -> tuple[float, str]:
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    ops_ms = f32_ops / F32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _in_image_terms(size: int, patch: int, dilation: int) -> int:
    """Over one axis: the (position, displacement) pairs whose shifted
    position lies inside the image; the others multiply by padding."""
    r = (patch - 1) // 2 * dilation
    return sum(0 <= p + d * dilation - r < size
               for p in range(size) for d in range(patch))


# The instance of each correlation kernel that the main paths launch (f32
# NHWC, 64 channels, patch 15, dilation 1), as resource_lines names it.
CORR_INSTANCES = {"correlation_fwd": "corr_fwd_kernel<1, 15>",
                  "correlation_bwd_f1": "corr_bwd_kernel<0, 1, 15>",
                  "correlation_bwd_f2": "corr_bwd_kernel<1, 1, 15>"}
CORR_TPU = {"correlation_fwd": "pathtracker_tpu/ops/correlation.py:82",
            "correlation_bwd_f1": "pathtracker_tpu/ops/correlation.py:109 (the XLA VJP; "
                                  "no Pallas kernel)",
            "correlation_bwd_f2": "pathtracker_tpu/ops/correlation.py:109 (the XLA VJP; "
                                  "no Pallas kernel)"}


def correlation_inputs(Co, n, h, w, c, patch, seed):
    """Seeded L2-normalised features f1, f2 and an N(0,1) cotangent g."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f1 = Co.l2_normalize(torch.randn((n, h, w, c), generator=gen, device=dev))
    f2 = Co.l2_normalize(torch.randn((n, h, w, c), generator=gen, device=dev))
    return f1, f2, torch.randn((n, h, w, patch * patch), generator=gen, device=dev)


def correlation_errors(Co, f1, f2, g, patch, dilation) -> list[float]:
    """Max abs error of each kernel against its plain version; fails past the
    stated tolerances or if a kernel's two launches differ."""
    def launch_all():
        return (Co.correlation(f1, f2, patch, dilation),
                Co.correlation_bwd_f1(g, f2, patch, dilation),
                Co.correlation_bwd_f2(g, f1, patch, dilation))
    got, again = launch_all(), launch_all()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("a correlation kernel gave different bits on two launches")
    want = (Co.correlation_plain(f1, f2, patch, dilation),
            Co.correlation_bwd_f1_plain(g, f2, patch, dilation),
            Co.correlation_bwd_f2_plain(g, f1, patch, dilation))
    errs = []
    for a, b, atol in zip(got, want, (CORR_ATOL_FWD, CORR_ATOL_BWD, CORR_ATOL_BWD)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.isfinite(a).all():
            fail(f"correlation output {a.dtype} {tuple(a.shape)} vs plain "
                 f"{b.dtype} {tuple(b.shape)}, or not finite")
        errs.append((a - b).abs().max().item())
        if errs[-1] > atol:
            fail(f"correlation kernel off by {errs[-1]:.3g} > {atol}")
    return errs


def correlation_call(Co, name: str, f1, f2, g):
    """(wrapper, tensor arguments) of the named correlation kernel."""
    if name == "correlation_fwd":
        return Co.correlation, (f1, f2)
    return getattr(Co, name), (g, f2 if name == "correlation_bwd_f1" else f1)


def correlation_timing(Co, name: str, f1, f2, g, plain: bool = True) -> dict:
    """Device time per call of one correlation wrapper (and of its plain
    version) at patch 15 on these inputs, its time per call from Python, and
    the bound from these inputs: each input read once, each output written
    once; one multiply-add for each product that involves a real f2 (f1)
    pixel."""
    wrapper, args = correlation_call(Co, name, f1, f2, g)
    ms = device_ms(lambda: wrapper(*args, PATCH, 1), calls=5, replays=4)
    per_call_ms = call_ms(lambda: wrapper(*args, PATCH, 1), iters=20, warmup=2)
    plain_ms = None
    if plain:
        plain_fn = getattr(Co, f"{name.replace('_fwd', '')}_plain")
        plain_ms = device_ms(lambda: plain_fn(*args, PATCH, 1), calls=1, replays=2)
    out_elems = g.numel() if name == "correlation_fwd" else f1.numel()
    nbytes = 4 * (sum(t.numel() for t in args) + out_elems)
    flop = 2.0 * f1.shape[0] * CORR_C * _in_image_terms(SIDE, PATCH, 1) ** 2
    bound_ms, bound_by = _bound(nbytes, flop)
    return dict(ms=ms, plain_ms=plain_ms, per_call_ms=per_call_ms, bound_ms=bound_ms,
                bound_by=bound_by, nbytes=nbytes, flop=flop)


def correlation_phase(Co, resources: dict) -> list[dict]:
    for label, (n, h, w, c, patch, dilation) in (
            ("dilated", (2, 24, 24, 16, 5, 2)), ("odd-sized", (3, 19, 27, 10, 7, 1))):
        errs = correlation_errors(Co, *correlation_inputs(Co, n, h, w, c, patch, 11),
                                  patch, dilation)
        print(f"kernel correlation, {label} case N={n} {h}x{w}x{c} patch {patch} "
              f"dilation {dilation}: max_abs_err fwd {errs[0]:.3g}, bwd_f1 {errs[1]:.3g}, "
              f"bwd_f2 {errs[2]:.3g} (held: {CORR_ATOL_FWD} forward, {CORR_ATOL_BWD} "
              f"backward)", flush=True)

    rows = []
    # The serving shape, then the train step's (where the backward kernels
    # run, and the forward once a step).
    for n in (CORR_N, CORR_TRAIN_N):
        f1, f2, g = correlation_inputs(Co, n, SIDE, SIDE, CORR_C, PATCH, 3)
        errs = dict(zip(CORR_INSTANCES, correlation_errors(Co, f1, f2, g, PATCH, 1)))
        for name in CORR_INSTANCES:
            t = correlation_timing(Co, name, f1, f2, g)
            res = resources.get(CORR_INSTANCES[name], "no ptxas line")
            if n == CORR_N:
                rows.append(dict(name=name, route="cuda",
                                 source="pathtracker_torch/csrc/correlation.cu",
                                 replaces=CORR_TPU[name], launches=0, max_abs_err=errs[name],
                                 ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                                 bound_by=t["bound_by"], library_ms=None, resources=res))
            else:
                row = next(r for r in rows if r["name"] == name)
                row["train_shape"] = dict(n=n, max_abs_err=errs[name], ms=t["ms"],
                                          plain_ms=t["plain_ms"], bound_ms=t["bound_ms"])
            print(f"kernel {name}: N={n} {SIDE}x{SIDE}x{CORR_C} patch {PATCH}: "
                  f"max_abs_err {errs[name]:.3g} (held: "
                  f"{CORR_ATOL_FWD if name == 'correlation_fwd' else CORR_ATOL_BWD}); "
                  f"bit-identical on two launches"
                  f" | device {t['ms']:.3f} ms/launch, plain {t['plain_ms']:.2f} ms, bound "
                  f"{t['bound_ms']:.3f} ms by {t['bound_by']} ({t['nbytes'] / 1e6:.0f} MB, "
                  f"{t['flop'] / 1e9:.2f} GFLOP in-image; {t['bound_ms'] / t['ms']:.0%} of "
                  f"bound) | wrapper {t['per_call_ms']:.3f} ms/call from Python | "
                  f"{CORR_INSTANCES[name]}: {res}", flush=True)
        del f1, f2, g
    return rows


def _flipped_argmax_pixels(Co, model, imgs) -> tuple[int, int]:
    """The MotionSqueeze's matching features for ``imgs``, through the
    kernel and the plain correlation: (pixels whose argmax over the ReLU'd
    volume differs, pixels)."""
    seen = {}
    hook = model.chnl_reduction.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("red", out))
    with torch.inference_mode():
        model(imgs)
        hook.remove()
        b, t = imgs.shape[0], imgs.shape[2]
        red = seen["red"].reshape(b, t, *seen["red"].shape[1:])
        pre = Co.l2_normalize(red[:, :-1].reshape(b * (t - 1), *red.shape[2:]))
        post = Co.l2_normalize(red[:, 1:].reshape(b * (t - 1), *red.shape[2:]))
        a = torch.relu(Co.correlation(pre, post, model.patch)).argmax(dim=-1)
        p = torch.relu(Co.correlation_plain(pre, post, model.patch)).argmax(dim=-1)
    return int((a != p).sum().item()), a.numel()


def rntsm_serve_phase(serve, Co, kernel_rows: list[dict]) -> None:
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.data.prepare import prepare_batch

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    models = {"fused": serve.build(model="rntsm", length=TIMESTEPS, device=dev),
              "plain": serve.build(model="rntsm", length=TIMESTEPS, fused=False,
                                   device=dev)}
    if not models["fused"].fused or models["plain"].fused:
        fail("rntsm: fused=True/False did not reach the model")
    for a, b in zip(models["fused"].parameters(), models["plain"].parameters()):
        if not torch.equal(a, b):
            fail("rntsm: the two seeded inits differ")
    n_params = sum(p.numel() for p in models["fused"].parameters())
    logit_fn = {k: serve.make_inference_fn(m, "rntsm", probs=False)
                for k, m in models.items()}
    infer = serve.make_inference_fn(models["fused"], "rntsm")
    batches = [torch.from_numpy(render_batch(100 + seed, TSM_BATCH, TIMESTEPS,
                                             n_distractors=DISTRACTORS,
                                             dot_size=DOT_SIZE)[0]).to(dev)
               for seed in range(REQUESTS)]
    for fn in logit_fn.values():  # warm-up: cuDNN plans, kernel load
        fn(batches[0])
    torch.cuda.synchronize()
    print(f"rntsm serve: built 2 models ({n_params / 1e6:.1f} M parameters, layers "
          f"{models['fused'].layers}, patch {models['fused'].patch}, f32, seeded init), "
          f"rendered {REQUESTS * TSM_BATCH} clips, warmed up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # The main path: counts from 0, three requests, each one forward launch.
    for k in Co.KERNELS:
        k.launches = 0
    for i, batch in enumerate(batches):
        before = [k.launches for k in Co.KERNELS]
        out = infer(batch)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(Co.KERNELS, before)]
        if rose != [1, 0, 0]:
            fail(f"rntsm request {i}: kernel launches rose by {rose}, expected [1, 0, 0]")
        if out.shape != (TSM_BATCH,) or out.dtype != torch.float32:
            fail(f"rntsm request {i}: scores {out.dtype} {tuple(out.shape)}")
        if not (torch.isfinite(out).all() and (out >= 0).all() and (out <= 1).all()):
            fail(f"rntsm request {i}: scores not finite in [0, 1]")
    for row, k in zip(kernel_rows, Co.KERNELS):
        row["launches_serve"] = k.launches
    print(f"rntsm serve: {REQUESTS} requests of {TSM_BATCH} clips (T={TIMESTEPS}) "
          f"through make_inference_fn, kernel launches "
          f"{[k.launches for k in Co.KERNELS]} (forward, bwd_f1, bwd_f2)", flush=True)

    logits = {k: torch.cat([fn(batch) for batch in batches]) for k, fn in logit_fn.items()}
    gap = (logits["fused"] - logits["plain"]).abs().max().item()
    imgs, _ = prepare_batch(batches[0], torch.zeros(TSM_BATCH, dtype=torch.uint8, device=dev))
    flipped, pixels = _flipped_argmax_pixels(Co, models["fused"], imgs)
    print(f"rntsm serve: logits kernels vs plain correlation max gap {gap:.3g} (held: "
          f"{TSM_LOGIT_ATOL}; logits span {logits['plain'].min().item():.4f} .. "
          f"{logits['plain'].max().item():.4f}); argmax over the volume differs at "
          f"{flipped} of {pixels} pixels of request 0", flush=True)
    if not gap <= TSM_LOGIT_ATOL:
        fail(f"rntsm logits differ by {gap:.3g} > {TSM_LOGIT_ATOL}")

    times = {"fused": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TSM_TIMED_REQUESTS):
        for path in (("fused", "plain") if i % 2 == 0 else ("plain", "fused")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logit_fn[path](batches[i % REQUESTS])
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t)
    for path, ts in times.items():
        print(f"rntsm serve {path}: p50 request latency {statistics.median(ts) * 1e3:.2f} ms, "
              f"{TSM_BATCH * len(ts) / sum(ts):.2f} clips/s over {len(ts)} requests of "
              f"{TSM_BATCH} clips (T={TIMESTEPS})", flush=True)
    print(f"rntsm serve: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB over the timed requests", flush=True)


def rntsm_train_phase(serve, Co, kernel_rows: list[dict]) -> None:
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.data.prepare import prepare_batch
    from pathtracker_torch.train.steps import (TRAIN_KEYS, make_optimizer,
                                               make_train_step)

    dev = torch.device(DEVICE)
    clips, labels = render_batch(200, TSM_TRAIN_BATCH, TIMESTEPS,
                                 n_distractors=DISTRACTORS, dot_size=DOT_SIZE)
    clips, labels = torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev)

    # Gradients through the kernels against the plain correlation, short clips.
    imgs, _ = prepare_batch(clips[:, :TSM_GRAD_TIMESTEPS], labels)
    grads = {}
    before = [k.launches for k in Co.KERNELS]
    for path, kw in (("fused", {}), ("plain", {"fused": False})):
        model = serve.build(model="rntsm", length=TSM_GRAD_TIMESTEPS, remat_blocks=True,
                            device=dev, **kw).train()
        grads[path] = _loss_gradients(model, imgs)
        del model
    rose = [k.launches - b for k, b in zip(Co.KERNELS, before)]
    if rose != [1, 1, 1]:
        fail(f"rntsm gradients: kernel launches rose by {rose}, expected [1, 1, 1]")
    worst_max, worst_mean = (0.0, ""), (0.0, "")
    for key, ref in grads["plain"].items():
        got = grads["fused"][key]
        if not torch.isfinite(got).all():
            fail(f"rntsm gradient of {key} is not finite")
        gaps = (got - ref).abs() / ref.abs().max().clamp_min(1e-3)
        worst_max = max(worst_max, (gaps.max().item(), key))
        worst_mean = max(worst_mean, (gaps.mean().item(), key))
    print(f"rntsm gradients, batch {TSM_TRAIN_BATCH}, T={TSM_GRAD_TIMESTEPS}, remat: "
          f"kernels vs plain correlation, each gradient normalised by its largest "
          f"entry: largest gap {worst_max[0]:.4g} (in {worst_max[1]}; held: "
          f"{TSM_GRAD_MAX}), largest mean gap {worst_mean[0]:.4g} (in {worst_mean[1]}; "
          f"held: {TSM_GRAD_MEAN})", flush=True)
    worst_max, worst_mean = worst_max[0], worst_mean[0]
    if worst_max > TSM_GRAD_MAX or worst_mean > TSM_GRAD_MEAN:
        fail("rntsm gradients through the kernels and the plain correlation differ")
    del grads
    torch.cuda.empty_cache()

    model = serve.build(model="rntsm", length=TIMESTEPS, remat_blocks=True,
                        device=dev).train()
    if not (model.remat and model.fused):
        fail("rntsm: remat_blocks/fused did not reach the model")
    step = make_train_step(model, "rntsm", make_optimizer(LEARNING_RATE))
    # Warm cuDNN's backward plans at this shape; weights untouched.
    model(torch.zeros((TSM_TRAIN_BATCH, 3, TIMESTEPS, SIDE, SIDE), device=dev)).sum().backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()

    # The main path: counts from 0; each step one launch of each kernel.
    for k in Co.KERNELS:
        k.launches = 0
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TSM_TRAIN_STEPS):
        before = [k.launches for k in Co.KERNELS]
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = step(clips, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        rose = [k.launches - b for k, b in zip(Co.KERNELS, before)]
        if rose != [1, 1, 1]:
            fail(f"rntsm train step {i}: kernel launches rose by {rose}, expected [1, 1, 1]")
        if set(stats) != set(TRAIN_KEYS) or not all(np.isfinite(v) for v in stats.values()):
            fail(f"rntsm train step {i}: stats {stats}")
        losses.append(float(stats["loss"]))
    peak = torch.cuda.max_memory_allocated()
    for row, k in zip(kernel_rows, Co.KERNELS):
        row["launches_train"] = k.launches
        row["launches"] = row.get("launches_serve", 0) + k.launches
    print(f"rntsm train: {TSM_TRAIN_STEPS} steps of batch {TSM_TRAIN_BATCH} (T={TIMESTEPS}, "
          f"remat, Adam {LEARNING_RATE}) through make_train_step, kernel launches "
          f"{[k.launches for k in Co.KERNELS]} (forward, bwd_f1, bwd_f2); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not losses[-1] < losses[0]:  # every step saw the same batch
        fail(f"rntsm loss on the repeated batch did not fall: {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"rntsm train: p50 step latency {statistics.median(times) * 1e3:.2f} ms, "
          f"{TSM_TRAIN_BATCH * len(times) / sum(times):.2f} clips/s over {len(times)} steps; "
          f"peak device memory {peak / 2**30:.2f} GiB", flush=True)


@contextlib.contextmanager
def _environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _WaitClock:
    """Iterates a loader and keeps the seconds spent waiting for each batch."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            self.waits.append(time.perf_counter() - t)
            yield batch


def eval_phase(serve, F, kernel_rows: list[dict], serve_clips_per_s: float) -> None:
    """The held-out eval path (python -m pathtracker_torch.eval.test_model)
    on a rendered test split of EVAL_CLIPS clips."""
    from pathtracker_torch.data import native, registry
    from pathtracker_torch.data.pathtracker import (make_synthetic_dataset,
                                                    render_pathtracker_clip)
    from pathtracker_torch.data.pipeline import tfr_data_loader
    from pathtracker_torch.data.tfrecord import read_clip_records
    from pathtracker_torch.eval import test_model

    dev = torch.device(DEVICE)
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=tmp, PATHTRACKER_DOT_SIZE=str(DOT_SIZE)):
        # Shards as the registry lays them out; empty train shards, so the
        # registry finds the config and renders nothing.
        root = registry._config_dir(DISTRACTORS, 1, TIMESTEPS)
        t0 = time.perf_counter()
        make_synthetic_dataset(root, n_train=0, n_test=EVAL_CLIPS, timesteps=TIMESTEPS,
                               n_distractors=DISTRACTORS, seed=EVAL_SEED)
        write_s = time.perf_counter() - t0
        codec = "native" if native.available() else "python"
        reader = native.read_clip_records if codec == "native" else read_clip_records
        files = sorted(glob.glob(os.path.join(root, "test-*")))
        t0 = time.perf_counter()
        records = [r for path in files for r in reader(path, TIMESTEPS)]
        decode_s = time.perf_counter() - t0
        rng = np.random.default_rng(EVAL_SEED)
        for i, (clip, label) in enumerate(records):
            want, want_label = render_pathtracker_clip(rng, TIMESTEPS,
                                                       n_distractors=DISTRACTORS)
            if not (np.array_equal(clip, want) and label == want_label):
                fail(f"eval: record {i} differs from the clip rendered in memory")
        if len(records) != EVAL_CLIPS:
            fail(f"eval: {len(records)} records decoded, {EVAL_CLIPS} written")
        mb = sum(c.nbytes for c, _ in records) / 1e6
        del records
        print(f"eval: wrote {EVAL_CLIPS} clips (T={TIMESTEPS}, dist {DISTRACTORS}, "
              f"{DOT_SIZE}-pixel dots) in {write_s:.2f} s; codec {codec}: decoded "
              f"{mb:.1f} MB in {decode_s:.3f} s ({mb / decode_s:.1f} MB/s), byte-equal "
              "to the clips rendered in memory", flush=True)

        # The main path: counts from 0, evaluate_model as test_model.py runs it.
        args = SimpleNamespace(model="InT", name="chainE", batch_size=BATCH, bf16=True,
                               dimensions=C, fb_kernel_size=7, ckpt=CHECKPOINT,
                               pretrained=False, algo="bptt", device=DEVICE)
        results = os.path.join(tmp, "results")
        for k in F.KERNELS:
            k.launches = 0
        acc, loss = test_model.evaluate_model(results, args, prep_gifs=0,
                                              dist=DISTRACTORS, speed=1, length=TIMESTEPS)
        launches = [k.launches for k in F.KERNELS]
        batches = EVAL_CLIPS // BATCH
        expected = [batches * TIMESTEPS] * len(F.FORWARD_KERNELS) + [0] * len(F.BACKWARD_KERNELS)
        if launches != expected:
            fail(f"eval: kernel launches {launches}, expected {expected}")
        for row, k in zip(kernel_rows, F.KERNELS):
            row["launches_eval"] = k.launches
            row["launches"] += k.launches
        saved = np.load(os.path.join(
            results, f"test_perf_dist_{DISTRACTORS}_speed_1_length_{TIMESTEPS}.npz"))
        if saved.files != ["arr_0", "arr_1"] or (
                float(saved["arr_0"]), float(saved["arr_1"])) != (acc, loss):
            fail(f"eval: test_perf npz holds {saved.files}")
        print(f"eval: evaluate_model, {batches} batches of {BATCH}: accuracy {acc:.4f} "
              f"(minimum {MIN_ACCURACY}), BCE {loss:.4f}; kernel launches {launches} "
              f"(K1, K2, K3 forward; backward); test_perf npz holds arr_0, arr_1",
              flush=True)
        if not np.isfinite(loss) or acc < MIN_ACCURACY:
            fail(f"eval: accuracy {acc:.4f} or loss {loss} out of bounds")

        # The eval step against the serving function on seeded loader batches.
        model = serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True, device=dev)
        infer = serve.make_inference_fn(model, "InT", probs=False)
        pattern = os.path.join(root, "test-*")
        seeded = 0
        with torch.inference_mode():
            for clips, labels in tfr_data_loader(pattern, batch_size=BATCH,
                                                 timesteps=TIMESTEPS, seed=0):
                got = test_model.eval_batch(model, "InT", clips, labels)[0][:, 0]
                if not torch.equal(got, infer(clips)):
                    fail(f"eval: batch {seeded}: eval-step logits differ from "
                         "make_inference_fn's")
                seeded += 1
        if seeded != batches:
            fail(f"eval: the seeded loader gave {seeded} batches, not {batches}")
        print(f"eval: eval-step logits bit-equal to make_inference_fn(probs=False) on "
              f"{seeded} seeded loader batches", flush=True)

        # Timed: decode, prefetch, H2D and forward, one unseeded pass.
        clock = _WaitClock(tfr_data_loader(pattern, batch_size=BATCH, timesteps=TIMESTEPS))
        before = [k.launches for k in F.FORWARD_KERNELS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_model.evaluate_batches(model, "InT", clock)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        rose = [k.launches - b for k, b in zip(F.FORWARD_KERNELS, before)]
        if rose != [batches * TIMESTEPS] * len(rose):
            fail(f"eval: timed pass launched {rose}")
        print(f"eval: {EVAL_CLIPS / total:.1f} clips/s end to end (decode, prefetch, "
              f"H2D, forward with states and gates) over {len(clock.waits)} batches "
              f"of {BATCH}, against {serve_clips_per_s:.1f} clips/s serving (fused); "
              f"waiting on the loader {sum(clock.waits) / total:.1%} of the loop "
              f"(first batch {clock.waits[0] * 1e3:.1f} ms)", flush=True)


class _Tee:
    """Standard output that is also kept, to read the loop's messages."""

    def __init__(self, stream):
        self.stream, self.text = stream, []

    def write(self, s):
        self.text.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def _launcher_argv() -> list[str]:
    """train_InT.sh's flags, as its command line passes them."""
    with open(os.path.join(ROOT, "train_InT.sh")) as f:
        words = shlex.split(f.read().replace("\\\n", " "), comments=True)
    return words[words.index("python") + 2:]


def _loop_run(loop, argv, F, steps, timed=None):
    """loop.main on ``argv`` with ``steps`` a capped epoch, its stdout kept;
    launch counts from 0. ``timed``, {(module, name): list}, wraps those
    functions to record the seconds of each call and its arguments."""
    args = loop.parser.parse_args(argv)
    for k in F.KERNELS:
        k.launches = 0
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee), contextlib.ExitStack() as stack:
        for (module, name), record in (timed or {}).items():
            stack.enter_context(_wrapped(module, name, record))
        result = loop.main(args, max_steps_per_epoch=steps)
    torch.cuda.synchronize()
    return args, result, "".join(tee.text), [k.launches for k in F.KERNELS]


@contextlib.contextmanager
def _wrapped(module, name, record):
    fn = getattr(module, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, a))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _ms(seconds) -> str:
    return "[" + ", ".join(f"{t * 1e3:.2f}" for t in seconds) + "]"


def loop_phase(F, kernel_rows: list[dict], bare_steps) -> float:
    """The training loop (python -m pathtracker_torch.train) with
    train_InT.sh's flags on a rendered root of LOOP_CLIPS clips a split; the
    median ms of the window's steps inside an epoch."""
    from pathtracker_torch.data import registry
    from pathtracker_torch.train import checkpoint as ckpt_lib
    from pathtracker_torch.train import loop
    from pathtracker_torch.train.torch_import import state_dict_from_jax

    base = _launcher_argv()
    if base[base.index("-b") + 1] != str(REFERENCE_BATCH):
        fail(f"train_InT.sh's flags changed: {base}")
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=os.path.join(tmp, "data"),
            PATHTRACKER_DOT_SIZE=str(DOT_SIZE),
            PATHTRACKER_SYNTH_TRAIN=str(LOOP_CLIPS),
            PATHTRACKER_SYNTH_TEST=str(LOOP_CLIPS)):
        t0 = time.perf_counter()
        registry.dataset_selector(DISTRACTORS, 1, TIMESTEPS)
        print(f"loop: rendered {LOOP_CLIPS} + {LOOP_CLIPS} clips (T={TIMESTEPS}, "
              f"dist {DISTRACTORS}, {DOT_SIZE}-pixel dots) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        mixed = base + ["--bf16", "--auto-resume", "--ckpt", CHECKPOINT,
                        "--results-dir", os.path.join(tmp, "mixed")]
        val_batches = LOOP_CLIPS // REFERENCE_BATCH
        want = ([2 * TIMESTEPS * LOOP_STEPS + TIMESTEPS * val_batches] * len(F.FORWARD_KERNELS)
                + [TIMESTEPS * LOOP_STEPS] * len(F.BACKWARD_KERNELS))
        loop_shape_kernel_check(F)

        # The main path: counts from 0, one capped epoch from chainE.
        saves, validations = [], []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        args, result, out, launches = _loop_run(
            loop, mixed + ["--epochs", "1"], F, LOOP_STEPS,
            {(ckpt_lib, "save_checkpoint"): saves, (loop, "validate"): validations})
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if launches != want:
            fail(f"loop: kernel launches {launches}, expected {want}")
        for row, n in zip(kernel_rows, launches):
            row["launches_loop"] = n
            row["launches"] += n
        folder = result["results_folder"]
        files = sorted(os.listdir(folder))
        names = sorted(os.listdir(os.path.join(folder, "saved_models")))
        if files != sorted(["hp_dict.npz", "saved_models", "train.npz", "val.npz",
                            f"{args.name}.txt"]) or ROLLING_NAME not in names or not any(
                n.startswith("model_val_acc_") for n in names):
            fail(f"loop: artifacts {files} {names}")
        train = np.load(os.path.join(folder, "train.npz"))
        if len(train["loss"]) != LOOP_STEPS or not np.isfinite(train["loss"]).all():
            fail(f"loop: train losses {train['loss']}")
        rolling = os.path.join(folder, "saved_models", ROLLING_NAME)
        back = state_dict_from_jax("InT", ckpt_lib.load_params(rolling))
        if any(not torch.equal(back[k], v.cpu()) for k, v in result["params"].items()):
            fail("loop: the rolling checkpoint differs from the weights main returned")
        count = int(ckpt_lib.load_checkpoint(rolling)["extra"]["opt_state"]["0"]["count"])
        if count != LOOP_STEPS:
            fail(f"loop: the rolling checkpoint's Adam count is {count}, not {LOOP_STEPS}")
        meters = result["meters"]
        data_share = sum(meters["data_time"].history) / sum(meters["batch_time"].history)
        rolling_s = [t for t, a in saves if a[0].endswith(ROLLING_NAME)]
        balacc = result["val_log"]["balacc"][0]
        card = card_line()
        print(f"loop: main, {LOOP_STEPS} steps of {REFERENCE_BATCH} clips (T={TIMESTEPS}, "
              f"bf16, fused) and {val_batches} val batches in {wall:.2f} s; kernel "
              f"launches {launches} (K1, K2, K3 forward; backward); losses "
              f"{' '.join(f'{v:.4f}' for v in train['loss'])}; artifacts {files} "
              f"{names}; the rolling checkpoint bit-equal to the returned weights, "
              f"Adam count {count} [{card}]", flush=True)
        print(f"loop: per step batch_time {_ms(meters['batch_time'].history)} ms, of it "
              f"data_time {_ms(meters['data_time'].history)} ms [{card}]", flush=True)
        print(f"loop: data_time {data_share:.1%} of the run's steps; validation "
              f"{sum(t for t, _ in validations):.3f} s; rolling checkpoint "
              f"{os.path.getsize(rolling) / 1e3:.1f} kB written in "
              f"{rolling_s[-1] * 1e3:.2f} ms; peak device memory {peak / 2**30:.2f} GiB; "
              f"val balacc after the warm start {balacc:.2f}% (chainE's held-out "
              f"69.08%, not gated) [{card}]", flush=True)

        # Resume: one more epoch continues from the rolling checkpoint.
        _, result, out, launches = _loop_run(loop, mixed + ["--epochs", "2"], F, LOOP_STEPS)
        folder = result["results_folder"]
        lengths = [len(np.load(os.path.join(folder, f"{n}.npz"))["loss"])
                   for n in ("val", "train")]
        count = int(ckpt_lib.load_checkpoint(rolling)["extra"]["opt_state"]["0"]["count"])
        if ("optimizer state restored" not in out or "continuing from epoch 1" not in out
                or lengths != [2, 2 * LOOP_STEPS] or count != 2 * LOOP_STEPS
                or launches != want):
            fail(f"loop: resume: val/train entries {lengths}, Adam count {count}, "
                 f"launches {launches}")
        for row, n in zip(kernel_rows, launches):
            row["launches_loop"] += n
            row["launches"] += n
        print(f"loop: --auto-resume continued at epoch 1 with the optimizer state "
              f"restored; val/train entries {lengths}, Adam count {count}; per step "
              f"batch_time {_ms(result['meters']['batch_time'].history)} ms, of it "
              f"data_time {_ms(result['meters']['data_time'].history)} ms [{card}]",
              flush=True)

        # A window of timed steps: WINDOW_EPOCHS capped epochs from chainE,
        # each step's batch_time and data_time read from its log line, with
        # bare steps of phase 7's model on either side.
        bare = bare_steps(REFERENCE_STEPS)
        _, result, out, launches = _loop_run(
            loop, mixed[:-1] + [os.path.join(tmp, "window"), "--epochs",
                                str(WINDOW_EPOCHS), "--print-freq", "1"], F, LOOP_STEPS)
        if launches != [n * WINDOW_EPOCHS for n in want]:
            fail(f"loop: window: kernel launches {launches}, expected "
                 f"{WINDOW_EPOCHS} x {want}")
        for row, n in zip(kernel_rows, launches):
            row["launches_loop"] += n
            row["launches"] += n
        logged = [(int(i), float(t) * 1e3, float(d) * 1e3)
                  for _, i, t, d in STEP_LINE.findall(out)]
        if len(logged) != WINDOW_EPOCHS * LOOP_STEPS:
            fail(f"loop: window: {len(logged)} step lines logged:\n{out[-2000:]}")
        bare = [t * 1e3 for t in bare + bare_steps(REFERENCE_STEPS)]
        bare_ms = statistics.median(bare)
        within = [t for i, t, _ in logged if i > 0]  # steps whose batch was prefetched
        starts = [t for i, t, _ in logged[1:] if i == 0]  # the loader restarted first
        warm = statistics.median(within)
        print(f"loop: window of {WINDOW_EPOCHS} capped epochs, batch_time "
              f"{[round(t, 1) for _, t, _ in logged]} ms, of it data_time "
              f"{[round(d, 1) for _, _, d in logged]} ms (the log's 1 ms steps); "
              f"median of the {len(within)} steps inside an epoch {warm:.1f} ms "
              f"(min {min(within):.1f}, max {max(within):.1f}) against bare "
              f"batch-{REFERENCE_BATCH} steps of phase 7's step function before and "
              f"after the run {[round(t, 1) for t in bare]} ms, median {bare_ms:.2f} ms "
              f"({warm / bare_ms - 1:+.1%}); median of the "
              f"{len(starts)} later epochs' first steps {statistics.median(starts):.1f} ms; "
              f"the run's first step {logged[0][1]:.1f} ms [{card}]", flush=True)

        # The CLI, stopped by SIGTERM after its first logged step.
        cli = mixed[:-1] + [os.path.join(tmp, "cli"), "--epochs", "500"]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-u", "-m", "pathtracker_torch.train",
                                 *cli], cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("Epoch: ["):
                    proc.send_signal(signal.SIGTERM)
                    break
            text = "".join(lines) + proc.communicate(timeout=300)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        folder = os.path.join(tmp, "cli", f"{TIMESTEPS}_1_{DISTRACTORS}", args.name)
        if proc.returncode != 0 or "terminated: logs + rolling checkpoint saved" not in text \
                or not os.path.exists(os.path.join(folder, "saved_models", ROLLING_NAME)):
            fail(f"loop: the CLI under SIGTERM exited {proc.returncode}:\n{text[-3000:]}")
        print(f"loop: python -m pathtracker_torch.train stopped by SIGTERM after its "
              f"first step: exit 0, rolling checkpoint written, "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

        # train_InT.sh as written: f32, the eager cell, seeded init.
        torch.cuda.reset_peak_memory_stats()
        _, result, _, launches = _loop_run(
            loop, base + ["--epochs", "1", "--results-dir", os.path.join(tmp, "f32")],
            F, LOOP_STEPS)
        if any(launches) or not np.isfinite(result["train_log"]["loss"]).all():
            fail(f"loop f32: kernel launches {launches}, losses {result['train_log']['loss']}")
        print(f"loop f32 (train_InT.sh as written): no kernel launched; steps "
              f"{_ms(result['meters']['batch_time'].history)} ms (the first cold); "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]", flush=True)
    return warm


def _render_shard(folder: str, split: str, count: int, seed: int) -> str:
    """One shard of ``count`` clips of ``split`` (the other split empty),
    rendered by make_synthetic_dataset in its own folder; the shard's path."""
    from pathtracker_torch.data.pathtracker import make_synthetic_dataset

    make_synthetic_dataset(folder, n_train=count if split == "train" else 0,
                           n_test=count if split == "test" else 0,
                           timesteps=TIMESTEPS, n_distractors=DISTRACTORS, speed=1,
                           shards=1, seed=seed)
    return os.path.join(folder, f"{split}-00000-of-00001.tfrecord")


def render_root(root: str, tmp: str) -> float:
    """RESIDENT_TRAIN + RESIDENT_VAL clips (dist 14, speed 1, T=64,
    2-pixel dots), a reference batch a shard, one process a shard; the
    seconds it took."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    jobs = ([("train", i) for i in range(RESIDENT_TRAIN // REFERENCE_BATCH)]
            + [("test", i) for i in range(RESIDENT_VAL // REFERENCE_BATCH)])
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    with ProcessPoolExecutor(RENDER_WORKERS, mp_context=get_context("spawn")) as pool:
        futures = [pool.submit(_render_shard, os.path.join(tmp, f"{split}{i}"), split,
                               REFERENCE_BATCH, 1000 + n)
                   for n, (split, i) in enumerate(jobs)]
        paths = [f.result() for f in futures]
    for (split, i), path in zip(jobs, paths):
        total = sum(1 for s, _ in jobs if s == split)
        os.replace(path, os.path.join(root, f"{split}-{i:05d}-of-{total:05d}.tfrecord"))
    return time.perf_counter() - t0


def window_account(models, opts, lr: float, steps: int) -> tuple[str, bool]:
    """Two models and optimizers after the same steps: an account,
    bit-identity first, and whether it holds WINDOW_SHARE's rule."""
    same, worst, share, moment = True, 0.0, 0.0, 0.0
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        gap = (a - b).abs()
        same = same and bool(torch.equal(a, b))
        worst = max(worst, gap.max().item())
        share = max(share, (gap > lr / 100).float().mean().item())
    for m0, m1 in zip(opts[0].mu + opts[0].nu, opts[1].mu + opts[1].nu):
        same = same and bool(torch.equal(m0, m1))
        rel = (m0 - m1).abs() / m1.abs().max().clamp_min(1e-30)
        moment = max(moment, (rel > 1e-3).float().mean().item())
    counts = [(o.count, o.mini_step) for o in opts]
    account = (f"{'bit-identical' if same else 'not bit-identical'}: largest weight gap "
               f"{worst:.3g} (held <= 2*lr*steps = {2 * lr * steps:.3g}), largest share "
               f"of a parameter's entries past lr/100 {share:.3g}, of a moment's past "
               f"1e-3 of its largest {moment:.3g} (held <= {WINDOW_SHARE}); optimizer "
               f"(count, mini_step) {counts[0]} and {counts[1]}")
    held = (worst <= 2 * lr * steps and share <= WINDOW_SHARE and moment <= WINDOW_SHARE
            and counts[0] == counts[1])
    return account, held


def window_gap(models, opts, lr: float, steps: int) -> str:
    account, held = window_account(models, opts, lr, steps)
    if not held:
        fail(f"resident windows and eager steps differ: {account}")
    return account


def windows_against_eager(pair, clips, labels, windows: int, start: int = 0,
                          kernels=()) -> tuple[list, list]:
    """Run ``windows`` windows of the graphed step, the first at step
    ``start``, and the same steps eagerly on the batches the windows gather;
    the (window, eager) losses, held within WINDOW_LOSS_ATOL, and the
    launches of each of ``kernels``' wrappers in the graphed calls alone."""
    graphed, eager = pair
    losses, done, launches = [], start, [0] * len(kernels)
    for _ in range(windows):
        before = [k.launches for k in kernels]
        stats = graphed(clips, labels)
        launches = [n + k.launches - b for n, k, b in zip(launches, kernels, before)]
        for j, loss in enumerate(np.atleast_1d(stats["loss"])):
            idx = graphed.indices(done + j)
            want = eager(clips.index_select(0, idx), labels.index_select(0, idx))
            losses.append((float(loss), float(want["loss"])))
        done += len(np.atleast_1d(stats["loss"]))
    if max(abs(a - b) for a, b in losses) > WINDOW_LOSS_ATOL:
        fail(f"resident window losses against eager steps: {losses}")
    return losses, launches


def _instance(kernel_name: str) -> str:
    """A kernel's name with its template arguments as resource_lines writes
    them ('corr_bwd_kernel<0, 1, 15>'); the bare name where it has none."""
    short = _short(kernel_name)
    match = re.search(re.escape(short) + r"<([^<>]*)>", kernel_name)
    if not match:
        return short
    args = [re.sub(r"^\(\w+\)", "", a.strip()) for a in match.group(1).split(",")]
    return f"{short}<{', '.join({'true': '1', 'false': '0'}.get(a, a) for a in args)}>"


def profile_window(fn, calls: int = 1) -> tuple[dict, dict, float, float]:
    """``calls`` calls of ``fn`` under torch.profiler (device activity
    only): ({kernel: count}, {kernel with its template arguments: count},
    the union of device busy ms, the calls' wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    counts, instances, spans = {}, {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[_short(e.name)] = counts.get(_short(e.name), 0) + 1
            instances[_instance(e.name)] = instances.get(_instance(e.name), 0) + 1
            spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return counts, instances, busy / 1e3, wall


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def _launch_shapes(native, seen: dict):
    """Record {kernel function: {(tensor shapes, integer arguments)}} of
    every native launch made inside."""
    launch = native.launch

    def recording(name, fn, tensors, ints, stream):
        seen.setdefault(fn, set()).add((tuple(tuple(t.shape) for t in tensors), tuple(ints)))
        return launch(name, fn, tensors, ints, stream)

    native.launch = recording
    try:
        yield
    finally:
        native.launch = launch


def _moment_gap(opts) -> float:
    """The largest gap between two optimizers' Adam moments, relative to
    the moment's largest entry."""
    return max(((m0 - m1).abs().max() / m1.abs().max().clamp_min(1e-30)).item()
               for m0, m1 in zip(opts[0].mu + opts[0].nu, opts[1].mu + opts[1].nu))


def _against_eager_runs(serve, dev, clips, labels, k: int):
    """A graph of ``k`` steps captured under cuDNN's default algorithms,
    the same steps eagerly, and a second eager run: (the models, the
    optimizers with the second run's last, [(graph, eager, second eager)
    loss of each step])."""
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    models, opts, (graphed, eager) = _resident_pair(serve, dev, int(labels.shape[0]), k)
    third = serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True, device=dev).train()
    opts.append(make_optimizer(LEARNING_RATE))
    other = make_train_step(third, "InT", opts[2])
    stats = graphed(clips, labels)
    losses = []
    for j, loss in enumerate(np.atleast_1d(stats["loss"])):
        idx = graphed.indices(j)
        batch = clips.index_select(0, idx), labels.index_select(0, idx)
        losses.append((float(loss), float(eager(*batch)["loss"]), float(other(*batch)["loss"])))
    return models, opts, losses


def default_algorithms_window(serve, dev, clips, labels) -> str:
    """Phase 13 (b): graphs captured under cuDNN's default algorithms (as
    the timed graphs and the CLI's are) against eager steps: one step, its
    loss and moments held at SPREAD_FACTOR times the gap between two eager
    runs (SPREAD_FLOORS where larger); a window of RESIDENT_K steps, its
    losses so held and its moment gap printed."""
    k = RESIDENT_K
    models, opts, losses = _against_eager_runs(serve, dev, clips, labels, 1)
    got = (abs(losses[0][0] - losses[0][1]), _moment_gap(opts[:2]))
    spread = (abs(losses[0][1] - losses[0][2]), _moment_gap(opts[1:]))
    bounds = [SPREAD_FACTOR * max(x, floor) for x, floor in zip(spread, SPREAD_FLOORS)]
    weight_gap = max((a - b).abs().max().item()
                     for a, b in zip(models[0].parameters(), models[1].parameters()))
    one = (f"a graph of one step captured under cuDNN's default algorithms against an "
           f"eager step from the same weights: losses (graph, eager, a second eager run) "
           f"{tuple(round(x, 6) for x in losses[0])}; loss gap and relative moment gap "
           f"{[f'{x:.3g}' for x in got]}, between the two eager runs "
           f"{[f'{x:.3g}' for x in spread]} (held <= {SPREAD_FACTOR} x each, at least "
           f"{SPREAD_FLOORS}: {[f'{x:.3g}' for x in bounds]}); largest weight gap "
           f"{weight_gap:.3g} (held <= 2*lr)")
    if (any(not x <= bound for x, bound in zip(got, bounds))
            or not np.isfinite(losses[0]).all() or not weight_gap <= 2 * LEARNING_RATE):
        fail(f"resident: {one}")
    del models, opts
    models, opts, losses = _against_eager_runs(serve, dev, clips, labels, k)
    account, _ = window_account(models, opts[:2], LEARNING_RATE, k)
    got = (max(abs(g - e) for g, e, _ in losses), _moment_gap(opts[:2]))
    spread = (max(abs(e - o) for _, e, o in losses), _moment_gap(opts[1:]))
    bound = SPREAD_FACTOR * max(spread[0], SPREAD_FLOORS[0])
    window = (f"a window of {k} steps so captured against {k} eager steps: losses "
              f"(window, eager, a second eager run) "
              f"{[tuple(round(x, 6) for x in t) for t in losses]}; largest loss gap "
              f"{got[0]:.3g}, between the two eager runs {spread[0]:.3g} (held <= "
              f"{bound:.3g}; the first loss within {WINDOW_LOSS_ATOL}); relative moment "
              f"gap {got[1]:.3g}, between the two eager runs {spread[1]:.3g} (printed); "
              f"window against eager {account}")
    if (not got[0] <= bound
            or abs(losses[0][0] - losses[0][1]) > WINDOW_LOSS_ATOL
            or not all(np.isfinite(t).all() for t in losses)
            or any(not torch.isfinite(p).all() for p in models[0].parameters())
            or max((a - b).abs().max().item() for a, b in zip(
                models[0].parameters(), models[1].parameters())) > 2 * LEARNING_RATE * k):
        fail(f"resident: {window}")
    return f"{one}; {window}"


def _resident_pair(serve, dev, n_clips, fused_steps, length=None, batch=None,
                   model="InT", **opt_kw):
    """The graphed resident step and the eager step on two copies of one
    model (chainE's weights for InT, the seeded init for rntsm); T=64 and
    batch 180 unless given."""
    length, batch = length or TIMESTEPS, batch or REFERENCE_BATCH
    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    if model == "InT":
        kw = dict(ckpt=CHECKPOINT, length=length, bf16=True, device=dev)
    else:
        kw = dict(model="rntsm", length=length, remat_blocks=True, device=dev)
    models = [serve.build(**kw).train() for _ in range(2)]
    opts = [make_optimizer(LEARNING_RATE, **opt_kw) for _ in range(2)]
    graphed = make_resident_train_step(models[0], model, opts[0], n_clips=n_clips,
                                       batch_size=batch, fused_steps=fused_steps)
    return models, opts, (graphed, make_train_step(models[1], model, opts[1]))


def resident_windows(serve, F, kernel_rows: list[dict], clips, labels, dev, card) -> None:
    """Phase 13 (b) and (c): windows of RESIDENT_K steps by graph replay
    against eager steps (the main path, its launch counts from 0), a replay
    under the profiler, and --accum-steps 2 across windows of 3."""
    import gc

    t2 = 2 * TIMESTEPS

    # (b) The main path: a window of RESIDENT_K steps by graph replay,
    # counts from 0, against eager steps; then a second replay.
    models, opts, pair = _resident_pair(serve, dev, int(labels.shape[0]), RESIDENT_K)
    per_window = [RESIDENT_K * t2] * 3 + [RESIDENT_K * TIMESTEPS] * 3
    for k in F.KERNELS:
        k.launches = 0
    for i in range(2):
        losses, launches = windows_against_eager(pair, clips, labels, 1,
                                                 start=RESIDENT_K * i, kernels=F.KERNELS)
        if i == 0:  # the warm-up and the capture
            if launches != [2 * e for e in per_window]:
                fail(f"resident: wrapper launches over the warm-up and capture "
                     f"{launches}, expected twice {per_window}")
            for row, count in zip(kernel_rows, launches):
                row["launches_resident"] = count
                row["launches"] += count
        elif any(launches):
            fail(f"resident: a replay called the wrappers {launches}")
        account = window_gap(models, opts, LEARNING_RATE, RESIDENT_K * (i + 1))
        print(f"resident: window {i + 1} of {RESIDENT_K} steps (batch {REFERENCE_BATCH}, "
              f"T={TIMESTEPS}, bf16, fused, chainE) by graph replay against {RESIDENT_K} "
              f"eager steps on the same batches (cudnn.deterministic): losses (window, "
              f"eager) {[(round(x, 6), round(y, 6)) for x, y in losses]} (held within "
              f"{WINDOW_LOSS_ATOL}); wrapper launches {launches}; weights and moments "
              f"{account}", flush=True)

    # (c) Launches per window, from the profiler over one replay.
    counts, _, busy, wall = profile_window(lambda: pair[0](clips, labels))
    seen = [counts.get(name, 0) for name in INT_CELL_KERNELS[:6]]
    if seen != per_window or counts.get("finish_kernel", 0) != 3 * RESIDENT_K * TIMESTEPS:
        fail(f"resident: one replay launched {counts}, expected {per_window} of "
             f"{INT_CELL_KERNELS[:6]}")
    for row, count in zip(kernel_rows, seen):
        row["launches_per_window"] = count
    print(f"resident: one replay of the {RESIDENT_K}-step graph launched "
          f"{dict(zip(INT_CELL_KERNELS[:6], seen))} and "
          f"{counts.get('finish_kernel')} finish_kernel (torch.profiler sees into the "
          f"replay): K x 2T forward and K x T backward a kernel; "
          f"{sum(counts.values())} device activities, busy {busy:.2f} of "
          f"{wall:.2f} ms under the profiler [{card}]", flush=True)
    del models, opts, pair
    gc.collect()
    torch.cuda.empty_cache()

    # (b') Accumulation over 2 across windows of 3: phases 0 then 1.
    models, opts, pair = _resident_pair(serve, dev, int(labels.shape[0]), 3, accum_steps=2)
    losses, _ = windows_against_eager(pair, clips, labels, 2)
    account = window_gap(models, opts, LEARNING_RATE, 6)
    print(f"resident: --accum-steps 2, two windows of 3 (the second starts at phase "
          f"1; graphs {sorted(pair[0].graphs)}): losses within "
          f"{max(abs(x - y) for x, y in losses):.3g} of eager; {account}", flush=True)
    del models, opts, pair
    gc.collect()
    torch.cuda.empty_cache()


def resident_times(serve, loader_steps, clips, labels, dev, loop_ms: float,
                   card: str) -> None:
    """Phase 13 (e): warm-step medians by mode, the streaming loop's first
    (``loader_steps()`` yields its device batches, an epoch a pass), then
    resident windows of each K over epochs of RESIDENT_EPOCH steps."""
    import gc

    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    b = REFERENCE_BATCH

    def build():
        return serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, bf16=True, device=dev).train()

    # The streaming loop: steps inside an epoch, and each epoch's first
    # (the loader's restart) apart.
    model = build()
    step = make_train_step(model, "InT", make_optimizer(LEARNING_RATE))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    within, firsts = [], []
    while len(within) < RESIDENT_TIMED:
        end = time.perf_counter()
        for i, batch in enumerate(loader_steps()):
            step(*batch)
            (firsts if i == 0 else within).append(time.perf_counter() - end)
            end = time.perf_counter()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    batches = [batch for batch, _ in zip(loader_steps(), range(3))]
    _, _, busy, _ = profile_window(lambda: [step(*x) for x in batches])
    med = statistics.median(within)
    print(f"resident times, streaming (the loop's path, batch {b}, T={TIMESTEPS}, bf16, "
          f"fused): in-epoch warm-step median {med * 1e3:.2f} ms over {len(within)} steps "
          f"(min {min(within) * 1e3:.2f}, max {max(within) * 1e3:.2f}), "
          f"{b / med:.1f} clips/s; phase 12's in-epoch median from the loop's log "
          f"{loop_ms:.1f} ms; each epoch's first step (the loader's restart) "
          f"{_ms(firsts)} ms, the run's first cold; device busy {busy / 3:.1f} ms a step "
          f"(torch.profiler over 3 steps), idle {1 - busy / 3 / (med * 1e3):.1%} of the "
          f"unprofiled median; peak device memory {peak / 2**30:.2f} GiB allocated, "
          f"{reserved / 2**30:.2f} GiB reserved [{card}]", flush=True)
    del model, step, batches
    gc.collect()
    torch.cuda.empty_cache()

    # Resident windows over epochs of RESIDENT_EPOCH steps, the clips and a
    # share of them again.
    n = RESIDENT_EPOCH * b
    data = torch.cat([clips, clips[:n - clips.shape[0]]])
    target = torch.cat([labels, labels[:n - labels.shape[0]]])
    for k in RESIDENT_KS:
        model = build()
        step = make_resident_train_step(model, "InT", make_optimizer(LEARNING_RATE),
                                        n_clips=n, batch_size=b, fused_steps=k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved()
        captures, times, done = [], [], 0
        while done < RESIDENT_EPOCH + RESIDENT_TIMED or done % RESIDENT_EPOCH:
            graphs = len(step.graphs)
            t0 = time.perf_counter()
            got = len(np.atleast_1d(step(data, target)["loss"]))
            seconds = time.perf_counter() - t0
            if len(step.graphs) > graphs:
                captures.append((got, seconds))
            elif done >= RESIDENT_EPOCH:
                times += [seconds / got] * got
            done += got
        peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
        held = torch.cuda.memory_reserved()
        calls = max(1, 4 // k)
        _, _, busy, _ = profile_window(lambda: step(data, target), calls)
        med = statistics.median(times)
        profiled = calls * min(k, RESIDENT_EPOCH)
        print(f"resident times, K={k} (epochs of {RESIDENT_EPOCH} steps; graphs "
              f"{sorted(step.graphs)}): warm-step median {med * 1e3:.2f} ms over "
              f"{len(times)} steps (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
              f"{b / med:.1f} clips/s; capture and warm-up of each graph "
              f"{[f'{s - g * med:.2f}' for g, s in captures]} s (the first window of each "
              f"length less that many warm steps); device busy {busy / profiled:.1f} ms a "
              f"step (torch.profiler over {profiled} steps), idle "
              f"{1 - busy / profiled / (med * 1e3):.1%} of the unprofiled median; peak "
              f"device memory {peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB "
              f"reserved (held after the run {held / 2**30:.2f}, before it "
              f"{before / 2**30:.2f}), all the run's graphs and "
              f"{(data.numel() + clips.numel()) / 1e9:.2f} GB of resident clips included "
              f"[{card}]", flush=True)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    del data, target


def remat_phase(serve, clips, labels, dev, card: str) -> None:
    """Phase 13 (f): train_InT.sh as written (f32, the eager cell) under
    each remat policy: gradients, then interleaved steps."""
    from pathtracker_torch.data.prepare import prepare_batch
    from pathtracker_torch.engine import model_step
    from pathtracker_torch.train.steps import make_optimizer, make_train_step
    from pathtracker_torch.utils.metrics import bce_with_logits

    b = REFERENCE_BATCH
    model = serve.build(ckpt=CHECKPOINT, length=TIMESTEPS, device=dev).train()
    if model.use_fused or not model.remat:
        fail("the f32 InT ran the fused cell or no remat")
    policies = ("full", "conv", "conv_gates")
    batches = [(clips[i * b:(i + 1) * b], labels[i * b:(i + 1) * b]) for i in range(2)]
    imgs, target = prepare_batch(*batches[0])
    params = [p for p in model.parameters() if p.requires_grad]
    grads = {}
    with _deterministic_cudnn():
        for policy in policies:
            model.remat_policy = policy
            loss = bce_with_logits(model_step(model, imgs, "InT")[0], target)
            grads[policy] = [torch.zeros_like(p) if g is None else g for p, g in zip(
                params, torch.autograd.grad(loss, params, allow_unused=True))]
    same = all(torch.equal(a, c) for policy in policies[1:]
               for a, c in zip(grads[policy], grads["full"]))
    worst = max(((a - c).abs() - REMAT_RTOL * c.abs()).max().item()
                for policy in policies[1:] for a, c in zip(grads[policy], grads["full"]))
    print(f"remat f32, batch {b}, T={TIMESTEPS}: gradients under 'conv' and "
          f"'conv_gates' against 'full' (cudnn.deterministic) "
          f"{'bit-identical' if same else 'not bit-identical'}"
          f" (largest |gap| - {REMAT_RTOL}|g| {worst:.3g}; held <= {REMAT_ATOL})",
          flush=True)
    if worst > REMAT_ATOL:
        fail("the remat policies' gradients differ")
    del grads, imgs, target
    step = make_train_step(model, "InT", make_optimizer(LEARNING_RATE))
    times, peaks = {p: [] for p in policies}, {p: 0 for p in policies}
    for i in range(REMAT_STEPS + 1):
        for policy in (policies if i % 2 == 0 else policies[::-1]):
            model.remat_policy = policy
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step(*batches[i % 2])
            torch.cuda.synchronize()
            if i > 0:  # the first round warms each policy
                times[policy].append(time.perf_counter() - t0)
            peaks[policy] = max(peaks[policy], torch.cuda.max_memory_allocated())
    for policy in policies:
        print(f"remat f32 '{policy}': step median {statistics.median(times[policy]) * 1e3:.2f}"
              f" ms over {REMAT_STEPS} warm steps ({_ms(times[policy])} ms); peak device "
              f"memory {peaks[policy] / 2**30:.2f} GiB [{card}]", flush=True)


def rntsm_resident(serve, Co, correlation_rows: list[dict], dev, card: str) -> None:
    """Phase 13 (g): an rntsm window of TSM_RESIDENT_K steps by graph replay
    (its own main path: counts from 0), against eager steps; the three
    correlation wrappers held against their plain versions at the shapes
    the window gave them; each kernel's launches in one replay."""
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.ops import _native

    rc, rl = render_batch(300, TSM_RESIDENT_CLIPS, TSM_RESIDENT_T, n_distractors=DISTRACTORS,
                          dot_size=DOT_SIZE)
    rc, rl = torch.from_numpy(rc).to(dev), torch.from_numpy(rl).to(dev)
    k = TSM_RESIDENT_K
    models, opts, pair = _resident_pair(serve, dev, TSM_RESIDENT_CLIPS, k,
                                        length=TSM_RESIDENT_T, batch=TSM_TRAIN_BATCH,
                                        model="rntsm")
    shapes = {}
    for kernel in Co.KERNELS:
        kernel.launches = 0
    with _deterministic_cudnn(), _launch_shapes(_native, shapes):
        losses, launches = windows_against_eager(pair, rc, rl, 1, kernels=Co.KERNELS)
    account = window_gap(models, opts, LEARNING_RATE, k)
    _, instances, _, _ = profile_window(lambda: pair[0](rc, rl))
    per_window = [instances.get(CORR_INSTANCES[row["name"]], 0) for row in correlation_rows]
    if launches != [2 * k] * 3 or per_window != [k] * 3:
        fail(f"rntsm resident: wrapper launches {launches} in the graphed window, one "
             f"replay {instances}")
    # The shapes the window gave the three wrappers: one (N, H, W, C, patch,
    # dilation) for all, f1 (the forward's first input) [N, H, W, C].
    seen = {args for fn in CORR_INSTANCES for _, args in shapes.get(fn, ())}
    if len(seen) != 1 or set(shapes) & set(CORR_INSTANCES) != set(CORR_INSTANCES):
        fail(f"rntsm resident: the correlation launches took {shapes}")
    n, h, w, c, patch, dilation = seen.pop()
    errs = correlation_errors(Co, *correlation_inputs(Co, n, h, w, c, patch, 5), patch,
                              dilation)
    for row, count, launched, err in zip(correlation_rows, per_window, launches, errs):
        row["launches_resident"] = launched
        row["launches"] += launched
        row["launches_per_window"] = count
        row["resident_shape"] = dict(n=n, max_abs_err=err)
    print(f"rntsm resident: a window of {k} steps (batch {TSM_TRAIN_BATCH}, "
          f"T={TSM_RESIDENT_T}, f32, remat) by graph replay against eager steps "
          f"(cudnn.deterministic): losses "
          f"{[(round(x, 6), round(y, 6)) for x, y in losses]}; {account}; wrapper launches "
          f"in the graphed window {launches} (warm-up and capture); one replay ran "
          f"{dict(zip(CORR_INSTANCES.values(), per_window))} (torch.profiler's names); "
          f"at the window's shape N={n} {h}x{w}x{c} patch {patch} dilation {dilation}, "
          f"max_abs_err against the plain versions fwd {errs[0]:.3g}, bwd_f1 {errs[1]:.3g}, "
          f"bwd_f2 {errs[2]:.3g} (held: {CORR_ATOL_FWD} forward, {CORR_ATOL_BWD} "
          f"backward) [{card}]", flush=True)


def resident_phase(serve, F, Co, kernel_rows: list[dict], correlation_rows: list[dict],
                   loop_ms: float) -> None:
    """--device-data and --fused-steps K: the resident dataset, each window
    one CUDA graph, against eager steps; the CLI; step times by mode; the
    eager cell's remat policies; an rntsm window."""
    import gc

    from pathtracker_torch.data import registry
    from pathtracker_torch.data.pipeline import tfr_data_loader
    from pathtracker_torch.data.resident import load_resident
    from pathtracker_torch.train import checkpoint as ckpt_lib
    from pathtracker_torch.train.loop import device_prefetch

    dev = torch.device(DEVICE)
    card = card_line()
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=os.path.join(tmp, "data"),
            PATHTRACKER_DOT_SIZE=str(DOT_SIZE),
            PATHTRACKER_SYNTH_TRAIN=str(RESIDENT_TRAIN),
            PATHTRACKER_SYNTH_TEST=str(RESIDENT_VAL)):
        # (a) The data, uploaded once.
        root = registry._config_dir(DISTRACTORS, 1, TIMESTEPS)
        render_s = render_root(root, os.path.join(tmp, "shards"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clips, labels = load_resident(os.path.join(root, "train-*"), TIMESTEPS, device=dev)
        val = load_resident(os.path.join(root, "test-*"), TIMESTEPS, device=dev)
        torch.cuda.synchronize()
        upload = time.perf_counter() - t0
        n = int(labels.shape[0])
        nbytes = sum(x.numel() * x.element_size() for x in (clips, labels, *val))
        if n != RESIDENT_TRAIN or int(val[1].shape[0]) != RESIDENT_VAL:
            fail(f"resident: loaded {n} + {int(val[1].shape[0])} clips")
        print(f"resident: rendered {RESIDENT_TRAIN} + {RESIDENT_VAL} clips (T={TIMESTEPS}, "
              f"dist {DISTRACTORS}, {DOT_SIZE}-pixel dots) with make_synthetic_dataset in "
              f"{RENDER_WORKERS} processes in {render_s:.2f} s; read and uploaded "
              f"{nbytes / 1e6:.1f} MB in {upload:.2f} s", flush=True)

        # (b) A graph captured under cuDNN's default algorithms.
        print(f"resident: {default_algorithms_window(serve, dev, clips, labels)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        # (b), (c) Graphs against eager steps, exactly.
        with _deterministic_cudnn():
            resident_windows(serve, F, kernel_rows, clips, labels, dev, card)

        # (d) The CLI: train_InT.sh's flags, 2 epochs, --bf16 --device-data
        # --fused-steps 4.
        argv = _launcher_argv() + ["--epochs", "2", "--bf16", "--device-data",
                                   "--fused-steps", str(RESIDENT_K), "--results-dir",
                                   os.path.join(tmp, "cli")]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pathtracker_torch.train", *argv],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        folder = os.path.join(tmp, "cli", f"{argv[argv.index('--length') + 1]}_1_"
                              f"{DISTRACTORS}", argv[argv.index("--name") + 1])
        rolling = os.path.join(folder, "saved_models", ROLLING_NAME)
        if proc.returncode != 0 or not os.path.exists(rolling):
            fail(f"resident CLI exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                 f"{proc.stderr[-3000:]}")
        losses = np.load(os.path.join(folder, "train.npz"))["loss"]
        vals = len(np.load(os.path.join(folder, "val.npz"))["loss"])
        count = int(ckpt_lib.load_checkpoint(rolling)["extra"]["opt_state"]["0"]["count"])
        spe = RESIDENT_TRAIN // REFERENCE_BATCH
        if (len(losses), vals, count) != (2 * spe, 2, 2 * spe) or not np.isfinite(losses).all():
            fail(f"resident CLI: losses {losses}, {vals} val entries, Adam count {count}")
        print(f"resident: python -m pathtracker_torch.train (train_InT.sh's flags, "
              f"--epochs 2 --bf16 --device-data --fused-steps {RESIDENT_K}) exit 0 in "
              f"{cli_s:.1f} s: {len(losses)} finite losses, {vals} val entries, the "
              f"rolling checkpoint's Adam count {count} [{card}]", flush=True)

        # (e) Step times by mode.
        loader = tfr_data_loader(data_dir=os.path.join(root, "train-*"),
                                 batch_size=REFERENCE_BATCH, drop_remainder=True,
                                 timesteps=TIMESTEPS, seed=0)
        resident_times(serve, lambda: device_prefetch(iter(loader), dev), clips, labels, dev,
                       loop_ms, card)
        del loader
        # (f) The remat policies.
        remat_phase(serve, clips, labels, dev, card)
        # (h) Data-parallel training on the same clips.
        parallel_phase(serve, F, kernel_rows, clips, labels, tmp, dev, card)
        del clips, labels, val
        gc.collect()
        torch.cuda.empty_cache()

    # (g) rntsm: a window of 2 steps through the correlation kernels.
    rntsm_resident(serve, Co, correlation_rows, dev, card)


# ------------------ phase 13 (h): data-parallel training --------------------

PARALLEL_RANKS = 2
PARALLEL_STEPS = 2  # held steps a side; a rank takes REFERENCE_BATCH / 2 clips
PARALLEL_TIMED = 3  # further steps a side on the same batches, timed only
# The ranks are held at tests/test_parallel.py's tolerances for JAX's sharded
# step: loss rtol 1e-4 and weights atol 5e-4 in bf16, 1e-5 and 2e-5 in f32.
# The weights by test_cuda_two_gloo_ranks_step_as_one_process's Adam rule:
# Adam's update is sign-like, lr*g/(|g|+eps) at the first step, so an entry
# whose gradient sits at rounding distance from zero may move by lr either
# way; the atol binds where the reference's gradient (the root of its second
# moment) clears PARALLEL_CUT of its parameter's largest, and at most
# PARALLEL_FLIPS of those entries may be past it.
#
# f32 (train_InT.sh as written, the eager cell) is held against one process
# on the global batch. The mixed bf16 cell (the main path, the K1-K3
# kernels) from chainE's weights at T=64 is not: a reordered f32 sum flips
# bf16 roundings that the 64-step recurrence carries to the loss and the
# gradient (one process on the same batches with their rows reversed, in an
# H100 call: step-1 loss 0.012% apart, step 2 0.71%, 69% of a parameter's
# entries past 5e-4). So bf16 is held against a witness: one process that
# computes the global batch the way the ranks do (_as_ranks): the cell's
# convs, kernels and hoisted projections and the readout each on a rank's
# clips, BN0/BN1 statistics from the ranks' E[x], E[x^2] summed as the
# all-reduce sums them, the loss the mean of the ranks' means. One process
# on the global batch, its run on the reversed rows, and one process with
# one piece at a time computed as the ranks compute it (PARALLEL_PIECES)
# are printed beside it, not held: they show where the ranks' gap to one
# process comes from.
PARALLEL_PATHS = {"bf16": dict(bf16=True, rtol=1e-4, atol=5e-4),
                  "f32": dict(bf16=False, rtol=1e-5, atol=2e-5)}
PARALLEL_CUT, PARALLEL_FLIPS = 1e-2, 1e-2
PARALLEL_PIECES = ("convs", "stats", "projections", "readout", "loss")  # see _as_ranks
PARALLEL_TIMEOUT = 300
# Phase 13 (e)'s resident step at K = 1, 4, 8, as PERF.md's section 5 records it.
RESIDENT_STEP_MS = "172.19-173.08"


def _parallel_steps(model, F, clips, labels, mesh, dev, timed: int = PARALLEL_TIMED) -> dict:
    """PARALLEL_STEPS held steps of make_train_step on the global batches
    ``clips[i]``, ``labels[i]`` (under ``mesh``, this rank's slice of each),
    then ``timed`` more on the same batches: the held steps' losses, every
    step's ms, the K1-K3 launches of the held steps, and after each held
    step the weights and the root of Adam's second moment, on the host."""
    from pathtracker_torch.parallel.mesh import data_group, shard_batch
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    opt = make_optimizer(LEARNING_RATE)
    step = make_train_step(model, "InT", opt)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    run = dict(losses=[], ms=[], launches=None, weights=[], rms=[])
    for k in F.KERNELS:
        k.launches = 0
    with data_group(mesh):
        for i in range(PARALLEL_STEPS + timed):
            batch = clips[i % PARALLEL_STEPS], labels[i % PARALLEL_STEPS]
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = step(*batch)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            if i < PARALLEL_STEPS:
                run["losses"].append(float(stats["loss"]))
                run["weights"].append({k: v.detach().to("cpu", copy=True)
                                       for k, v in model.state_dict().items()})
                run["rms"].append({n: v.sqrt().cpu() for n, v in zip(names, opt.nu)})
            if i == PARALLEL_STEPS - 1:
                run["launches"] = [k.launches for k in F.KERNELS]
    return run


def parallel_rank(rank: str, world: str, store: str, data: str, out: str) -> int:
    """One rank of phase 13 (h1), run as ``chip_smoke.py --parallel-rank``:
    gloo on the card, chainE's weights, _parallel_steps on its slices, the
    bf16 path then f32."""
    from pathtracker_torch.ops import int_fused as F
    from pathtracker_torch.parallel import distributed
    from pathtracker_torch.parallel.mesh import make_mesh

    dev = distributed.initialize(f"file://{store}", int(world), int(rank), backend="gloo")
    torch.backends.cudnn.deterministic = True  # as the one process it is held to
    try:
        clips, labels = (t.to(dev) for t in torch.load(data))
        mesh = make_mesh()
        torch.save({name: _parallel_steps(_chaine(path["bf16"], device=dev).train(), F, clips,
                                          labels, mesh,
                                          dev, PARALLEL_TIMED if path["bf16"] else 0)
                    for name, path in PARALLEL_PATHS.items()}, out)
        distributed.barrier("done")
    finally:
        distributed.shutdown()
    return 0


class _RankSum(torch.autograd.Function):
    """parallel/mesh.py's all-reduce for ranks that are parts of one
    process: each part gets the parts' sum, and in backward the sum of the
    parts' cotangents."""

    @staticmethod
    def forward(ctx, *parts):
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return tuple(total.clone() for _ in parts)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(grads[0]) if g is None else g for g in grads]
        return _RankSum.forward(ctx, *grads)


@contextlib.contextmanager
def _as_ranks(ranks: int, only: str | None = None):
    """The witness of phase 13 (h1): the fused InT on a global batch as
    ``ranks`` ranks of a data group compute it, in one process. Each rank's
    rows of the fused cell go through K1, the convs, K2 and K3 as on that
    rank (chunk i of the rows: clips [i*b, (i+1)*b)), with int_fused.stats
    on each part and the parts' [E[x], E[x^2]] summed as the all-reduce sums
    them; the hoisted input projections and the readout run on each rank's
    clips; the loss is the mean of the parts' means. ``only`` names one
    piece to compute as the ranks do, the rest as one process does:
    "convs" (the cell's two convs), "stats" (BN0/BN1's statistics),
    "projections", "readout" or "loss"."""
    from pathtracker_torch.models import common
    from pathtracker_torch.models import int_circuit as ic
    from pathtracker_torch.ops import int_fused as F
    from pathtracker_torch.train import steps

    conv_rows, dense, readout, bce = (ic._conv_rows, ic.dense, common.target_readout,
                                      steps.bce_with_logits)

    def rank_conv_rows(z, weight, shape):
        part = (shape[0] // ranks, *shape[1:])
        return torch.cat([conv_rows(p, weight, part) for p in z.chunk(ranks)])

    def rank_stats(parts):
        xs = [p.float() for p in parts]
        sums = [torch.stack([x.mean(dim=0), x.square().mean(dim=0)]) for x in xs]
        out = []
        for total in _RankSum.apply(*sums):  # int_fused.stats after its pmean
            mean, mean2 = (total / ranks).unbind()
            out.append((mean, torch.rsqrt(mean2 - mean.square() + F.BN_EPS)))
        return out

    def rank_step(cp, xt, carry, shape):  # int_circuit._int_cell_step_fused
        c, bf16 = shape[-1], torch.bfloat16
        part = (shape[0] // ranks, *shape[1:])
        inp, att_x, gi_x, inh, exc = (z.reshape(-1, c).chunk(ranks) for z in (*xt, *carry))
        k1 = [F.k1_attention(exc[i], att_x[i], cp["a_u"].to(bf16), cp["a_u_b"])
              for i in range(ranks)]
        conv_i = [conv_rows(gated, cp["w_inh"], part) for gated, _ in k1]
        conv_i32 = [z.float() for z in conv_i]  # each rank's f32 view, as the cell's
        new_inh = [F.k2_inhibition(
            conv_i[i], mean0, rstd0, cp["bn0_scale"], cp["bn0_bias"], inp[i], gi_x[i],
            inh[i], cp["i_u"].to(bf16), cp["i_u_b"], cp["alpha"], cp["mu"],
            conv_f32=conv_i32[i])
            for i, (mean0, rstd0) in enumerate(rank_stats(conv_i32))]
        conv_e = [conv_rows(z, cp["w_exc"], part) for z in new_inh]
        conv_e32 = [z.float() for z in conv_e]
        new_exc = [F.k3_excitation(
            conv_e[i], mean1, rstd1, cp["bn1_scale"], cp["bn1_bias"], new_inh[i], inh[i],
            k1[i][0], exc[i], cp["e_w"].to(bf16), cp["e_w_b"], cp["e_u"].to(bf16),
            cp["e_u_b"], cp["kappa"], cp["gamma"], conv_f32=conv_e32[i])
            for i, (mean1, rstd1) in enumerate(rank_stats(conv_e32))]
        return (torch.cat(new_inh), torch.cat(new_exc)), torch.cat([a for _, a in k1])

    def rank_dense(x, *a, **kw):  # the hoisted projections, [T, B, H, W, C]
        if x.dim() != 5:
            return dense(x, *a, **kw)
        return torch.cat([dense(p, *a, **kw) for p in x.chunk(ranks, dim=1)], dim=1)

    def rank_readout(mod, state, frame):
        return torch.cat([readout(mod, s, f)
                          for s, f in zip(state.chunk(ranks), frame.chunk(ranks))])

    def rank_bce(output, target):
        return sum(bce(o, t) for o, t in zip(output.chunk(ranks), target.chunk(ranks))) / ranks

    def ranks_stats(conv_out):
        return rank_stats(conv_out.chunk(ranks))[0]

    pieces = {"convs": (ic, "_conv_rows", rank_conv_rows), "stats": (F, "stats", ranks_stats),
              "projections": (ic, "dense", rank_dense),
              "readout": (common, "target_readout", rank_readout),
              "loss": (steps, "bce_with_logits", rank_bce)}
    patches = ([pieces[only]] if only else
               [(ic, "_int_cell_step_fused", rank_step)]
               + [pieces[k] for k in ("projections", "readout", "loss")])
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _adam_rule(got: dict, want: dict, rms: dict, atol: float) -> tuple[float, float]:
    """Two weight sets by the Adam rule (see PARALLEL_PATHS): the largest
    gap, and the largest share of a parameter's entries past ``atol`` among
    those whose ``rms`` clears PARALLEL_CUT of the parameter's largest."""
    worst, share = 0.0, 0.0
    for k, r in rms.items():
        gap = (got[k].float() - want[k].float()).abs()
        worst = max(worst, gap.max().item())
        clear = r > PARALLEL_CUT * r.max()
        if clear.any():
            share = max(share, ((gap > atol) & clear).sum().item() / clear.sum().item())
    return worst, share


def _relative(run, ref) -> list[str]:
    return [f"{abs(a - c) / abs(c):.3g}" for a, c in zip(run["losses"], ref["losses"])]


def _parallel_account(name: str, ranked: dict, ref: dict) -> tuple[str, bool]:
    """The ranks' run against its reference by PARALLEL_PATHS' tolerances:
    (the account, whether it holds)."""
    path = PARALLEL_PATHS[name]
    rules = [_adam_rule(w, v, r, path["atol"])
             for w, v, r in zip(ranked["weights"], ref["weights"], ref["rms"])]
    holds = (all(abs(a - c) <= path["rtol"] * abs(c)
                 for a, c in zip(ranked["losses"], ref["losses"]))
             and all(share <= PARALLEL_FLIPS for _, share in rules))
    account = (f"losses {[round(x, 7) for x in ranked['losses']]}, the reference's "
               f"{[round(x, 7) for x in ref['losses']]}: relative gaps "
               f"{_relative(ranked, ref)} (held <= {path['rtol']}); after each step the "
               f"largest weight gap {[f'{w:.3g}' for w, _ in rules]} and the largest share "
               f"of a parameter's entries past {path['atol']} where the gradient clears "
               f"{PARALLEL_CUT} of the parameter's largest {[f'{s:.3g}' for _, s in rules]} "
               f"(held <= {PARALLEL_FLIPS})")
    return account, holds


@contextlib.contextmanager
def _counted(module, name: str, record: list):
    """``module.name`` appends its arguments' shapes to ``record`` a call."""
    fn = getattr(module, name)

    def counting(tensor, *a, **kw):
        record.append(tuple(tensor.shape))
        return fn(tensor, *a, **kw)

    setattr(module, name, counting)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _eval_reduces(stats_calls: int) -> int:
    """The all-reduces of one eval step of the fused InT under a group: the
    cell's statistics (BN0 and BN1 a time step), the loss with the
    accuracy, and the meters' counts (its readout has no BatchNorm)."""
    return stats_calls + 2


def _collective_activity(trace: str) -> tuple[int, int, int]:
    """(device kernels named nccl*, device-to-device copies, device kernels)
    in a chrome trace torch.profiler wrote."""
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    copies = sum(1 for e in events
                 if e.get("cat") == "gpu_memcpy" and "DtoD" in e.get("name", ""))
    return sum("nccl" in k.lower() for k in kernels), copies, len(kernels)


def parallel_phase(serve, F, kernel_rows: list[dict], clips, labels, tmp: str, dev,
                   card: str) -> None:
    """Phase 13 (h): (h1) two gloo ranks on the card against one process;
    (h2) the loop over NCCL in a world of one against no group."""
    t_phase = time.perf_counter()
    parallel_ranks(F, kernel_rows, clips, labels, tmp, dev, card)
    parallel_nccl(F, kernel_rows, tmp, dev, card)
    print(f"parallel: phase 13 (h) {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def parallel_ranks(F, kernel_rows: list[dict], clips, labels, tmp: str, dev,
                   card: str) -> None:
    """Phase 13 (h1): two gloo ranks on the card, each a process of this
    script, against the references of PARALLEL_PATHS."""
    import gc

    b, t2 = REFERENCE_BATCH, 2 * TIMESTEPS
    n = PARALLEL_STEPS * b
    batches = (clips[:n].reshape(PARALLEL_STEPS, b, *clips.shape[1:]),
               labels[:n].reshape(PARALLEL_STEPS, b))
    data = os.path.join(tmp, "parallel.pt")
    torch.save(tuple(x.cpu() for x in batches), data)
    gc.collect()
    torch.cuda.empty_cache()

    outs = [os.path.join(tmp, f"parallel{r}.pt") for r in range(PARALLEL_RANKS)]
    logs = [os.path.join(tmp, f"parallel{r}.log") for r in range(PARALLEL_RANKS)]
    procs = []
    t0 = time.perf_counter()
    for r in range(PARALLEL_RANKS):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
                 str(PARALLEL_RANKS), os.path.join(tmp, "parallel.store"), data, outs[r]],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.time() + PARALLEL_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ranks_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as f:
                fail(f"parallel: rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
    ranks = [torch.load(o) for o in outs]
    want = {"bf16": [PARALLEL_STEPS * t2] * 3 + [PARALLEL_STEPS * TIMESTEPS] * 3,
            "f32": [0] * 6}
    for name in PARALLEL_PATHS:
        for r, rank in enumerate(ranks):
            run = rank[name]
            if run["launches"] != want[name]:
                fail(f"parallel: {name}: rank {r} launched the K1-K3 wrappers "
                     f"{run['launches']}, expected {want[name]}")
            if run["losses"] != ranks[0][name]["losses"] or any(
                    not torch.equal(v, ranks[0][name]["weights"][-1][k])
                    for k, v in run["weights"][-1].items()):
                fail(f"parallel: {name}: rank {r}'s losses or weights differ from rank 0's")

    order = torch.arange(b, device=dev).flip(0)
    runs = {}
    with _deterministic_cudnn():
        for name, bf16, witness, rows, timed in (
                ("bf16", True, None, None, PARALLEL_TIMED),
                ("bf16 as the ranks", True, {}, None, 0),
                *((f"bf16 {piece} as the ranks", True, dict(only=piece), None, 0)
                  for piece in PARALLEL_PIECES),
                ("bf16 rows reversed", True, None, order, 0),
                ("f32", False, None, None, 0)):
            model = _chaine(bf16, device=dev).train()
            data = batches if rows is None else (batches[0][:, rows], batches[1][:, rows])
            with (_as_ranks(PARALLEL_RANKS, **witness) if witness is not None
                  else contextlib.nullcontext()):
                runs[name] = _parallel_steps(model, F, *data, None, dev, timed)
            del model
    bf16, f32 = (_parallel_account(name, ranks[0][name], runs[ref])
                 for name, ref in (("bf16", "bf16 as the ranks"), ("f32", "f32")))
    print(f"parallel: {PARALLEL_RANKS} ranks on the card (gloo, CUDA tensors), each "
          f"{b // PARALLEL_RANKS} clips of the global {b} a step (T={TIMESTEPS}, chainE), "
          f"{PARALLEL_STEPS} steps, cudnn.deterministic; bf16 (the K1-K3 kernels) against "
          f"one process computing the global batch as the ranks do: {bf16[0]}; f32 (the "
          f"eager cell) against one process on the global batch: {f32[0]}; the ranks "
          f"bit-equal to each other; K1-K3 wrapper launches a rank "
          f"{ranks[0]['bf16']['launches']} in bf16 (counts from 0), none in f32; "
          f"{ranks_s:.1f} s for both processes [{card}]", flush=True)
    plain = runs["bf16"]
    print(f"parallel: bf16 relative loss gaps to one process on the global batch, step 1 "
          f"and 2: the ranks {_relative(ranks[0]['bf16'], plain)}, one process as the "
          f"ranks {_relative(runs['bf16 as the ranks'], plain)}, with only its "
          + ", ".join(f"{piece} {_relative(runs[f'bf16 {piece} as the ranks'], plain)}"
                      for piece in PARALLEL_PIECES)
          + f" as the ranks compute them, on the rows reversed "
          f"{_relative(runs['bf16 rows reversed'], plain)} (not held) [{card}]", flush=True)
    for r, rank in enumerate(ranks):
        ms = rank["bf16"]["ms"]
        print(f"parallel: bf16 rank {r} step ms {_ms([m / 1e3 for m in ms])}, median of "
              f"the warm {statistics.median(ms[1:]):.2f} ms; one process at batch {b}: "
              f"{_ms([m / 1e3 for m in plain['ms']])}, median of the warm "
              f"{statistics.median(plain['ms'][1:]):.2f} ms (gloo stages each BatchNorm "
              f"statistics' all-reduce through the host) [{card}]", flush=True)
    if not (bf16[1] and f32[1]):
        fail(f"parallel: {PARALLEL_RANKS} ranks against their references: bf16 "
             f"{'holds' if bf16[1] else 'fails'}, f32 {'holds' if f32[1] else 'fails'}")
    for row, count in zip(kernel_rows,
                          [sum(x) for x in zip(*(r["bf16"]["launches"] for r in ranks))]):
        row["launches_parallel"] = count
        row["launches"] += count
    del runs, ranks, batches
    gc.collect()
    torch.cuda.empty_cache()


def parallel_nccl(F, kernel_rows: list[dict], tmp: str, dev, card: str) -> None:
    """Phase 13 (h2): loop.main over NCCL in a world of one against the same
    run with no group."""
    import gc

    from pathtracker_torch.parallel import distributed
    from pathtracker_torch.train import loop

    t2 = 2 * TIMESTEPS
    argv = _launcher_argv() + ["--epochs", "2", "--bf16", "--device-data", "--fused-steps",
                               str(RESIDENT_K)]
    runs, reduces = {}, []
    # A process whose first torch.profiler session came in the NCCL run
    # traced no device copies in it (seen on the card); a throwaway session
    # comes first.
    profile_window(lambda: torch.zeros(1, device=dev).add_(1))
    with _deterministic_cudnn():
        for name, env in (("nccl", dict(COORDINATOR_ADDRESS="file://" + os.path.join(
                tmp, "nccl.store"), NUM_PROCESSES="1", PROCESS_ID="0")), ("alone", {})):
            folder = os.path.join(tmp, f"parallel-{name}")
            with _environ(**env), _counted(torch.distributed, "all_reduce", reduces):
                _, result, out, launches = _loop_run(
                    loop, argv + ["--results-dir", folder, "--profile",
                                  os.path.join(folder, "trace")], F, None)
            if distributed.is_initialized():
                fail("parallel: loop.main left its process group joined")
            runs[name] = (result, out, launches,
                          _collective_activity(os.path.join(folder, "trace", "trace.json")))
            del result
            gc.collect()
            torch.cuda.empty_cache()
    (group, out, launches, nccl), (alone, _, alone_launches, nccl_alone) = (
        runs["nccl"], runs["alone"])
    spe = RESIDENT_TRAIN // REFERENCE_BATCH
    val = 2 * (RESIDENT_VAL // REFERENCE_BATCH)
    # The all-reduces of one window: those of its warm-up and its capture,
    # less the validations' (one graph; any_rank and the barriers make none
    # in a world of one).
    per_window = (len(reduces) - val * _eval_reduces(2 * TIMESTEPS)) // 2
    want = ([2 * RESIDENT_K * t2 + val * TIMESTEPS] * 3 + [2 * RESIDENT_K * TIMESTEPS] * 3)
    same = (group["train_log"]["loss"] == alone["train_log"]["loss"]
            and group["val_log"] == alone["val_log"])
    if ("Loading parallel finished on device count: 1" not in out or not same
            or len(group["train_log"]["loss"]) != 2 * spe or launches != want
            or alone_launches != want or nccl_alone[0] != 0 or not per_window
            or nccl[0] + nccl[1] - nccl_alone[1] < per_window - RESIDENT_K):
        fail(f"parallel: NCCL world of one: same losses and validation {same}, "
             f"{len(group['train_log']['loss'])} losses, launches {launches} and "
             f"{alone_launches} (expected {want}), (nccl kernels, device-to-device "
             f"copies, kernels) in a replay {nccl} and {nccl_alone} alone, {per_window} "
             f"all-reduces a window:\n{out[-2000:]}")
    for row, count in zip(kernel_rows, launches):
        row["launches_parallel"] += count
        row["launches"] += count
    group_ms = statistics.median(group["meters"]["batch_time"].history) * 1e3
    alone_ms = statistics.median(alone["meters"]["batch_time"].history) * 1e3
    print(f"parallel: loop.main over NCCL in a world of one (COORDINATOR_ADDRESS, "
          f"NUM_PROCESSES=1; train_InT.sh's flags, --epochs 2 --bf16 --device-data "
          f"--fused-steps {RESIDENT_K}) against the same run with no group, "
          f"cudnn.deterministic: {2 * spe} losses and {len(group['val_log']['loss'])} "
          f"validations bit-equal; the profiled replay of a {RESIDENT_K}-step window "
          f"ran {nccl[0]} NCCL kernels and {nccl[1]} device-to-device copies, alone "
          f"{nccl_alone[0]} and {nccl_alone[1]}, of {nccl[2]} and {nccl_alone[2]} "
          f"kernels: the window's {per_window} all-reduces through ProcessGroupNCCL at "
          f"capture each copy their input first, but the {RESIDENT_K} gradient buckets "
          f"(held >= {per_window - RESIDENT_K} more copies), and NCCL's in-place sum over "
          f"a world of one moves nothing; K1-K3 wrapper launches "
          f"{launches} (warm-up and capture of one graph, and validation); epoch 1's "
          f"replayed steps median {group_ms:.2f} ms over NCCL, {alone_ms:.2f} ms alone "
          f"(phase 13's resident step {RESIDENT_STEP_MS} ms) [{card}]", flush=True)


# ------------------ phase 13 (i): model-parallel training -------------------

MP_RANKS = 2
# (i1) rntsm at the registry's width under FSDP: phase 10's global batch
# (4 clips, T=64, f32), 2 a rank, 2 SGD steps at 1e-2 from the seeded init
# (SGD as tests/test_parallel.py's rntsm FSDP test: the update is the
# gradient, where Adam's sign-like first update flips the entries whose
# gradient sits at rounding distance from zero), under cudnn.deterministic,
# against one process that computes the global batch as the ranks do
# (_as_data_ranks: each BatchNorm's statistics from the two halves' E[x],
# E[x^2] summed as the all-reduce sums them, the loss the mean of the
# halves'). Step 1: the loss within rtol 1e-5 (test_parallel's f32), and
# the update by test_torch_tsm_steps.py's rule for f32 ResNet gradients,
# normalised by the parameter's largest: within 0.1 but for 2 entries a
# parameter, the mean of the other entries within 2e-2. Step 2 starts from
# weights that differ by the order of the gradient's f32 sums (the ranks'
# halves reduced, against one backward), which flips a ReLU mask or an
# argmax here and there (a rehearsal on the CPU at T=4: step-2 loss 1.9e-5
# apart, 79 of a BatchNorm's 1,024 update entries past 0.1), so its loss is
# held to a twentieth of the move the step makes (weights left stale or
# updated twice would miss it by the whole move; at this rate step 1
# lifts the loss from 0.7286 to 1.0376, a move of 0.309) and its update
# printed. One process on the global batch is printed beside it, not held:
# it was 1.06e-5 from the ranks at step 1 (the statistics' summation order
# through 53 BatchNorms) and 5.6e-4 at step 2. Before each comparison the
# kernels are held against their plain versions at the ranks' shapes.
MP_RNTSM_STEPS = 2
MP_RNTSM_LR = 1e-2
MP_RNTSM_TOL = dict(rtol=1e-5, update=0.1, flips=2, mean=2e-2, move=0.05)
# (i2) InT at train_InT.sh's width from chainE, --bf16, dp x tp and dp x sp
# as 1 x 2: one step of a global batch of 32 clips, cut from 180 so that
# gloo's host copies (a collective a conv, a projection and a BatchNorm
# statistic, each time step) stay short. Held by PARALLEL_PATHS["bf16"]
# (test_parallel's: loss rtol 1e-4, weights atol 5e-4 by the Adam rule) against
# one process that computes the batch as the ranks do (_as_model_ranks: the
# convs and projections by output-channel halves; _as_space_ranks: the
# convs by halves of H with their halo rows, BN0/BN1's statistics from the
# halves' E[x], E[x^2] summed as the all-reduce sums them, the readout's
# pool the halves' mean): phase 13 (h) found a reordered f32 sum of the
# statistics carried by the bf16 recurrence to 0.72% of the step-1 loss at
# T=64, so one process on the batch is printed beside it, not held.
MP_INT_BATCH = 32
MP_TIMEOUT = 300
MP_DRYRUN_RANKS = 4
MP_DRYRUN_MODES = ("dp step ok", "fsdp step ok", "rntsm fsdp step ok", "dp x tp step ok",
                   "dp x sp step ok", "dp x ep moe step ok", "pp x dp pipeline step ok")


class _SGD:
    """Plain SGD with the Optimizer's binding (``init``, ``step``): its
    update is the gradient itself."""

    def __init__(self, lr: float):
        self.lr, self.params = lr, None

    def init(self, params):
        self.params = [p.detach() for p in params]
        return self

    @torch.no_grad()
    def step(self, grads):
        for p, g in zip(self.params, grads, strict=True):
            if g is not None:
                p.sub_(self.lr * g)


def _mp_steps(model, model_name: str, F, Co, layout, clips, labels, steps: int,
              sgd: float | None = None) -> dict:
    """``steps`` Adam steps (SGD steps at ``sgd``) of make_train_step on a
    global batch, under ``layout`` (this rank's block of the batch) or none:
    the losses, the whole weights before and after each step (gather_params
    under a layout) and, with no layout, the root of Adam's second moment;
    the K1-K3 and correlation launches from 0; each step's ms; the peak
    memory this process allocated over the steps."""
    from pathtracker_torch.parallel.mesh import gather_params
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    opt = _SGD(sgd) if sgd else make_optimizer(LEARNING_RATE)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    start = (gather_params(layout) if layout is not None else
             {n: p.detach() for n, p in model.named_parameters() if p.requires_grad})
    start = {k: v.to("cpu", copy=True) for k, v in start.items()}
    step = make_train_step(model, model_name, opt, layout=layout)
    batch = (clips, labels) if layout is None else layout.local_batch((clips, labels))
    run = dict(losses=[], weights=[start], rms=[], ms=[])
    for k in (*F.KERNELS, *Co.KERNELS):
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = step(*batch)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        if not all(np.isfinite(v) for v in stats.values()):
            fail(f"model parallel: {model_name} stats {stats}")
        run["losses"].append(float(stats["loss"]))
        weights = (gather_params(layout) if layout is not None
                   else dict(zip(names, (p.detach() for p in opt.params))))
        run["weights"].append({k: v.to("cpu", copy=True) for k, v in weights.items()})
        if layout is None and not sgd:
            run["rms"].append({n: v.sqrt().cpu() for n, v in zip(names, opt.nu)})
    run["launches"] = [k.launches for k in F.KERNELS]
    run["corr_launches"] = [k.launches for k in Co.KERNELS]
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if layout is not None:
        run["specs"] = layout.specs
        run["shards"] = dict(zip(layout.names, (tuple(s.shape) for s in layout.shards)))
        run["empty"] = all(p.numel() == 0 for p in layout.params)
    return run


def _rntsm_model(dev):
    from pathtracker_torch.eval import serve

    return serve.build(model="rntsm", length=TIMESTEPS, remat_blocks=True, device=dev).train()


def model_parallel_rank(rank: str, world: str, store: str, data: str, out: str) -> int:
    """One rank of phase 13 (i1) and (i2), run as ``chip_smoke.py
    --model-parallel-rank``: gloo on the card; rntsm under FSDP over the
    world, then chainE's InT under dp x tp and dp x sp (1 x world)."""
    from pathtracker_torch.ops import correlation as Co
    from pathtracker_torch.ops import int_fused as F
    from pathtracker_torch.parallel import distributed
    from pathtracker_torch.parallel import mesh as M

    dev = distributed.initialize(f"file://{store}", int(world), int(rank), backend="gloo")
    torch.backends.cudnn.deterministic = True  # as the one process it is held to
    try:
        batches = {k: tuple(t.to(dev) for t in v) for k, v in torch.load(data).items()}
        model = _rntsm_model(dev)
        runs = {"rntsm": _mp_steps(model, "rntsm", F, Co,
                                   M.fsdp_shard_params(M.make_mesh(), model),
                                   *batches["rntsm"], MP_RNTSM_STEPS, sgd=MP_RNTSM_LR)}
        del model
        torch.cuda.empty_cache()
        n = int(world)
        for name, layout_of in (
                ("tp", lambda m: M.shard_params_2d(M.make_mesh_2d(1, n), m)),
                ("sp", lambda m: M.spatial_layout(M.make_mesh_2d(1, n, ("data", "space")), m))):
            model = _chaine(True, device=dev).train()
            runs[name] = _mp_steps(model, "InT", F, Co, layout_of(model), *batches["int"], 1)
            del model
        torch.save(runs, out)
        distributed.barrier("done")
    finally:
        distributed.shutdown()
    return 0


@contextlib.contextmanager
def _patched(*patches):
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    for module, name, fn in patches:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _as_data_ranks(ranks: int):
    """The witness of phase 13 (i1): one process computing rntsm's global
    batch as ``ranks`` ranks of a data group do: each BatchNorm's
    statistics from the ranks' blocks of the frames (E[x] and E[x^2] of
    each, summed in rank order and divided, as layers.batch_norm's pmean),
    the loss the mean of the blocks' BCE (as the averaged gradients and the
    logged pmean)."""
    from pathtracker_torch.models import tsm_resnet
    from pathtracker_torch.train import steps

    bce = steps.bce_with_logits

    def batch_norm(x, scale, bias, eps: float = 1e-3):
        dims = tuple(range(x.dim() - 1))
        total = None
        for block in x.chunk(ranks, dim=0):
            xs = block.float()
            part = torch.stack([xs.mean(dim=dims), xs.square().mean(dim=dims)])
            total = part if total is None else total + part
        mean, mean2 = (total / ranks).unbind()
        inv = torch.rsqrt(mean2 - mean.square() + eps)
        return ((x - mean.to(x.dtype)) * (inv.to(x.dtype) * scale.to(x.dtype))
                + bias.to(x.dtype))

    def loss(output, target):
        total = None
        for o, t in zip(output.chunk(ranks), target.chunk(ranks)):
            part = bce(o, t)
            total = part if total is None else total + part
        return total / ranks

    return _patched((tsm_resnet, "batch_norm", batch_norm), (steps, "bce_with_logits", loss))


def _as_model_ranks(ranks: int):
    """The witness of phase 13 (i2) dp x tp: one process computing the InT
    step as a model group of ``ranks`` does, every conv and projection whose
    output width ``ranks`` divides by blocks of output channels,
    concatenated (parallel.mesh.model_split on one process)."""
    from pathtracker_torch.ops import layers

    def split(op, weight_dim, out_dim):
        def parts(x, w, **kw):
            cout = w.shape[weight_dim]
            if cout % ranks or cout < ranks or kw.get("groups", 1) != 1:
                return op(x, w, **kw)
            ys = [op(x, wp, **kw) for wp in w.chunk(ranks, dim=weight_dim)]
            return torch.cat(ys, dim=out_dim % ys[0].dim())
        return parts

    return _patched((layers, "model_split", split))


def _as_space_ranks(ranks: int, side: int):
    """The witness of phase 13 (i2) dp x sp: one process computing the InT
    step as a space group of ``ranks`` does on clips of ``side`` rows: each
    k x k conv by blocks of H with their halo rows (zeros past the image),
    laid out as collectives.with_halo lays them; BN0/BN1's statistics from
    each block's E[x], E[x^2], summed in rank order and divided as the
    all-reduce and pmean do; the readout's pool the blocks' means, summed."""
    from pathtracker_torch.models import common
    from pathtracker_torch.ops import int_fused as F
    from pathtracker_torch.ops import layers
    from pathtracker_torch.parallel.collectives import with_halo

    h = side // ranks

    def halo(conv, kernel_h):
        if kernel_h == 1:
            return conv
        above, below = (kernel_h - 1) // 2, kernel_h // 2

        def parts(x, w, **kw):
            outs = []
            for r in range(ranks):
                top = (x[:, :, r * h - above:r * h] if r > 0
                       else x.new_zeros((*x.shape[:2], above, x.shape[3])))
                bottom = (x[:, :, (r + 1) * h:(r + 1) * h + below] if r < ranks - 1
                          else x.new_zeros((*x.shape[:2], below, x.shape[3])))
                piece = with_halo(top.contiguous(), x[:, :, r * h:(r + 1) * h],
                                  bottom.contiguous(), 2)
                outs.append(conv(piece, w, **kw).narrow(2, above, h))
            return torch.cat(outs, dim=2)
        return parts

    def stats(conv_out):
        c = conv_out.shape[-1]
        blocks = conv_out.view(-1, side, side, c).chunk(ranks, dim=1)
        total = None
        for block in blocks:
            x = block.reshape(-1, c).float()
            part = torch.stack([x.mean(dim=0), x.square().mean(dim=0)])
            total = part if total is None else total + part
        mean, mean2 = (total / ranks).unbind()
        return mean, torch.rsqrt(mean2 - mean.square() + F.BN_EPS)

    def pool(x):
        total = None
        for block in x.chunk(ranks, dim=1):
            part = block.mean(dim=(1, 2))
            total = part if total is None else total + part
        return total / ranks

    return _patched((layers, "space_split", halo), (F, "stats", stats),
                    (common, "global_avg_pool", pool))


def _update_account(got: dict, ref: dict, tol: dict) -> tuple[str, bool]:
    """A ranks' SGD run against its reference (MP_RNTSM_TOL): step 1's loss
    within ``tol["rtol"]`` and its update against the reference's,
    normalised by the parameter's largest update entry, at most
    ``tol["flips"]`` entries past ``tol["update"]`` and the mean gap of the
    others within ``tol["mean"]``; each later step's loss within
    ``tol["move"]`` of the move the reference's step makes, its update
    printed."""
    rows = []
    for i in range(1, len(ref["weights"])):
        worst, mean, flips = (0.0, ""), (0.0, ""), (0, "")
        for k, w in ref["weights"][i].items():
            d_ref = w - ref["weights"][i - 1][k]
            d_got = got["weights"][i][k] - got["weights"][i - 1][k]
            gap = (d_got - d_ref).abs() / d_ref.abs().max().clamp_min(1e-30)
            tag = f"{k} ({d_ref.numel()} entries)"
            rest = gap.flatten().sort().values[:max(gap.numel() - tol["flips"], 1)]
            worst = max(worst, (gap.max().item(), tag))
            mean = max(mean, (rest.mean().item(), tag))
            flips = max(flips, (int((gap > tol["update"]).sum()), tag))
        rows.append((worst, mean, flips))
    (_, _), (mean1, _), (flips1, _) = rows[0]
    gaps = [abs(a - c) for a, c in zip(got["losses"], ref["losses"])]
    moves = [abs(b - a) for a, b in zip(ref["losses"], ref["losses"][1:])]
    holds = (gaps[0] <= tol["rtol"] * abs(ref["losses"][0]) and flips1 <= tol["flips"]
             and mean1 <= tol["mean"]
             and all(g <= tol["move"] * m for g, m in zip(gaps[1:], moves)))
    updates = "; ".join(
        f"step {i + 1} largest gap {w[0]:.3g} (in {w[1]}), at most {f[0]} entries of a "
        f"parameter past {tol['update']} (in {f[1]}), largest mean gap of the rest "
        f"{m[0]:.3g} (in {m[1]})" for i, (w, m, f) in enumerate(rows))
    return (f"losses {got['losses']} against {ref['losses']}: relative gaps "
            f"{_relative(got, ref)} (step 1 held <= {tol['rtol']}; later steps' gaps "
            f"{[f'{g:.3g}' for g in gaps[1:]]} held <= {tol['move']} x the step's move "
            f"{[f'{m:.3g}' for m in moves]}); each step's update against the reference's, "
            f"normalised by the parameter's largest: {updates} (step 1 held: <= "
            f"{tol['flips']} entries past {tol['update']}, mean <= {tol['mean']})"), holds


def model_parallel_phase(F, Co, kernel_rows: list[dict], correlation_rows: list[dict],
                         card: str) -> None:
    """Phase 13 (i): (i1) rntsm under FSDP and (i2) chainE under dp x tp and
    dp x sp, two gloo ranks on the card against one process; (i3) the dry
    run at 4 ranks; (i4) FSDP, TP and SP meshes of one over NCCL against no
    group."""
    import gc

    from pathtracker_torch.data.pathtracker import render_batch

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    os.makedirs(BUILD, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        batches = {"rntsm": render_batch(200, TSM_TRAIN_BATCH, TIMESTEPS,
                                         n_distractors=DISTRACTORS, dot_size=DOT_SIZE),
                   "int": render_batch(40, MP_INT_BATCH, TIMESTEPS,
                                       n_distractors=DISTRACTORS, dot_size=DOT_SIZE)}
        batches = {k: tuple(torch.from_numpy(a) for a in v) for k, v in batches.items()}
        data = os.path.join(tmp, "batches.pt")
        torch.save(batches, data)
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(MP_RANKS)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(MP_RANKS)]
        t0 = time.perf_counter()
        procs = []
        for r in range(MP_RANKS):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--model-parallel-rank",
                     str(r), str(MP_RANKS), os.path.join(tmp, "store"), data, outs[r]],
                    cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.time() + MP_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        ranks_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(logs[r]) as f:
                    fail(f"model parallel: rank {r} exited {p.returncode}:\n{f.read()[-4000:]}")
        ranks = [torch.load(o) for o in outs]

        # The ranks against each other: one loss, one set of whole weights.
        for name in ("rntsm", "tp", "sp"):
            for r, rank in enumerate(ranks):
                run = rank[name]
                if (run["losses"] != ranks[0][name]["losses"] or not run["empty"]
                        or any(not torch.equal(v, ranks[0][name]["weights"][-1][k])
                               for k, v in run["weights"][-1].items())):
                    fail(f"model parallel: {name}: rank {r}'s losses or weights differ from "
                         "rank 0's, or its module kept whole weights")

        # (i1) rntsm under FSDP against one process on the global batch.
        rntsm = ranks[0]["rntsm"]
        wide = {k: s for k, s in rntsm["specs"].items()
                if k.startswith("layer4.") and k.endswith(".weight") and "conv" in k}
        full = rntsm["weights"][0]
        halves = all("data" in s and rntsm["shards"][k] == tuple(
            d // MP_RANKS if a == "data" else d for d, a in zip(full[k].shape, s))
            for k, s in wide.items())
        sharded = sum(full[k].numel() for k, s in rntsm["specs"].items() if "data" in s)
        total = sum(v.numel() for v in full.values())
        if not wide or not halves:
            fail(f"model parallel: rntsm's layer-4 kernels are not split in halves over "
                 f"'data': {[(k, wide[k], rntsm['shards'].get(k)) for k in list(wide)[:4]]}")
        for r, rank in enumerate(ranks):
            if rank["rntsm"]["corr_launches"] != [MP_RNTSM_STEPS] * 3:
                fail(f"model parallel: rntsm rank {r} launched the correlation wrappers "
                     f"{rank['rntsm']['corr_launches']}, expected {[MP_RNTSM_STEPS] * 3}")
        # The correlation kernels against their plain versions at a rank's
        # shape: its clips' frame pairs.
        n = TSM_TRAIN_BATCH // MP_RANKS * (TIMESTEPS - 1)
        errs = correlation_errors(Co, *correlation_inputs(Co, n, SIDE, SIDE, CORR_C, PATCH, 7),
                                  PATCH, 1)
        print(f"model parallel: gap (i1) correlation kernels at a rank's shape N={n} "
              f"{SIDE}x{SIDE}x{CORR_C} patch {PATCH} against their plain versions: "
              f"max_abs_err fwd {errs[0]:.3g} atol {CORR_ATOL_FWD}, bwd_f1 {errs[1]:.3g} "
              f"atol {CORR_ATOL_BWD}, bwd_f2 {errs[2]:.3g} atol {CORR_ATOL_BWD}", flush=True)
        with _deterministic_cudnn():
            rclips, rlabels = (t.to(dev) for t in batches["rntsm"])
            plain = _mp_steps(_rntsm_model(dev), "rntsm", F, Co, None, rclips, rlabels, 1,
                              sgd=MP_RNTSM_LR)
            gc.collect()
            torch.cuda.empty_cache()
            with _as_data_ranks(MP_RANKS):
                ref = _mp_steps(_rntsm_model(dev), "rntsm", F, Co, None, rclips, rlabels,
                                MP_RNTSM_STEPS, sgd=MP_RNTSM_LR)
        gc.collect()
        torch.cuda.empty_cache()
        rntsm_account, rntsm_holds = _update_account(rntsm, ref, MP_RNTSM_TOL)
        print(f"model parallel: rntsm (ResNet-50 + MotionSqueeze, {total:,} parameters, "
              f"T={TIMESTEPS}, f32, remat) under FSDP over {MP_RANKS} gloo ranks on the card, "
              f"global batch {TSM_TRAIN_BATCH}, {MP_RNTSM_STEPS} SGD({MP_RNTSM_LR:g}) steps, "
              f"cudnn.deterministic, against one process computing the global batch as "
              f"the ranks do: {rntsm_account}; one process on the global batch: step-1 "
              f"relative loss gap {_relative(rntsm, plain)} (printed); {len(wide)} layer-4 "
              f"kernels split in halves over 'data' "
              f"({sharded:,} of {total:,} parameter entries sharded: between steps each "
              f"rank stores {(total - sharded + sharded / MP_RANKS) / total:.3f} of the "
              f"weights, by their shapes; during a step it holds the whole weights and "
              f"their whole gradients); peak memory allocated over the steps "
              f"{[round(r['rntsm']['peak_gib'], 2) for r in ranks]} GiB a rank (batch "
              f"{TSM_TRAIN_BATCH // MP_RANKS}), the witness {ref['peak_gib']:.2f} GiB, one "
              f"process {plain['peak_gib']:.2f} GiB (batch {TSM_TRAIN_BATCH}); correlation "
              f"wrapper launches a rank "
              f"{[r['rntsm']['corr_launches'] for r in ranks]} (forward, bwd_f1, bwd_f2); "
              f"step ms a rank {[f'{m:.1f}' for m in rntsm['ms']]}, the witness "
              f"{[f'{m:.1f}' for m in ref['ms']]}, one process "
              f"{[f'{m:.1f}' for m in plain['ms']]} [{card}]", flush=True)
        print(f"model parallel: gap (i1) loss {_relative(rntsm, ref)} rtol "
              f"{MP_RNTSM_TOL['rtol']}; updates by test_torch_tsm_steps.py's rule "
              f"({MP_RNTSM_TOL['update']}, {MP_RNTSM_TOL['flips']} entries, mean "
              f"{MP_RNTSM_TOL['mean']})", flush=True)
        del ref, plain
        gc.collect()
        torch.cuda.empty_cache()

        # (i2) chainE under dp x tp and dp x sp against their witnesses; the
        # K1-K3 kernels against their plain versions at the ranks' rows: a
        # model rank's (and the meshes of one's) whole batch, a space rank's
        # half of H.
        loop_shape_kernel_check(F, MP_INT_BATCH, "model parallel: gap (i2) dp x tp")
        loop_shape_kernel_check(F, MP_INT_BATCH // MP_RANKS, "model parallel: gap (i2) dp x sp")
        clips, labels = (t.to(dev) for t in batches["int"])
        want = [2 * TIMESTEPS] * 3 + [TIMESTEPS] * 3
        accounts, holds = {}, []
        with _deterministic_cudnn():
            plain = _mp_steps(_chaine(True).train(), "InT", F, Co, None, clips, labels, 1)
            for name, witness in (("tp", _as_model_ranks(MP_RANKS)),
                                  ("sp", _as_space_ranks(MP_RANKS, SIDE))):
                for r, rank in enumerate(ranks):
                    if rank[name]["launches"] != want:
                        fail(f"model parallel: {name}: rank {r} launched the K1-K3 wrappers "
                             f"{rank[name]['launches']}, expected {want}")
                with witness:
                    ref = _mp_steps(_chaine(True).train(), "InT", F, Co, None, clips, labels, 1)
                account, ok = _parallel_account("bf16", *(
                    {**run, "weights": run["weights"][1:]} for run in (ranks[0][name], ref)))
                accounts[name] = (account, _relative(ranks[0][name], plain),
                                  ranks[0][name]["ms"], ref["ms"])
                holds.append(ok)
                print(f"model parallel: gap (i2) {name} loss {_relative(ranks[0][name], ref)} "
                      f"rtol {PARALLEL_PATHS['bf16']['rtol']}; weights by the Adam rule atol "
                      f"{PARALLEL_PATHS['bf16']['atol']}", flush=True)
        tp_specs = ranks[0]["tp"]["specs"]
        split = sorted(k for k, s in tp_specs.items() if "model" in s)
        for name, title in (("tp", "dp x tp (1 x 2: output channels over 'model')"),
                            ("sp", "dp x sp (1 x 2: rows of H over 'space')")):
            account, gap, ms, ref_ms = accounts[name]
            print(f"model parallel: InT {title} from chainE, --bf16 (the K1-K3 kernels), "
                  f"T={TIMESTEPS}, global batch {MP_INT_BATCH}, one Adam step, "
                  f"cudnn.deterministic, against one process computing the batch as the "
                  f"ranks do: {account}; one process on the batch: relative loss gap {gap} "
                  f"(printed); K1-K3 wrapper launches a rank "
                  f"{[r[name]['launches'] for r in ranks]}; step ms a rank "
                  f"{[f'{m:.1f}' for m in ms]}, the witness's {[f'{m:.1f}' for m in ref_ms]}, "
                  f"one process's {[f'{m:.1f}' for m in plain['ms']]} [{card}]", flush=True)
        print(f"model parallel: dp x tp split {len(split)} of {len(tp_specs)} parameters "
              f"over 'model' ({', '.join(split[:6])}, ...)", flush=True)
        if not (rntsm_holds and all(holds)):
            fail(f"model parallel: against the references: rntsm "
                 f"{'holds' if rntsm_holds else 'fails'}, dp x tp "
                 f"{'holds' if holds[0] else 'fails'}, dp x sp "
                 f"{'holds' if holds[1] else 'fails'}")
        del plain, ref
        gc.collect()
        torch.cuda.empty_cache()

        # (i3) the dry run of every mode at 4 ranks on the card (gloo).
        t0 = time.perf_counter()
        dry = subprocess.run([sys.executable, "-m", "pathtracker_torch.parallel.dryrun",
                              "--ranks", str(MP_DRYRUN_RANKS)], cwd=ROOT, capture_output=True,
                             text=True, timeout=MP_TIMEOUT)
        dry_s = time.perf_counter() - t0
        lines = [ln for ln in dry.stdout.splitlines() if ln.startswith("dryrun(")]
        missing = [m for m in MP_DRYRUN_MODES if not any(m in ln for ln in lines)]
        if dry.returncode != 0 or missing:
            fail(f"model parallel: the dry run exited {dry.returncode}, missing {missing}:\n"
                 f"{dry.stdout[-2000:]}\n{dry.stderr[-2000:]}")
        for ln in lines:
            print(f"model parallel: {ln}", flush=True)
        print(f"model parallel: python -m pathtracker_torch.parallel.dryrun --ranks "
              f"{MP_DRYRUN_RANKS} on the card (gloo): exit 0 in {dry_s:.1f} s [{card}]",
              flush=True)

        # (i4) meshes of one over NCCL against no group.
        nccl = model_parallel_nccl(F, Co, clips, labels, os.path.join(tmp, "nccl.store"))
    for row, count in zip(kernel_rows, [sum(x) for x in zip(*(
            [r[name]["launches"] for r in ranks for name in ("tp", "sp")] + [nccl]))]):
        row["launches_parallel"] += count
        row["launches"] += count
    for row, count in zip(correlation_rows,
                          [sum(x) for x in zip(*(r["rntsm"]["corr_launches"] for r in ranks))]):
        row["launches_parallel"] += count
        row["launches"] += count
    print(f"model parallel: phase 13 (i) {time.perf_counter() - t_phase:.1f} s (the two "
          f"ranks' processes {ranks_s:.1f} s) [{card}]", flush=True)


def model_parallel_nccl(F, Co, clips, labels, store: str) -> list[int]:
    """Phase 13 (i4): one step of chainE's InT under FSDP, TP and SP meshes
    of one rank over NCCL, each bit-equal to the step with no group; the
    K1-K3 launches of the meshes' steps."""
    from pathtracker_torch.parallel import distributed
    from pathtracker_torch.parallel import mesh as M

    layouts = {"fsdp": lambda m: M.fsdp_shard_params(M.make_mesh(), m),
               "tp": lambda m: M.shard_params_2d(M.make_mesh_2d(1, 1), m),
               "sp": lambda m: M.spatial_layout(M.make_mesh_2d(1, 1, ("data", "space")), m)}
    runs = {}
    distributed.initialize(f"file://{store}", 1, 0)
    try:
        with _deterministic_cudnn():
            runs["none"] = _mp_steps(_chaine(True).train(), "InT", F, Co, None, clips, labels, 1)
            for name, layout_of in layouts.items():
                model = _chaine(True).train()
                runs[name] = _mp_steps(model, "InT", F, Co, layout_of(model), clips, labels, 1)
                del model
    finally:
        distributed.shutdown()
    none = runs["none"]
    for name in layouts:
        run = runs[name]
        same = (run["losses"] == none["losses"] and run["launches"] == none["launches"]
                and all(torch.equal(v, none["weights"][0][k])
                        for k, v in run["weights"][0].items()))
        if not same:
            fail(f"model parallel: NCCL {name} mesh of one differs from no group: losses "
                 f"{run['losses']} / {none['losses']}, launches {run['launches']} / "
                 f"{none['launches']}")
    print(f"model parallel: FSDP, TP and SP meshes of one over NCCL, chainE --bf16, batch "
          f"{MP_INT_BATCH}, one step each under cudnn.deterministic: losses and weights "
          f"bit-equal to the step with no group; K1-K3 wrapper launches a step "
          f"{none['launches']}", flush=True)
    return [sum(x) for x in zip(*(runs[name]["launches"] for name in layouts))]


# ------------------------- phases 14-16: this slice -------------------------

def _recorded_launches(F, record):
    """A wrapper for viz.attribution_step that keeps each call's launches."""
    def wrap(fn):
        def call(*a, **kw):
            before = [k.launches for k in F.KERNELS]
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            record.append([k.launches - b for k, b in zip(F.KERNELS, before)])
            return out
        return call
    return wrap


def _signed(pos, neg):
    return (pos - neg).flatten(1).double()


def viz_phase(F, kernel_rows: list[dict]) -> None:
    """viz_InT.sh's command (python -m pathtracker_torch.eval.viz) with --bf16
    and as written (f32), on a rendered VIZ_SET test split."""
    from pathtracker_torch.data import registry
    from pathtracker_torch.data.pathtracker import make_synthetic_dataset
    from pathtracker_torch.eval import greedy, viz
    from pathtracker_torch.utils.opts import parser

    loop_shape_kernel_check(F, VIZ_BATCH, "viz")
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=tmp, PATHTRACKER_DOT_SIZE=str(DOT_SIZE)):
        root = registry._config_dir(VIZ_DIST, 1, TIMESTEPS)
        make_synthetic_dataset(root, n_train=0, n_test=VIZ_BATCH * VIZ_BATCHES,
                               timesteps=TIMESTEPS, n_distractors=VIZ_DIST, seed=VIZ_SEED)
        pattern = os.path.join(root, "test-*")
        proxy = greedy.greedy_responses_for_shards(pattern, TIMESTEPS, VIZ_BATCH * VIZ_BATCHES)
        again = greedy.greedy_responses_for_shards(pattern, TIMESTEPS, VIZ_BATCH * VIZ_BATCHES)
        if not np.array_equal(proxy, again) or proxy.shape != (VIZ_BATCH * VIZ_BATCHES,):
            fail("viz: two greedy-proxy computations over the same shard differ")
        print(f"viz: rendered {VIZ_BATCH * VIZ_BATCHES} clips ({VIZ_SET}: dist {VIZ_DIST}, "
              f"T={TIMESTEPS}); greedy-proxy responses bit-equal over two passes "
              f"(mean {proxy.mean():.4f})", flush=True)

        for tag, extra in (("bf16", ["--bf16"]), ("f32", [])):
            argv = ["--model", "InT", "--name", "InT", "--length", str(TIMESTEPS),
                    "--speed", "1", "--dist", str(VIZ_DIST), "--set_name", VIZ_SET,
                    "-b", str(VIZ_BATCH), "--ckpt", CHECKPOINT] + extra
            record = []
            for k in F.KERNELS:
                k.launches = 0
            original = viz.attribution_step
            viz.attribution_step = _recorded_launches(F, record)(original)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            os.makedirs(os.path.join(tmp, tag))
            try:
                with contextlib.chdir(os.path.join(tmp, tag)):  # its results/InT
                    accs = viz.main(parser.parse_args(argv))
            finally:
                viz.attribution_step = original
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            per_batch = ([2 * TIMESTEPS] * 3 + [TIMESTEPS] * 3 if tag == "bf16" else [0] * 6)
            if record != [per_batch] * VIZ_BATCHES:
                fail(f"viz {tag}: launches per batch {record}, expected {per_batch} each")
            npz = dict(np.load(os.path.join(tmp, tag, "results", "InT",
                                            f"mturk_visualizations_{VIZ_SET}.npz")))
            kept = len(npz["targets"])
            shapes = {"attention": (kept, TIMESTEPS, C, SIDE, SIDE),
                      "states": (kept, TIMESTEPS, 1, SIDE, SIDE),
                      "pos_grads": (kept, 3, TIMESTEPS, SIDE, SIDE),
                      "neg_grads": (kept, 3, TIMESTEPS, SIDE, SIDE),
                      "imgs": (kept, 3, TIMESTEPS, SIDE, SIDE), "targets": (kept,),
                      "outputs": (kept,), "human": (kept,)}
            if kept == 0 or {k: v.shape for k, v in npz.items()} != shapes:
                fail(f"viz {tag}: npz {({k: v.shape for k, v in npz.items()})}")
            if not all(np.isfinite(npz[k]).all() for k in ("pos_grads", "neg_grads")):
                fail(f"viz {tag}: gradients not finite")
            print(f"viz {tag}: {VIZ_BATCHES} batches of {VIZ_BATCH} in {seconds:.2f} s "
                  f"({VIZ_BATCH * VIZ_BATCHES / seconds:.1f} clips/s end to end, first "
                  f"batch included), peak device memory {peak / 2**30:.2f} GiB; model "
                  f"accuracy {accs[0]:.4f}, proxy human accuracy {accs[1]:.4f}; {kept} "
                  f"correct positive clips in the npz; launches per batch {record[0]} "
                  "(K1, K2, K3 forward; backward)", flush=True)
            if tag == "bf16":
                for row, k in zip(kernel_rows, F.KERNELS):
                    row["launches_viz"] = k.launches
                    row["launches"] += k.launches

        # Fused (--bf16) against f32 attribution maps: one batch, chainE's
        # weights, the same clips and human probabilities.
        from pathtracker_torch.data.pipeline import tfr_data_loader

        raw, labels = next(iter(tfr_data_loader(pattern, batch_size=VIZ_BATCH,
                                                shuffle_buffer=0, timesteps=TIMESTEPS)))
        hp = np.clip(proxy[:VIZ_BATCH], 1e-4, 1 - 1e-4)
        human_logit = torch.from_numpy(np.log(hp) - np.log1p(-hp)).to(DEVICE)
        models = {"fused": _chaine(True), "bf16 eager": _chaine(True, fused=False),
                  "f32": _chaine(False)}
        if [m.use_fused for m in models.values()] != [True, False, False]:
            fail("viz: the three InT builds did not take the fused, eager, eager cells")
        for model in models.values():
            for p in model.parameters():
                p.requires_grad_(False)
        for frames in (VIZ_GATE_T, TIMESTEPS):
            maps = {tag: viz.attribution_step(model, "InT", raw[:, :frames], labels, hp)
                    for tag, model in models.items()}
            held = frames == VIZ_GATE_T
            for first, second in (("fused", "f32"), ("fused", "bf16 eager"),
                                  ("bf16 eager", "f32")):
                a, b = (_signed(maps[tag][3], maps[tag][4]) for tag in (first, second))
                cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)
                # Each clip's map is 2/B (logit - human logit) d logit / d input:
                # where the residual's sign differs the map is negated whole.
                ra, rb = (maps[tag][0].flatten().double() - human_logit
                          for tag in (first, second))
                flips = int((torch.sign(ra) != torch.sign(rb)).sum())
                dlogit = cos * torch.sign(ra * rb)
                gated = held and first == "fused"
                print(f"viz: {first} against {second} attribution maps, {VIZ_BATCH} "
                      f"clips at T={frames}: cosine per clip mean {cos.mean().item():.4f}, "
                      f"min {cos.min().item():.4f}; relative L2 gap "
                      f"{((a - b).norm() / b.norm()).item():.4f}; logits "
                      f"{_gap(maps[first][0].flatten(), maps[second][0].flatten())}; "
                      f"residual (logit - human logit) sign differs on {flips} clips, "
                      f"|residual| min {ra.abs().min().item():.4f}; d logit / d input "
                      f"cosine mean {dlogit.mean().item():.4f}, min {dlogit.min().item():.4f} "
                      + (f"(held: mean >= {VIZ_MIN_MEAN_COSINE}, each clip >= {VIZ_MIN_COSINE})"
                         if gated else "(printed)"), flush=True)
                if gated and (not bool(torch.isfinite(cos).all())
                              or cos.mean().item() < VIZ_MIN_MEAN_COSINE
                              or cos.min().item() < VIZ_MIN_COSINE):
                    fail(f"viz: the {first} and {second} attribution maps disagree past "
                         "the tolerance")


def _chaine(bf16: bool, **model_kwargs):
    """chainE's InT (dims 32, kernel 7) for serving at T=64 on the card
    (``device=`` another); ``fused=False`` takes the eager cell under
    --bf16."""
    from pathtracker_torch.eval import serve

    model_kwargs.setdefault("device", torch.device(DEVICE))
    model_kwargs.setdefault("length", TIMESTEPS)
    return serve.build(ckpt=CHECKPOINT, bf16=bf16, **model_kwargs)


# The export's moves between devices. The CPU checks take EXPORT_CPU_BATCH
# clips (chainE at T=64 on the card machine's CPU: seconds); the program
# exported on the CPU has EXPORT_CPU_T steps. A program moved to another
# device runs the ops it traced, in that device's summation order: its bf16
# conv outputs round to neighbouring values where the sums differ in the
# last f32 bits, and the recurrence carries that on, as between the fused
# and the eager cell. So its scores are held by phase 4's rule for those
# (MEAN_SCORE_ATOL, P99_SCORE_ATOL), the largest gap printed; the K1-K3
# kernels' own 1e-5 does not survive 64 steps (measured on the card, PR 16:
# 4.4e-4 at batch 8, 0.031 at batch 32, mean 0.0028).
EXPORT_CPU_BATCH = 4
EXPORT_CPU_T = 4
# torch.export traces the recurrence step by step (95 s at T=64, 54.5 s at
# T=32 on the card machine's host), so the served program is chainE at
# T=8, the length of the chain's stage A: depth cut to keep the script's time.
EXPORT_T = 8


def export_phase(F, kernel_rows: list[dict], serve_p50_ms) -> None:
    """chainE's fused program through torch.export at T=EXPORT_T with a
    symbolic batch, written and read back as .pt2, run at batch BATCH and
    VIZ_BATCH against the live make_inference_fn."""
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.eval import serve

    dev = torch.device(DEVICE)
    model = _chaine(True, length=EXPORT_T)
    if not model.use_fused:
        fail("export: the bf16 InT did not dispatch to the fused cell")
    live = serve.make_inference_fn(model, "InT")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program = serve.export_program(model, "InT", EXPORT_T)
    export_s = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("pathtracker.")})
    if ops != ["pathtracker.k1_attention.default", "pathtracker.k2_inhibition.default",
               "pathtracker.k3_excitation.default"]:
        fail(f"export: the program calls {ops}, not the three K1-K3 forward ops")
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = os.path.join(tmp, f"chainE_t{EXPORT_T}.pt2")
        t0 = time.perf_counter()
        serve.save_exported(program, path)
        served = serve.load_exported(path)
        io_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    program_launches = [0] * len(F.KERNELS)  # the program's, not the live model's
    calls = []
    for batch, seed in ((BATCH, 20), (VIZ_BATCH, 21)):
        clips, _ = render_batch(seed, batch, EXPORT_T, n_distractors=DISTRACTORS,
                                dot_size=DOT_SIZE)
        x = torch.from_numpy(clips).to(dev)
        before = [k.launches for k in F.KERNELS]
        got = served(x)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        program_launches = [a + b for a, b in zip(program_launches, rose)]
        want = live(x)
        if rose != [EXPORT_T] * 3 + [0] * 3:
            fail(f"export: batch {batch}: launches inside the program rose by {rose}")
        if got.shape != (batch,) or not torch.equal(got, want):
            gap = (got - want).abs().max().item() if got.shape == want.shape else None
            fail(f"export: batch {batch}: the program's scores differ from the live "
                 f"model's (max gap {gap})")
        calls.append((batch, x))
    for row, n in zip(kernel_rows, program_launches):
        row["launches_export"] = n
        row["launches"] += n
    moved = export_platforms(F, serve, program, model, calls[0][1])
    times = {"program": [], "live": []}
    x = calls[0][1]
    for path in ("program", "live"):
        (served if path == "program" else live)(x)
    for i in range(TIMED_REQUESTS):
        for path in (("program", "live") if i % 2 == 0 else ("live", "program")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            (served if path == "program" else live)(x)
            torch.cuda.synchronize()
            times[path].append(time.perf_counter() - t)
    p50 = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f"export: chainE (InT, --bf16, fused) at T={EXPORT_T}, symbolic batch: "
          f"torch.export {export_s:.2f} s, {len(program.graph.nodes)} graph nodes, "
          f".pt2 {size} bytes written and loaded in "
          f"{io_s:.2f} s; the program calls {', '.join(ops)}; bit-equal (atol 0) to "
          f"make_inference_fn at batch {BATCH} and {VIZ_BATCH}, launches {EXPORT_T} "
          f"per K1-K3 forward kernel per call; p50 at batch {BATCH}: program "
          f"{p50['program']:.2f} ms, live {p50['live']:.2f} ms (interleaved, "
          f"{TIMED_REQUESTS} each), phase 4's fused p50 at T={TIMESTEPS} "
          f"{serve_p50_ms:.2f} ms", flush=True)
    print(moved, flush=True)


def export_platforms(F, serve, program, model, clips) -> str:
    """--platforms: the card's program (saved for cpu,cuda) served on the
    CPU against the card's scores; a cuda-only program refused on the CPU;
    a program exported on the CPU served on the card through the K1-K3
    kernels against the live model there. A line of what they gave."""
    dev = torch.device(DEVICE)
    x = clips[:EXPORT_CPU_BATCH]
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        both, card_only = os.path.join(tmp, "both.pt2"), os.path.join(tmp, "cuda.pt2")
        serve.save_exported(program, both)
        serve.save_exported(program, card_only, platforms="cuda")
        on_card = serve.load_exported(both)
        if on_card.device.type != "cuda":
            fail(f"export: a cpu,cuda program loaded on {on_card.device} with a card present")
        want = on_card(x).cpu()
        before = [k.launches for k in F.KERNELS]
        t0 = time.perf_counter()
        got = serve.load_exported(both, device="cpu")(x.cpu())
        cpu_s = time.perf_counter() - t0
        if [k.launches for k in F.KERNELS] != before:
            fail("export: the program served on the CPU launched a kernel")
        gap = _gap(got, want)
        if got.device.type != "cpu" or not _served_alike(got, want):
            fail(f"export: the card's program on the CPU scores {gap} from the card's")
        try:
            serve.load_exported(card_only, device="cpu")
        except ValueError as e:
            refused = str(e)
        else:
            fail("export: a cuda-only program loaded on the CPU")
        if "platforms cuda" not in refused:
            fail(f"export: the refusal does not name the program's platforms: {refused}")

        # Exported on the CPU (T=EXPORT_CPU_T), served on the card.
        cpu_model = _chaine(True, device=torch.device("cpu"), length=EXPORT_CPU_T)
        path = os.path.join(tmp, "cpu.pt2")
        t0 = time.perf_counter()
        serve.save_exported(serve.export_program(cpu_model, "InT", EXPORT_CPU_T), path)
        export_s = time.perf_counter() - t0
        served = serve.load_exported(path)
        short = clips[:, :EXPORT_CPU_T].contiguous()
        before = [k.launches for k in F.KERNELS]
        moved = served(short)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(F.KERNELS, before)]
        if served.device != dev or rose != [EXPORT_CPU_T] * 3 + [0] * 3:
            fail(f"export: the CPU's program on {served.device} launched {rose}")
        live = serve.make_inference_fn(_chaine(True, length=EXPORT_CPU_T), "InT")(short)
        moved_gap = _gap(moved, live)
        if not _served_alike(moved, live):
            fail(f"export: the CPU's program on the card scores {moved_gap} from the "
                 f"live model's there")
    held = f"held: mean <= {MEAN_SCORE_ATOL}, p99 <= {P99_SCORE_ATOL}"
    return (f"export --platforms: the card's program (cpu,cuda) on the CPU at batch "
            f"{EXPORT_CPU_BATCH}: {cpu_s:.2f} s, no launch, scores {gap} from the "
            f"card's ({held}); a cuda-only program refused there "
            f"({os.path.basename(refused)}); chainE at T={EXPORT_CPU_T} exported on the "
            f"CPU in {export_s:.2f} s, served on the card at batch {short.shape[0]}: "
            f"{EXPORT_CPU_T} launches a K1-K3 forward kernel, scores {moved_gap} from "
            f"the live model's ({held})")


def _served_alike(a, b) -> bool:
    """Phase 4's rule for two mixed paths' scores on the same clips."""
    diff = (a.float().cpu() - b.float().cpu()).abs()
    return diff.mean().item() <= MEAN_SCORE_ATOL and diff.quantile(0.99).item() <= P99_SCORE_ATOL


def _zoo_batch(batch, seed, length=None):
    from pathtracker_torch.data.pathtracker import render_batch

    clips, labels = render_batch(seed, batch, length or TIMESTEPS, n_distractors=DISTRACTORS,
                                 dot_size=DOT_SIZE)
    dev = torch.device(DEVICE)
    return torch.from_numpy(clips).to(dev), torch.from_numpy(labels).to(dev)


def _train_steps(step, batch, n):
    """n steps on one batch: (losses, seconds, peak bytes)."""
    losses, seconds = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        t = time.perf_counter()
        stats = step(*batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        if not all(np.isfinite(v) for v in stats.values()):
            fail(f"non-finite train stats {stats}")
        losses.append(float(stats["loss"]))
    return losses, seconds, torch.cuda.max_memory_allocated()


def rbp_zoo_phase(F, loop_ms) -> None:
    """InT under --algo rbp at train_InT.sh's batch, the hGRU family and the
    ConvGRU at the registry's width with and without --bf16, and ConvLSTM
    through its direct contract."""
    from pathtracker_torch import engine
    from pathtracker_torch.eval import serve
    from pathtracker_torch.models import registry
    from pathtracker_torch.ops import rbp
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    dev = torch.device(DEVICE)
    args = SimpleNamespace(model="InT", algo="rbp", bf16=True, dimensions=C,
                           fb_kernel_size=7)
    model = engine.model_selector(args, TIMESTEPS, device=dev)
    engine.load_ckpt(model, CHECKPOINT)
    if model.use_fused:
        fail("rbp: --algo rbp dispatched to the fused cell")
    step = make_train_step(model.train(), "InT", make_optimizer(LEARNING_RATE))
    big = _zoo_batch(REFERENCE_BATCH, 30)
    for k in F.KERNELS:
        k.launches = 0
    rbp.neumann_rbp.terms.clear()
    losses, seconds, peak = _train_steps(step, big, RBP_STEPS)
    if any(k.launches for k in F.KERNELS):
        fail(f"rbp: K1-K3 launched {[k.launches for k in F.KERNELS]} times")
    if len(rbp.neumann_rbp.terms) != RBP_STEPS:
        fail(f"rbp: {len(rbp.neumann_rbp.terms)} Neumann series in {RBP_STEPS} steps")
    print(f"rbp: InT --algo rbp --bf16 (eager cell) from chainE, {RBP_STEPS} steps of "
          f"batch {REFERENCE_BATCH}, T={TIMESTEPS}: losses {' '.join(f'{v:.4f}' for v in losses)}, "
          f"Neumann terms {rbp.neumann_rbp.terms} (at most 15), no K1-K3 launch; step "
          f"times {_ms(seconds)} ms (first includes warm-up), peak device memory "
          f"{peak / 2**30:.2f} GiB; phase 12's BPTT step (fused, in the loop) "
          f"{loop_ms:.2f} ms", flush=True)
    del step, model, big
    torch.cuda.empty_cache()

    batch = _zoo_batch(ZOO_BATCH, 31)
    for name in ZOO_MODELS:
        for bf16 in (False, True):
            args = SimpleNamespace(model=name, algo="bptt", bf16=bf16, dimensions=C,
                                   fb_kernel_size=7)
            model = engine.model_selector(args, TIMESTEPS, device=dev).train()
            rate = ZOO_RATES.get(name, LEARNING_RATE)
            step = make_train_step(model, name, make_optimizer(rate))
            losses, seconds, peak = _train_steps(step, batch, ZOO_STEPS)
            if not losses[-1] < losses[0]:
                fail(f"zoo {name}: the loss on the repeated batch did not fall: {losses}")
            scores = serve.make_inference_fn(model.eval(), name)(batch[0])
            if scores.shape != (ZOO_BATCH,) or not bool(
                    (torch.isfinite(scores) & (scores >= 0) & (scores <= 1)).all()):
                fail(f"zoo {name}: request scores {scores}")
            print(f"zoo {name}{' --bf16' if bf16 else ''}: width "
                  f"{getattr(model, 'dimensions', C)}, {ZOO_STEPS} Adam({rate:g}) steps of batch "
                  f"{ZOO_BATCH} (T={TIMESTEPS}): losses {' '.join(f'{v:.4f}' for v in losses)}, "
                  f"step times {_ms(seconds)} ms, peak {peak / 2**30:.2f} GiB; one "
                  f"request finite in [0, 1]", flush=True)
            del model, step
    torch.cuda.empty_cache()

    image = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (ZOO_BATCH, 1, SIDE, SIDE)).astype(np.float32)).to(dev)
    target = (image[:, 0] > 0).long()
    for method in ("bptt", "rbp"):
        model = registry.model_selector("convlstm", timesteps=CONVLSTM_T,
                                        grad_method=method, device=dev)
        params = [p for p in model.parameters()]
        opt = torch.optim.Adam(params, lr=LEARNING_RATE)
        rbp.neumann_rbp.terms.clear()
        losses, pens = [], []
        for _ in range(ZOO_STEPS):
            out, jv, loss = model(image, target=target,
                                  criterion=torch.nn.functional.cross_entropy)
            total = loss + (jv.sum() if method == "bptt" else 0.0)
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            losses.append(float(loss.detach()))
            pens.append(float(jv.detach().sum()))
        if out.shape != (ZOO_BATCH, 2, SIDE, SIDE) or not np.all(np.isfinite(losses + pens)):
            fail(f"convlstm {method}: output {tuple(out.shape)}, losses {losses}, "
                 f"penalties {pens}")
        if method == "rbp" and len(rbp.neumann_rbp.terms) != ZOO_STEPS:
            fail(f"convlstm rbp: {len(rbp.neumann_rbp.terms)} Neumann series")
        print(f"convlstm {method}: {ZOO_STEPS} Adam steps on {ZOO_BATCH} images "
              f"(T={CONVLSTM_T}, hidden 25, 15x15 gates): cross-entropy "
              f"{' '.join(f'{v:.4f}' for v in losses)}, Jacobian penalty "
              f"{' '.join(f'{v:.4g}' for v in pens)}"
              + (f", Neumann terms {rbp.neumann_rbp.terms}" if method == "rbp" else ""),
              flush=True)


def _rzoo_model(name: str, length: int, bf16: bool = False, device=DEVICE):
    from pathtracker_torch import engine

    args = SimpleNamespace(model=name, algo="bptt", bf16=bf16)
    return engine.model_selector(args, length, device=device)


def _rzoo_parity(serve, name: str) -> float:
    """The card's f32 logits against the CPU's from the same weights, at
    batch RZOO_PARITY_BATCH, T=RZOO_PARITY_T; the largest gap."""
    import copy

    cpu = _rzoo_model(name, RZOO_PARITY_T, device="cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    clips = _zoo_batch(RZOO_PARITY_BATCH, 40, RZOO_PARITY_T)[0].cpu()
    want = serve.make_inference_fn(cpu, name, probs=False)(clips)
    got = serve.make_inference_fn(card, name, probs=False)(clips).cpu()
    if not torch.allclose(got, want, atol=RZOO_PARITY_ATOL, rtol=RZOO_PARITY_RTOL):
        fail(f"{name}: card logits {got.tolist()} against the CPU's {want.tolist()}")
    return float((got - want).abs().max())


def _rzoo_run(serve, name: str, batch, bf16: bool = False):
    """RZOO_STEPS Adam steps on one batch (of RZOO_LENGTH's clips, else
    T=TIMESTEPS) through make_train_step, then
    requests through make_inference_fn on the same clips (RZOO_REQUESTS;
    fflstm RZOO_FFLSTM_REQUESTS): (losses, step seconds, request seconds,
    peak bytes, batch). Halves the batch while it does not fit."""
    from pathtracker_torch.models import registry
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    n_requests = RZOO_FFLSTM_REQUESTS if name == "fflstm" else RZOO_REQUESTS
    rate = ZOO_RATES.get(name, LEARNING_RATE)
    prep = {"coord_channels": registry.needs_coord_channels(name)}
    while True:
        labels = batch[1]
        try:
            model = _rzoo_model(name, RZOO_LENGTH.get(name, TIMESTEPS), bf16).train()
            step = make_train_step(model, name, make_optimizer(rate), prepare_kwargs=prep)
            losses, steps, peak = _train_steps(step, batch, RZOO_STEPS)
            infer = serve.make_inference_fn(model.eval(), name)
            requests = []
            for _ in range(n_requests):
                torch.cuda.synchronize()
                t = time.perf_counter()
                scores = infer(batch[0])
                torch.cuda.synchronize()
                requests.append(time.perf_counter() - t)
            break
        except torch.cuda.OutOfMemoryError:
            model = step = infer = None
            torch.cuda.empty_cache()
            if len(labels) == 1:
                raise
            print(f"zoo {name}: batch {len(labels)} does not fit; halved", flush=True)
            batch = (batch[0][:len(labels) // 2], batch[1][:len(labels) // 2])
    if scores.shape != (len(labels),) or not bool(
            (torch.isfinite(scores) & (scores >= 0) & (scores <= 1)).all()):
        fail(f"zoo {name}: request scores {scores}")
    return losses, steps, requests, max(peak, torch.cuda.max_memory_allocated()), len(labels)


def _rzoo_cli(name: str, root: str) -> str:
    """python -m pathtracker_torch.train --model <name>, one capped epoch,
    then the eval CLI on its rolling checkpoint; a line of what they gave."""
    from pathtracker_torch.eval import test_model
    from pathtracker_torch.train import loop

    common = ["--model", name, "--name", f"p17_{name}", "--length", str(TIMESTEPS),
              "--speed", "1", "--dist", str(DISTRACTORS), "-b", str(ZOO_BATCH)]
    t0 = time.perf_counter()
    result = loop.main(loop.parser.parse_args(
        common + ["--epochs", "1", "--results-dir", os.path.join(root, "runs")]),
        max_steps_per_epoch=RZOO_CLI_STEPS)
    train_s = time.perf_counter() - t0
    losses = result["train_log"]["loss"]
    rolling = os.path.join(result["results_folder"], "saved_models", ROLLING_NAME)
    if len(losses) != RZOO_CLI_STEPS or not np.all(np.isfinite(losses)) or not os.path.exists(
            rolling):
        fail(f"zoo CLI {name}: losses {losses}, rolling checkpoint {os.path.exists(rolling)}")
    t0 = time.perf_counter()
    acc, loss = test_model.evaluate_model(
        os.path.join(root, "eval", name), test_model.parser.parse_args(common + ["--ckpt", rolling]),
        prep_gifs=0, dist=DISTRACTORS, speed=1, length=TIMESTEPS)
    if not (0.0 <= acc <= 1.0 and np.isfinite(loss)):
        fail(f"zoo CLI {name}: eval accuracy {acc}, loss {loss}")
    return (f"{RZOO_CLI_STEPS} steps of batch {ZOO_BATCH} in {train_s:.2f} s (losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}), eval of the rolling checkpoint "
            f"{time.perf_counter() - t0:.2f} s (accuracy {acc:.3f}, loss {loss:.4f})")


def rzoo_phase(F, Co, card: str) -> None:
    """The rest of the recurrent zoo and the video ResNets: for each name the
    card against the CPU at T=8, RZOO_STEPS steps on one batch and
    RZOO_REQUESTS requests at the registry's width; --bf16 for RZOO_BF16
    with its logits against f32; the train and eval CLIs for RZOO_CLI."""
    from pathtracker_torch.data import registry
    from pathtracker_torch.eval import serve

    t_phase = time.perf_counter()
    for k in (*F.KERNELS, *Co.KERNELS):
        k.launches = 0
    batches = {TIMESTEPS: _zoo_batch(ZOO_BATCH, 33)}
    for name in RZOO_MODELS:
        length = RZOO_LENGTH.get(name, TIMESTEPS)
        if length not in batches:
            batches[length] = _zoo_batch(ZOO_BATCH, 33, length)
        batch = batches[length]
        gap = _rzoo_parity(serve, name)
        runs = [(False, *_rzoo_run(serve, name, batch))]
        if name in RZOO_BF16:
            logits = [serve.make_inference_fn(_rzoo_model(name, TIMESTEPS, bf16), name,
                                              probs=False)(batch[0]) for bf16 in (False, True)]
            bf16_gap = float((logits[1] - logits[0]).abs().max())
            if not bf16_gap <= RZOO_BF16_ATOL:
                fail(f"zoo {name}: --bf16 logits {bf16_gap:.3g} from f32 (at most "
                     f"{RZOO_BF16_ATOL})")
            runs.append((True, *_rzoo_run(serve, name, batch, bf16=True)))
        for bf16, losses, steps, requests, peak, used in runs:
            if not losses[-1] < losses[0]:
                fail(f"zoo {name}: the loss on the repeated batch did not fall: {losses}")
            print(f"zoo {name}{' --bf16' if bf16 else ''} (T={length}, batch {used}): "
                  f"{RZOO_STEPS} Adam({ZOO_RATES.get(name, LEARNING_RATE):g}) steps, losses "
                  f"{' '.join(f'{v:.4f}' for v in losses)}, step times {_ms(steps)} ms, "
                  f"median {statistics.median(steps) * 1e3:.2f} ms, "
                  f"{used / statistics.median(steps):.1f} clips/s; request p50 "
                  f"{statistics.median(requests) * 1e3:.2f} ms ({_ms(requests)}), "
                  f"{used / statistics.median(requests):.1f} clips/s; peak "
                  f"{peak / 2**30:.2f} GiB; card vs CPU logits (batch {RZOO_PARITY_BATCH}, "
                  f"T={RZOO_PARITY_T}) {gap:.3g}"
                  + (f"; --bf16 logits {bf16_gap:.3g} from f32" if bf16 else "")
                  + f"; {card}", flush=True)
        torch.cuda.empty_cache()
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=os.path.join(tmp, "data"),
            PATHTRACKER_DOT_SIZE=str(DOT_SIZE),
            PATHTRACKER_SYNTH_TRAIN=str(2 * ZOO_BATCH),
            PATHTRACKER_SYNTH_TEST=str(2 * ZOO_BATCH)):
        registry.dataset_selector(DISTRACTORS, 1, TIMESTEPS)
        for name in RZOO_CLI:
            print(f"zoo CLI {name}: {_rzoo_cli(name, tmp)}", flush=True)
    launched = [k.launches for k in (*F.KERNELS, *Co.KERNELS)]
    if any(launched):
        fail(f"zoo: a csrc kernel launched on the zoo's paths: {launched}")
    print(f"zoo: phase 17 took {time.perf_counter() - t_phase:.2f} s; no csrc kernel "
          "launched", flush=True)


def _dropout_gap(name: str, batch) -> float:
    """The largest logit gap between a forward with a generator (the train
    step's dropout) and one without (a request's), on 4 clips: nonzero
    when the dropout is live."""
    from pathtracker_torch import engine
    from pathtracker_torch.data.prepare import prepare_batch

    model = _rzoo_model(name, TIMESTEPS).train()
    imgs, _ = prepare_batch(batch[0][:4], batch[1][:4])
    with torch.no_grad():
        plain = engine.model_step(model, imgs, name)[0]
        dropped = engine.model_step(model, imgs, name,
                                    generator=torch.Generator(device=DEVICE).manual_seed(0))[0]
    return float((dropped - plain).abs().max())


def sfzoo_phase(F, Co, card: str) -> None:
    """SlowFast and the transformer baselines: for each name the card
    against the CPU at T=8, RZOO_STEPS steps on one batch and RZOO_REQUESTS
    requests at the registry's width and depth, SlowFast's dropout live in the
    steps; the train and eval CLIs for SFZOO_CLI."""
    from pathtracker_torch.data import registry
    from pathtracker_torch.eval import serve

    t_phase = time.perf_counter()
    for k in (*F.KERNELS, *Co.KERNELS):
        k.launches = 0
    batch = _zoo_batch(ZOO_BATCH, 34)
    for name in SFZOO_MODELS:
        gap = _rzoo_parity(serve, name)
        losses, steps, requests, peak, used = _rzoo_run(serve, name, batch)
        if not losses[-1] < losses[0]:
            fail(f"sfzoo {name}: the loss on the repeated batch did not fall: {losses}")
        dropout = ""
        if name in SFZOO_DROPOUT:
            live = _dropout_gap(name, batch)
            if not live > 0:
                fail(f"sfzoo {name}: a forward with the step's generator equals one without")
            dropout = f"; dropout live in the steps (logits {live:.3g} from a request's)"
        print(f"sfzoo {name} (T={TIMESTEPS}, batch {used}): {RZOO_STEPS} "
              f"Adam({LEARNING_RATE:g}) steps, losses {' '.join(f'{v:.4f}' for v in losses)}, "
              f"step times {_ms(steps)} ms, median {statistics.median(steps) * 1e3:.2f} ms, "
              f"{used / statistics.median(steps):.1f} clips/s; request p50 "
              f"{statistics.median(requests) * 1e3:.2f} ms ({_ms(requests)}), "
              f"{used / statistics.median(requests):.1f} clips/s; peak "
              f"{peak / 2**30:.2f} GiB; card vs CPU logits (batch {RZOO_PARITY_BATCH}, "
              f"T={RZOO_PARITY_T}) {gap:.3g}{dropout}; {card}", flush=True)
        torch.cuda.empty_cache()
    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp, _environ(
            PATHTRACKER_DATA_ROOT=os.path.join(tmp, "data"),
            PATHTRACKER_DOT_SIZE=str(DOT_SIZE),
            PATHTRACKER_SYNTH_TRAIN=str(2 * ZOO_BATCH),
            PATHTRACKER_SYNTH_TEST=str(2 * ZOO_BATCH)):
        registry.dataset_selector(DISTRACTORS, 1, TIMESTEPS)
        for name in SFZOO_CLI:
            print(f"sfzoo CLI {name}: {_rzoo_cli(name, tmp)}", flush=True)
    launched = [k.launches for k in (*F.KERNELS, *Co.KERNELS)]
    if any(launched):
        fail(f"sfzoo: a csrc kernel launched on SlowFast's or the transformers' paths: "
             f"{launched}")
    print(f"sfzoo: phase 18 took {time.perf_counter() - t_phase:.2f} s; no csrc kernel "
          "launched", flush=True)


# Phase 19: scripts/torch_reproduce_canonical.py's chain at full width (InT,
# dims 32, kernel 7, batch 128, --bf16 --device-data --fused-steps 12, its
# defaults) with only the depth cut: a window of 12 steps an epoch.
CHAIN_DEPTH = {"SYNTH_TRAIN": "1536", "SYNTH_TEST": "128", "EPOCHS_A": "2",
               "EPOCHS_B": "1", "EPOCHS_C": "1"}
CHAIN_STAGES = (("A", 8, 1), ("B", 32, 5), ("C", 64, 14))  # tag, T, dist
CHAIN_MATRIX_CLIPS = 128  # test clips of a matrix config the chain left unrendered (8 train)
CHAIN_TIMEOUT = 600


def _chain_script(name: str):
    """A scripts/torch_*.py module of the checkout (its folder on the path,
    where the render workers it spawns find it too)."""
    import importlib

    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def _chain_run(argv, env) -> str:
    """The chain driver as a process; its output, or a failure."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                        "torch_reproduce_canonical.py"), *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=CHAIN_TIMEOUT)
    if proc.returncode != 0:
        fail(f"chain: the driver {argv} exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-3000:]}")
    print(f"chain: driver {' '.join(argv) or '(the chain)'} took "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return proc.stdout


def chain_roots_in_background():
    """Start rendering phase 19's roots (the stages' at CHAIN_DEPTH, the
    matrix's other configs at CHAIN_MATRIX_CLIPS test clips) in a scratch
    folder under build/, in processes of their own with 2-pixel dots, while
    phases 17 and 18 hold the card; (the folder, the render's future)."""
    from concurrent.futures import ThreadPoolExecutor

    matrix = _chain_script("torch_eval_matrix")
    os.makedirs(BUILD, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=BUILD)
    data = os.path.join(tmp.name, "data")
    stages = [(d, 1, t) for _, t, d in CHAIN_STAGES]
    others = [(d["dist"], d["speed"], d["length"]) for d in matrix.configs()]

    def render():
        t0 = time.perf_counter()
        matrix.render_missing(stages, RENDER_WORKERS // 2, (int(CHAIN_DEPTH["SYNTH_TRAIN"]),
                                                            int(CHAIN_DEPTH["SYNTH_TEST"])),
                              data, DOT_SIZE)
        matrix.render_missing(others, RENDER_WORKERS // 2, (8, CHAIN_MATRIX_CLIPS), data,
                              DOT_SIZE)
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    future = pool.submit(render)
    pool.shutdown(wait=False)
    return tmp, future


def chain_eager_stage_a(canon, env: dict, results: str, launches_log: str) -> None:
    """Stage A on the eager mixed cell (CELL=eager --until A: a process of
    the chain script that calls loop.main with fused=False), as a chain on that
    cell starts, in the results root of phase 19's chain: it runs through
    ``--stage-run eager``, launches no K1-K3 kernel (its line of
    ``launches_log``, after the chain's stages and its second C), and ends
    every epoch with a finite loss."""
    eager_env = dict(env, CELL="eager")
    ek = canon.knobs(eager_env)
    out = _chain_run(["--results-root", results, "--until", "A"], eager_env)
    argv_line = next((line for line in out.splitlines()
                      if line.startswith(f"chain: [{ek['PFX']}A] ")), "")
    if "--stage-run eager" not in argv_line:
        fail(f"chain: stage A on the eager cell did not run through --stage-run: "
             f"{argv_line!r}")
    with open(launches_log) as f:
        counts = [json.loads(line) for line in f][len(CHAIN_STAGES) + 1:]
    if len(counts) != 1 or any(counts[0].values()):
        fail(f"chain: stage A on the eager cell launched {counts}")
    with open(os.path.join(results, "logs", f"{ek['PFX']}A.log")) as f:
        losses = [float(m.group(1)) for m in
                  re.finditer(r"Loss: [\d.]+ \([\d.]+\) \(([\d.]+)\)", f.read())]
    val = np.load(os.path.join(canon.run_folder(results, "A", ek), "val.npz"))["balacc"]
    if len(val) != int(ek["EPOCHS_A"]) or not losses or not np.all(np.isfinite(losses)):
        fail(f"chain: stage A on the eager cell: {len(val)} val entries, losses {losses}")
    print(f"chain: stage A on the eager cell ({ek['PFX']}chainA): no K1-K3 launch; "
          f"epoch-mean losses {[round(v, 4) for v in losses]}; val meter "
          f"{[round(float(v), 2) for v in val]}", flush=True)


def chain_phase(F, kernel_rows: list[dict], card: str, roots) -> None:
    """The canonical chain A -> B -> C through its driver (each stage a
    train CLI process on the card) with its report, the chain again, and the matrix
    driver over C's best checkpoint, each config at a cut test size, on
    the ``roots`` that ``chain_roots_in_background`` rendered."""
    from pathtracker_torch.train.checkpoint import find_best_checkpoint

    t_phase = time.perf_counter()
    canon = _chain_script("torch_reproduce_canonical")
    matrix = _chain_script("torch_eval_matrix")
    os.makedirs(BUILD, exist_ok=True)
    # Every process the phase starts renders 2-pixel dots, as the chain's
    # roots are rendered.
    scratch, rendering = roots
    with scratch as tmp, _environ(PATHTRACKER_DOT_SIZE=str(DOT_SIZE)):
        data, results = os.path.join(tmp, "data"), os.path.join(tmp, "results")
        launches_log = os.path.join(tmp, "launches.jsonl")
        # The stages train where DEVICE says (a rehearsal sets "cpu").
        where = {"PATHTRACKER_TORCH_DEVICE": "cpu"} if DEVICE == "cpu" else {}
        env = dict(os.environ, **CHAIN_DEPTH, **where, PATHTRACKER_DATA_ROOT=data,
                   PATHTRACKER_DOT_SIZE=str(DOT_SIZE), PATHTRACKER_LAUNCHES=launches_log)
        if not where:
            env.pop("PATHTRACKER_TORCH_DEVICE", None)
        # The roots, rendered as the stages would, since phase 17 began.
        t0 = time.perf_counter()
        render_s = rendering.result()
        print(f"chain: the stages' roots ({CHAIN_DEPTH['SYNTH_TRAIN']} + "
              f"{CHAIN_DEPTH['SYNTH_TEST']} clips) and the matrix's other configs "
              f"({CHAIN_MATRIX_CLIPS} test clips) were rendered in {render_s:.2f} s behind "
              f"phases 17-18; waited {time.perf_counter() - t0:.2f} s for them", flush=True)

        first = _chain_run(["--results-root", results], env)
        k = canon.knobs(env)
        batch, fused = int(k["BATCH"]), int(k["FUSED_STEPS"])
        with open(launches_log) as f:
            stage_counts = [json.loads(line) for line in f]
        if len(stage_counts) != len(CHAIN_STAGES):
            fail(f"chain: {len(stage_counts)} stage processes reported launches, "
                 f"expected {len(CHAIN_STAGES)}")
        previous, chain_launches = None, [0] * len(F.KERNELS)
        for (tag, length, dist), counts in zip(CHAIN_STAGES, stage_counts):
            folder = canon.run_folder(results, tag, k)
            have = sorted(os.listdir(folder))
            want = ["hp_dict.npz", "saved_models", f"chain{tag}.txt", "train.npz", "val.npz"]
            if have != sorted(want):
                fail(f"chain {tag}: the run folder holds {have}, expected {sorted(want)}")
            loaded = str(np.load(os.path.join(folder, "hp_dict.npz"))["loaded_ckpt"])
            named = "None" if previous is None else find_best_checkpoint(previous)
            if loaded != named:
                fail(f"chain {tag}: hp_dict.npz names {loaded}, not {named}")
            # A window of `fused` steps is warmed up once and captured once
            # (each wrapper counts a graph's kernels at capture), and each
            # epoch's validation runs its batches through the forward kernels.
            epochs = int(k[f"EPOCHS_{tag}"])
            val_batches = min(int(k["SYNTH_TEST"]) // batch, 5)
            want_counts = ([2 * fused * 2 * length + epochs * val_batches * length] * 3
                           + [2 * fused * length] * 3)
            got = [counts[kern.__name__] for kern in F.KERNELS]
            if got != want_counts or any(counts[n] for n in counts
                                         if n not in {kk.__name__ for kk in F.KERNELS}):
                fail(f"chain {tag}: kernel launches {counts}, expected K1-K3 {want_counts}")
            chain_launches = [a + b for a, b in zip(chain_launches, got)]
            log = os.path.join(results, "logs", f"{tag}.log")
            with open(log) as f:
                losses = [float(m.group(1)) for m in
                          re.finditer(r"Loss: [\d.]+ \([\d.]+\) \(([\d.]+)\)", f.read())]
            val = np.load(os.path.join(folder, "val.npz"))["balacc"]
            print(f"chain {tag} (T={length}, dist {dist}): from "
                  f"{os.path.basename(named) if previous else 'nothing'}; K1-K3 launches "
                  f"{got}; epoch-mean losses {[round(v, 4) for v in losses]}; val meter "
                  f"{[round(float(v), 2) for v in val]}", flush=True)
            if len(val) != epochs or not np.all(np.isfinite(losses)):
                fail(f"chain {tag}: {len(val)} val entries, losses {losses}")
            previous = folder
        stage_s = [float(m.group(1)) for m in
                   re.finditer(r"^chain: \[[ABC]\] exit 0 after ([\d.]+) s", first, re.M)]
        report = json.loads(first.strip().splitlines()[-1])
        for tag in ("B", "C"):
            held = report["stages"][tag].get("held_out")
            if held is None or not (0.0 <= held["acc"] <= 1.0 and np.isfinite(held["loss"])):
                fail(f"chain: the report has no held-out result for {tag}: {held}")
        if not 0.0 <= report["jax_chainB"]["acc"] <= 1.0:
            fail(f"chain: the report's JAX chainB result {report['jax_chainB']}")
        print(f"chain: stages took {stage_s} s; report (cut roots): B "
              f"{report['stages']['B']['held_out']['acc']:.4f}, C "
              f"{report['stages']['C']['held_out']['acc']:.4f}, JAX chainB "
              f"{report['jax_chainB']['acc']:.4f} held-out", flush=True)

        # Again, the chain alone in this process (the report ran above): A
        # and B are skipped, C continues its rolling checkpoint (no epoch
        # left).
        mtimes = {tag: os.path.getmtime(os.path.join(canon.run_folder(results, tag, k),
                                                     "val.npz")) for tag in "AB"}
        t0 = time.perf_counter()
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            if not canon.chain(results, env):
                fail("chain: the second invocation stopped the chain")
        second = "".join(tee.text)
        print(f"chain: the chain again took {time.perf_counter() - t0:.2f} s", flush=True)
        for tag in "AB":
            if (f"chain: [{tag}] done" not in second or os.path.getmtime(os.path.join(
                    canon.run_folder(results, tag, k), "val.npz")) != mtimes[tag]):
                fail(f"chain: the second invocation did not skip stage {tag}")
        c_argv = next(line for line in second.splitlines() if line.startswith("chain: [C] "))
        if "--ckpt" in c_argv:
            fail(f"chain: the second invocation warm-started C again: {c_argv}")
        with open(launches_log) as f:
            rerun = [json.loads(line) for line in f][len(CHAIN_STAGES):]
        if len(rerun) != 1 or any(rerun[0].values()):
            fail(f"chain: the second invocation's C launched {rerun}")
        print("chain: the second invocation skipped A and B, C resumed with nothing left "
              "(no launch)", flush=True)

        chain_eager_stage_a(canon, env, results, launches_log)

        # The matrix over C's best, counted in this process.
        best = find_best_checkpoint(canon.run_folder(results, "C", k))
        for kern in F.KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        tee = _Tee(sys.stdout)
        with _environ(PATHTRACKER_DATA_ROOT=data, PATHTRACKER_DOT_SIZE=str(DOT_SIZE),
                      **where), contextlib.redirect_stdout(tee):
            got = matrix.main([best, os.path.join(tmp, "matrix"), "-b", str(batch),
                               *shlex.split(k["EXTRA_FLAGS"])])
        torch.cuda.synchronize()
        matrix_s = time.perf_counter() - t0
        order = [key for key in got]
        want_order = [(d["dist"], d["speed"], d["length"]) for d in matrix.configs()]
        text = "".join(tee.text)
        if (order != want_order or order[0][2] != 64 or "MATRIX COMPLETE" not in text
                or not all(0.0 <= a <= 1.0 and np.isfinite(b) for a, b in got.values())):
            fail(f"chain: the matrix visited {order}, results {got}")
        test_clips = {key: (int(CHAIN_DEPTH["SYNTH_TEST"]) if key == (14, 1, 64)
                            else CHAIN_MATRIX_CLIPS) for key in order}
        fwd = sum(n // batch * key[2] for key, n in test_clips.items())
        matrix_counts = [kern.launches for kern in F.KERNELS]
        if matrix_counts != [fwd] * 3 + [0] * 3:
            fail(f"chain: the matrix launched {matrix_counts}, expected {fwd} a forward kernel")
        chain_launches = [a + b for a, b in zip(chain_launches, matrix_counts)]
        print(f"chain: matrix over C's best in {matrix_s:.2f} s, {len(order)} configs "
              f"(T=64 first): " + "; ".join(f"{key} {a:.4f}" for key, (a, _) in got.items())
              + f"; K1-K3 launches {matrix_counts}", flush=True)
    for row, n in zip(kernel_rows, chain_launches):
        row["launches_chain"] = n
        row["launches"] += n
    print(f"chain: phase 19 took {time.perf_counter() - t_phase:.2f} s; K1-K3 launches "
          f"{chain_launches} (stages + matrix) at batch {batch} x 32 x 32 = "
          f"{batch * SIDE * SIDE} rows, the width phases 3 and 5 hold each kernel at; "
          f"{card}", flush=True)


def resource_lines(log: str) -> list[str]:
    """'kernel: N registers, S bytes smem, spills' from ptxas -v's output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in INT_CELL_KERNELS if k in mangled), mangled)
            templated = re.search(r"(corr_\w+?_kernel)I((?:L[bi]\d+E)+)", mangled)
            if templated:  # corr_bwd_kernel<GATHER, VEC, P_T>, corr_fwd_kernel<VEC, P_T>
                args = re.findall(r"L[bi](\d+)E", templated.group(2))
                name = f"{templated.group(1)}<{', '.join(args)}>"
        elif "spill" in line and name:
            spill = line.strip()
        elif "Used" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def print_resources(native, names) -> dict:
    """Print each built kernel's ptxas account; {kernel: account}."""
    resources = {}
    for name in names:
        for line in resource_lines(native.build_log(name)):
            print(f"build: csrc/{name}.cu {line}", flush=True)
            kernel, _, account = line.partition(": ")
            resources[kernel] = account
    return resources


def main() -> int:
    if sys.argv[1:2] == ["--parallel-rank"]:  # one rank of phase 13 (h1)
        return parallel_rank(*sys.argv[2:])
    if sys.argv[1:2] == ["--model-parallel-rank"]:  # one rank of phase 13 (i1), (i2)
        return model_parallel_rank(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pathtracker_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    adopt_orphans()
    atexit.register(_stop_children_at_exit)
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    from pathtracker_torch.data.pathtracker import render_batch
    from pathtracker_torch.eval import serve
    from pathtracker_torch.ops import _native
    from pathtracker_torch.ops import correlation as Co
    from pathtracker_torch.ops import int_fused as F

    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    built = _native.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(f'csrc/{n}.cu' for n in built) or 'up to date'})", flush=True)
    resources = print_resources(_native, _native.SIGNATURES)
    mark("phases 1-2 (imports, build)")

    kernel_rows = kernel_phase(F)
    mark("phase 3")
    rendered = [render_batch(seed, BATCH, TIMESTEPS, n_distractors=DISTRACTORS,
                             dot_size=DOT_SIZE) for seed in range(REQUESTS)]
    serve_clips_per_s, serve_p50_ms = serve_phase(serve, F, kernel_rows, rendered)
    mark("phase 4")
    kernel_rows += backward_kernel_phase(F)
    mark("phase 5")
    gradient_phase(serve, F, rendered)
    plateau_check(serve, F)
    mark("phase 6")
    bare_steps = train_phase(serve, F, kernel_rows, rendered)
    mark("phase 7")
    del rendered
    torch.cuda.empty_cache()
    correlation_rows = correlation_phase(Co, resources)
    mark("phase 8")
    torch.cuda.empty_cache()
    rntsm_serve_phase(serve, Co, correlation_rows)
    mark("phase 9")
    torch.cuda.empty_cache()
    rntsm_train_phase(serve, Co, correlation_rows)
    mark("phase 10")
    torch.cuda.empty_cache()
    eval_phase(serve, F, kernel_rows, serve_clips_per_s)
    mark("phase 11")
    torch.cuda.empty_cache()
    loop_ms = loop_phase(F, kernel_rows, bare_steps)
    mark("phase 12")
    torch.cuda.empty_cache()
    for row in correlation_rows:
        row["launches_loop"] = row["launches_parallel"] = 0
    resident_phase(serve, F, Co, kernel_rows, correlation_rows, loop_ms)
    mark("phase 13 (a-h)")
    torch.cuda.empty_cache()
    model_parallel_phase(F, Co, kernel_rows, correlation_rows, card)
    mark("phase 13 (i)")
    torch.cuda.empty_cache()
    viz_phase(F, kernel_rows)
    mark("phase 14")
    torch.cuda.empty_cache()
    export_phase(F, kernel_rows, serve_p50_ms)
    mark("phase 15")
    torch.cuda.empty_cache()
    rbp_zoo_phase(F, loop_ms)
    mark("phase 16")
    torch.cuda.empty_cache()
    chain_roots = chain_roots_in_background()  # phase 19's, behind phases 17-18
    rzoo_phase(F, Co, card)
    mark("phase 17")
    torch.cuda.empty_cache()
    sfzoo_phase(F, Co, card)
    mark("phase 18")
    torch.cuda.empty_cache()
    chain_phase(F, kernel_rows, card, chain_roots)
    mark("phase 19")
    torch.cuda.empty_cache()
    for row in correlation_rows:  # not on the viz, export or chain paths
        row["launches_viz"] = row["launches_export"] = row["launches_chain"] = 0
    kernel_rows += correlation_rows
    if any(row["launches"] <= 0 for row in kernel_rows):
        fail(f"a kernel was never launched on the main paths: {kernel_rows}")
    left = stop_children()
    print(f"processes: {len(left)} started by this script still ran at its end, "
          f"stopped and reaped: {sorted(left.values())}", flush=True)
    if _descendants():
        fail(f"processes still run after they were stopped: {_descendants()}")
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
