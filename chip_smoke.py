#!/usr/bin/env python3
"""Smoke run of rigl_tpu_torch's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package.  Phases, each fatal on failure:

  1. device: torch / CUDA versions, the card's name and power limit;
  2. build: compiles rigl_tpu_torch/csrc/packed_mm.cu, flash_attn.cu and
     tap_conv.cu with nvcc, one process per source started together (into
     the git-ignored rigl_tpu_torch/_build/), and prints ptxas' report;
  3. packed kernels vs plain: each kernel against its plain PyTorch
     version on the same inputs, with errors, device times of both (CUDA
     events around calls queued while the device sleeps), the host time to
     issue one call, the time of the dense torch.matmul that computes the
     same product on the unpacked matrix, and the bound (the larger of the
     bytes the product needs over 3.35 TB/s and its FLOPs over the H100's
     dense peak for the dtype).  Points:
     a. the forward at the serving model's four layer shapes (s = 0.8,
        block (512, 512)), m = 8 and 1024 in bf16, plus f32 at one shape;
        each m = 8 point (the decode branch, packed_mm_decode_kernel) also
        prints its plan (ops/mm_split.py decode_plan): S blocks a
        cluster, the tile, the grid and the bytes in flight per SM, and
        its time at every S (1, 2, 4, 8, forced); then the decode
        kernel's floor at every S: fc2's shape with no active block (the
        launch, the cluster's reduction and the zero stores, no loads);
     b. forward, dx and packed dw at the MLP training shape K = N = 4096,
        block (512, 512): s = 0.8 and 0.9 at m = 1024 in bf16 and f32, a
        ragged m = 1000, and a grid with an empty block-row and an empty
        block-column;
     c. forward, dx and packed dw at the transformer train step's four
        layer shapes, m = 2048, bf16, and the packed dw there in f32 (the
        f32 step's calls, beside xᵀ @ gy in f32);
     d. forward and dx at the wgmma branch's narrow and ragged tiles: a
        contraction per active (96) that 64 does not divide, m = 1024,
        3072 wide, s = 0.8; and block (16, 16), m = 25088, 512 -> 512, s
        = 0.8 (MobileNetV1's 14 x 14 pointwise convs at batch 128).
     Each forward / dx point prints the branch it takes
     (ops/block_sparse_packed.py mm_branch: decode at m <= 32, wgmma in
     bf16, ffma in f32) and a wgmma point its tile (mm_tile);
  4. autograd on the card: torch.autograd.grad through packed_matmul
     matches the plain versions and launches dx and dw once each;
  5. serving, a main path: a 4-layer d_model 2048 / d_ff 8192 / 16-head,
     vocab 256 bf16 PackedTransformer with seeded random occupancy and
     weights serves a greedy request (batch 8, prompt 128, 128 steps; the
     kernel launch count must grow by exactly 4 layers x 4 projections x
     128 passes, of which the 127 decode passes' run the decode kernel)
     and a left-padded mixed-length sampled request; its
     logits are held against the plain path (the dense twin holding the
     unpacked kernels) and against its own full causal forward;
  6. serving speed: us/token of the packed model and the dense twin at
     batch 8 and 1, the device-busy share of a batch-8 request, and the
     decode kernel's device time in it and its share of the busy time;
  7. MLP training, a main path: PackedMLPTrainer on the repo's `mlp`
     model (3 hidden layers of 4096, batch 1024, block (512, 512), s =
     0.8, f32, via='kernel') trains 30 steps with mask updates at steps 0,
     10 and 20 on synthetic MNIST-normalised data; occupancy counts,
     per-step launches (fwd 3, dx 2, dw 3), falling finite losses, and one
     step's loss and gradients against the plain path are checked;
  8. MLP training speed: the packed branch of
     scripts/bench_blocksparse_mlp.py (bf16 weights, no bias, SGD
     momentum, loss mean(y^2)): us/step of the dense arm and the packed
     arm at s = 0.8 and 0.9, each measured twice in mirrored order, their
     ratio, MFU, each arm's device time and busy share, and a packed
     step's device time by kernel;
  9. flash kernels vs plain: the causal flash-attention forward, dK/dV and
     dQ kernels against their plain versions at (B, H, S, hd) = (4, 16,
     512, 128), a ragged S = 1000 and hd 64 and 32, beside torch's
     scaled_dot_product_attention (forward; its backward) and the bound;
     in bf16 here and their f32 variants after phase 20; in both a
     second launch of the forward, of dK/dV and of dQ must give the same
     bits;
     then, in both, a head dim the kernels do not take (48) through
     flash_attention, zero-padded to 64, forward and gradients against
     autograd through the plain forward;
 10. transformer train step, the main path of the flash kernels
     (scripts/bench_packed_transformer.py: 2 layers of the serving width,
     seq 512, batch 4, bf16, SGD momentum, loss mean(out^2) on
     pre-embedded inputs): one fused packed step's launches (fwd 8, dx 8,
     dw 8, flash fwd / dK-dV / dQ 2 each) and its output and gradients
     against the plain path; us/step of the dense twin and the packed
     model, each with the unfused and the fused attention core, in
     mirrored order, their ratios, MFU by bench.py's formula, device busy
     shares, and each arm's kernel time per step, in all and by kernel;
 11. LM training, a main path: PackedLMTrainer at that width (vocab 64
     synthetic stream, seq 512, batch 4, bf16, s = 0.8) trains 30 RigL
     steps with updates at 0, 10 and 20 (counts preserved, grown blocks'
     weights and Adam slots zero, finite falling loss), then SET and SNFS
     a few steps with one update each; 16 greedy tokens with kv_chunk 0
     and 128 (L = 1024) must agree;
 12. tap kernels vs plain: the tap conv's forward, dx and dw kernels, each
     against its plain version, at the four WRN-22-2 conv shapes and RN50's
     four stride-1 3x3 shapes (batch 128, ERK-0.8 densities, block (16,
     16)) in f32 and bf16, in f32 at batch 100, a 5x5 kernel and an
     empty output column, and in bf16 at block (8, 8) at one WRN shape
     (the tf32 branch's bf16 instance); beside cuDNN on the expanded
     weight (F.conv2d, torch.nn.grad.conv2d_input and conv2d_weight, TF32
     off) and the bound;
     then the RN50 default route's points (bf16, block (128, 128), batch
     128, ERK 0.8): the forward, dx and dw at the 29 eligible 1x1 shapes,
     forward and dx each beside B7 (dense_mm_cuda on the same lists,
     bitwise equal), all beside cuBLAS, with their sums, and at the six
     3x3 shapes the step runs with block_conv3x3, beside cuDNN.  Each
     forward / dx point
     prints its branch (ops/block_sparse_conv.py tap_branch: mm for a
     1x1, wgmma for bf16 KxK at blocks of 16s, tf32 for f32 and for bf16
     at blocks of 8s), and a tf32 point its tile (tap_tf32_tile);
 13. conv-net training, a main path: PackedClassifierTrainer on WRN-22-2
     with engine='tap' (synthetic CIFAR-10 shapes, standardized, batch
     128, block (16, 16), ERK s = 0.8, f32, SGD 0.05 nesterov 0.9) trains
     30 RigL steps with updates at 0, 10 and 20 (counts preserved, grown
     blocks' weights and momentum zero, finite falling loss, fwd / dx / dw
     launches 16 each per step), one step's loss and packed gradients
     against the plain path (the dense twin holding the unpacked kernels),
     evaluate, then SET and SNFS a few steps with one update each;
 14. WRN-22-2 step speed: us/step of the 'tap' engine, the 'xla' engine
     and the dense twin, each twice in mirrored order, with each arm's
     device busy share and kernel time per step by kernel, the tap arm's
     also for each of the tap conv's kernels;
 15. dense-storage kernels vs plain: the forward / dx kernels' dense
     modes (each point printing its branch) from the flat packing (v4,
     B7) and from per-column index lists (v3, B8), and the dw kernels'
     dense mode (the gathered dw, B9), each against its plain version (one
     torch.matmul per active block) at ResNet-50's 29 eligible 1x1 shapes
     (batch 128, 224 px, ERK-0.8 occupancies at block (128, 128), bf16)
     and at one shape in f32, beside torch.matmul on the masked dense W
     and the bound;
 16. dense-masked ResNet-50 training, a main path: the train step of
     bench.py's resnet50 arm with BENCH_BLOCK=128,128 (constants RN50_*)
     with its 29 eligible 1x1 convs routed 'matmul', 12 RigL steps with
     updates at steps 0, 5 and 10 (exactly 29 forward and 29 dx launches
     of the v4 form per iteration, every block layer at its static count
     after each update, finite loss, the schedule followed); one step's
     loss and gradients against the plain path (dense-times-mask on
     cuDNN) from the same state; masks after 3 iterations equal to those
     of dense-times-mask execution from the same initial state;
 17. the occupancy route, the paths of B8 and B9: GradualPruning steps of
     the same model (no static counts: its 1x1s hold occupancies, 29
     forward and 29 dx launches of the v3 form per step), BlockSparseDense
     forward and backward at the 3 x 4096 'layer' width (batch 1024, block
     (512, 512), s = 0.8) against masked dense matmuls, and one 'auto'
     call where the traffic model picks the gathered dw (B9);
 18. ResNet-50 step speed: us/step of RigL with 'matmul' routing, RigL
     with the default routing (1x1s on the tap kernels), the same with
     block_conv3x3 (the 13 3x3 convs that block (128, 128) divides on the
     tap kernels too), RigL with dense-times-mask execution and the dense
     algorithm, each twice in mirrored order, with each arm's device busy
     share and kernel time per step by kernel; the two tap arms, main
     paths, first checked: one forward, dx and dw tap entry call per
     executed conv in one hot step (29 each; 42), and one step's loss and
     gradients against the plain path (STEP_RTOL);
 19. history kernels vs plain, at scripts/bench_mlp_arms.py's shape (M, K,
     N) = (1024, 4096, 4096), bf16 at densities 1.0, 0.2, 0.1 and f32 at
     0.2: B11's forward (block_sparse_matmul_gather), B10's forward, dx
     and forward + backward (block_sparse_matmul_v6), B9'
     (pallas_dense_matmul, density 1.0) and B12's forward, dx and dw
     (block_sparse_matmul, block (128, 128)), beside torch.matmul on the
     masked dense W and the bound, each forward / dx point printing its
     branch; B11's and B12's forward, which build their entry lists from
     the mask on every call, also timed as the list building alone and
     the kernel alone (the point's ms; the entry's is entry_ms); B10's
     empty output column exactly zero
     in a reused NaN-filled buffer; then the arms path, each entry called
     once per point;
 20. the v6 and B12 MLP steps, the main paths of B10 and B12
     (scripts/bench_blocksparse_mlp.py, MLP_ENGINE=v6: 3 x 4096, batch
     1024, block (512, 512), s = 0.8, bf16 premasked weights, SGD
     momentum, loss mean(y^2)): one step's launches (v6: 3 forward, 2 dx,
     no gathered dw; B12: 3, 2, 3) and loss and gradients against the
     plain path, 10 steps with momentum and weights exactly zero at
     inactive blocks; us/step of the v6, B12, packed and dense arms in
     mirrored order with busy shares and kernel time by kernel; then
     phase 9 in f32;
 21. the f32 transformer train step, the main path of the f32 flash
     kernels and of the f32 dw: phase 10's model in float32, fused
     against unfused (output, loss and gradients within 1e-3), 2 launches
     of each f32 flash kernel and 8 of the forward, dx and dw per fused
     step, us/step of both in mirrored order, and the fused step's device
     time by kernel (torch.profiler), the flash kernels' and
     packed_dw_3xtf32_kernel's shares summed;
 22. the dense-masked model zoo, a main path of models/registry.py,
     data/pipeline.py and the structured mask generators (constants
     ZOO_*): make_train_step with SparseTraining (RigL, ERK 0.8, masks
     from the per_neuron generator, SGD 0.1 nesterov 0.9, weight decay
     1e-4, label smoothing 0.1) on batches from the port's synthetic
     datasets through ArrayDataset (pad_crop_flip(4) and per-image
     standardization for CIFAR shapes) and prefetch_to_device to the
     card; WRN-22-2 (batch 128, 32 px, f32) 12 steps with updates at
     steps 0, 5 and 10, MobileNetV1 width 1.0 (batch 32, 224 px, 1000
     classes, f32, its 13 depthwise kernels unmasked by the mask rule)
     6 steps with an update at step 0.  Checked: every output neuron's
     fan-in equal at init, every layer's active count after each update
     equal to its count at init, finite losses, the schedule followed, no
     mask and no zero on a depthwise kernel, and the first step's loss and
     gradients in float64 on the card against the same step in float64
     on the CPU (ZOO_F64_RTOL); printed: step ms (CUDA events), the
     device-busy share (torch.profiler) and each step's loss;
 23. the config-driven Trainer, a main path of train/trainer.py, its
     checkpoints, eval loop and export and of drivers/train.py and
     drivers/cifar.py (constants TRAINER_*): the repo's ResNet-50 preset
     (configs/imagenet_resnet50_rigl_erk80.json: ERK 0.8, RigL,
     premask_params, static_update_steps; float32) through
     drivers.train, batch 128, 12 steps with updates at 0, 5 and 10,
     block (128, 128) executed on its 29 1x1s (the tap conv's mm branch
     and the dense-storage dw) and the 3x3s that block divides (the tf32
     branch and tap_dw_kernel).  Checked: the batches against
     simulate_step_sequence and the final step, every block layer's count
     after each update, global sparsity within 0.01 of ERK's at init,
     the hints and the premask invariant, one tap launch of each kind
     per routed conv on every iteration and no other kernel, one step's
     loss and gradients against dense-times-mask (TRAINER_*_RTOL),
     the checkpoints, a second trainer that auto-resumes (params, masks
     and momentum equal to the first's final state) and runs on to step
     14, the eval loop against evaluate(), and export_model ->
     load_for_inference on the card against the trained model's logits;
     printed: step ms (CUDA events) of the plain and the update steps,
     the device-busy share, peak memory, launches per iteration and the
     losses.  Then WRN-22-2 through drivers.cifar at its defaults, 10
     steps (finite losses, the batch count, sparsity 0.9);
 24. the MoE LM, a main path of models/packed_moe.py, parallel/packed_ep.py
     and the MoE PackedLMTrainer (constants MOE_*: the `moe` arm's width,
     2 layers of d_model 1024 / d_ff 4096 / 16 heads, 8 experts at
     capacity factor 2.0, seq 512, batch 4, block (256, 256), s = 0.8,
     bf16 over f32): each expert's forward, dx and dw against their plain
     versions at m = 512 (1024 -> 4096 and 4096 -> 1024) and the forward
     and dx at m = 4 (the decode branch); one train step's launches (fwd,
     dx and dw 2 x (2 + 2 x 8) = 36 each) and its loss (aux included) and
     gradients against the plain path (the dense MoE twin) with the kernel
     path's routing replayed there, the smallest top-1 / top-2 router
     margin and the tokens the plain path alone would route elsewhere
     printed; RigL 30 steps with updates at 0, 10 and 20 (every expert's
     count kept, grown slots' weights and Adam slots zero, an expert's
     mask changed, the aux loss finite, the loss falling), SET and SNFS
     6 steps with one update each; 16 greedy tokens at batch 4 from
     64-token prompts with kv_chunk 0 and 128 (L = 1024) equal, and
     teacher-forced decoding against the full causal forward at capacity
     factor 8 (no drop) in f32; a save / restore round trip whose next
     step's loss is equal; drivers/packed_lm.py --n_experts=8 at its
     defaults, 6 steps and 4 generated tokens, on the card without
     --device; printed: step ms (CUDA events and host clock), update ms,
     the device-busy share and a step's device time by kernel
     (torch.profiler), the dense twin's step, peak memory;
 25. sparse RL, a main path of rl/ (envs, replay, networks, DQN, PPO,
     SAC) and drivers/rl.py (constants RL_*): (a) the two Atari RigL
     presets (configs/rl_dqn_atari_rigl.json, NatureDQN, and its
     impala_net twin, width 1.0, batch 32, learn_every 4, lr 2.5e-4, ERK
     0.9) through drivers.rl.run on Breakout, cut only in
     total_env_steps and maskupdate_frequency: the env-step and learn
     counts, four RigL updates with every layer at its init count and a
     mask changed, the global sparsity within 0.01 of ERK's, the target
     masks and params equal to the online ones after each sync (and not
     aliased), a finite return, and one plain learn step on the card
     against the same step on the CPU, both in float64 (RL_F64_*); (b)
     tests/test_rl.py's three slow learning checks at their settings on
     the card: DQN on CartPole above 35, PPO above 40, SAC on Pendulum
     above -900; (c) rl_dqn_gym_sparse, rl_ppo_mujoco_sparse and
     rl_sac_mujoco_sparse at their widths for a few hundred env steps;
     printed: env steps a second, the learn step's ms (CUDA events), the
     device-busy share (torch.profiler), host syncs per env step (0, by
     torch.cuda.set_sync_debug_mode), per learn step and per
     collect_and_learn, and peak memory;
 26. the analysis harness and the flop count (constants ANALYSIS_*):
     configs/lenet_rigl.json (LeNet-5, RigL, ERK 0.9) through
     drivers.train on the card for 300 steps with checkpoints, then
     drivers.analysis on its run directory: the exact Hessian of the last
     checkpoint at lenet_hessian.json's batch of 60000 (the eval batch
     repeated) and Lanczos at order 32 on every checkpoint, its extreme
     Ritz values inside the exact spectrum (ANALYSIS_RITZ_SLACK);
     lenet_interpolate.json's 29 points, finite, their ends equal to the
     two checkpoints' losses; MetaInit 10 steps with the gradient
     quotient falling; utils.flops.count_model of ResNet-50 on the card
     equal to its count on the CPU; printed: n_active, the Hessian's
     seconds and peak memory.

Every dw point (phases 3, 12, 15, 19 and 24) also logs how its kernel split
the reduction (ops/dw_split.py): S slices, the grid and the workspace's
bytes.  Each main path runs with the launch counts set to 0 just before
it and read just after.  The line before the last is the JSON record: `kernels`
(per kernel: the sums over its bf16 points, f32 for the f32 flash
kernels and the f32 dw, of ms, plain_ms, bound_ms and library_ms, its
launches on the main paths, and every point), `serving`, `training`,
`train_step`, `lm`, `wrn`, `rn50`, `history`, `f32_train_step`, `zoo`,
`trainer`, `moe_lm`, `rl`, `analysis` and the script's wall time; the
packed kernels'
entries count the MoE path's launches under `moe_lm` and list its points
as `moe_lm_points`.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this script, it exits non-zero and prints
no result.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
LAYERS, D_MODEL, D_FF, HEADS, VOCAB = 4, 2048, 8192, 16, 256
SPARSITY, BLOCK = 0.8, (512, 512)
BATCH, PROMPT, STEPS = 8, 128, 128
MAX_LEN = PROMPT + STEPS
# The repo's `mlp` model (scripts/bench_blocksparse_mlp.py): 3 hidden
# layers of 4096, batch 1024, block (512, 512), s = 0.8 (0.9 timed too).
MLP_WIDTH, MLP_DEPTH, MLP_BATCH = 4096, 3, 1024
MLP_SPARSITIES = (0.8, 0.9)
TRAIN_STEPS, TIMED_STEPS = 30, 20
# Kernel vs plain: both sum in f32 and round once, so bf16 outputs differ by
# at most a few bf16 ulps (2^-8 relative) from the order of the f32 sums;
# f32 outputs by f32 summation order over K <= 8192 terms.
TOL = {'bfloat16': 2e-2, 'float32': 1e-4}   # x max(1, max |plain|)
# Whole-model logits, kernel path vs the plain path, bf16: rounding points
# differ in every projection of 4 layers; relative to max |logit|.
LOGIT_RTOL = 5e-2
# H100 SXM data sheet: HBM rate, dense peak per dtype.  bf16: the tensor
# cores.  f32: a third of the 495 TFLOP/s TF32 rate, the rate of
# f32-accurate products in error-compensated TF32 (three passes), which
# the f32 flash backward runs and no f32 kernel can beat by its own
# means (the CUDA cores' FFMA peak is 67).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 495e12 / 3}
LIBRARIES = ('packed_mm', 'flash_attn', 'tap_conv')
# Transformer training (scripts/bench_packed_transformer.py): 2 layers of
# the serving width, seq 512, batch 4, bf16, block (512, 512), s = 0.8.
TR_LAYERS, TR_SEQ, TR_BATCH = 2, 512, 4
# Flash kernels vs plain: (B, H, S, hd) of the train step, a ragged S and
# the other head dims.  Both sides sum in f32; the kernels round P (for
# P v and Pᵀ do) and dS to bf16 before their products where the plain
# versions keep f32, so bf16 outputs differ by a few bf16 ulps of the
# largest value (relative to max |plain|); lse is f32 from f32 sums.
FLASH_SHAPES = ((4, 16, 512, 128), (4, 16, 1000, 128), (4, 16, 512, 64),
                (4, 16, 512, 32))
FLASH_TOL, LSE_TOL = 2e-2, 1e-4
# A head dim the kernels do not take, which flash_attention zero-pads.
FLASH_PADDED_SHAPE = (4, 16, 512, 48)
# One bf16 train step, kernel path vs plain path (dense twin, plain
# attention): rounding points differ in every product of 2 layers; each
# error over its own largest plain value.
STEP_RTOL = 5e-2
LM_STEPS, LM_VOCAB = 30, 64
# WRN-22-2 on CIFAR-10 shapes, the JAX packed-conv driver's --arch=wrn
# (rigl_tpu/drivers/packed_conv.py): batch 128, block (16, 16), ERK at
# s = 0.8, f32, SGD lr 0.05 with nesterov momentum 0.9.  Its 16 stride-1
# 3x3 convs run the tap kernels; the 2 stride-2 ones the 'xla' engine.
WRN_DEPTH, WRN_WIDTH, WRN_BATCH, WRN_BLOCK = 22, 2, 128, (16, 16)
WRN_SPARSITY, WRN_STEPS, WRN_TAP_CONVS = 0.8, 30, 16
# One f32 step, tap path vs plain path (the dense twin on cuDNN, TF32 off):
# the same sums in another order through 20 convs and 21 GroupNorms, each
# error over its own largest plain value.  The largest, at the first
# group's kernels and GroupNorm biases, measured 6.7e-4 and 1.8e-3 in two
# runs (cuDNN picks its algorithms per run); a wrong tap or block would be
# of order 1.
WRN_STEP_RTOL = 1e-2
# The dense-masked ResNet-50 step, bench.py's resnet50 arm with
# BENCH_BLOCK=128,128: 1000 classes, batch 128 of 224 x 224 x 3, bf16
# compute over f32 parameters and BatchNorm statistics, RigL at ERK 0.8
# with the first conv unmasked, SGD 0.1 nesterov 0.9, weight decay 1e-4,
# label smoothing 0.1, pre-masked storage; the mask-update frequency cut
# from 100 to 5 so that 12 steps hold updates at steps 0, 5 and 10.  Its
# 29 1x1 convs that block (128, 128) divides run 'matmul' (B7).
RN50_BLOCK, RN50_BATCH, RN50_IMAGE, RN50_SPARSITY = (128, 128), 128, 224, 0.8
RN50_1X1, RN50_FREQ, RN50_STEPS, RN50_PRUNE_STEPS = 29, 5, 12, 3
RN50_TIMED = 5
# BlockSparseDense at scripts/bench_blocksparse_mlp.py's 'layer' width.
MLP_BSD_BLOCK = (512, 512)
# The history entries at scripts/bench_mlp_arms.py's shape (bf16 at three
# densities, f32 at 0.2), B12 at its own default block; the v6 and B12 MLP
# steps run V6_STEPS steps after their one-step check.
ARMS_M, ARMS_K, ARMS_N, ARMS_BM = 1024, 4096, 4096, 512
ARMS_DENSITIES = (1.0, 0.2, 0.1)
V1_BLOCK, V6_STEPS = (128, 128), 10
# f32 flash kernels vs plain: both sum in f32 (the forward on the CUDA
# cores, dK/dV and dQ in 3xTF32, whose products keep about 21 bits), so
# outputs differ by summation order and the 2^-21 of each product: 1e-4
# of each output's largest value.  The f32 transformer step, fused vs
# unfused: the same sums in another order through 2 layers and their
# LayerNorms, each error over its own largest value.
FLASH_F32_TOL, F32_STEP_RTOL = 1e-4, 1e-3

# The dense-masked zoo (phase 22): name, registry kwargs, batch, the
# port's dataset, steps, mask-update frequency.  WRN-22-2 is the RigL
# paper's CIFAR-10 model at its published width; MobileNetV1 at width 1.0
# its ImageNet one, depthwise kernels dense by convention.
ZOO = (
    ('wrn_22_2', {}, 128, 'cifar10', 12, 5),
    ('mobilenet_v1', dict(num_classes=1000), 32, 'imagenet', 6, 100),
)
ZOO_SPARSITY = 0.8
# The first step against the CPU runs in float64 on both: at random init,
# these models' float32 gradients differ from their float64 ones by up to
# 2e-2 (WRN-22-2) and 7e-2 (MobileNetV1) of a tensor's largest value on
# the CPU alone (BatchNorm's E[x^2] - E[x]^2 in float32 through 21 and 27
# layers), so float32 cannot hold two devices together.  In float64 both
# take the loss from float32 logits, as the package does; a 6e-8 change
# of that float32 loss moves the float64 gradients by at most 8e-8 (CPU).
ZOO_F64_RTOL = 1e-5

# The trainer (phase 23): the repo's ResNet-50 preset (ERK 0.8, RigL,
# premask_params, static_update_steps; float32, as in JAX) through
# drivers.train, cut as TRAINER_REDUCED says, with block execution of its
# 1x1s and of the 3x3s that block (128, 128) divides.
TRAINER_CONFIG = 'configs/imagenet_resnet50_rigl_erk80.json'
TRAINER_OVERRIDES = (
    'batch_size=128', 'train_steps=12', 'maskupdate_frequency=5',
    'log_every=4', 'checkpoint_every=6', 'n_synthetic=256',
    'block_width=128', 'block_height=128', 'block_execution=True',
    'block_conv3x3=True')
TRAINER_REDUCED = {
    'batch_size': '1024 -> 128: 1024 images of activations at 224 px in '
                  'float32 do not fit 80 GB',
    'train_steps': '112590 -> 12 (resumed to 14)',
    'maskupdate_frequency': '100 -> 5, so that 12 steps hold updates',
    'n_synthetic': 'synthetic ImageNet (no ImageNet in the repo), 256 '
                   'images'}
TRAINER_RESUME_STEPS = 14
# The port's kernels on the trainer's path, whose device time a plain step
# is summed by name.
TRAINER_KERNELS = ('tap_conv_tf32_kernel', 'tap_w_split_kernel',
                   'tap_dw_kernel', 'tap_dw_reduce_kernel',
                   'packed_mm_ffma_kernel', 'packed_dw_3xtf32_kernel',
                   'packed_dw_reduce_kernel')
# One float32 step on the trained state, the tap kernels (3xTF32 3x3s,
# FFMA 1x1s) against dense-times-mask on cuDNN with TF32 off: the same
# sums in another order through 53 convs and BatchNorms, each error over
# its own largest plain value; a wrong tap or block would be of order 1.
# Measured (H100, four runs): the loss's relative error 0, so
# TRAINER_LOSS_RTOL; the routed convs' kernel gradients 3.9e-4 to 8.4e-4,
# every conv and dense kernel's the same in the two runs that read them,
# so TRAINER_KERNEL_RTOL on all of them, which plain TF32 products
# exceed: cuDNN in TF32 against the kernels, as the phase also prints,
# gave 6.3e-2 and 8.1e-2 on the routed convs' gradients (the loss 4.6e-7
# and 6.8e-7); the BatchNorm scales' and biases' gradients 9.4e-3 to
# 1.96e-2, largest at group 2-3's biases (sums of the whole batch's gy, E[x^2] -
# E[x]^2 in float32: two evaluation orders of one float32 model differ by
# up to 2e-2 and 7e-2 on the CPU alone, ZOO_F64_RTOL's note), so
# TRAINER_BN_RTOL.
TRAINER_LOSS_RTOL, TRAINER_KERNEL_RTOL, TRAINER_BN_RTOL = 1e-5, 5e-3, 5e-2
# The exported model's logits against the trained model's eval-mode ones
# (the same dense convs on the same w * m), and the eval loop's metrics
# against evaluate() on the state.
TRAINER_EXPORT_RTOL = 1e-5
# WRN-22-2 through drivers.cifar at its defaults (RigL, s = 0.9, batch
# 128, the cifar schedule) on synthetic CIFAR-10.
TRAINER_WRN = ('--train_steps=10', '--maskupdate_frequency=5',
               '--log_every=5')
# The MoE LM (phase 24): the width of the repo's `moe` arm
# (scripts/bench_packed_moe.py:31-42, bench.py's BENCH_WORKLOAD=moe), 2
# layers of d_model 1024 / d_ff 4096 / 16 heads, seq 512, batch 4, 8
# experts at capacity factor 2.0, block (256, 256), bm 512, s = 0.8, bf16
# over f32 master weights, through PackedLMTrainer; vocab 64 on the
# synthetic stream, as phase 11.  An expert runs 2048 / 8 x 2 = 512 rows a
# training step, 256 at the prefill of 4 prompts of 64 tokens and 4 a
# decode step (the decode branch).
MOE_LAYERS, MOE_D_MODEL, MOE_D_FF, MOE_HEADS = 2, 1024, 4096, 16
MOE_EXPERTS, MOE_CAPACITY, MOE_BLOCK, MOE_BM = 8, 2.0, (256, 256), 512
MOE_PROMPT, MOE_GENERATE = 64, 16
# Decode against the full causal forward at capacity factor E runs in f32
# (the f32 forward's FFMA branch, the decode branch at m = 4): bf16 would
# round the router's input differently in the two passes, and a token
# whose two top router probabilities lie within that rounding could pick
# another expert, an order-1 difference for that token.  Both passes sum
# in f32 in another order through 2 layers: 1e-3 of the largest logit.
MOE_DECODE_RTOL = 1e-3


class SmokeFailure(Exception):
  pass


def check(cond, msg):
  if not cond:
    raise SmokeFailure(msg)


def log(msg):
  print(msg, flush=True)


def device_ms(fn, iters):
  """Device time of one fn() call, after a warm-up: CUDA events around
  `iters` back-to-back calls that the host queued while the device slept
  (torch.cuda._sleep), so the window holds the calls' device work and
  launch gaps, not the host's time to issue them.  The sleep lasts at
  least twice the wall time of `iters` synchronised calls (and 50 ms), so
  the host has queued them all before it ends.  (torch.profiler
  sessions, used for this at first, stopped recording device time after
  some tens of sessions on the card.)"""
  import torch
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  sleep_s = max(0.05, 2 * iters * (time.perf_counter() - t0))
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(int(sleep_s * 2e9))   # cycles; the clock is <= 2 GHz
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  ms = start.elapsed_time(end) / iters
  check(ms > 0, 'no device time recorded')
  return ms


def time_ms(fn, iters):
  """Mean CUDA-event time of fn() over `iters` back-to-back calls, after
  a warm-up: what a caller's loop sees, host overhead included."""
  import torch
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


def host_ms(fn, iters):
  """Host time to issue one fn() call: the wall time of `iters` calls,
  taken before the device is waited for, / iters (after a warm-up)."""
  import torch
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(iters):
    fn()
  dt = time.perf_counter() - t0
  torch.cuda.synchronize()
  return dt * 1e3 / iters


def profiled_kernel_time(torch, step, n, match=()):
  """{'kernel_us_per_step', 'device_ms_by_kernel'}: the device time of n
  step() calls under torch.profiler (device activity only), per step, in
  all and for the 8 largest kernels, which it logs; for each string of
  `match`, also 'matched_us_per_step' and 'matched_by_kernel' under that
  string: the kernels whose names hold it.  torch.profiler can stop
  recording device time within
  a process (on the card, after as few as 5 profiling runs or as many as
  some tens): a run that records none is tried once more, then the values
  are None, not measured."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(2):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(n):
        step()
      torch.cuda.synchronize()
    events = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in events) / n
    if kernel_us > 0:
      top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
      log('  top kernels, device ms and launches per step:')
      for e in top:
        log(f'    {e.self_device_time_total / 1e3 / n:8.3f} ms '
            f'{e.count / n:5.1f} x {e.key[:90]}')
      rec = dict(kernel_us_per_step=kernel_us, device_ms_by_kernel={
          e.key[:90]: [e.self_device_time_total / 1e3 / n, e.count / n]
          for e in top})
      if match:
        rec['matched_us_per_step'], rec['matched_by_kernel'] = {}, {}
      for name in match:
        hits = [e for e in events if name in e.key]
        rec['matched_us_per_step'][name] = sum(
            e.self_device_time_total for e in hits) / n
        rec['matched_by_kernel'][name] = {
            e.key[:90]: [e.self_device_time_total / 1e3 / n, e.count / n]
            for e in hits}
      return rec
  log('  torch.profiler recorded no device time: kernel time not measured')
  rec = dict(kernel_us_per_step=None, device_ms_by_kernel=None)
  if match:
    rec.update(matched_us_per_step=None, matched_by_kernel=None)
  return rec


def _share(part, whole):
  """part / whole, or None where part was not measured."""
  return None if part is None else part / whole


def phase_device(torch):
  log(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
      f'cuda {torch.version.cuda}  devices {torch.cuda.device_count()}')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      timeout=60, check=False)
  check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr.strip()}')
  card = smi.stdout.strip().splitlines()[0]
  log(card)
  return card


def phase_build():
  """Builds every kernel library, one nvcc per source, all started
  together, and prints ptxas' report of each."""
  from concurrent.futures import ThreadPoolExecutor
  from rigl_tpu_torch.ops import _build
  root = Path(__file__).resolve().parent
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(LIBRARIES)) as pool:
    built = list(pool.map(_build.build, LIBRARIES))
  for name in LIBRARIES:
    _build.load(name)
  log(f'build: {", ".join(str(so.relative_to(root)) for so in built)} in '
      f'{time.perf_counter() - t0:.2f} s (in parallel)')
  for so in built:
    for line in so.with_suffix('.log').read_text().splitlines():
      if 'entry function' in line:
        log(f'  ptxas: {line.split("entry function")[1].strip()[:110]}')
      elif any(w in line for w in ('registers', 'spill', 'error',
                                   'serialized')):   # wgmma serialised
        log(f'    {line.strip()}')


def layer_shapes():
  return {'qkv': (D_MODEL, 3 * D_MODEL), 'out': (D_MODEL, D_MODEL),
          'fc1': (D_MODEL, D_FF), 'fc2': (D_FF, D_MODEL)}


def dtype_name(dtype):
  return str(dtype).split('.')[-1]


def bound(op, m, packing, block, dtype):
  """(ms, 'bytes' | 'operations'): the least time of one call on an H100,
  the larger of the bytes it must move (the activation columns of
  non-empty block-rows / -columns and the active weights read once, the
  output written once) over HBM_BYTES_PER_S and its FLOPs on the active
  blocks over PEAK_FLOPS."""
  import torch
  bk, bn = block
  nk, nn_ = packing.shape
  e = torch.empty((), dtype=dtype).element_size()
  occ = torch.zeros(nk, nn_, dtype=torch.bool)
  cols, rows = (t[:packing.n_active].long() for t in packing.fwd[:2])
  occ[rows, cols] = True
  k_used = int(occ.any(1).sum()) * bk
  n_used = int(occ.any(0).sum()) * bn
  w_bytes = packing.n_active * bk * bn * e
  moved = {'fwd': m * k_used * e + w_bytes + m * nn_ * bn * e,
           'dx': m * n_used * e + w_bytes + m * nk * bk * e,
           'dw': m * k_used * e + m * n_used * e + w_bytes}[op]
  flops = 2.0 * m * packing.n_active * bk * bn
  t_bytes = moved / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def kernel_point(torch, label, counter, run, plain, library, bound_,
                 module=None, library_name='torch.matmul', plain_iters=10,
                 branch=None):
  """Launches `run` once (its counter, an attribute of `module`, by
  default ops/block_sparse_packed, must move by one), holds its output
  against `plain` on the same inputs, then times kernel, plain version and
  the dense `library` call.  `branch`, where given, is the forward / dx
  branch the call takes (ops/block_sparse_packed.py mm_branch, which the
  wrappers pass to the kernel), logged and recorded.  Returns
  (record, kernel output)."""
  if module is None:
    from rigl_tpu_torch.ops import block_sparse_packed as module
  before = getattr(module, counter)
  got = run()
  torch.cuda.synchronize()
  check(getattr(module, counter) == before + 1, f'{label}: not launched')
  want = plain()
  check(bool(torch.isfinite(got).all()), f'{label}: non-finite output')
  check(got.shape == want.shape and got.dtype == want.dtype,
        f'{label}: {tuple(got.shape)} {got.dtype} vs plain '
        f'{tuple(want.shape)} {want.dtype}')
  err = float((got.float() - want.float()).abs().max())
  scale = max(1.0, float(want.float().abs().max()))
  tol = TOL[dtype_name(got.dtype)] * scale
  rec = dict(max_abs_err=err, max_rel_err=err / scale, tol=tol,
             ms=device_ms(run, 20), plain_ms=device_ms(plain, plain_iters),
             library_ms=device_ms(library, 20), host_ms=host_ms(run, 20),
             bound_ms=bound_[0], bound_by=bound_[1])
  if branch:
    rec['branch'] = branch
  log(f'{label}{f" [{branch}]" if branch else ""}: max|err| {err:.3e} (rel '
      f'{err / scale:.3e}, tol {tol:.3e})'
      f'  device ms: kernel {rec["ms"]:.4f}, plain {rec["plain_ms"]:.4f}, '
      f'{library_name} {rec["library_ms"]:.4f}, bound {bound_[0]:.4f} '
      f'({bound_[1]})  host {rec["host_ms"]:.4f}')
  check(err <= tol, f'{label}: error {err} > {tol}')
  return rec, got


def dw_split(label, plan):
  """Logs a dw point's split of its reduction (ops/dw_split.py: S slices,
  the first kernel's grid, the f32 workspace) and, for the block dw
  kernels, its tile (ops/block_sparse_packed.py dw_tile), and returns
  them for the point's record."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  tile = None if plan.tile is None else list(bsp.DW_TILES[plan.tile][:2])
  log(f'  {label}: S = {plan.slices} ({plan.slice_rows} rows a slice), '
      f'grid {plan.grid}, workspace {plan.workspace_bytes} bytes'
      + ('' if tile is None else f', tile {tile[0]} x {tile[1]}'))
  return dict(slices=plan.slices, slice_rows=plan.slice_rows,
              grid=list(plan.grid), workspace_bytes=plan.workspace_bytes,
              tile=tile)


def sm_count(torch):
  return torch.cuda.get_device_properties(0).multi_processor_count


def decode_sweep(torch, run):
  """{S: device ms} of a decode call `run` with its cluster size forced
  to each S of 1, 2, 4, 8 (ops/mm_split.py decode_plan's `slices`),
  logged."""
  import functools
  from rigl_tpu_torch.ops import mm_split
  planner = mm_split.decode_plan
  out = {}
  try:
    for s in (1, 2, 4, 8):
      mm_split.decode_plan = functools.partial(planner, slices=s)
      out[s] = device_ms(run, 20)
  finally:
    mm_split.decode_plan = planner
  log('  at S = 1 / 2 / 4 / 8: '
      + ' / '.join(f'{ms * 1e3:.2f}' for ms in out.values()) + ' us')
  return out


def decode_plan(torch, m, ngroups, out_w, seg, longest, dtype):
  """Logs a decode point's plan (ops/mm_split.py decode_plan, as the
  wrapper makes it): S blocks a cluster, the tile, the grid, the bytes in
  flight per SM; returns it for the point's record."""
  from rigl_tpu_torch.ops import mm_split
  sms = sm_count(torch)
  plan = mm_split.decode_plan(m, out_w, ngroups, seg, longest, dtype, sms)
  flight = plan.bytes_in_flight_per_sm(sms)
  log(f'  decode plan: S = {plan.slices} (clusters of {plan.slices}), tile '
      f'{plan.rows} x {mm_split.TILE}, {plan.tiles} tiles, grid '
      f'{plan.grid}, {plan.chunks} chunks in the longest column, '
      f'{flight} bytes in flight per SM ({plan.stage_bytes} a stage, '
      f'{plan.smem_bytes} bytes of shared memory a block)')
  return dict(slices=plan.slices, rows=plan.rows, tile_columns=mm_split.TILE,
              tiles=plan.tiles, grid=list(plan.grid), chunks=plan.chunks,
              bytes_in_flight_per_sm=flight, stage_bytes=plan.stage_bytes,
              smem_bytes=plan.smem_bytes)


def phase_kernel(torch, device):
  """The forward kernel vs plain at the serving model's shapes."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED)
  bk, bn = BLOCK
  points = [(name, m, torch.bfloat16) for name in layer_shapes()
            for m in (8, 1024)] + [('fc1', 8, torch.float32)]
  records = []
  for name, m, dtype in points:
    kdim, ndim = layer_shapes()[name]
    nk, nn_ = kdim // bk, ndim // bn
    n_act = nk * nn_ - get_n_zeros(nk * nn_, SPARSITY)
    packing = bsp.make_packing(random_occupancy(gen, nk, nn_, n_act), n_act)
    x = torch.randn(m, kdim, generator=gen).to(device, dtype)
    w = (torch.randn(n_act, bk, bn, generator=gen) / kdim ** 0.5).to(
        device, dtype)
    wd = bsp.unpack_dense(w, packing, BLOCK)
    branch = bsp.mm_branch(m, bk, dtype)
    before = bsp.mm_decode_launches
    rec, got = kernel_point(
        torch, f'fwd {name:3s} m={m:4d} {dtype_name(dtype):8s}',
        'packed_mm_launches',
        lambda: bsp.packed_matmul(x, w, packing, BLOCK),
        lambda: bsp.packed_matmul_reference(x, w, packing, BLOCK),
        lambda: torch.matmul(x, wd), bound('fwd', m, packing, BLOCK, dtype),
        branch=branch)
    if branch == 'decode':
      check(bsp.mm_decode_launches > before,
            f'{name} m={m}: the decode kernel did not run')
      rec['decode_plan'] = decode_plan(torch, m, nn_, bn, bk,
                                       packing.longest('fwd'), dtype)
      rec['ms_by_slices'] = decode_sweep(
          torch, lambda: bsp.packed_matmul(x, w, packing, BLOCK))
    empty = (packing.column_index('cpu')[0].diff() == 0).nonzero().flatten()
    check(all(not bool(got[:, int(j) * bn:(int(j) + 1) * bn].any())
              for j in empty), f'{name} m={m}: an empty column is not zero')
    rec.update(path='serving', layer=name, m=m, dtype=dtype_name(dtype),
               k=kdim, n=ndim, n_active=n_act, empty_columns=len(empty))
    records.append(rec)
  kdim, ndim = layer_shapes()['fc2']
  nk, nn_ = kdim // bk, ndim // bn
  none = bsp.make_packing(torch.zeros(nk, nn_, dtype=torch.int32), 0)
  x = torch.randn(8, kdim, generator=gen).to(device, torch.bfloat16)
  w = torch.zeros(0, bk, bn, dtype=torch.bfloat16, device=device)
  y = bsp.packed_matmul(x, w, none, BLOCK)
  torch.cuda.synchronize()
  check(not bool(y.any()), 'decode with no active block: output not zero')
  log(f'decode floor: fc2 {kdim} x {ndim} m=8 bfloat16, no active block:')
  floor = decode_sweep(torch, lambda: bsp.packed_matmul(x, w, none, BLOCK))
  return records, floor


def _mlp_occupancy(torch, gen, sparsity, empty_row_col):
  """(8, 8) occupancy at `sparsity`; with empty_row_col, block-row 0 and
  block-column 0 hold no active block."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  nb = MLP_WIDTH // BLOCK[0]
  n_act = nb * nb - get_n_zeros(nb * nb, sparsity)
  if not empty_row_col:
    return random_occupancy(gen, nb, nb, n_act), n_act
  occ = torch.zeros(nb, nb, dtype=torch.int32)
  occ[1:, 1:] = random_occupancy(gen, nb - 1, nb - 1, n_act)
  return occ, n_act


def _product_ops(torch, x, gy, w, packing, block=BLOCK):
  """{op: (counter, kernel call, plain call, torch.matmul call)} for the
  forward, dx and packed dw of one packed layer on the same inputs."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  wd = bsp.unpack_dense(w, packing, block)
  return {
      'fwd': ('packed_mm_launches',
              lambda: bsp.packed_matmul(x, w, packing, block),
              lambda: bsp.packed_matmul_reference(x, w, packing, block),
              lambda: torch.matmul(x, wd)),
      'dx': ('packed_mm_dx_launches',
             lambda: bsp.packed_matmul_dx_cuda(gy, w, packing, block),
             lambda: bsp.packed_matmul_dx_reference(gy, w, packing, block),
             lambda: torch.matmul(gy, wd.T)),
      'dw': ('packed_dw_launches',
             lambda: bsp.packed_dw_cuda(x, gy, w, packing, block),
             lambda: bsp.packed_dw_reference(x, gy, packing, block, w.dtype),
             lambda: torch.matmul(x.T, gy))}


def phase_train_kernels(torch, device):
  """Forward, dx and packed dw vs plain at the training shape."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  gen = torch.Generator().manual_seed(SEED + 5)
  bk, bn = BLOCK
  f32, bf16 = torch.float32, torch.bfloat16
  points = [(s, MLP_BATCH, dt, False) for s in MLP_SPARSITIES
            for dt in (bf16, f32)]
  points += [(SPARSITY, 1000, bf16, False), (SPARSITY, MLP_BATCH, bf16, True)]
  records = {'fwd': [], 'dx': [], 'dw': []}
  for sparsity, m, dtype, empty in points:
    occ, n_act = _mlp_occupancy(torch, gen, sparsity, empty)
    packing = bsp.make_packing(occ, n_act)
    x = torch.randn(m, MLP_WIDTH, generator=gen).to(device, dtype)
    gy = torch.randn(m, MLP_WIDTH, generator=gen).to(device, dtype)
    w = (torch.randn(n_act, bk, bn, generator=gen) / MLP_WIDTH ** 0.5).to(
        device, dtype)
    tag = (f's={sparsity} m={m:4d} {dtype_name(dtype):8s}'
           + (' empty row+col' if empty else ''))
    ops = _product_ops(torch, x, gy, w, packing)
    for op, (counter, run, plain, library) in ops.items():
      rec, got = kernel_point(
          torch, f'{op:3s} {tag}', counter, run, plain, library,
          bound(op, m, packing, BLOCK, dtype),
          branch=None if op == 'dw' else bsp.mm_branch(
              m, bk if op == 'fwd' else bn, dtype))
      if op == 'fwd':
        empty_cols = (occ.sum(0) == 0).nonzero().flatten().tolist()
        check(all(not bool(got[:, j * bn:(j + 1) * bn].any())
                  for j in empty_cols), f'fwd {tag}: empty column not zero')
      if op == 'dx':
        empty_rows = (occ.sum(1) == 0).nonzero().flatten().tolist()
        check(all(not bool(got[:, k * bk:(k + 1) * bk].any())
                  for k in empty_rows), f'dx {tag}: empty row not zero')
      rec.update(path='training', sparsity=sparsity, m=m,
                 dtype=dtype_name(dtype), k=MLP_WIDTH, n=MLP_WIDTH,
                 n_active=n_act, empty_row_and_column=empty)
      if op == 'dw':
        rec['split'] = dw_split(f'dw  {tag}', bsp.dw_plan(
            m, n_act, BLOCK, dtype, sm_count(torch)))
      records[op].append(rec)
  return records


def phase_step_kernels(torch, device):
  """Forward, dx and packed dw vs plain at the transformer train step's
  shapes: m = batch x seq = 2048 rows, each layer of a block (s = 0.8,
  block (512, 512), bf16); then the packed dw in f32 at the same shapes,
  the calls of the f32 step (phase 21)."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED + 10)
  bk, bn = BLOCK
  m = TR_BATCH * TR_SEQ
  records = {'fwd': [], 'dx': [], 'dw': []}
  for name, (kdim, ndim) in layer_shapes().items():
    nk, nn_ = kdim // bk, ndim // bn
    n_act = nk * nn_ - get_n_zeros(nk * nn_, SPARSITY)
    packing = bsp.make_packing(random_occupancy(gen, nk, nn_, n_act), n_act)
    x = torch.randn(m, kdim, generator=gen).to(device, torch.bfloat16)
    gy = torch.randn(m, ndim, generator=gen).to(device, torch.bfloat16)
    w = (torch.randn(n_act, bk, bn, generator=gen) / kdim ** 0.5).to(
        device, torch.bfloat16)
    ops = _product_ops(torch, x, gy, w, packing)
    for op, (counter, run, plain, library) in ops.items():
      rec, _ = kernel_point(
          torch, f'{op:3s} {name:3s} m={m} bfloat16', counter, run, plain,
          library, bound(op, m, packing, BLOCK, torch.bfloat16),
          branch=None if op == 'dw' else bsp.mm_branch(
              m, bk if op == 'fwd' else bn, torch.bfloat16))
      rec.update(path='train_step', layer=name, m=m, dtype='bfloat16',
                 k=kdim, n=ndim, n_active=n_act)
      if op == 'dw':
        rec['split'] = dw_split(f'dw  {name:3s} m={m}', bsp.dw_plan(
            m, n_act, BLOCK, torch.bfloat16, sm_count(torch)))
      records[op].append(rec)
    x, gy, w = x.float(), gy.float(), w.float()
    counter, run, plain, library = _product_ops(torch, x, gy, w,
                                                packing)['dw']
    rec, _ = kernel_point(
        torch, f'dw  {name:3s} m={m} float32', counter, run, plain, library,
        bound('dw', m, packing, BLOCK, torch.float32))
    rec.update(path='train_step', layer=name, m=m, dtype='float32', k=kdim,
               n=ndim, n_active=n_act)
    rec['split'] = dw_split(f'dw  {name:3s} m={m} float32', bsp.dw_plan(
        m, n_act, BLOCK, torch.float32, sm_count(torch)))
    records['dw'].append(rec)
  return records


def phase_narrow_tiles(torch, device):
  """Forward and dx vs plain on the wgmma branch's narrower and ragged
  tiles (ops/block_sparse_packed.py mm_tile), bf16, s = 0.8: block (96,
  96), m = 1024, K = N = 3072 (a contraction per active that 64 does not
  divide: tile 128 x 32); and block (16, 16), m = 25088, K = N = 512
  (MobileNetV1's 14 x 14 pointwise shape at batch 128: tile 16 x 16)."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED + 7)
  dtype = torch.bfloat16
  records = {'fwd': [], 'dx': []}
  for block, width, m in (((96, 96), 3072, MLP_BATCH),
                          ((16, 16), 512, 25088)):
    nb = width // block[0]
    n_act = nb * nb - get_n_zeros(nb * nb, SPARSITY)
    packing = bsp.make_packing(random_occupancy(gen, nb, nb, n_act), n_act)
    x = torch.randn(m, width, generator=gen).to(device, dtype)
    gy = torch.randn(m, width, generator=gen).to(device, dtype)
    w = (torch.randn(n_act, *block, generator=gen) / width ** 0.5).to(
        device, dtype)
    wd = bsp.unpack_dense(w, packing, block)
    ops = {'fwd': ('packed_mm_launches',
                   lambda: bsp.packed_matmul(x, w, packing, block),
                   lambda: bsp.packed_matmul_reference(x, w, packing, block),
                   lambda: torch.matmul(x, wd)),
           'dx': ('packed_mm_dx_launches',
                  lambda: bsp.packed_matmul_dx_cuda(gy, w, packing, block),
                  lambda: bsp.packed_matmul_dx_reference(gy, w, packing,
                                                         block),
                  lambda: torch.matmul(gy, wd.T))}
    for op, (counter, run, plain, library) in ops.items():
      branch = bsp.mm_branch(m, block[0], dtype)
      check(branch == 'wgmma', f'block {block}: branch {branch}, not wgmma')
      tile = list(bsp.MM_TILES[bsp.mm_tile(block[1], block[0])])
      log(f'  wgmma tile {tile[0]} columns x {tile[1]} deep')
      rec, _ = kernel_point(torch, f'{op:3s} block {block} m={m} bfloat16',
                            counter, run, plain, library,
                            bound(op, m, packing, block, dtype),
                            branch=branch)
      rec.update(path='narrow_tiles', sparsity=SPARSITY, m=m,
                 dtype='bfloat16', k=width, n=width, n_active=n_act,
                 block=list(block), tile=tile)
      records[op].append(rec)
    del x, gy, w, wd
  torch.cuda.empty_cache()
  return records


def phase_autograd(torch, device):
  """torch.autograd.grad through packed_matmul on CUDA tensors (the
  trainer's f32 shape) vs the plain functions on the same tensors."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  gen = torch.Generator().manual_seed(SEED + 6)
  occ, n_act = _mlp_occupancy(torch, gen, SPARSITY, False)
  packing = bsp.make_packing(occ, n_act)
  x = torch.randn(MLP_BATCH, MLP_WIDTH, generator=gen).to(device)
  w = (torch.randn(n_act, *BLOCK, generator=gen) / MLP_WIDTH ** 0.5).to(
      device)
  g = torch.randn(MLP_BATCH, MLP_WIDTH, generator=gen).to(device)
  x.requires_grad_()
  w.requires_grad_()
  before = (bsp.packed_mm_dx_launches, bsp.packed_dw_launches)
  dx, dw = torch.autograd.grad(bsp.packed_matmul(x, w, packing, BLOCK),
                               (x, w), g)
  torch.cuda.synchronize()
  moved = (bsp.packed_mm_dx_launches - before[0],
           bsp.packed_dw_launches - before[1])
  check(moved == (1, 1), f'autograd: dx/dw launches moved by {moved}')
  errs = {}
  for name, got, want in (
      ('dx', dx, bsp.packed_matmul_dx_reference(g, w.detach(), packing,
                                                BLOCK)),
      ('dw', dw, bsp.packed_dw_reference(x.detach(), g, packing, BLOCK,
                                         torch.float32))):
    scale = max(1.0, float(want.abs().max()))
    errs[name] = float((got - want).abs().max()) / scale
    check(errs[name] <= TOL['float32'], f'autograd {name}: rel error '
          f'{errs[name]} > {TOL["float32"]}')
  log(f'autograd on the card (f32, m={MLP_BATCH}, K = N = {MLP_WIDTH}, '
      f's={SPARSITY}): dx rel err {errs["dx"]:.3e}, dw rel err '
      f'{errs["dw"]:.3e}; dx/dw launches +1 each')
  return errs


def build_models(torch, device):
  from rigl_tpu_torch import convert
  from rigl_tpu_torch.models.packed_transformer import (DenseTransformer,
                                                        PackedTransformer)
  gen = torch.Generator().manual_seed(SEED)
  kw = dict(num_layers=LAYERS, d_model=D_MODEL, d_ff=D_FF, num_heads=HEADS,
            vocab_size=VOCAB, dtype=torch.bfloat16)
  packed = PackedTransformer(sparsity=SPARSITY, block=BLOCK, bm=512,
                             generator=gen, device=device, **kw)
  # The plain path end to end: the dense twin holding the unpacked kernels.
  dense = DenseTransformer(device='meta', **kw)
  dense.load_state_dict(convert.dense_twin_state(packed), strict=True,
                        assign=True)
  n_packed = sum(p.numel() for n, p in packed.named_parameters()
                 if n.endswith('kernel') and 'head' not in n)
  log(f'model: packed projection params {n_packed} '
      f'({n_packed * 2 / 2 ** 20:.1f} MiB bf16)')
  return packed, dense.to(device)


def phase_serve(torch, device, packed, dense):
  """The main path: two requests through generate.  Returns the launch
  count of the greedy request."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.serve.decode import decode_twin, generate, init_cache
  gen = torch.Generator().manual_seed(SEED + 1)
  prompt = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen,
                         dtype=torch.int32).to(device)
  twin = decode_twin(packed, MAX_LEN)

  _zero_counts()
  t0 = time.perf_counter()
  out = generate(twin, prompt, STEPS)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  counts = _counts()
  launches, decode = counts['fwd'], counts['decode']
  expect = LAYERS * 4 * STEPS
  log(f'request 1 (greedy, batch {BATCH}, prompt {PROMPT}, {STEPS} steps): '
      f'{dt:.3f} s, packed_mm launches {launches} (expected {expect}), of '
      f'which packed_mm_decode_kernel {decode} (expected '
      f'{LAYERS * 4 * (STEPS - 1)})')
  check(launches == expect, f'launches {launches} != {expect}')
  check(decode == LAYERS * 4 * (STEPS - 1),
        f'decode launches {decode} != {LAYERS * 4 * (STEPS - 1)}')
  check(tuple(out.shape) == (BATCH, STEPS) and out.dtype == torch.int32,
        f'request 1 output {tuple(out.shape)} {out.dtype}')
  check(int(out.min()) >= 0 and int(out.max()) < VOCAB, 'token out of range')

  # Logits: kernel path vs plain path, and decode prefill vs full forward.
  with torch.inference_mode():
    cache = init_cache(twin, BATCH)
    pre = twin(prompt, cache).float()
    plain = dense(prompt).float()
    full = packed(prompt).float()
  check(tuple(pre.shape) == (BATCH, PROMPT, VOCAB), f'logits {pre.shape}')
  check(bool(torch.isfinite(pre).all()), 'non-finite prefill logits')
  scale = float(plain.abs().max())
  err_plain = float((pre - plain).abs().max())
  err_full = float((pre - full).abs().max())
  agree = float((pre[:, -1].argmax(-1) == plain[:, -1].argmax(-1)).float()
                .mean())
  log(f'prefill logits: max|logit| {scale:.4f}  kernel vs plain max|err| '
      f'{err_plain:.4e} (rel {err_plain / scale:.3e}, tol {LOGIT_RTOL})  '
      f'decode vs full forward {err_full:.4e}  last-position argmax '
      f'agreement {agree:.3f}')
  check(err_plain <= LOGIT_RTOL * scale, 'kernel path disagrees with plain')
  check(err_full <= LOGIT_RTOL * scale, 'prefill disagrees with full pass')
  check(int(out[:, 0].eq(pre[:, -1].argmax(-1)).sum()) == BATCH,
        'first greedy token is not the argmax of the last prompt logit')

  lens = torch.tensor([max(8, PROMPT - 16 * i) for i in range(BATCH)],
                      dtype=torch.int32, device=device)
  padded = prompt.clone()
  for i, n in enumerate(lens.tolist()):
    padded[i, :PROMPT - n] = 0
  sgen = torch.Generator(device=device).manual_seed(SEED + 2)
  before = bsp.packed_mm_launches
  out2 = generate(twin, padded, STEPS, generator=sgen, temperature=0.8,
                  top_k=50, top_p=0.9, prompt_lens=lens)
  torch.cuda.synchronize()
  check(bsp.packed_mm_launches - before == expect, 'request 2 launches')
  check(tuple(out2.shape) == (BATCH, STEPS), f'request 2 {out2.shape}')
  check(int(out2.min()) >= 0 and int(out2.max()) < VOCAB, 'request 2 range')
  log(f'request 2 (left-padded lens {lens.tolist()}, T=0.8 top_k=50 '
      f'top_p=0.9): ok, {len(set(out2.flatten().tolist()))} distinct tokens')
  return (launches, decode), dict(prefill_rel_err=err_plain / scale,
                                  decode_vs_full_rel_err=err_full / scale)


def phase_speed(torch, device, packed, dense):
  """us/token of a whole greedy request (prefill + STEPS steps) / STEPS,
  and the device-busy share of one packed request at batch BATCH."""
  from torch.profiler import ProfilerActivity, profile
  from rigl_tpu_torch.serve.decode import decode_twin, make_generate_fn
  gen = torch.Generator().manual_seed(SEED + 3)
  rows = {}
  for batch in (BATCH, 1):
    prompt = torch.randint(0, VOCAB, (batch, PROMPT), generator=gen,
                           dtype=torch.int32).to(device)
    for label, model in (('packed', packed), ('dense', dense)):
      fn = make_generate_fn(decode_twin(model, MAX_LEN), STEPS)
      ms = time_ms(lambda: fn(prompt), 3)
      rows[f'{label}_b{batch}_us_per_token'] = ms * 1e3 / STEPS
      log(f'speed: {label:6s} batch {batch}: {ms * 1e3 / STEPS:.1f} '
          f'us/token ({ms:.1f} ms per request of {STEPS} tokens)')
      if batch == BATCH:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
          fn(prompt)
          torch.cuda.synchronize()
        stats = sorted(prof.key_averages(),
                       key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
        rows[f'{label}_b{batch}_device_busy_share'] = busy_ms / ms
        log(f'  device busy {busy_ms:.1f} ms of {ms:.1f} ms '
            f'({busy_ms / ms:.3f}); top kernels:')
        if label == 'packed' and busy_ms > 0:
          dec = [e for e in stats if 'packed_mm_decode_kernel' in e.key]
          dec_ms = sum(e.self_device_time_total for e in dec) / 1e3
          rows['packed_b8_decode_kernel_ms'] = dec_ms
          rows['packed_b8_decode_kernel_launches'] = sum(e.count for e in dec)
          rows['packed_b8_decode_kernel_busy_share'] = dec_ms / busy_ms
          log(f'  packed_mm_decode_kernel: {dec_ms:.2f} ms in '
              f'{rows["packed_b8_decode_kernel_launches"]} launches, '
              f'{dec_ms / busy_ms:.3f} of the device-busy time')
        for e in stats[:6]:
          log(f'    {e.self_device_time_total / 1e3:8.2f} ms '
              f'{e.count:6d} x {e.key[:90]}')
  return rows


def _counts():
  """{kernel: launches so far}: the wrappers' counters, packed (and the
  decode branch's, which the forward / dx counts include too), flash (bf16
  and f32), tap, dense-storage and history entries."""
  from rigl_tpu_torch.ops import block_sparse as v1
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.ops import block_sparse_v2 as v2
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.ops import block_sparse_v4 as v4
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  from rigl_tpu_torch.ops import flash_attention as fa
  return dict(fwd=bsp.packed_mm_launches, dx=bsp.packed_mm_dx_launches,
              dw=bsp.packed_dw_launches, decode=bsp.mm_decode_launches,
              flash_fwd=fa.flash_fwd_launches,
              flash_dkv=fa.flash_bwd_dkv_launches,
              flash_dq=fa.flash_bwd_dq_launches,
              flash_fwd_f32=fa.flash_fwd_f32_launches,
              flash_dkv_f32=fa.flash_bwd_dkv_f32_launches,
              flash_dq_f32=fa.flash_bwd_dq_f32_launches,
              tap_fwd=bsc.tap_conv_fwd_launches,
              tap_dx=bsc.tap_conv_dx_launches, tap_dw=bsc.tap_dw_launches,
              tap_mm_fwd=bsc.tap_mm_fwd_launches,
              tap_mm_dx=bsc.tap_mm_dx_launches,
              tap_mm_dw=bsc.tap_mm_dw_launches,
              v4_fwd=v4.v4_fwd_launches, v4_dx=v4.v4_dx_launches,
              v3_fwd=v3.v3_fwd_launches, v3_dx=v3.v3_dx_launches,
              dw_gather=v3.dw_gather_launches, gather=v2.gather_launches,
              control=v3.dense_control_launches, v6_fwd=v6.v6_fwd_launches,
              v6_dx=v6.v6_dx_launches, v1_fwd=v1.v1_fwd_launches,
              v1_dx=v1.v1_dx_launches, v1_dw=v1.v1_dw_launches)


def _zero_counts():
  """Sets every launch counter of the package to 0."""
  from rigl_tpu_torch.ops import block_sparse as v1
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.ops import block_sparse_v2 as v2
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.ops import block_sparse_v4 as v4
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  from rigl_tpu_torch.ops import flash_attention as fa
  bsp.packed_mm_launches = bsp.packed_mm_dx_launches = 0
  bsp.packed_dw_launches = bsp.mm_decode_launches = 0
  fa.flash_fwd_launches = fa.flash_bwd_dkv_launches = 0
  fa.flash_bwd_dq_launches = 0
  fa.flash_fwd_f32_launches = fa.flash_bwd_dkv_f32_launches = 0
  fa.flash_bwd_dq_f32_launches = 0
  bsc.tap_conv_fwd_launches = bsc.tap_conv_dx_launches = 0
  bsc.tap_dw_launches = 0
  bsc.tap_mm_fwd_launches = bsc.tap_mm_dx_launches = 0
  bsc.tap_mm_dw_launches = 0
  v4.v4_fwd_launches = v4.v4_dx_launches = 0
  v3.v3_fwd_launches = v3.v3_dx_launches = v3.dw_gather_launches = 0
  v3.dense_control_launches = v2.gather_launches = 0
  v6.v6_fwd_launches = v6.v6_dx_launches = 0
  v1.v1_fwd_launches = v1.v1_dx_launches = v1.v1_dw_launches = 0


def _packed_counts():
  """(fwd, dx, dw) launches so far."""
  c = _counts()
  return c['fwd'], c['dx'], c['dw']


def phase_train(torch, device):
  """The training main path: PackedMLPTrainer at the mlp model's full
  width, f32, via='kernel'.  Returns (launches (fwd, dx, dw), record)."""
  import numpy as np
  from rigl_tpu_torch.data.datasets import normalize, synthetic_arrays
  from rigl_tpu_torch.train.packed_loop import (PackedMLPConfig,
                                                PackedMLPTrainer)
  from rigl_tpu_torch.transforms.packed_training import occupancy_grid
  tx, ty, vx, vy = synthetic_arrays(10, (MLP_WIDTH,), n_train=8192,
                                    n_test=1024, seed=SEED)
  xtr, xte = normalize('mnist', tx), normalize('mnist', vx)
  cfg = PackedMLPConfig(
      in_features=MLP_WIDTH, widths=(MLP_WIDTH,) * MLP_DEPTH, num_classes=10,
      sparsity=SPARSITY, block=BLOCK, via='kernel', batch_size=MLP_BATCH,
      train_steps=TRAIN_STEPS, maskupdate_begin_step=0,
      maskupdate_end_step=20, maskupdate_frequency=10, drop_fraction=0.3,
      drop_fraction_anneal='cosine', seed=SEED)
  trainer = PackedMLPTrainer(cfg, device=device)
  trainer.init_state()

  updates, steps = [], []
  mask_update = trainer.mask_update

  def recorded_update(x, y):
    before = {n: occupancy_grid(pk).numpy()
              for n, pk in trainer.packings.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = mask_update(x, y)
    torch.cuda.synchronize()
    grown = sum(int(((occ[n] == 1) & (before[n] == 0)).sum()) for n in occ)
    counts = {n: int(o.sum()) for n, o in occ.items()}
    updates.append(dict(step=trainer.step, grown=grown, counts=counts,
                        ms=(time.perf_counter() - t0) * 1e3))
    check(counts == trainer.n_active, f'update at step {trainer.step}: '
          f'occupancy {counts} != n_active {trainer.n_active}')
    return occ

  last = [(0, 0, 0)]

  def progress(m):
    now = _packed_counts()
    steps.append(dict(step=m['step'], loss=m['loss'], t=time.perf_counter(),
                      launches=tuple(a - b for a, b in zip(now, last[0]))))
    last[0] = now

  trainer.mask_update = recorded_update
  _zero_counts()
  t0 = time.perf_counter()
  result = trainer.train((xtr, ty), eval_xy=(xte, vy), progress_fn=progress,
                         log_every=1)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _packed_counts()
  del trainer.mask_update

  losses = [st['loss'] for st in steps]
  log(f'training: {result["train_steps"]} steps, {result["mask_updates"]} '
      f'mask updates at steps {[u["step"] for u in updates]} in {wall:.2f} s;'
      f' launches fwd/dx/dw {launches}; loss {losses[0]:.4f} -> '
      f'{losses[-1]:.4f}; eval top-1 {result["eval_top_1"]:.4f}')
  check(result['train_steps'] == TRAIN_STEPS, 'train steps')
  check([u['step'] for u in updates] == [0, 10, 20],
        f'mask updates at {[u["step"] for u in updates]}, not [0, 10, 20]')
  check(sum(u['grown'] for u in updates) > 0, 'no block was grown')
  bad = [st for st in steps if st['launches'] != (MLP_DEPTH, MLP_DEPTH - 1,
                                                  MLP_DEPTH)]
  check(not bad, f'steps whose launches are not fwd 3, dx 2, dw 3: {bad[:3]}')
  check(all(np.isfinite(losses)), 'non-finite loss')
  check(losses[-1] < losses[0], f'loss did not fall: {losses}')
  check(all(n > 0 for n in launches), f'a kernel was not launched: {launches}')
  after_update = {u['step'] + 1 for u in updates}
  gaps = [b['t'] - a['t'] for a, b in zip(steps, steps[1:])
          if b['step'] not in after_update]
  step_ms = float(np.median(gaps)) * 1e3
  update_ms = [u['ms'] for u in updates]
  log(f'  step time (median of {len(gaps)}, host clock, synchronised by the '
      f'loss read) {step_ms:.3f} ms; update steps {update_ms} ms; blocks '
      f'grown {[u["grown"] for u in updates]}')

  # One step's loss and gradients: kernel path vs the plain path (the
  # dense view), from the same state, on the card.
  rs = np.random.RandomState(SEED + 7)
  idx = rs.randint(0, len(xtr), size=MLP_BATCH)
  x = torch.as_tensor(xtr[idx]).to(device)
  y = torch.as_tensor(ty[idx]).to(device)
  params = list(trainer.params.values())
  out = {}
  for via in ('kernel', 'dense_view'):
    trainer.via = via
    loss = trainer._loss(trainer.params, x, y)
    out[via] = (float(loss.detach()), torch.autograd.grad(loss, params))
  trainer.via = 'kernel'
  (lk, gk), (lp, gp) = out['kernel'], out['dense_view']
  # Each error is relative to its own scale (no floor at 1: the weight
  # gradients are far below 1, where a floor would make the limit absolute).
  tiny = torch.finfo(torch.float32).tiny
  loss_err = abs(lk - lp) / max(abs(lp), tiny)
  grad_errs = {}
  for name, a, b in zip(trainer.params, gk, gp):
    grad_errs[name] = (float((a - b).abs().max())
                       / max(float(b.abs().max()), tiny))
  log(f'  one step, kernel vs plain path: loss {lk:.6f} vs {lp:.6f} (rel '
      f'{loss_err:.3e}); max rel grad err '
      f'{max(grad_errs.values()):.3e} (tol {TOL["float32"]})')
  check(loss_err <= TOL['float32'], f'step loss: rel error {loss_err}')
  for name, err in grad_errs.items():
    check(err <= TOL['float32'], f'step grad {name}: rel error {err}')
  record = dict(config=dict(dataclass_fields(cfg)), wall_s=wall,
                step_ms=step_ms, update_step_ms=update_ms,
                blocks_grown=[u['grown'] for u in updates],
                losses=losses, eval_top_1=result['eval_top_1'],
                launches=dict(zip(('fwd', 'dx', 'dw'), launches)),
                step_vs_plain=dict(loss_rel_err=loss_err,
                                   max_grad_rel_err=max(grad_errs.values())))
  return launches, record


def dataclass_fields(obj):
  import dataclasses
  return {k: list(v) if isinstance(v, tuple) else v
          for k, v in dataclasses.asdict(obj).items()}


def phase_train_speed(torch, device):
  """The packed branch of scripts/bench_blocksparse_mlp.py: us/step of the
  dense arm and the packed arm (bf16 weights, no bias, SGD(1e-4, momentum
  0.9), loss mean(y^2)), CUDA events over TIMED_STEPS steps after warm-up,
  each arm twice in mirrored order; MFU and the device-busy share."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  gen = torch.Generator().manual_seed(SEED + 4)
  bf16 = torch.bfloat16
  W, B = MLP_WIDTH, MLP_BATCH
  x = (torch.randn(B, W, generator=gen) * 0.01).to(device, bf16)

  def make_arm(sparsity):
    if sparsity is None:
      params = [(torch.randn(W, W, generator=gen) / W ** 0.5).to(device, bf16)
                for _ in range(MLP_DEPTH)]
      def layer(h, i):
        return h @ params[i]
      flops = (4 + 6 * (MLP_DEPTH - 1)) * B * W * W
    else:
      packings, params, flops = [], [], 0
      for i in range(MLP_DEPTH):
        occ, n_act = _mlp_occupancy(torch, gen, sparsity, False)
        packings.append(bsp.make_packing(occ, n_act))
        params.append((torch.randn(n_act, *BLOCK, generator=gen)
                       / W ** 0.5).to(device, bf16))
        flops += (4 if i == 0 else 6) * B * n_act * BLOCK[0] * BLOCK[1]
      def layer(h, i):
        return bsp.packed_matmul(h, params[i], packings[i], BLOCK)
    for p in params:
      p.requires_grad_()
    opt = torch.optim.SGD(params, lr=1e-4, momentum=0.9)

    def step():
      opt.zero_grad(set_to_none=True)
      h = x
      for i in range(MLP_DEPTH):
        h = torch.relu(layer(h, i))
      loss = (h.float() ** 2).mean()
      loss.backward()
      opt.step()
    for _ in range(3):
      step()
    torch.cuda.synchronize()
    return step, flops

  arms = {'dense': make_arm(None)}
  for sp in MLP_SPARSITIES:
    arms[f'packed_s{sp}'] = make_arm(sp)
  order = list(arms) + list(arms)[::-1]
  us = {name: [] for name in arms}
  for name in order:
    us[name].append(time_ms(arms[name][0], TIMED_STEPS) * 1e3)
  peak = PEAK_FLOPS['bfloat16']
  rec = {}
  for name, (step, flops) in arms.items():
    mean_us = float(np.mean(us[name]))
    dev_us = device_ms(step, 10) * 1e3
    rec[name] = dict(us_per_step=us[name], mfu=flops / (mean_us * 1e-6) / peak,
                     flops_per_step=flops, device_us_per_step=dev_us,
                     device_busy_share=dev_us / mean_us)
    log(f'train speed: {name:12s} us/step {us[name]} (mean {mean_us:.1f}); '
        f'device time {dev_us:.1f} us/step (busy share '
        f'{dev_us / mean_us:.3f}); MFU {rec[name]["mfu"]:.4f} of '
        f'{peak / 1e12:.0f} TFLOP/s bf16 '
        f'({"dense" if name == "dense" else "active"} FLOPs)')
  dense_us = float(np.mean(us['dense']))
  for sp in MLP_SPARSITIES:
    name = f'packed_s{sp}'
    rec[name]['dense_over_packed'] = dense_us / float(np.mean(us[name]))
    log(f'  dense/packed at s={sp}: {rec[name]["dense_over_packed"]:.3f}')
  # Where a packed step's time goes (torch.profiler, which slows the host
  # side): device time by kernel, host time by operator.
  step, _ = arms[f'packed_s{SPARSITY}']
  n = 5
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(n):
      step()
    torch.cuda.synchronize()
  events = prof.key_averages()
  by_device = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
  by_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
  rec['packed_device_ms_by_kernel'] = {
      e.key[:90]: [e.self_device_time_total / 1e3 / n, e.count / n]
      for e in by_device}
  rec['packed_host_ms_by_op'] = {
      e.key[:90]: [e.self_cpu_time_total / 1e3 / n, e.count / n]
      for e in by_host}
  log(f'  packed s={SPARSITY}, profiled: device ms per step by kernel, '
      'launches per step:')
  for e in by_device:
    log(f'    {e.self_device_time_total / 1e3 / n:8.3f} ms '
        f'{e.count / n:5.1f} x {e.key[:90]}')
  log('  host (self CPU) ms per step by operator, calls per step:')
  for e in by_host:
    log(f'    {e.self_cpu_time_total / 1e3 / n:8.3f} ms '
        f'{e.count / n:5.1f} x {e.key[:90]}')
  return rec


def flash_bound(op, b, h, s, hd, dtype='bfloat16'):
  """(ms, 'bytes' | 'operations'): the least time of one call on an H100.
  Bytes: each (B, H, S, hd) input of `dtype` read once and each output
  written once, plus the f32 row statistics (lse; D for the backward).
  FLOPs: the causal pairs (k <= q) only, 2 hd per pair per product: QKᵀ
  and PV (forward); QKᵀ, dO Vᵀ, Pᵀ dO and dSᵀ Q (dK/dV); QKᵀ, dO Vᵀ and
  dS K (dQ); over the dtype's peak."""
  t = b * h * s * hd * (2 if dtype == 'bfloat16' else 4)
  stats = b * h * s * 4
  moved = {'fwd': 4 * t + stats, 'dkv': 6 * t + 2 * stats,
           'dq': 5 * t + 2 * stats}[op]
  products = {'fwd': 2, 'dkv': 4, 'dq': 3}[op]
  flops = products * 2.0 * hd * b * h * s * (s + 1) / 2
  t_bytes = moved / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _rel(got, want):
  """max |got - want| over max |want| (no floor: gradients can be small)."""
  import torch
  want = want.float()
  return (float((got.float() - want).abs().max())
          / max(float(want.abs().max()), torch.finfo(torch.float32).tiny))


def _flash_counts(dtype):
  """(fwd, dK/dV, dQ) launches so far of the flash kernels for `dtype`."""
  c = _counts()
  suffix = '_f32' if dtype == 'float32' else ''
  return tuple(c[f'flash_{op}{suffix}'] for op in ('fwd', 'dkv', 'dq'))


def phase_flash(torch, device, dtype):
  """The three flash kernels for `dtype` (bf16 or their f32 variants),
  each launched once and held against its own plain version on the same
  inputs, then timed beside it and beside torch's
  scaled_dot_product_attention (forward; its backward, which computes dq,
  dk and dv in one call, beside dK/dV and dQ)."""
  import torch.nn.functional as F
  from rigl_tpu_torch.ops import flash_attention as fa
  name = dtype_name(dtype)
  tol = FLASH_TOL if name == 'bfloat16' else FLASH_F32_TOL
  gen = torch.Generator().manual_seed(SEED + 8)
  records = {'fwd': [], 'dkv': [], 'dq': []}
  for b, h, s, hd in FLASH_SHAPES:
    q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(device, dtype)
                   for _ in range(4))
    scale = hd ** -0.5
    counts = _flash_counts(name)
    o, lse = fa.flash_fwd_cuda(q, k, v, scale)
    d = fa._rowsum_do_o(do, o)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale)
    torch.cuda.synchronize()
    moved = tuple(a - c for a, c in zip(_flash_counts(name), counts))
    tag = f'{name} (B, H, S, hd) = ({b}, {h}, {s}, {hd})'
    check(moved == (1, 1, 1), f'flash {tag}: launches moved by {moved}')
    want_o, want_lse = fa.flash_attention_fwd_reference(q, k, v, scale)
    want_dk, want_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, d,
                                                  scale)
    want_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, d, scale)
    lse_err = float((lse - want_lse).abs().max())
    check(lse_err <= LSE_TOL * max(1.0, float(want_lse.abs().max())),
          f'flash fwd {tag}: lse error {lse_err}')
    # Every kernel writes each output once, its sums in a fixed order: a
    # second launch gives the same bits.
    o2, lse2 = fa.flash_fwd_cuda(q, k, v, scale)
    dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
    dq2 = fa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale)
    check(all(bool(torch.equal(a, b)) for a, b in
              ((o, o2), (lse, lse2), (dk, dk2), (dv, dv2), (dq, dq2))),
          f'flash {tag}: a second launch gave other bits')
    del o2, lse2, dk2, dv2, dq2
    # SDPA, the library yardstick, timed only: its forward, and its
    # backward alone on a retained graph.
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                           scale=scale)
    lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale), 20)
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl), do, retain_graph=True), 20)
    lib_err = _rel(o_lib.detach(), want_o)
    ops = {
        'fwd': (((o, want_o),), lambda: fa.flash_fwd_cuda(q, k, v, scale),
                lambda: fa.flash_attention_fwd_reference(q, k, v, scale),
                lib_fwd),
        'dkv': (((dk, want_dk), (dv, want_dv)),
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale),
                lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, d,
                                                   scale), lib_bwd),
        'dq': (((dq, want_dq),),
               lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale),
               lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, d, scale),
               lib_bwd)}
    for op, (pairs, run, plain, lib_ms) in ops.items():
      for got, want in pairs:
        check(got.dtype == want.dtype == dtype
              and got.shape == want.shape, f'flash {op} {tag}: dtype/shape')
        check(bool(torch.isfinite(got).all()), f'flash {op} {tag}: '
              'non-finite output')
      err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
      rel = max(_rel(g, w) for g, w in pairs)
      bound_ = flash_bound(op, b, h, s, hd, name)
      rec = dict(max_abs_err=err, max_rel_err=rel, tol=tol,
                 ms=device_ms(run, 20), plain_ms=device_ms(plain, 5),
                 library_ms=lib_ms, bound_ms=bound_[0], bound_by=bound_[1],
                 host_ms=host_ms(run, 20), dtype=name,
                 shape=[b, h, s, hd], path='train_step')
      if op == 'fwd':
        rec.update(lse_abs_err=lse_err, library_rel_err=lib_err)
      log(f'flash {op:3s} {tag}: max|err| {err:.3e} (rel {rel:.3e}, tol '
          f'{tol})  device ms: kernel {rec["ms"]:.4f}, plain '
          f'{rec["plain_ms"]:.4f}, sdpa {"fwd" if op == "fwd" else "bwd"} '
          f'{lib_ms:.4f}, bound {bound_[0]:.4f} ({bound_[1]})  host '
          f'{rec["host_ms"]:.4f}')
      check(rel <= tol, f'flash {op} {tag}: rel error {rel}')
      records[op].append(rec)
    log(f'  sdpa fwd+bwd {lib_fwd + lib_bwd:.4f} ms; sdpa vs plain o rel '
        f'{lib_err:.3e}; lse max|err| {lse_err:.3e}')
    del ql, kl, vl, o_lib
  records['padded'] = _flash_padded(torch, device, dtype, tol)
  return records


def _flash_padded(torch, device, dtype, tol):
  """flash_attention at a head dim the kernels do not take
  (FLASH_PADDED_SHAPE's 48, zero-padded to 64 by ops/flash_attention.py
  pad_head_dim): one launch of each kernel, and o and the gradients of q,
  k and v against autograd through the plain forward in f32, each error
  over its own largest plain value."""
  from rigl_tpu_torch.ops import flash_attention as fa
  name = dtype_name(dtype)
  b, h, s, hd = FLASH_PADDED_SHAPE
  gen = torch.Generator().manual_seed(SEED + 9)
  q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(device, dtype)
                 for _ in range(4))
  leaves = [t.clone().requires_grad_() for t in (q, k, v)]
  counts = _flash_counts(name)
  o = fa.flash_attention(*leaves, hd ** -0.5)
  grads = torch.autograd.grad(o, leaves, do)
  torch.cuda.synchronize()
  moved = tuple(a - c for a, c in zip(_flash_counts(name), counts))
  tag = f'{name} padded (B, H, S, hd) = ({b}, {h}, {s}, {hd})'
  check(moved == (1, 1, 1), f'flash {tag}: launches moved by {moved}')
  plain = [t.detach().float().clone().requires_grad_() for t in (q, k, v)]
  want_o, _ = fa.flash_attention_fwd_reference(*plain, hd ** -0.5)
  want = torch.autograd.grad(want_o, plain, do.float())
  errs = {}
  for what, got, ref in zip(('o', 'dq', 'dk', 'dv'), (o.detach(), *grads),
                            (want_o.detach(), *want)):
    check(got.dtype == dtype and got.shape == ref.shape
          and bool(torch.isfinite(got).all()),
          f'flash {tag}: {what} dtype, shape or non-finite')
    errs[what] = _rel(got, ref)
  log(f'flash {tag} through flash_attention: rel errors '
      + ', '.join(f'{w} {e:.3e}' for w, e in errs.items()) + f' (tol {tol})')
  check(max(errs.values()) <= tol, f'flash {tag}: rel errors {errs}')
  return dict(shape=[b, h, s, hd], padded_to=64, dtype=name, rel_err=errs,
              tol=tol)


def _since(before):
  return {k: v - before[k] for k, v in _counts().items()}


def _grad_errors(torch, packed_model, grads, plain):
  """{name: error over the largest plain value}: the packed kernels' grads
  unpacked to dense against the plain dense grads at active blocks."""
  from rigl_tpu_torch.ops.block_sparse_packed import unpack_dense
  from rigl_tpu_torch.parallel import packed_ep as ep
  errs = {}
  for name, g in grads.items():
    layer = name.rsplit('.', 1)[0]
    sub = packed_model.get_submodule(layer)
    if hasattr(sub, 'packing'):
      unpack = (ep.unpack_dense_experts if ep.is_expert_stacked(sub.packing)
                else unpack_dense)
      got = unpack(g, sub.packing, sub.block)
      want = plain[f'{layer}.d.kernel'] * unpack(
          torch.ones_like(g), sub.packing, sub.block)
    else:
      got, want = g, plain[name]
    check(bool(torch.isfinite(got).all()), f'non-finite grad {name}')
    errs[name] = _rel(got, want)
  return errs


def phase_train_step(torch, device):
  """The transformer train step of scripts/bench_packed_transformer.py, the
  full-width path of the flash kernels: 2 layers of d_model 2048 / d_ff
  8192 / 16 heads, seq 512, batch 4, bf16, block (512, 512), bm 512,
  s = 0.8, SGD(1e-4, momentum 0.9), loss mean(out^2) on pre-embedded
  inputs.  Arms: dense twin and packed, each with the unfused and the
  fused attention core, timed twice in mirrored order.  Checks one fused
  packed step's launches, and a loss's value and gradients against the
  plain path.  Returns (launches of the path, record)."""
  import numpy as np
  from torch.func import functional_call
  from rigl_tpu_torch.layers.packed_dense import PackedDense
  from rigl_tpu_torch.models.packed_transformer import (DenseTransformer,
                                                        PackedTransformer)
  from rigl_tpu_torch.train.packed_lm import dense_twin_params
  gen = torch.Generator().manual_seed(SEED + 9)
  kw = dict(num_layers=TR_LAYERS, d_model=D_MODEL, d_ff=D_FF,
            num_heads=HEADS, vocab_size=0, dtype=torch.bfloat16)
  x = (torch.randn(TR_BATCH, TR_SEQ, D_MODEL, generator=gen) * 0.02).to(
      device, torch.bfloat16)
  _zero_counts()
  arms = {}
  for fused in (False, True):
    tag = 'fused' if fused else 'unfused'
    arms[f'dense_{tag}'] = DenseTransformer(
        fused_attention=fused, generator=gen, device=device, **kw)
    arms[f'packed_{tag}'] = PackedTransformer(
        sparsity=SPARSITY, block=BLOCK, bm=512, fused_attention=fused,
        generator=gen, device=device, **kw)

  def make_step(model):
    opt = torch.optim.SGD(model.parameters(), lr=1e-4, momentum=0.9)

    def step():
      opt.zero_grad(set_to_none=True)
      loss = (model(x).float() ** 2).mean()
      loss.backward()
      opt.step()
    for _ in range(3):
      step()
    torch.cuda.synchronize()
    return step

  # One fused packed step's launches, then its loss and every gradient
  # against the plain path, before any optimizer step moves the weights.
  # The check's loss is mean(out * r) for a fixed random r: mean(out^2) of
  # a LayerNorm output is flat in every weight before ln_f (the output's
  # norm is fixed), so its gradients there are rounding noise.
  packed = arms['packed_fused']
  params = dict(packed.named_parameters())
  r = torch.randn(x.shape, generator=gen).to(device)
  before = _counts()
  out = packed(x).float()
  loss = (out * r).mean()
  grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
  loss = loss.detach()
  torch.cuda.synchronize()
  per_step = _since(before)
  packings = {f'{n}.kernel': m.packing for n, m in packed.named_modules()
              if isinstance(m, PackedDense)}
  views = {n: v.detach().clone().requires_grad_() for n, v in
           dense_twin_params({n: p.detach() for n, p in params.items()},
                             packings, BLOCK).items()}
  twin = DenseTransformer(device='meta', **kw)
  plain_out = functional_call(twin, views, (x,)).float()
  plain_loss = (plain_out * r).mean()
  plain = dict(zip(views, torch.autograd.grad(plain_loss,
                                              list(views.values()))))
  plain_loss = plain_loss.detach()
  out_err = _rel(out.detach(), plain_out.detach())
  # The loss is a mean of terms of both signs: its error is taken over the
  # mean |term|, not over the (much smaller) mean.
  loss_err = (abs(float(loss) - float(plain_loss))
              / float((plain_out.detach() * r).abs().mean()))
  grad_errs = _grad_errors(torch, packed, grads, plain)
  del grads, plain, views, out, plain_out
  expect = dict(fwd=4 * TR_LAYERS, dw=4 * TR_LAYERS, flash_fwd=TR_LAYERS,
                flash_dkv=TR_LAYERS, flash_dq=TR_LAYERS)
  log(f'train step, packed fused: launches per step {per_step} (expected '
      f'{expect}, dx <= {4 * TR_LAYERS}); output rel err {out_err:.3e}; '
      f'loss {float(loss):.6e} vs plain {float(plain_loss):.6e} (err over '
      f'mean |term| {loss_err:.3e}); max rel grad err '
      f'{max(grad_errs.values()):.3e} (tol {STEP_RTOL})')
  check(all(per_step[k] == n for k, n in expect.items())
        and 0 < per_step['dx'] <= 4 * TR_LAYERS,
        f'fused packed step launches {per_step}')
  check(out_err <= STEP_RTOL, f'train step output rel error {out_err}')
  check(loss_err <= STEP_RTOL, f'train step loss error {loss_err}')
  for name, err in grad_errs.items():
    check(err <= STEP_RTOL, f'train step grad {name}: rel error {err}')

  steps = {name: make_step(model) for name, model in arms.items()}
  order = list(steps) + list(steps)[::-1]
  us = {name: [] for name in steps}
  for name in order:
    us[name].append(time_ms(steps[name], TIMED_STEPS) * 1e3)
  tok = TR_BATCH * TR_SEQ
  param_fwd = TR_LAYERS * 2.0 * tok * (3 * D_MODEL * D_MODEL
                                       + D_MODEL * D_MODEL
                                       + 2 * D_MODEL * D_FF)
  attn_fwd = TR_LAYERS * 2.0 * 2 * TR_BATCH * TR_SEQ * TR_SEQ * D_MODEL
  peak = PEAK_FLOPS['bfloat16']
  # Device time per step two ways: a CUDA-event window over 3 steps queued
  # behind a sleep (more would overrun the device's queue of pending
  # launches, and the window would time the host again), and the summed
  # kernel time of a torch.profiler session of 3 steps (device activity
  # only), which also gives the top kernels.  The busy share is the
  # kernel sum over the step time.
  rec = {}
  for name, step in steps.items():
    flops = 3 * (param_fwd * (1 - SPARSITY if 'packed' in name else 1)
                 + attn_fwd)
    mean_us = float(np.mean(us[name]))
    dev_us = device_ms(step, 3) * 1e3
    prof = profiled_kernel_time(torch, step, 3)
    busy = _share(prof['kernel_us_per_step'], mean_us)
    rec[name] = dict(us_per_step=us[name], mfu=flops / (mean_us * 1e-6) / peak,
                     flops_per_step=flops, device_us_per_step=dev_us,
                     device_busy_share=busy, **prof)
    log(f'train step: {name:14s} us/step {[round(u, 1) for u in us[name]]} '
        f'(mean {mean_us:.1f}); device window {dev_us:.1f} us/step, kernels '
        f'{prof["kernel_us_per_step"]} us/step (busy share {busy}); '
        f'MFU {rec[name]["mfu"]:.4f} (bench.py formula, '
        f'{peak / 1e12:.0f} TFLOP/s)')
  for tag in ('unfused', 'fused'):
    ratio = (float(np.mean(us[f'dense_{tag}']))
             / float(np.mean(us[f'packed_{tag}'])))
    rec[f'dense_over_packed_{tag}'] = ratio
    log(f'  dense/packed ({tag}): {ratio:.3f}')
  launches = _since({k: 0 for k in _counts()})
  rec.update(launches_per_packed_fused_step=per_step,
             step_vs_plain=dict(out_rel_err=out_err, loss_err=loss_err,
                                max_grad_rel_err=max(grad_errs.values())))
  del arms, steps
  torch.cuda.empty_cache()
  return launches, rec


def _lm_run(torch, device, tokens, base, tag, algo, steps, frequency, end):
  """Trains a PackedLMTrainer of the config `base` with `algo` for `steps`
  steps, mask updates every `frequency` up to `end`, each update checked:
  every packed kernel's count kept (an expert stack's, per expert), grown
  blocks' weights and Adam slots zero.  Returns (trainer, record: update
  steps, update ms, blocks grown, losses, median step ms on the host
  clock, wall s)."""
  import numpy as np
  from rigl_tpu_torch.parallel import packed_ep as ep
  from rigl_tpu_torch.train.packed_lm import PackedLMConfig, PackedLMTrainer
  from rigl_tpu_torch.transforms.packed_training import repack_permutation
  cfg = PackedLMConfig(algo=algo, train_steps=steps,
                       maskupdate_begin_step=0, maskupdate_end_step=end,
                       maskupdate_frequency=frequency, **base)
  tr = PackedLMTrainer(cfg, device=device)
  tr.init_state()
  updates, progress = [], []
  mask_update = tr.mask_update

  def grown_slots(old, new):
    if ep.is_expert_stacked(new):
      return torch.stack([repack_permutation(o, n) < 0
                          for o, n in zip(old.experts, new.experts)])
    return repack_permutation(old, new) < 0

  def checked_update(x, y):
    old = tr.packings
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    occ = mask_update(x, y)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    mu, nu = tr.adam_slots()
    grown = {}
    for name, pk in tr.packings.items():
      lead = int(ep.is_expert_stacked(pk)) + 1
      counts = occ[name].reshape(occ[name].shape[:lead - 1] + (-1,)).sum(-1)
      check(bool((counts == tr.params[name].shape[lead - 1]).all()),
            f'{tag} {algo} update: {name} count changed')
      new = grown_slots(old[name], pk).to(device)
      grown[name] = int(new.sum())
      for t in (tr.params[name].detach(), mu[name], nu[name]):
        check(not bool(t[new].any()), f'{tag} {algo} update: grown slot '
              f'of {name} not zero')
    updates.append(dict(step=tr.step, ms=ms, grown=sum(grown.values()),
                        grown_by_kernel=grown))
    return occ

  tr.mask_update = checked_update
  t0 = time.perf_counter()
  res = tr.train(tokens, progress_fn=lambda m: progress.append(
      dict(m, t=time.perf_counter())), log_every=1)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  del tr.mask_update
  losses = [p['loss'] for p in progress]
  after = {u['step'] + (1 if algo == 'rigl' else 0) for u in updates}
  gaps = [b_['t'] - a['t'] for a, b_ in zip(progress, progress[1:])
          if b_['step'] not in after]
  rec = dict(algo=algo, steps=res['train_steps'],
             update_steps=[u['step'] for u in updates],
             update_ms=[u['ms'] for u in updates],
             blocks_grown=[u['grown'] for u in updates],
             blocks_grown_by_kernel=[u['grown_by_kernel'] for u in updates],
             losses=losses,
             step_ms=float(np.median(gaps)) * 1e3 if gaps else None,
             wall_s=wall)
  log(f'{tag} {algo}: {res["train_steps"]} steps in {wall:.2f} s, updates '
      f'at {rec["update_steps"]} ({[round(m, 1) for m in rec["update_ms"]]}'
      f' ms, grown {rec["blocks_grown"]}); step {rec["step_ms"]:.2f} ms '
      f'(median, host clock); loss {losses[0]:.4f} -> {losses[-1]:.4f}')
  check(all(np.isfinite(losses)), f'{tag} {algo}: non-finite loss')
  return tr, rec


def phase_lm(torch, device):
  """The LM trainer main path: PackedLMTrainer at the train step's width,
  vocab 64 (the synthetic stream), seq 512, batch 4, bf16, block (512,
  512), s = 0.8.  RigL for 30 steps with updates at 0, 10 and 20 (each
  checked: counts preserved, grown blocks' weights and Adam slots zero);
  then SET and SNFS a few steps with one update each; then 16 greedy
  tokens with kv_chunk 0 and 128 (L = 1024), which must agree.  Returns
  (launches of the RigL run, record)."""
  import numpy as np
  from rigl_tpu_torch.drivers.packed_lm import synthetic_stream
  tokens = synthetic_stream(200_000, seed=SEED)
  base = dict(vocab_size=LM_VOCAB, num_layers=TR_LAYERS, d_model=D_MODEL,
              d_ff=D_FF, num_heads=HEADS, seq_len=TR_SEQ, sparsity=SPARSITY,
              block=BLOCK, bm=512, dtype='bfloat16', learning_rate=1e-3,
              warmup_steps=5, batch_size=TR_BATCH, drop_fraction=0.3,
              drop_fraction_anneal='cosine', seed=SEED)

  def run(algo, steps, frequency, end):
    return _lm_run(torch, device, tokens, base, 'lm', algo, steps,
                   frequency, end)

  _zero_counts()
  tr, rigl = run('rigl', LM_STEPS, 10, 20)
  launches = _since({k: 0 for k in _counts()})
  check(rigl['update_steps'] == [0, 10, 20],
        f'rigl updates at {rigl["update_steps"]}, not [0, 10, 20]')
  check(sum(rigl['blocks_grown']) > 0, 'rigl grew no block')
  check(np.mean(rigl['losses'][-5:]) < np.mean(rigl['losses'][:5]),
        f'rigl loss did not fall: {rigl["losses"]}')
  check(all(launches[k] > 0 for k in ('fwd', 'dx', 'dw')),
        f'lm: a packed kernel was not launched: {launches}')
  log(f'  lm rigl launches {launches}')

  prompt = np.asarray(tokens[:4 * 64], np.int32).reshape(4, 64)
  out = {}
  for kv_chunk in (0, 128):
    t0 = time.perf_counter()
    out[kv_chunk] = tr.generate(prompt, 16, max_len=1024, kv_chunk=kv_chunk)
    log(f'  generate 16 greedy tokens, batch 4, L = 1024, kv_chunk '
        f'{kv_chunk}: {(time.perf_counter() - t0) * 1e3:.1f} ms')
  check(out[0].shape == (4, 16), f'generate shape {out[0].shape}')
  check((out[0] == out[128]).all(), 'kv_chunk=128 tokens differ from '
        f'unchunked: {out[0].tolist()} vs {out[128].tolist()}')
  del tr
  others = {}
  for algo in ('set', 'snfs'):
    t, others[algo] = run(algo, 6, 5, 5)
    check(len(others[algo]['update_steps']) == 1,
          f'{algo} updates at {others[algo]["update_steps"]}')
    del t
  torch.cuda.empty_cache()
  return launches, dict(rigl=rigl, **others,
                        generated=out[0].tolist(), kv_chunk_equal=True)


def _tap_counts():
  """(fwd, dx, dw) launches of the tap kernels so far."""
  c = _counts()
  return c['tap_fwd'], c['tap_dx'], c['tap_dw']


def _wrn_spec():
  from rigl_tpu_torch.models.packed_convnet import wrn_layer_shapes
  from rigl_tpu_torch.sparsity.layer_sparsity import spec_for_model
  return spec_for_model(wrn_layer_shapes(WRN_DEPTH, WRN_WIDTH),
                        'erdos_renyi_kernel', WRN_SPARSITY)


def tap_points(torch):
  """Phase 12's points: (label, n, hw, cin, cout, k, sparsity, dtype,
  empty column, block).  The four WRN-22-2 conv shapes and RN50's four
  stride-1 3x3 shapes at batch 128 and their ERK-0.8 sparsities, in f32
  and bf16, at block (16, 16); then f32 at the JAX driver's batch 100, a
  5x5 kernel and an empty output column; then bf16 at block (8, 8) at one
  WRN shape, the tf32 branch's bf16 instance."""
  from rigl_tpu_torch.models.packed_convnet import resnet_layer_shapes
  from rigl_tpu_torch.sparsity.layer_sparsity import (resolve_sparsity,
                                                      spec_for_model)
  wspec = _wrn_spec()
  rspec = spec_for_model(resnet_layer_shapes(50, 1.0, WRN_BLOCK),
                         'erdos_renyi_kernel', WRN_SPARSITY)
  shapes = [('wrn g0_b0/conv1', 32, 16, 32, wspec),
            ('wrn g0_b0/conv2', 32, 32, 32, wspec),
            ('wrn g1_b1/conv1', 16, 64, 64, wspec),
            ('wrn g2_b1/conv1', 8, 128, 128, wspec),
            ('rn50 g0_b1/conv3x3', 56, 64, 64, rspec),
            ('rn50 g1_b1/conv3x3', 28, 128, 128, rspec),
            ('rn50 g2_b1/conv3x3', 14, 256, 256, rspec),
            ('rn50 g3_b1/conv3x3', 7, 512, 512, rspec)]
  points = []
  for dtype in (torch.float32, torch.bfloat16):
    for label, hw, cin, cout, spec in shapes:
      s = resolve_sparsity(spec, label.split()[1] + '/kernel')
      points.append((label, WRN_BATCH, hw, cin, cout, 3, s, dtype, False,
                     WRN_BLOCK))
  s = resolve_sparsity(wspec, 'g0_b0/conv2/kernel')
  points.append(('wrn g0_b0/conv2', 100, 32, 32, 32, 3, s, torch.float32,
                 False, WRN_BLOCK))
  points.append(('wrn g0_b0/conv2', WRN_BATCH, 32, 32, 32, 3, s,
                 torch.float32, True, WRN_BLOCK))
  s = resolve_sparsity(wspec, 'g1_b1/conv1/kernel')
  points.append(('wrn g1_b1/conv1 5x5', WRN_BATCH, 16, 64, 64, 5, s,
                 torch.float32, False, WRN_BLOCK))
  points.append(('wrn g1_b1/conv1 block 8', WRN_BATCH, 16, 64, 64, 3, s,
                 torch.bfloat16, False, (8, 8)))
  return points


def tap_bound(op, n, hw, index, dtype):
  """(ms, 'bytes' | 'operations'): the least time of one tap kernel call on
  an H100.  Bytes: the input's channel blocks that some entry reads, the
  active weight blocks and the output, each once (dw: x and gy blocks read,
  the active blocks written).  FLOPs: 2 bk bn per entry and pixel whose
  tap-shifted read lies inside the image (this run's taps)."""
  import torch
  e = torch.empty((), dtype=dtype).element_size()
  taps, rblks, cblks = (t.long() for t in index.to('cpu').dw[:3])
  dy = (taps // index.kw - index.kh // 2).abs()
  dx = (taps % index.kw - index.kw // 2).abs()
  pixels = int((n * (hw - dy).clamp(min=0) * (hw - dx).clamp(min=0)).sum())
  flops = 2.0 * pixels * index.bk * index.bn
  m = n * hw * hw
  cin_used = int(rblks.unique().numel()) * index.bk
  cout_used = int(cblks.unique().numel()) * index.bn
  w_bytes = index.n_entries * index.bk * index.bn * e
  moved = {'fwd': m * cin_used * e + w_bytes + m * index.cout * e,
           'dx': m * cout_used * e + w_bytes + m * index.cin * e,
           'dw': m * (cin_used + cout_used) * e + w_bytes}[op]
  t_bytes = moved / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _tap_occupancy(torch, gen, k, cin, cout, sparsity, empty_column,
                   block):
  """(T, cin/bk, cout/bn) occupancy at `sparsity` over the conv's 2D
  block grid (cin-minor rows, as PackedConv's), with cout-block 0 emptied
  on request; and its active count."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  bk, bn = block
  nk, nn_ = k * k * cin // bk, cout // bn
  n_act = nk * nn_ - get_n_zeros(nk * nn_, sparsity)
  occ = random_occupancy(gen, nk, nn_, n_act).reshape(k * k, cin // bk, nn_)
  if empty_column:
    occ[:, :, 0] = 0
  return occ, int(occ.sum())


def phase_tap_kernels(torch, device):
  """The tap kernels (forward, dx, dw), each against its plain version at
  phase 12's points, beside cuDNN on the expanded weight (F.conv2d;
  torch.nn.grad.conv2d_input / conv2d_weight; TF32 off)."""
  import torch.nn.functional as F
  from torch.nn.grad import conv2d_input, conv2d_weight
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  gen = torch.Generator().manual_seed(SEED + 11)
  records = {'fwd': [], 'dx': [], 'dw': []}
  for (label, n, hw, cin, cout, k, s, dtype, empty,
       block) in tap_points(torch):
    bk, bn = block
    occ, n_act = _tap_occupancy(torch, gen, k, cin, cout, s, empty, block)
    packing = dict(zip(('cols', 'rows', 'taps'),
                       bsc.pack_tap_active(occ, n_act)))
    index = bsc.tap_index(packing, (k, k, cin, cout), block)
    mask = occ.repeat_interleave(bk, 1).repeat_interleave(bn, 2)
    w = ((torch.randn(k, k, cin, cout, generator=gen) / (k * k * cin) ** 0.5)
         * mask.reshape(k, k, cin, cout)).to(device, dtype)
    x = torch.randn(n, hw, hw, cin, generator=gen).to(device, dtype)
    gy = torch.randn(n, hw, hw, cout, generator=gen).to(device, dtype)
    # cuDNN's operands: NCHW views of the NHWC tensors (channels-last
    # memory) and the expanded weight as OIHW.
    xc, gyc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = (k // 2, k // 2)
    ops = {
        'fwd': ('tap_conv_fwd_launches',
                lambda: bsc.tap_conv_cuda(x, w, index),
                lambda: bsc.tap_conv_reference(x, w, index),
                lambda: F.conv2d(xc, wc, padding=pad), 'F.conv2d'),
        'dx': ('tap_conv_dx_launches',
               lambda: bsc.tap_conv_cuda(gy, w, index, 'dx'),
               lambda: bsc.tap_conv_reference(gy, w, index, 'dx'),
               lambda: conv2d_input(xc.shape, wc, gyc, padding=pad),
               'conv2d_input'),
        'dw': ('tap_dw_launches', lambda: bsc.tap_dw_cuda(x, gy, w, index),
               lambda: bsc.tap_dw_reference(x, gy, index, dtype),
               lambda: conv2d_weight(xc, wc.shape, gyc, padding=pad),
               'conv2d_weight')}
    tag = (f'{label} {k}x{k} n={n} {hw}x{hw} {cin}->{cout} s={s:.3f} '
           f'({n_act} blocks) {dtype_name(dtype)}'
           + (' empty column' if empty else ''))
    branch = bsc.tap_branch(k, k, bk, bn, dtype)
    for op, (counter, run, plain, library, lib_name) in ops.items():
      rec, got = kernel_point(
          torch, f'tap {op:3s} {tag}', counter, run, plain, library,
          tap_bound(op, n, hw, index, dtype), module=bsc,
          library_name=lib_name, plain_iters=3,
          branch=branch if op != 'dw' else None)
      if branch == 'wgmma' and op != 'dw':
        rec['gcols'] = _tap_gcols(torch, index, op, n * hw * hw)
      if branch == 'tf32' and op != 'dw':
        rec['gcols'], rec['tile'] = _tap_tf32_tile(torch, index, op,
                                                   n * hw * hw, dtype)
      if op == 'fwd':
        for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
          check(not bool(got[..., j * bn:(j + 1) * bn].any()),
                f'tap fwd {tag}: empty column {j} not zero')
      rec.update(path='wrn_training', layer=label, n=n, hw=hw, k=k, cin=cin,
                 cout=cout, sparsity=s, n_active=n_act,
                 dtype=dtype_name(dtype), empty_column=empty,
                 library=lib_name, block=list(block))
      if op == 'dw':
        rec['split'] = dw_split(f'tap dw  {tag}', bsc.tap_dw_plan(
            index, n * hw * hw, dtype, sm_count(torch)))
      records[op].append(rec)
    del x, gy, w, xc, gyc, wc
  torch.cuda.empty_cache()
  return records


def _tap_gcols(torch, index, op, pixels):
  """The group width (output block-columns a thread block) a wgmma call
  took (ops/block_sparse_conv.py tap_wgmma_gcols), logged."""
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  gcols = bsc.tap_wgmma_gcols(index, op, pixels, sm_count(torch))
  log(f'  wgmma groups of {gcols} block-column(s)')
  return gcols


def _tap_tf32_tile(torch, index, op, pixels, dtype):
  """The (group width, tile) a tf32 call took (ops/block_sparse_conv.py
  tap_tf32_tile), logged."""
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  gcols, tile = bsc.tap_tf32_tile(index, op, pixels, sm_count(torch), dtype)
  log(f'  tf32 tile {tile}, groups of {gcols} block-column(s)')
  return gcols, tile


def rn50_3x3_tap_shapes():
  """(path, hw, channels) of the six 3x3 convs of ResNet-50 that the tap
  route runs at block RN50_BLOCK with block_conv3x3 (bench.py's
  BENCH_BLOCK_CONV3X3=1): the stride-2 ones as their stride-1 conv on the
  fixed-padded input (models/common.py), one entry per shape."""
  return [('group2_block0/conv2/conv/kernel', 58, 128),
          ('group2_block1/conv2/conv/kernel', 28, 128),
          ('group3_block0/conv2/conv/kernel', 30, 256),
          ('group3_block1/conv2/conv/kernel', 14, 256),
          ('group4_block0/conv2/conv/kernel', 16, 512),
          ('group4_block1/conv2/conv/kernel', 7, 512)]


def phase_tap_route(torch, device):
  """Phase 12, the RN50 route's points: the tap conv's forward, dx and dw
  in bf16 at block RN50_BLOCK, batch RN50_BATCH, ERK-0.8 occupancies, each
  against its plain version: the 29 eligible 1x1 shapes (forward / dx on
  the 'mm' branch, beside B7, dense_mm_cuda on the same lists; dw on the
  packed dw kernels) beside cuBLAS on the masked W, with their sums; and
  the six 3x3 shapes the step runs with block_conv3x3 (the 'wgmma'
  branch; dw on tap_dw_kernel) beside cuDNN on the expanded weight.
  Returns {'fwd': [...], 'dx': [...], 'dw': [...], 'sums': {...}}."""
  import torch.nn.functional as F
  from torch.nn.grad import conv2d_input, conv2d_weight
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED + 12)
  bk, bn = RN50_BLOCK
  dtype = torch.bfloat16
  sparsities = _rn50_sparsities()
  points = [(path, 1, int(round((m // RN50_BATCH) ** 0.5)), cin, cout)
            for path, m, cin, cout in rn50_1x1_shapes()]
  points += [(path, 3, hw, c, c) for path, hw, c in rn50_3x3_tap_shapes()]
  records = {'fwd': [], 'dx': [], 'dw': []}
  for path, k, hw, cin, cout in points:
    nk, nn_ = k * k * cin // bk, cout // bn
    s = sparsities[path]
    n_act = nk * nn_ - get_n_zeros(nk * nn_, s)
    occ = random_occupancy(gen, nk, nn_, n_act).reshape(k * k, cin // bk,
                                                        nn_)
    index = bsc.tap_index(bsc.TapPack(*bsc.pack_tap_active(occ, n_act)),
                          (k, k, cin, cout), RN50_BLOCK)
    mask = occ.repeat_interleave(bk, 1).repeat_interleave(bn, 2)
    w = ((torch.randn(k, k, cin, cout, generator=gen) / (k * k * cin) ** 0.5)
         * mask.reshape(k, k, cin, cout)).to(device, dtype)
    x = torch.randn(RN50_BATCH, hw, hw, cin, generator=gen).to(device, dtype)
    gy = torch.randn(RN50_BATCH, hw, hw, cout, generator=gen).to(device,
                                                                  dtype)
    branch = bsc.tap_branch(k, k, bk, bn, dtype)
    tag = (f'{path} {k}x{k} n={RN50_BATCH} {hw}x{hw} {cin}->{cout} '
           f's={s:.3f} ({n_act} blocks) bfloat16')
    if k == 1:
      x2, gy2, w2 = x.view(-1, cin), gy.view(-1, cout), w.view(cin, cout)
      libs = {'fwd': (lambda: x2 @ w2, 'x @ W (cuBLAS, masked W)'),
              'dx': (lambda: gy2 @ w2.T, 'gy @ Wᵀ (cuBLAS, masked W)'),
              'dw': (lambda: x2.T @ gy2, 'xᵀ @ gy (cuBLAS, dense)')}
    else:
      xc, gyc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
      wc = w.permute(3, 2, 0, 1).contiguous(
          memory_format=torch.channels_last)
      libs = {'fwd': (lambda: F.conv2d(xc, wc, padding=1), 'F.conv2d'),
              'dx': (lambda: conv2d_input(xc.shape, wc, gyc, padding=1),
                     'conv2d_input'),
              'dw': (lambda: conv2d_weight(xc, wc.shape, gyc, padding=1),
                     'conv2d_weight')}
    ops = {op: (f'tap_conv_{op}_launches',
                lambda a=a, op=op: bsc.tap_conv_cuda(a, w, index, op),
                lambda a=a, op=op: bsc.tap_conv_reference(a, w, index, op))
           for op, a in (('fwd', x), ('dx', gy))}
    ops['dw'] = ('tap_dw_launches', lambda: bsc.tap_dw_cuda(x, gy, w, index),
                 lambda: bsc.tap_dw_reference(x, gy, index, dtype))
    for op, (counter, run, plain) in ops.items():
      rec, got = kernel_point(
          torch, f'tap {op:3s} {tag}', counter, run, plain, libs[op][0],
          tap_bound(op, RN50_BATCH, hw, index, dtype), module=bsc,
          library_name=libs[op][1], plain_iters=2,
          branch=branch if op != 'dw' else None)
      if op == 'dw':
        if k != 1:
          rec['split'] = dw_split(f'tap dw  {tag}', bsc.tap_dw_plan(
              index, RN50_BATCH * hw * hw, dtype, sm_count(torch)))
      elif branch == 'wgmma':
        rec['gcols'] = _tap_gcols(torch, index, op, RN50_BATCH * hw * hw)
      if k == 1 and op != 'dw':
        lists = index.mm_lists(op, device)
        a2 = (x if op == 'fwd' else gy).view(-1, cin if op == 'fwd'
                                             else cout)
        b7 = lambda a2=a2, lists=lists, op=op: v3.dense_mm_cuda(  # noqa: E731
            a2, w2, lists, RN50_BLOCK, op)
        check(torch.equal(b7().view(got.shape), got),
              f'tap {op} {tag}: not bitwise B7\'s product')
        rec['b7_ms'] = device_ms(b7, 20)
        log(f'  B7 (dense_mm_cuda, the same lists) {rec["b7_ms"]:.4f} ms')
      if op == 'fwd':
        for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
          check(not bool(got[..., j * bn:(j + 1) * bn].any()),
                f'tap fwd {tag}: empty column {j} not zero')
      rec.update(path='rn50_tap_route', layer=path, n=RN50_BATCH, hw=hw, k=k,
                 cin=cin, cout=cout, sparsity=s, n_active=n_act,
                 dtype='bfloat16', empty_column=False,
                 library=libs[op][1])
      records[op].append(rec)
    del x, gy, w
  torch.cuda.empty_cache()
  sums = {}
  for op in ('fwd', 'dx', 'dw'):
    for k in (1, 3):
      pts = [r for r in records[op] if r['k'] == k]
      keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms') + (
          ('b7_ms',) if k == 1 and op != 'dw' else ())
      sums[f'{op}_{k}x{k}'] = {key: sum(r[key] for r in pts) for key in keys}
      sums[f'{op}_{k}x{k}']['points'] = len(pts)
      log(f'rn50 tap route {op} {k}x{k}, {len(pts)} shapes, sums (ms): '
          + ', '.join(f'{key} {v:.4f}' for key, v in
                      sums[f'{op}_{k}x{k}'].items() if key != 'points'))
  records['sums'] = sums
  return records


def wrn_model(torch, device, engine, seed):
  from rigl_tpu_torch.models.packed_convnet import PackedWideResNet
  return PackedWideResNet(depth=WRN_DEPTH, width=WRN_WIDTH, num_classes=10,
                          sparsity=_wrn_spec(), block=WRN_BLOCK,
                          engine=engine, generator=torch.Generator().manual_seed(seed),
                          device=device)


def wrn_twin(device='meta'):
  from rigl_tpu_torch.models.packed_convnet import DenseWideResNetTwin
  return DenseWideResNetTwin(depth=WRN_DEPTH, width=WRN_WIDTH,
                             num_classes=10, device=device)


def wrn_data():
  """Synthetic CIFAR-10 shapes, standardized per image (both splits)."""
  from rigl_tpu_torch.data.datasets import normalize, synthetic_arrays
  tx, ty, vx, vy = synthetic_arrays(10, (32, 32, 3), n_train=4096,
                                    n_test=1024, seed=SEED)
  return (normalize('cifar10', tx), ty), (normalize('cifar10', vx), vy)


def phase_wrn(torch, device):
  """The conv-net main path: PackedClassifierTrainer on WRN-22-2 with the
  'tap' engine (module docstring, phase 13).  Returns (tap launches of the
  RigL run, record)."""
  import numpy as np
  from torch.func import functional_call
  from rigl_tpu_torch.train.packed_classifier import (
      PackedClassifierConfig, PackedClassifierTrainer)
  from rigl_tpu_torch.train.packed_lm import dense_twin_params
  from rigl_tpu_torch.transforms.packed_training import repack_permutation
  train_xy, eval_xy = wrn_data()
  base = dict(sparsity=WRN_SPARSITY, block=WRN_BLOCK, learning_rate=0.05,
              momentum=0.9, batch_size=WRN_BATCH, drop_fraction=0.3,
              drop_fraction_anneal='cosine', seed=SEED,
              maskupdate_begin_step=0)

  def run(algo, steps, frequency, end):
    cfg = PackedClassifierConfig(algo=algo, train_steps=steps,
                                 maskupdate_end_step=end,
                                 maskupdate_frequency=frequency, **base)
    tr = PackedClassifierTrainer(wrn_model(torch, device, 'tap', SEED), wrn_twin(),
                                 cfg, (32, 32, 3))
    tr.init_state()
    updates, progress = [], []
    mask_update = tr.mask_update

    def checked_update(x, y):
      old = tr.packings
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      occ = mask_update(x, y)
      torch.cuda.synchronize()
      ms = (time.perf_counter() - t0) * 1e3
      mom = tr.momentum()
      grown = 0
      for name, pk in tr.packings.items():
        check(int(occ[name].sum()) == tr.params[name].shape[0],
              f'wrn {algo} update: {name} count changed')
        new = (repack_permutation(old[name], pk) < 0).to(device)
        grown += int(new.sum())
        for t in (tr.params[name].detach(), mom[name]):
          check(not bool(t[new].any()), f'wrn {algo} update: grown slot of '
                f'{name} not zero')
      updates.append(dict(step=tr.step, ms=ms, grown=grown))
      return occ

    last = [_tap_counts()]

    def on_step(m):
      now = _tap_counts()
      progress.append(dict(m, t=time.perf_counter(), launches=tuple(
          a - b for a, b in zip(now, last[0]))))
      last[0] = now

    tr.mask_update = checked_update
    t0 = time.perf_counter()
    res = tr.train(train_xy, progress_fn=on_step, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del tr.mask_update
    losses = [p['loss'] for p in progress]
    after = {u['step'] + (1 if algo == 'rigl' else 0) for u in updates}
    gaps = [b['t'] - a['t'] for a, b in zip(progress, progress[1:])
            if b['step'] not in after]
    bad = [(p['step'], p['launches']) for p in progress
           if p['launches'] != (WRN_TAP_CONVS,) * 3]
    rec = dict(algo=algo, steps=res['train_steps'],
               batches=res['batches'],
               update_steps=[u['step'] for u in updates],
               update_ms=[u['ms'] for u in updates],
               blocks_grown=[u['grown'] for u in updates], losses=losses,
               step_ms=float(np.median(gaps)) * 1e3 if gaps else None,
               wall_s=wall)
    log(f'wrn {algo}: {res["train_steps"]} steps in {wall:.2f} s, updates '
        f'at {rec["update_steps"]} ({[round(m, 1) for m in rec["update_ms"]]}'
        f' ms, grown {rec["blocks_grown"]}); step {rec["step_ms"]:.2f} ms '
        f'(median, host clock); loss {losses[0]:.4f} -> {losses[-1]:.4f}')
    check(all(np.isfinite(losses)), f'wrn {algo}: non-finite loss')
    check(not bad, f'wrn {algo}: steps whose tap launches (fwd, dx, dw) are '
          f'not {WRN_TAP_CONVS} each: {bad[:3]}')
    return tr, rec

  _zero_counts()
  tr, rigl = run('rigl', WRN_STEPS, 10, 20)
  launches = _tap_counts()
  check(rigl['update_steps'] == [0, 10, 20],
        f'wrn rigl updates at {rigl["update_steps"]}, not [0, 10, 20]')
  check(rigl['batches'] == WRN_STEPS + 3, f'wrn rigl batches '
        f'{rigl["batches"]} != steps + updates')
  check(sum(rigl['blocks_grown']) > 0, 'wrn rigl grew no block')
  check(np.mean(rigl['losses'][-5:]) < np.mean(rigl['losses'][:5]),
        f'wrn rigl loss did not fall: {rigl["losses"]}')
  log(f'  wrn rigl tap launches (fwd, dx, dw) {launches}')

  # One step's loss and packed gradients against the plain path: the dense
  # twin (cuDNN convs, TF32 off) holding the unpacked kernels.
  rs = np.random.RandomState(SEED + 12)
  idx = rs.randint(0, len(train_xy[0]), size=WRN_BATCH)
  x = torch.as_tensor(train_xy[0][idx]).to(device)
  y = torch.as_tensor(train_xy[1][idx]).to(device)
  params = tr.params
  loss = tr._loss(x, y)
  grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
  loss = loss.detach()
  views = {n: v.detach().clone().requires_grad_() for n, v in
           dense_twin_params({n: p.detach() for n, p in params.items()},
                             tr.packings, WRN_BLOCK).items()}
  logits = functional_call(wrn_twin(), views, (x,)).float()
  plain_loss = -torch.log_softmax(logits, -1).gather(
      1, y.long()[:, None]).mean()
  plain = dict(zip(views, torch.autograd.grad(plain_loss,
                                              list(views.values()))))
  plain_loss = plain_loss.detach()
  loss_err = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
  grad_errs = _grad_errors(torch, tr.model, grads, plain)
  worst = sorted(grad_errs, key=grad_errs.get)[-3:]
  log(f'  one step, tap path vs plain path: loss {float(loss):.6f} vs '
      f'{float(plain_loss):.6f} (rel {loss_err:.3e}); max rel grad err '
      f'{max(grad_errs.values()):.3e} (tol {WRN_STEP_RTOL}); largest at '
      f'{[(n, float(f"{grad_errs[n]:.3e}")) for n in worst]}')
  check(loss_err <= WRN_STEP_RTOL, f'wrn step loss: rel error {loss_err}')
  for name, err in grad_errs.items():
    check(err <= WRN_STEP_RTOL, f'wrn step grad {name}: rel error {err}')
  del grads, plain, views
  t0 = time.perf_counter()
  top1 = tr.evaluate(*eval_xy)
  eval_s = time.perf_counter() - t0
  log(f'  evaluate on {len(eval_xy[0])} images: top-1 {top1:.4f} in '
      f'{eval_s:.2f} s')
  check(0.0 <= top1 <= 1.0, f'eval top-1 {top1}')
  del tr
  others = {}
  for algo in ('set', 'snfs'):
    t, others[algo] = run(algo, 6, 5, 5)
    check(len(others[algo]['update_steps']) == 1,
          f'wrn {algo} updates at {others[algo]["update_steps"]}')
    del t
  torch.cuda.empty_cache()
  return launches, dict(rigl=rigl, **others, eval_top_1=top1,
                        step_vs_plain=dict(
                            loss_rel_err=loss_err,
                            max_grad_rel_err=max(grad_errs.values())))


# The tap conv's kernels, by name, whose time phase 14 sums per step: the
# f32 forward / dx (W's copy, then the products) and the dw.
WRN_TAP_KERNELS = ('tap_w_split_kernel', 'tap_conv_tf32_kernel',
                   'tap_dw_kernel')


def phase_wrn_speed(torch, device):
  """us/step of WRN-22-2 (f32, batch 128, SGD nesterov 0.9, lr 0.05) with
  the 'tap' engine, the 'xla' engine (unpack, then cuDNN) and the dense
  twin, each twice in mirrored order; each arm's device busy share and
  kernel time per step, in all and by kernel (torch.profiler), the tap
  arm's also for each kernel of the tap conv (WRN_TAP_KERNELS)."""
  import numpy as np
  from rigl_tpu_torch import convert
  train_xy, _ = wrn_data()
  x = torch.as_tensor(train_xy[0][:WRN_BATCH]).to(device)
  y = torch.as_tensor(train_xy[1][:WRN_BATCH]).to(device)
  tap = wrn_model(torch, device, 'tap', SEED + 13)
  xla = wrn_model(torch, device, 'xla', SEED + 13)
  dense = wrn_twin(device)
  dense.load_state_dict(convert.dense_twin_state(tap))

  def make_step(model):
    opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9,
                          nesterov=True)

    def step():
      opt.zero_grad(set_to_none=True)
      logits = model(x).float()
      loss = -torch.log_softmax(logits, -1).gather(1, y.long()[:, None]).mean()
      loss.backward()
      opt.step()
    for _ in range(3):
      step()
    torch.cuda.synchronize()
    return step

  steps = {'tap': make_step(tap), 'xla': make_step(xla),
           'dense': make_step(dense)}
  order = list(steps) + list(steps)[::-1]
  us = {name: [] for name in steps}
  for name in order:
    us[name].append(time_ms(steps[name], 10) * 1e3)
  rec = {}
  for name, step in steps.items():
    mean_us = float(np.mean(us[name]))
    prof = profiled_kernel_time(torch, step, 3,
                                WRN_TAP_KERNELS if name == 'tap' else ())
    busy = _share(prof['kernel_us_per_step'], mean_us)
    rec[name] = dict(us_per_step=us[name], device_busy_share=busy, **prof)
    log(f'wrn step: {name:5s} us/step {[round(u, 1) for u in us[name]]} '
        f'(mean {mean_us:.1f}); kernels {prof["kernel_us_per_step"]} us/step '
        f'(busy share {busy})')
    if name == 'tap' and prof['matched_us_per_step'] is not None:
      for kernel, t in prof['matched_us_per_step'].items():
        log(f'  tap kernels {kernel}: {t:.1f} us/step')
  for name in ('tap', 'xla'):
    rec[f'dense_over_{name}'] = (float(np.mean(us['dense']))
                                 / float(np.mean(us[name])))
    log(f'  dense/{name}: {rec[f"dense_over_{name}"]:.3f}')
  del steps, tap, xla, dense
  torch.cuda.empty_cache()
  return rec


# ------------------------------------------ dense-masked ResNet-50 (15-18) --
def rn50_1x1_shapes():
  """(path, m, cin, cout) of ResNet-50's 1x1 convs that block RN50_BLOCK
  divides, at batch RN50_BATCH and RN50_IMAGE px: rows are the conv's
  output pixels (the stride of a projection subsamples its input)."""
  from rigl_tpu_torch.models.resnet import DEPTHS
  bk, bn = RN50_BLOCK
  hw = RN50_IMAGE // 4
  cin = 64
  out = []
  for g, n_blocks in enumerate(DEPTHS[50][1]):
    f = 64 * 2 ** g
    for i in range(n_blocks):
      name = f'group{g + 1}_block{i}'
      stride = 2 if (g > 0 and i == 0) else 1
      hw_out = hw // stride
      convs = [('conv1', hw, cin, f), ('conv3', hw_out, f, 4 * f)]
      if i == 0:
        convs.append(('proj', hw_out, cin, 4 * f))
      for conv, side, ci, co in convs:
        if ci % bk == 0 and co % bn == 0:
          out.append((f'{name}/{conv}/conv/kernel', RN50_BATCH * side * side,
                      ci, co))
      hw, cin = hw_out, 4 * f
  return out


def _rn50_mask_rule(path, leaf):
  """bench.py's rule: the first conv is not masked at all."""
  from rigl_tpu_torch.sparsity.masks import default_mask_rule
  return not path.startswith('initial_conv') and default_mask_rule(path,
                                                                   leaf)


def _rn50_sparsities():
  """{path: ERK sparsity} of ResNet-50's masked layers at RN50_SPARSITY."""
  from rigl_tpu_torch.models.resnet import ResNet
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.sparsity.distributions import get_sparsities
  model = ResNet(50, num_classes=1000, device='meta')
  shapes = masks_lib.mask_shapes(masks_lib.param_dict(model),
                                 _rn50_mask_rule)
  return get_sparsities(shapes, 'erdos_renyi_kernel', RN50_SPARSITY)


def dense_bound(op, m, occ, block, dtype):
  """(ms, 'bytes' | 'operations'): the least time of one dense-storage
  call on an H100: the activation columns of non-empty block-rows /
  -columns, the active W blocks and the output (dw: the whole (K, N)
  gradient) each once over HBM_BYTES_PER_S, or its FLOPs on the active
  blocks over PEAK_FLOPS, whichever is larger."""
  import torch
  bk, bn = block
  nk, nn_ = occ.shape
  e = torch.empty((), dtype=dtype).element_size()
  occ = occ.cpu().bool()
  n_act = int(occ.sum())
  k_used = int(occ.any(1).sum()) * bk
  n_used = int(occ.any(0).sum()) * bn
  w_bytes = n_act * bk * bn * e
  moved = {'fwd': m * k_used * e + w_bytes + m * nn_ * bn * e,
           'dx': m * n_used * e + w_bytes + m * nk * bk * e,
           'dw': m * k_used * e + m * n_used * e + nk * bk * nn_ * bn * e}[op]
  flops = 2.0 * m * n_act * bk * bn
  t_bytes = moved / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _cpu_lists(lists):
  return type(lists)(*(None if t is None else t.cpu() for t in lists))


def phase_dense_kernels(torch, device):
  """Phase 15: the dense-storage modes against their plain versions at
  ResNet-50's 29 eligible 1x1 shapes (batch 128, 224 px, ERK-0.8
  occupancies at block (128, 128), bf16), the forward and dx from the
  flat packing (v4, B7) and from the occupancy (v3, B8) and the gathered
  dw (B9); then f32 at one shape; beside torch.matmul on the masked dense
  W (xᵀ @ gy for dw) and the bound."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.ops import block_sparse_v4 as v4
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED + 15)
  bk, bn = RN50_BLOCK
  sparsities = _rn50_sparsities()
  shapes = rn50_1x1_shapes()
  check(len(shapes) == RN50_1X1, f'{len(shapes)} eligible 1x1 convs, not '
        f'{RN50_1X1}')
  points = [(p, m, ci, co, torch.bfloat16) for p, m, ci, co in shapes]
  points.append(shapes[-1][:4] + (torch.float32,))
  records = {k: [] for k in ('v4_fwd', 'v4_dx', 'v3_fwd', 'v3_dx', 'dw')}
  for path, m, cin, cout, dtype in points:
    nk, nn_ = cin // bk, cout // bn
    s = sparsities[path]
    n_act = nk * nn_ - get_n_zeros(nk * nn_, s)
    occ = random_occupancy(gen, nk, nn_, n_act).to(device)
    mask = occ.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    w = (torch.randn(cin, cout, generator=gen) / cin ** 0.5).to(device)
    w = (w * mask).to(dtype)
    x = torch.randn(m, cin, generator=gen).to(device, dtype)
    gy = torch.randn(m, cout, generator=gen).to(device, dtype)
    cols, rows = v4.pack_flat_active(occ, n_act)
    shape = (cin, cout)
    lists = {'v4_fwd': v4.flat_lists(cols, rows, RN50_BLOCK, shape),
             'v4_dx': v4.flat_lists(cols, rows, RN50_BLOCK, shape, 'dx'),
             'v3_fwd': v3.occupancy_lists(occ, RN50_BLOCK, cout),
             'v3_dx': v3.occupancy_lists(occ, RN50_BLOCK, cout, 'dx')}
    entries = v4.flat_dw_entries(cols, rows)
    entries_cpu = _cpu_lists(entries)
    tag = (f'{path} m={m} {cin}->{cout} s={s:.3f} ({n_act} blocks) '
           f'{dtype_name(dtype)}')
    for key, lst in lists.items():
      form, op = key.split('_')
      mod, kern = (v4, v4.v4_matmul_cuda) if form == 'v4' else (
          v3, v3.v3_matmul_cuda)
      a = x if op == 'fwd' else gy
      lst_cpu = _cpu_lists(lst)
      rec, got = kernel_point(
          torch, f'{key:6s} {tag}', f'{form}_{op}_launches',
          lambda a=a, lst=lst, kern=kern, op=op: kern(a, w, lst, RN50_BLOCK,
                                                     op),
          lambda a=a, lst=lst_cpu, op=op: v3.dense_mm_reference(
              a, w, lst, RN50_BLOCK, op),
          (lambda: x @ w) if op == 'fwd' else (lambda: gy @ w.T),
          dense_bound(op, m, occ, RN50_BLOCK, dtype), module=mod,
          plain_iters=3,
          branch=bsp.mm_branch(m, bk if op == 'fwd' else bn, dtype))
      if op == 'fwd':
        for j in (occ.sum(0) == 0).nonzero().flatten().tolist():
          check(not bool(got[:, j * bn:(j + 1) * bn].any()),
                f'{key} {tag}: empty column {j} not zero')
      rec.update(path=path, m=m, cin=cin, cout=cout, sparsity=s,
                 n_active=n_act, dtype=dtype_name(dtype))
      records[key].append(rec)
    rec, _ = kernel_point(
        torch, f'dw     {tag}', 'dw_gather_launches',
        lambda: v3.dense_dw_cuda(x, gy, w, entries, RN50_BLOCK),
        lambda: v3.dense_dw_reference(x, gy, entries_cpu, RN50_BLOCK, dtype),
        lambda: x.T @ gy, dense_bound('dw', m, occ, RN50_BLOCK, dtype),
        module=v3, library_name='xᵀ @ gy', plain_iters=3)
    rec.update(path=path, m=m, cin=cin, cout=cout, sparsity=s,
               n_active=n_act, dtype=dtype_name(dtype),
               split=dw_split(f'dw     {tag}', bsp.dw_plan(
                   m, int(entries.rows.numel()), RN50_BLOCK, dtype,
                   sm_count(torch))))
    records['dw'].append(rec)
    del x, gy, w
  torch.cuda.empty_cache()
  return records


def rn50_model(torch, device, block, seed):
  from rigl_tpu_torch.models.resnet import ResNet
  return ResNet(50, num_classes=1000, dtype=torch.bfloat16, block=block,
                generator=torch.Generator().manual_seed(seed), device=device)


def rn50_setup(torch, device, algo, block, routing, execute=True,
               seed=SEED + 16, conv3x3=False):
  """(model, st, state, hot step, update step) of bench.py's resnet50
  arm: ERK 0.8 without the first conv, SGD 0.1 nesterov 0.9, weight decay
  1e-4, label smoothing 0.1, pre-masked storage for RigL; the schedule's
  frequency cut to RN50_FREQ.  `block`: the masks' block granularity,
  executed on the block kernels unless `execute` is False
  (dense-times-mask execution of block-granular masks); `conv3x3`: the
  spatial convs that block divides on the tap kernels too (bench.py's
  BENCH_BLOCK_CONV3X3=1)."""
  import functools
  from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
  from rigl_tpu_torch.train import steps
  from rigl_tpu_torch.transforms import algorithms
  from rigl_tpu_torch.transforms.sparse_training import SparseTraining
  model = rn50_model(torch, device, block if execute else None, seed)
  sched = UpdateSchedule(begin_step=0, end_step=25000, frequency=RN50_FREQ,
                         drop_fraction=0.3, drop_fraction_anneal='cosine')
  if algo == 'rigl':
    alg = algorithms.RigL(schedule=sched)
  elif algo == 'prune':
    alg = algorithms.GradualPruning(schedule=UpdateSchedule(
        begin_step=0, end_step=10, frequency=2))
  else:
    alg = algorithms.DENSE
  st = SparseTraining(
      functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                        nesterov=True), alg,
      distribution='erdos_renyi_kernel', default_sparsity=RN50_SPARSITY,
      block=block if alg.name != 'none' else None, block_routing=routing,
      mask_rule=_rn50_mask_rule, premask_params=(algo == 'rigl'))
  state = steps.init_train_state(SEED, model, st)

  def make(hint):
    return steps.make_train_step(model, st, weight_decay=1e-4,
                                 label_smoothing=0.1,
                                 block=block if execute else None,
                                 block_conv3x3=conv3x3,
                                 update_hint=hint)
  if alg.name == 'none':
    return model, st, state, make(None), None
  return model, st, state, make(False), make(True)


def rn50_batches(torch, device, n):
  """bench.py's synthetic data: N(0, 1) images, uniform labels."""
  gen = torch.Generator(device=device).manual_seed(SEED + 17)
  return [{'image': torch.randn(RN50_BATCH, RN50_IMAGE, RN50_IMAGE, 3,
                                generator=gen, device=device),
           'label': torch.randint(0, 1000, (RN50_BATCH,), generator=gen,
                                  device=device)} for _ in range(n)]


def _rn50_counts_ok(st, state):
  """Every block layer's active count equals static_block_counts()."""
  from rigl_tpu_torch.ops import block_mask as bm_lib
  counts = st.static_block_counts()
  for p, want in counts.items():
    m = state.sparse.masks[p]
    pool = (bm_lib.pool_to_tap_blocks if bm_lib.is_tap_layer(
        tuple(m.shape), st.block) else bm_lib.pool_to_blocks)
    got = int((pool(m, st.block, 'max') > 0).sum())
    check(got == want, f'rn50: {p} holds {got} active blocks, not {want}')
  return len(counts)


def _rn50_step_vs_plain(torch, model, st, state, batch, routing,
                        plain_tf32=False):
  """One step's loss and per-tensor gradients through the kernels (the
  block packs of the paths in `routing`: the 'matmul' route's flat
  packings or the tap route's TapPacks) against the plain path
  (dense-times-mask execution on cuDNN, in TF32 with `plain_tf32`), from
  the same state, statistics frozen; the gradients of masked tensors
  compared on their active entries."""
  from rigl_tpu_torch.models.common import frozen_batch_stats
  from rigl_tpu_torch.train import steps
  loss_fn = steps.make_loss_fn(model, 1e-4, 0.1)
  entries = {p: state.sparse.block_packs[p] for p in routing}
  out = {}
  with frozen_batch_stats(model):
    for name, e in (('kernel', entries), ('plain', None)):
      torch.backends.cudnn.allow_tf32 = plain_tf32 and e is None
      loss, _ = loss_fn(state.params, batch, e)
      grads = torch.autograd.grad(loss, list(state.params.values()))
      out[name] = (float(loss.detach()), dict(zip(state.params, grads)))
  torch.backends.cudnn.allow_tf32 = False
  loss_err = abs(out['kernel'][0] - out['plain'][0]) / abs(out['plain'][0])
  errs = {}
  for p, g in out['kernel'][1].items():
    want = out['plain'][1][p]
    m = state.sparse.masks.get(p)
    if m is not None:
      g, want = g * m, want * m
    check(bool(torch.isfinite(g).all()), f'rn50: non-finite grad {p}')
    errs[p] = _rel(g, want)
  return out['kernel'][0], out['plain'][0], loss_err, errs


def phase_rn50(torch, device):
  """Phase 16, the main path of B7: RN50_STEPS RigL steps of the
  dense-masked ResNet-50 train step with every eligible 1x1 conv routed
  'matmul' (module docstring).  Returns (launches, record)."""
  import numpy as np
  shapes = rn50_1x1_shapes()
  routing = {p: 'matmul' for p, *_ in shapes}
  model, st, state, hot, upd = rn50_setup(torch, device, 'rigl', RN50_BLOCK,
                                          routing)
  batches = rn50_batches(torch, device, 3)
  packs = state.sparse.block_packs
  check(all(set(packs[p]) == {'cols', 'rows'} for p in routing),
        'rn50: the routed 1x1s do not hold flat packings')
  loss_k, loss_p, loss_err, errs = _rn50_step_vs_plain(
      torch, model, st, state, batches[0], routing)
  worst = sorted(errs, key=errs.get)[-3:]
  log(f'rn50 one step, kernel path vs plain path: loss {loss_k:.6f} vs '
      f'{loss_p:.6f} (rel {loss_err:.3e}); max rel grad err '
      f'{max(errs.values()):.3e} (tol {STEP_RTOL}); largest at '
      f'{[(n, float(f"{errs[n]:.3e}")) for n in worst]}')
  check(loss_err <= STEP_RTOL, f'rn50 step loss: rel error {loss_err}')
  for p, err in errs.items():
    check(err <= STEP_RTOL, f'rn50 step grad {p}: rel error {err}')

  n_updates = RN50_STEPS // RN50_FREQ + 1
  hints = st.predict_update_iters(RN50_STEPS + n_updates)
  progress, masks_at_3 = [], None
  torch.cuda.synchronize()
  _zero_counts()
  last = _counts()
  t0 = time.perf_counter()
  for i, hint in enumerate(hints):
    state, m = (upd if hint else hot)(state, batches[i % len(batches)])
    now = _counts()
    launches = (now['v4_fwd'] - last['v4_fwd'], now['v4_dx'] - last['v4_dx'])
    last = now
    progress.append(dict(step=m['step'], updated=m['mask_updated'],
                         hint_ok=m.get('update_hint_ok', True),
                         loss=float(m['loss']), launches=launches,
                         t=time.perf_counter()))
    if m['mask_updated']:
      _rn50_counts_ok(st, state)
    if i == 2:
      masks_at_3 = {p: t.clone() for p, t in state.sparse.masks.items()}
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = _counts()
  n_layers = _rn50_counts_ok(st, state)
  losses = [p['loss'] for p in progress]
  upd_steps = [p['step'] for p in progress if p['updated']]
  bad = [(i, p['launches']) for i, p in enumerate(progress)
         if p['launches'] != (RN50_1X1, RN50_1X1)]
  gaps = [b['t'] - a['t'] for a, b in zip(progress, progress[1:])
          if not b['updated']]
  log(f'rn50 rigl: {len(progress)} iterations to step {state.step} in '
      f'{wall:.2f} s, updates at steps {upd_steps}; step '
      f'{float(np.median(gaps)) * 1e3:.1f} ms (median, host clock); loss '
      f'{losses[0]:.4f} -> {losses[-1]:.4f}; v4 launches (fwd, dx) '
      f'{launches["v4_fwd"]}, {launches["v4_dx"]}; {n_layers} block layers '
      'at their static counts')
  check(all(p['hint_ok'] for p in progress), 'rn50: a hint missed')
  check(state.step == RN50_STEPS, f'rn50 ended at step {state.step}')
  check(upd_steps == list(range(0, RN50_STEPS, RN50_FREQ)),
        f'rn50 updates at {upd_steps}')
  check(all(np.isfinite(losses)), f'rn50: non-finite loss {losses}')
  check(not bad, f'rn50: iterations whose v4 launches (fwd, dx) are not '
        f'{RN50_1X1} each: {bad[:3]}')
  del model, st, state, hot, upd
  torch.cuda.empty_cache()

  # The same 3 iterations (the step-0 update, two steps) with
  # dense-times-mask execution from the same initial state.
  model, st, state, hot, upd = rn50_setup(torch, device, 'rigl', RN50_BLOCK,
                                          routing, execute=False)
  for i, hint in enumerate(st.predict_update_iters(3)):
    state, _ = (upd if hint else hot)(state, batches[i])
  differ = [p for p, t in state.sparse.masks.items()
            if not torch.equal(t, masks_at_3[p])]
  log(f'  masks after 3 iterations, block vs dense-times-mask execution: '
      f'{len(state.sparse.masks) - len(differ)} of '
      f'{len(state.sparse.masks)} equal')
  check(not differ, f'rn50: masks differ from dense-times-mask at {differ}')
  del model, st, state, hot, upd, batches
  torch.cuda.empty_cache()
  return launches, dict(
      iterations=len(progress), steps=RN50_STEPS, update_steps=upd_steps,
      losses=losses, step_ms=float(np.median(gaps)) * 1e3, wall_s=wall,
      launches_per_iteration=[p['launches'] for p in progress],
      step_vs_plain=dict(loss_rel_err=loss_err,
                         max_grad_rel_err=max(errs.values())))


def phase_rn50_occupancy(torch, device):
  """Phase 17, the paths of B8 and B9: a few GradualPruning steps of the
  same model (no static counts, so its 1x1s hold occupancies: the v3
  route), BlockSparseDense forward and backward at
  scripts/bench_blocksparse_mlp.py's 'layer' width (3 x 4096, batch 1024,
  block (512, 512), s = 0.8: dense dw), and one 'auto' call where the
  traffic model picks the gathered dw (K = N = 1024, block (512, 512)).
  Returns ({path: launches}, record)."""
  from rigl_tpu_torch.layers.block_sparse_dense import BlockSparseDense
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  routing = {p: 'matmul' for p, *_ in rn50_1x1_shapes()}
  model, st, state, hot, upd = rn50_setup(torch, device, 'prune', RN50_BLOCK,
                                          routing)
  check(not st.static_block_counts(), 'prune has static counts')
  check(all(not isinstance(state.sparse.block_packs[p], dict)
            for p in routing), 'rn50 prune: 1x1s do not hold occupancies')
  batches = rn50_batches(torch, device, 1)
  hints = st.predict_update_iters(RN50_PRUNE_STEPS)
  _zero_counts()
  per_step, losses = [], []
  for hint in hints:
    before = _counts()
    state, m = (upd if hint else hot)(state, batches[0])
    now = _counts()
    per_step.append((now['v3_fwd'] - before['v3_fwd'],
                     now['v3_dx'] - before['v3_dx']))
    losses.append(float(m['loss']))
  torch.cuda.synchronize()
  occ_launches = _counts()
  log(f'rn50 prune (occupancy route): {len(hints)} steps, updates at '
      f'{[i for i, h in enumerate(hints) if h]}, loss {losses}; v3 launches '
      f'(fwd, dx) per step {per_step}')
  check(all(ps == (RN50_1X1, RN50_1X1) for ps in per_step),
        f'rn50 prune: v3 launches per step {per_step}')
  check(all(math.isfinite(v) for v in losses), 'rn50 prune: loss')
  del model, st, state, hot, upd, batches
  torch.cuda.empty_cache()

  # BlockSparseDense at the bench's 'layer' width: B8 with a dense dw.
  gen = torch.Generator().manual_seed(SEED + 18)
  bk, bn = MLP_BSD_BLOCK
  nb = MLP_WIDTH // bk
  layers = [BlockSparseDense(MLP_WIDTH, MLP_WIDTH, block=MLP_BSD_BLOCK,
                             use_bias=False, dtype=torch.bfloat16,
                             generator=gen, device=device)
            for _ in range(MLP_DEPTH)]
  for layer in layers:
    occ = random_occupancy(gen, nb, nb, nb * nb - get_n_zeros(nb * nb, 0.8))
    layer.mask.copy_(occ.repeat_interleave(bk, 0).repeat_interleave(
        bn, 1).to(device))
  x = torch.randn(MLP_BATCH, MLP_WIDTH, generator=gen).to(device,
                                                          torch.bfloat16)
  _zero_counts()
  h = x
  for layer in layers:
    h = torch.relu(layer(h))
  loss = h.float().square().mean()
  grads = torch.autograd.grad(loss, [l.kernel for l in layers])
  loss = loss.detach()
  torch.cuda.synchronize()
  bsd_launches = _counts()
  # The plain path: the same layers as masked dense matmuls.
  hp = x
  for layer in layers:
    hp = torch.relu(hp @ (layer.kernel * layer.mask).to(torch.bfloat16))
  plain_loss = hp.float().square().mean()
  plain_grads = torch.autograd.grad(plain_loss, [l.kernel for l in layers])
  plain_loss = float(plain_loss.detach())
  bsd_errs = [_rel(g * l.mask, pg * l.mask)
              for g, pg, l in zip(grads, plain_grads, layers)]
  bsd_loss_err = abs(float(loss) - plain_loss) / abs(plain_loss)
  log(f'BlockSparseDense 3 x {MLP_WIDTH}, batch {MLP_BATCH}, block '
      f'{MLP_BSD_BLOCK} bf16: loss rel err {bsd_loss_err:.3e}, grad rel errs '
      f'{[float(f"{e:.3e}") for e in bsd_errs]} (tol {STEP_RTOL}); v3 '
      f'launches (fwd, dx) {bsd_launches["v3_fwd"]}, '
      f'{bsd_launches["v3_dx"]}; dw mode '
      f'{v3.dw_mode_for((MLP_WIDTH, MLP_WIDTH), MLP_BSD_BLOCK, "auto")}')
  check(bsd_launches['v3_fwd'] == MLP_DEPTH
        and bsd_launches['v3_dx'] == MLP_DEPTH - 1
        and bsd_launches['dw_gather'] == 0,
        f'BlockSparseDense launches {bsd_launches}')
  check(bsd_loss_err <= STEP_RTOL and max(bsd_errs) <= STEP_RTOL,
        'BlockSparseDense: kernel path and plain path disagree')
  del layers, x, h, hp, grads, plain_grads
  torch.cuda.empty_cache()

  # One 'auto' call the traffic model sends to the gathered dw (B9).
  k = n = 1024
  block = (512, 512)
  check(v3.dw_mode_for((k, n), block, 'auto') == 'gather',
        'auto does not pick gather at K = N = 1024, block 512')
  occ = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32, device=device)
  xa = torch.randn(MLP_BATCH, k, generator=gen).to(device,
                                                   torch.bfloat16)
  wa = (torch.randn(k, n, generator=gen) / k ** 0.5).to(
      device, torch.bfloat16).requires_grad_()
  _zero_counts()
  ya = v3.block_sparse_matmul_v3(xa, wa, occ, block, dw_mode='auto')
  (dwa,) = torch.autograd.grad(ya.float().sum(), [wa])
  torch.cuda.synchronize()
  auto_launches = _counts()
  want = v3.masked_dense_dw(xa, torch.ones_like(ya), occ, block,
                            torch.bfloat16)
  auto_err = _rel(dwa, want)
  log(f"'auto' dw at K = N = {k}, block {block}: gathered dw launches "
      f"{auto_launches['dw_gather']}, rel err vs the dense dw {auto_err:.3e}")
  check(auto_launches['dw_gather'] == 1, 'auto: B9 not launched')
  check(auto_err <= TOL['bfloat16'], f'auto dw: rel error {auto_err}')
  torch.cuda.empty_cache()
  return (dict(rn50_occupancy=occ_launches, block_sparse_dense=bsd_launches,
               auto_gather=auto_launches),
          dict(prune_losses=losses, prune_launches_per_step=per_step,
               bsd_loss_rel_err=bsd_loss_err, bsd_grad_rel_errs=bsd_errs,
               auto_dw_rel_err=auto_err))


def phase_rn50_speed(torch, device):
  """Phase 18: us/step of the ResNet-50 step (batch 128, 224 px, bf16) in
  five arms, each twice in mirrored order: RigL with 'matmul' routing
  (B7), RigL with the default routing (the 1x1s on the tap kernels'
  'mm' branch), the same with block_conv3x3 (also the 13 3x3 convs that
  block (128, 128) divides, on the tap kernels' 'wgmma' branch), RigL
  with dense-times-mask execution, and the dense algorithm; each arm's
  device busy share and kernel time per step by kernel.  The two tap
  arms are first checked as main paths: one hot step with the launch
  counts set to 0 makes one forward, dx and dw tap entry call per
  executed conv (29 each; 42 with the 3x3s; the 1x1s' dw on
  packed_mm.cu's dw kernels), and one step's loss and gradients agree
  with the plain path within STEP_RTOL.  Returns ({arm: that step's
  launches}, record)."""
  import numpy as np
  routing = {p: 'matmul' for p, *_ in rn50_1x1_shapes()}
  arms = {'rigl_matmul': ('rigl', RN50_BLOCK, routing, False),
          'rigl_tap': ('rigl', RN50_BLOCK, None, False),
          'rigl_tap3x3': ('rigl', RN50_BLOCK, None, True),
          'rigl_masked': ('rigl', None, None, False),
          'dense': ('dense', None, None, False)}
  batch = rn50_batches(torch, device, 1)[0]
  steps_, tap_launches, tap_checks = {}, {}, {}
  for name, (algo, block, rt, conv3x3) in arms.items():
    model, st, state, hot, upd = rn50_setup(torch, device, algo, block, rt,
                                            conv3x3=conv3x3)
    holder = {'state': state}
    if upd is not None:   # the step-0 update first, then the hot loop
      holder['state'], _ = upd(holder['state'], batch)

    def step(hot=hot, holder=holder):
      holder['state'], _ = hot(holder['state'], batch)
    if name.startswith('rigl_tap'):
      from rigl_tpu_torch.ops import block_mask as bm_lib
      paths = bm_lib.block_executable_layers(state.sparse.masks, RN50_BLOCK,
                                             conv3x3=conv3x3)
      tap_launches[name], tap_checks[name] = _rn50_tap_route_check(
          torch, model, st, holder, step, batch,
          [p for p in paths if p in holder['state'].sparse.block_packs])
    for _ in range(2):
      step()
    torch.cuda.synchronize()
    steps_[name] = (step, model)
  order = list(steps_) + list(steps_)[::-1]
  us = {name: [] for name in steps_}
  for name in order:
    us[name].append(time_ms(steps_[name][0], RN50_TIMED) * 1e3)
  rec = {}
  for name, (step, _) in steps_.items():
    mean_us = float(np.mean(us[name]))
    prof = profiled_kernel_time(torch, step, 2)
    busy = _share(prof['kernel_us_per_step'], mean_us)
    rec[name] = dict(us_per_step=us[name], device_busy_share=busy, **prof)
    log(f'rn50 step: {name:11s} us/step {[round(u, 1) for u in us[name]]} '
        f'(mean {mean_us:.1f}); kernels {prof["kernel_us_per_step"]} us/step '
        f'(busy share {busy})')
  for name in ('rigl_matmul', 'rigl_tap', 'rigl_tap3x3', 'rigl_masked'):
    rec[f'dense_over_{name}'] = (float(np.mean(us['dense']))
                                 / float(np.mean(us[name])))
    log(f'  dense/{name}: {rec[f"dense_over_{name}"]:.3f}')
  for name, check_ in tap_checks.items():
    rec[name]['check'] = check_
  del steps_
  torch.cuda.empty_cache()
  return tap_launches, rec


def _rn50_tap_route_check(torch, model, st, holder, step, batch, paths):
  """A tap-route arm as a main path (phase_rn50_speed): the launches of
  one hot step, counted from 0 (one forward, dx and dw tap call for each
  of the executed convs `paths`), and one step's loss and gradients
  against the plain path.  Returns (launches, record)."""
  packs = holder['state'].sparse.block_packs
  check(all(set(packs[p]) == {'cols', 'rows', 'taps'} for p in paths),
        'rn50 tap route: an executed conv does not hold a tap pack')
  n_convs = len(paths)
  n_3x3 = sum(tuple(holder['state'].sparse.masks[p].shape[:2]) != (1, 1)
              for p in paths)
  check(n_convs - n_3x3 == RN50_1X1,
        f'rn50 tap route: {n_convs - n_3x3} 1x1 convs, not {RN50_1X1}')
  torch.cuda.synchronize()
  _zero_counts()
  step()
  torch.cuda.synchronize()
  launches = _counts()
  got = (launches['tap_fwd'], launches['tap_dx'], launches['tap_dw'])
  log(f'rn50 tap route ({n_convs - n_3x3} 1x1 and {n_3x3} 3x3 convs), '
      f'one step: tap fwd / dx / dw entry calls {got}; v4 fwd / dx '
      f'{launches["v4_fwd"]} / {launches["v4_dx"]}')
  check(got == (n_convs,) * 3,
        f'rn50 tap route: tap launches {got}, not {(n_convs,) * 3}')
  check(launches['v4_fwd'] == launches['v4_dx'] == 0,
        'rn50 tap route: the v4 form ran')
  loss_k, loss_p, loss_err, errs = _rn50_step_vs_plain(
      torch, model, st, holder['state'], batch, paths)
  worst = sorted(errs, key=errs.get)[-3:]
  log(f'rn50 tap route one step, kernel path vs plain path: loss '
      f'{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3e}); max rel grad '
      f'err {max(errs.values()):.3e} (tol {STEP_RTOL}); largest at '
      f'{[(n, float(f"{errs[n]:.3e}")) for n in worst]}')
  check(loss_err <= STEP_RTOL, f'rn50 tap step loss: rel error {loss_err}')
  for p, err in errs.items():
    check(err <= STEP_RTOL, f'rn50 tap step grad {p}: rel error {err}')
  return launches, dict(launches_per_step=list(got), convs_3x3=n_3x3,
                        loss_rel_err=loss_err,
                        max_grad_rel_err=max(errs.values()))


def _density_occupancy(torch, gen, nk, nn_, density, empty_column=False):
  """(nk, nn) int32 occupancy with round(density * nk * nn) actives (the
  sparsity library's count); with empty_column, block-column 0 holds
  none."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  n_act = nk * nn_ - get_n_zeros(nk * nn_, 1.0 - density)
  if not empty_column:
    return random_occupancy(gen, nk, nn_, n_act)
  occ = torch.zeros(nk, nn_, dtype=torch.int32)
  occ[:, 1:] = random_occupancy(gen, nk, nn_ - 1, min(n_act, nk * (nn_ - 1)))
  return occ


def _expand(occ, block):
  return occ.repeat_interleave(block[0], 0).repeat_interleave(block[1], 1)


def phase_history_kernels(torch, device):
  """Phase 19: the history entries at scripts/bench_mlp_arms.py's shape,
  (M, K, N) = (1024, 4096, 4096), against their plain versions (one
  torch.matmul per active block, f32 sums, one rounding) beside
  torch.matmul on the masked dense W (xᵀ @ gy for dw) and the bound:
  bf16 at densities 1.0, 0.2 and 0.1, f32 at 0.2.  Points: B11's forward
  (block (512, 512), bm 512), B10's forward, dx, and forward + backward
  through autograd (dw the masked xᵀ @ gy), B9' (density 1.0, tiles
  (512, 512, 512)), and B12's forward, dx and dw at block (128, 128).
  Then B10 with an empty output column, into a NaN-filled buffer the
  caching allocator hands back, must give exact zeros there; and the
  arms path: each entry called once per point, as the arms script calls
  it, with the counts set to 0 before.  Returns (records, launches)."""
  from rigl_tpu_torch.ops import block_sparse as v1
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.ops import block_sparse_v2 as v2
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  gen = torch.Generator().manual_seed(SEED + 19)
  m, kdim, n = ARMS_M, ARMS_K, ARMS_N
  points = [(d, torch.bfloat16) for d in ARMS_DENSITIES]
  points.append((0.2, torch.float32))
  records = {k: [] for k in ('gather', 'v6_fwd', 'v6_dx', 'v6_fwd_bwd',
                             'control', 'v1_fwd', 'v1_dx', 'v1_dw')}
  calls = []
  for density, dtype in points:
    x = torch.randn(m, kdim, generator=gen).to(device, dtype)
    gy = torch.randn(m, n, generator=gen).to(device, dtype)
    w = (torch.randn(kdim, n, generator=gen) / kdim ** 0.5).to(device, dtype)
    occ = _density_occupancy(torch, gen, kdim // BLOCK[0], n // BLOCK[1],
                             density).to(device)
    occ1 = _density_occupancy(torch, gen, kdim // V1_BLOCK[0],
                              n // V1_BLOCK[1], density).to(device)
    wm = w * _expand(occ, BLOCK).to(dtype)
    wm1 = w * _expand(occ1, V1_BLOCK).to(dtype)
    n_act = int(occ.sum())
    packing = v6.make_packing(occ, n_act)
    fwd = _cpu_lists(v3.occupancy_lists(occ, BLOCK, n))
    fwd6 = _cpu_lists(v6.entry_lists(*packing['fwd'], BLOCK, n,
                                     n // BLOCK[1]))
    dx6 = v6.entry_lists(*packing['bwd'], BLOCK, n, kdim // BLOCK[0], 'dx')
    fwd1 = v3.occupancy_lists(occ1, V1_BLOCK, n)
    dx1 = v3.occupancy_lists(occ1, V1_BLOCK, n, 'dx')
    ent1 = v3.occupancy_dw_entries(occ1)
    tag = f'd={density} {dtype_name(dtype):8s}'
    b512 = {op: dense_bound(op, m, occ, BLOCK, dtype)
            for op in ('fwd', 'dx', 'dw')}
    b128 = {op: dense_bound(op, m, occ1, V1_BLOCK, dtype)
            for op in ('fwd', 'dx', 'dw')}
    ops = {
        'gather': (v2, 'gather_launches',
                   lambda: v2.block_sparse_matmul_gather(x, wm, occ, BLOCK,
                                                         ARMS_BM),
                   lambda: v3.dense_mm_reference(x, wm, fwd, BLOCK),
                   lambda: x @ wm, b512['fwd']),
        'v6_fwd': (v6, 'v6_fwd_launches',
                   lambda: v6.block_sparse_matmul_v6(x, wm, packing, BLOCK,
                                                     ARMS_BM),
                   lambda: v3.dense_mm_reference(x, wm, fwd6, BLOCK),
                   lambda: x @ wm, b512['fwd']),
        'v6_dx': (v6, 'v6_dx_launches',
                  lambda: v6.v6_matmul_cuda(gy, wm, dx6, BLOCK, 'dx'),
                  lambda: v3.dense_mm_reference(gy, wm, _cpu_lists(dx6),
                                                BLOCK, 'dx'),
                  lambda: gy @ wm.T, b512['dx']),
        'v1_fwd': (v1, 'v1_fwd_launches',
                   lambda: v1.block_sparse_matmul(x, wm1, occ1, V1_BLOCK),
                   lambda: v3.dense_mm_reference(x, wm1, _cpu_lists(fwd1),
                                                 V1_BLOCK),
                   lambda: x @ wm1, b128['fwd']),
        'v1_dx': (v1, 'v1_dx_launches',
                  lambda: v1.v1_matmul_cuda(gy, wm1, dx1, V1_BLOCK, 'dx'),
                  lambda: v3.dense_mm_reference(gy, wm1, _cpu_lists(dx1),
                                                V1_BLOCK, 'dx'),
                  lambda: gy @ wm1.T, b128['dx']),
        'v1_dw': (v1, 'v1_dw_launches',
                  lambda: v1.v1_dw_cuda(x, gy, wm1, ent1, V1_BLOCK),
                  lambda: v3.dense_dw_reference(x, gy, _cpu_lists(ent1),
                                                V1_BLOCK, dtype),
                  lambda: x.T @ gy, b128['dw'])}
    if density == 1.0:
      ones = _cpu_lists(v3.occupancy_lists(torch.ones_like(occ), BLOCK, n))
      ops['control'] = (v3, 'dense_control_launches',
                        lambda: v3.pallas_dense_matmul(
                            x, w, (ARMS_BM,) + BLOCK),
                        lambda: v3.dense_mm_reference(x, w, ones, BLOCK),
                        lambda: x @ w, b512['fwd'])
    for key, (mod, counter, run, plain, library, bound_) in ops.items():
      block = V1_BLOCK if key.startswith('v1') else BLOCK
      rec, _ = kernel_point(
          torch, f'{key:7s} {tag}', counter, run, plain, library, bound_,
          module=mod, plain_iters=3,
          library_name='xᵀ @ gy' if key == 'v1_dw' else 'torch.matmul',
          branch=None if key == 'v1_dw' else bsp.mm_branch(
              m, block[1] if key.endswith('dx') else block[0], dtype))
      rec.update(density=density, dtype=dtype_name(dtype), m=m, k=kdim, n=n,
                 block=list(block))
      if key in ('gather', 'v1_fwd'):
        rec.update(_entry_split(torch, f'{key:7s} {tag}', rec, x,
                                wm if key == 'gather' else wm1,
                                occ if key == 'gather' else occ1, block,
                                v2.gather_matmul_cuda if key == 'gather'
                                else v1.v1_matmul_cuda))
      if key == 'v1_dw':
        rec['split'] = dw_split(f'v1_dw   {tag}', bsp.dw_plan(
            m, int(ent1.rows.numel()), V1_BLOCK, dtype, sm_count(torch)))
      records[key].append(rec)
      calls.append(run)
    records['v6_fwd_bwd'].append(_v6_fwd_bwd_point(
        torch, tag, x, gy, wm, occ, packing, (fwd6, _cpu_lists(dx6)), b512,
        dtype))
  _v6_empty_column_check(torch, device, gen)
  _zero_counts()
  for run in calls:
    run()
  torch.cuda.synchronize()
  launches = {k: v for k, v in _counts().items() if v}
  log(f'history arms path: launches {launches}')
  check(launches == {'gather': len(points), 'v6_fwd': len(points),
                     'v6_dx': len(points), 'control': 1,
                     'v1_fwd': len(points), 'v1_dx': len(points),
                     'v1_dw': len(points)}, f'arms path launches {launches}')
  torch.cuda.empty_cache()
  return records, launches


def _entry_split(torch, label, rec, x, w, occ, block, kernel):
  """B11's and B12's forward entries build their entry lists from the
  mask on every call, as JAX reduces it per call: the device time of that
  list building alone (the entry's own steps: the occupancy as int32,
  occupancy_lists) and of the kernel alone on lists built once (its
  counting wrapper).  Returns {'ms': the kernel's, 'lists_ms',
  'entry_ms': the whole entry's (the point's ms)}."""
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  n = w.shape[1]

  def lists():
    return v3.occupancy_lists((occ.to(torch.int32) != 0).to(torch.int32),
                              block, n)

  built = lists()
  out = dict(entry_ms=rec['ms'], lists_ms=device_ms(lists, 20),
             ms=device_ms(lambda: kernel(x, w, built, block), 20))
  log(f'  {label}: kernel {out["ms"]:.4f} ms + list building '
      f'{out["lists_ms"]:.4f} ms (entry {out["entry_ms"]:.4f} ms)')
  return out


def _v6_fwd_bwd_point(torch, tag, x, gy, wm, occ, packing, lists, b512,
                      dtype):
  """B10 forward + backward through autograd (as bench_mlp_arms' v6grad):
  y, dx and dw against the plain versions, timed beside autograd through
  torch.matmul on the masked W; the bound is the sum of the three
  products' bounds."""
  from rigl_tpu_torch.ops import block_sparse_v3 as v3
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  xr, wr = x.detach().requires_grad_(), wm.detach().requires_grad_()
  fwd, dxl = lists

  def run():
    y = v6.block_sparse_matmul_v6(xr, wr, packing, BLOCK, 512)
    return (y,) + torch.autograd.grad(y, (xr, wr), gy)

  def plain():
    return (v3.dense_mm_reference(x, wm, fwd, BLOCK),
            v3.dense_mm_reference(gy, wm, dxl, BLOCK, 'dx'),
            v3.masked_dense_dw(x, gy, occ, BLOCK, wm.dtype))

  def library():
    y = xr @ wr
    return torch.autograd.grad(y, (xr, wr), gy)

  before = _counts()
  got = run()
  torch.cuda.synchronize()
  moved = {k: v - before[k] for k, v in _counts().items()
           if v != before[k]}
  check(moved == {'v6_fwd': 1, 'v6_dx': 1}, f'v6 fwd+bwd {tag}: {moved}')
  want = plain()
  errs = [float((g.float() - r.float()).abs().max()) for g, r in
          zip(got, want)]
  rels = [e / max(1.0, float(r.float().abs().max()))
          for e, r in zip(errs, want)]
  tol = TOL[dtype_name(dtype)]
  bound_ms = sum(b512[op][0] for op in ('fwd', 'dx', 'dw'))
  rec = dict(max_abs_err=max(errs), max_rel_err=max(rels), tol=tol,
             ms=device_ms(run, 20), plain_ms=device_ms(plain, 3),
             library_ms=device_ms(library, 20), bound_ms=bound_ms,
             bound_by=max(('fwd', 'dx', 'dw'), key=lambda o: b512[o][0]),
             dtype=dtype_name(dtype))
  rec['bound_by'] = b512[rec['bound_by']][1]
  log(f'v6 fwd+bwd {tag}: max rel err {max(rels):.3e} (tol {tol})  device '
      f'ms: kernel path {rec["ms"]:.4f}, plain {rec["plain_ms"]:.4f}, '
      f'torch.matmul fwd+bwd {rec["library_ms"]:.4f}, bound '
      f'{bound_ms:.4f}')
  check(max(rels) <= tol, f'v6 fwd+bwd {tag}: rel error {max(rels)}')
  return rec


def _v6_empty_column_check(torch, device, gen):
  """B10 at the arms shape with block-column 0 empty: the kernel writes
  exact zeros there into torch.empty's memory, just handed back by the
  caching allocator from a NaN-filled buffer of the output's size."""
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  occ = _density_occupancy(torch, gen, ARMS_K // BLOCK[0],
                           ARMS_N // BLOCK[1], 0.2, True).to(device)
  x = torch.randn(ARMS_M, ARMS_K, generator=gen).to(device, torch.bfloat16)
  w = (torch.randn(ARMS_K, ARMS_N, generator=gen) / ARMS_K ** 0.5).to(
      device, torch.bfloat16) * _expand(occ, BLOCK).to(torch.bfloat16)
  packing = v6.make_packing(occ, int(occ.sum()))
  torch.cuda.synchronize()
  nan = torch.full((ARMS_M, ARMS_N), float('nan'), dtype=torch.bfloat16,
                   device=device)
  ptr = nan.data_ptr()
  del nan
  y = v6.block_sparse_matmul_v6(x, w, packing, BLOCK, 512)
  torch.cuda.synchronize()
  reused = y.data_ptr() == ptr
  zero = not bool(y[:, :BLOCK[1]].any())
  log(f'v6 empty output column: exact zeros {zero} (output in the freed '
      f'NaN buffer: {reused}); other columns finite '
      f'{bool(torch.isfinite(y).all())}')
  check(zero and bool(torch.isfinite(y).all()),
        'v6: the empty output column is not exactly zero')


def _mlp_block_arm(torch, device, kind, gen, x):
  """The 3 x 4096 MLP step of scripts/bench_blocksparse_mlp.py on premasked
  bf16 weights at s = 0.8 (block (512, 512)) through `kind`: 'v6'
  (block_sparse_matmul_v6, MLP_ENGINE=v6) or 'v1' (block_sparse_matmul,
  B12); SGD(1e-4, momentum 0.9), loss mean(y.float()^2).  Returns
  (step, params, occupancies, optimizer, layer function)."""
  from rigl_tpu_torch.ops import block_sparse as v1
  from rigl_tpu_torch.ops import block_sparse_v6 as v6
  bf16 = torch.bfloat16
  occs, params, packings = [], [], []
  for _ in range(MLP_DEPTH):
    occ, n_act = _mlp_occupancy(torch, gen, SPARSITY, False)
    occ = occ.to(device)
    occs.append(occ)
    packings.append(v6.make_packing(occ, n_act))
    w = torch.randn(MLP_WIDTH, MLP_WIDTH, generator=gen) / MLP_WIDTH ** 0.5
    params.append((w.to(device) * _expand(occ, BLOCK)).to(bf16)
                  .requires_grad_())

  def layer(h, i, w):
    if kind == 'v6':
      return v6.block_sparse_matmul_v6(h, w, packings[i], BLOCK, 512)
    return v1.block_sparse_matmul(h, w, occs[i], BLOCK, 512)

  opt = torch.optim.SGD(params, lr=1e-4, momentum=0.9)

  def step():
    opt.zero_grad(set_to_none=True)
    h = x
    for i, w in enumerate(params):
      h = torch.relu(layer(h, i, w))
    (h.float() ** 2).mean().backward()
    opt.step()
  return step, params, occs, opt, layer


def phase_block_mlp(torch, device):
  """Phase 20, the main path of B10 and B12: the MLP_ENGINE=v6 train step
  of scripts/bench_blocksparse_mlp.py at full width (3 x 4096, batch 1024,
  block (512, 512), s = 0.8, bf16 premasked weights), and the same step
  through block_sparse_matmul (B12) at that block.  For each: one step's
  loss and gradients against the plain path (torch.matmul on the masked
  W, the gradient masked) before any update, with its launches (v6: 3
  forward, 2 dx, no gathered dw; B12: 3, 2 and 3 dw); then 10 SGD steps
  with the counts set to 0 before and read after, momentum and weights
  exactly zero at inactive blocks after them.  Then us/step of the v6
  arm, the B12 arm, the packed arm (B1/B2, phase 8's) and the dense twin
  in mirrored pairs, with each arm's device busy share and kernel time
  per step by kernel.  Returns (launches by arm, record)."""
  import numpy as np
  gen = torch.Generator().manual_seed(SEED + 20)
  bf16 = torch.bfloat16
  x = torch.randn(MLP_BATCH, MLP_WIDTH, generator=gen).to(device, bf16)
  rec, launches, arms = {}, {}, {}
  expect = {'v6': {'v6_fwd': MLP_DEPTH, 'v6_dx': MLP_DEPTH - 1},
            'v1': {'v1_fwd': MLP_DEPTH, 'v1_dx': MLP_DEPTH - 1,
                   'v1_dw': MLP_DEPTH}}
  for kind in ('v6', 'v1'):
    step, params, occs, opt, layer = _mlp_block_arm(torch, device, kind,
                                                    gen, x)
    masks = [_expand(o, BLOCK).to(bf16) for o in occs]
    before = _counts()
    h = x
    for i, w in enumerate(params):
      h = torch.relu(layer(h, i, w))
    loss = (h.float() ** 2).mean()
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _counts().items()
             if v != before[k]}
    views = [p.detach().clone().requires_grad_() for p in params]
    h = x
    for w, mk in zip(views, masks):
      h = torch.relu(h @ (w * mk))
    plain_loss = (h.float() ** 2).mean()
    plain = torch.autograd.grad(plain_loss, views)
    loss_err = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
    grad_errs = [_rel(g, p * mk) for g, p, mk in zip(grads, plain, masks)]
    zero_dw = all(not bool(g[mk == 0].any()) for g, mk in zip(grads, masks))
    log(f'{kind} MLP step: launches {moved} (expected {expect[kind]}); loss '
        f'{float(loss):.6e} vs plain {float(plain_loss):.6e} (rel '
        f'{loss_err:.3e}); grad rel errs {[f"{e:.3e}" for e in grad_errs]} '
        f'(tol {STEP_RTOL}); dw zero at inactive blocks {zero_dw}')
    check(moved == expect[kind], f'{kind} MLP step launches {moved}')
    check(loss_err <= STEP_RTOL, f'{kind} MLP step loss error {loss_err}')
    check(max(grad_errs) <= STEP_RTOL, f'{kind} MLP step grads {grad_errs}')
    check(zero_dw, f'{kind} MLP step: dw not zero at inactive blocks')
    del grads, plain, views
    _zero_counts()
    for _ in range(V6_STEPS):
      step()
    torch.cuda.synchronize()
    launches[kind] = {k: v for k, v in _counts().items() if v}
    want = {k: v * V6_STEPS for k, v in expect[kind].items()}
    bufs = [opt.state[p]['momentum_buffer'] for p in params]
    invariant = all(not bool(b[mk == 0].any()) and not bool(p[mk == 0].any())
                    for b, p, mk in zip(bufs, params, masks))
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    log(f'{kind} MLP: {V6_STEPS} steps, launches {launches[kind]} (expected '
        f'{want}); momentum and weights exactly zero at inactive blocks '
        f'{invariant}; finite {finite}')
    check(launches[kind] == want, f'{kind} MLP launches {launches[kind]}')
    check(invariant and finite, f'{kind} MLP: premask invariant broken')
    rec[kind] = dict(step_vs_plain=dict(loss_rel_err=loss_err,
                                        max_grad_rel_err=max(grad_errs)),
                     launches_per_step=moved)
    arms[f'{kind}_s{SPARSITY}'] = step
  arms.update(_mlp_packed_and_dense_arms(torch, device, gen, x))
  for step in arms.values():
    for _ in range(3):
      step()
  torch.cuda.synchronize()
  order = list(arms) + list(arms)[::-1]
  us = {name: [] for name in arms}
  for name in order:
    us[name].append(time_ms(arms[name], TIMED_STEPS) * 1e3)
  for name, step in arms.items():
    mean_us = float(np.mean(us[name]))
    dev_us = device_ms(step, 10) * 1e3
    prof = profiled_kernel_time(torch, step, 3)
    rec.setdefault(name, {}).update(
        us_per_step=us[name], device_us_per_step=dev_us,
        device_busy_share=dev_us / mean_us, **prof)
    log(f'block MLP speed: {name:10s} us/step '
        f'{[round(u, 1) for u in us[name]]} (mean {mean_us:.1f}); device '
        f'window {dev_us:.1f} us/step (busy share {dev_us / mean_us:.3f}); '
        f'kernels {prof["kernel_us_per_step"]} us/step')
  dense_us = float(np.mean(us['dense']))
  for name in arms:
    if name != 'dense':
      rec[name]['dense_over_arm'] = dense_us / float(np.mean(us[name]))
      log(f'  dense/{name}: {rec[name]["dense_over_arm"]:.3f}')
  del arms
  torch.cuda.empty_cache()
  return launches, rec


def _mlp_packed_and_dense_arms(torch, device, gen, x):
  """Phase 8's packed arm (B1/B2 on packed storage, s = 0.8) and the dense
  twin, for the mirrored timing beside the dense-storage arms."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  bf16 = torch.bfloat16
  W = MLP_WIDTH
  arms = {}
  for name in ('packed', 'dense'):
    if name == 'dense':
      params = [(torch.randn(W, W, generator=gen) / W ** 0.5).to(device, bf16)
                for _ in range(MLP_DEPTH)]
      layer = lambda h, i, params=params: h @ params[i]
    else:
      packings, params = [], []
      for _ in range(MLP_DEPTH):
        occ, n_act = _mlp_occupancy(torch, gen, SPARSITY, False)
        packings.append(bsp.make_packing(occ, n_act))
        params.append((torch.randn(n_act, *BLOCK, generator=gen)
                       / W ** 0.5).to(device, bf16))
      layer = lambda h, i, params=params, packings=packings: (
          bsp.packed_matmul(h, params[i], packings[i], BLOCK))
    for p in params:
      p.requires_grad_()
    opt = torch.optim.SGD(params, lr=1e-4, momentum=0.9)

    def step(layer=layer, opt=opt):
      opt.zero_grad(set_to_none=True)
      h = x
      for i in range(MLP_DEPTH):
        h = torch.relu(layer(h, i))
      (h.float() ** 2).mean().backward()
      opt.step()
    arms[name if name == 'dense' else f'packed_s{SPARSITY}'] = step
  return arms


def phase_f32_train_step(torch, device):
  """Phase 21, the main path of the f32 flash kernels: the transformer
  train step of phase 10 (2 layers of d_model 2048 / d_ff 8192 / 16
  heads, seq 512, batch 4, block (512, 512), s = 0.8, SGD(1e-4, momentum
  0.9)) in float32, fused (flash_attention) and unfused from the same
  seed: output, loss and every gradient of one step within F32_STEP_RTOL
  of each tensor's largest value; then one fused SGD step with the counts
  set to 0 before and read after (2 launches of each f32 flash kernel);
  then us/step of both in mirrored pairs.  Returns (launches, record)."""
  import numpy as np
  from rigl_tpu_torch.models.packed_transformer import PackedTransformer
  f32 = torch.float32
  gen = torch.Generator().manual_seed(SEED + 21)
  x = (torch.randn(TR_BATCH, TR_SEQ, D_MODEL, generator=gen) * 0.02).to(
      device, f32)
  r = torch.randn(x.shape, generator=gen).to(device)
  models = {fused: PackedTransformer(
      num_layers=TR_LAYERS, d_model=D_MODEL, d_ff=D_FF, num_heads=HEADS,
      vocab_size=0, dtype=f32, sparsity=SPARSITY, block=BLOCK, bm=512,
      fused_attention=fused, device=device,
      generator=torch.Generator().manual_seed(SEED + 22))
      for fused in (False, True)}
  outs = {}
  for fused, model in models.items():
    params = list(model.parameters())
    out = model(x)
    loss = (out * r).mean()
    outs[fused] = (out.detach(), loss.detach(),
                   torch.autograd.grad(loss, params))
  (o0, l0, g0), (o1, l1, g1) = outs[False], outs[True]
  out_err = _rel(o1, o0)
  loss_err = abs(float(l1) - float(l0)) / float((o0 * r).abs().mean())
  grad_err = max(_rel(a, b) for a, b in zip(g1, g0))
  log(f'f32 train step, fused vs unfused: output rel err {out_err:.3e}, '
      f'loss {float(l1):.6e} vs {float(l0):.6e} (err over mean |term| '
      f'{loss_err:.3e}), max grad rel err {grad_err:.3e} (tol '
      f'{F32_STEP_RTOL})')
  check(max(out_err, loss_err, grad_err) <= F32_STEP_RTOL,
        f'f32 fused step vs unfused: {out_err} {loss_err} {grad_err}')
  del outs, g0, g1

  def make_step(model):
    opt = torch.optim.SGD(model.parameters(), lr=1e-4, momentum=0.9)

    def step():
      opt.zero_grad(set_to_none=True)
      (model(x).float() ** 2).mean().backward()
      opt.step()
    return step
  steps = {('fused' if f else 'unfused'): make_step(m)
           for f, m in models.items()}
  _zero_counts()
  steps['fused']()
  torch.cuda.synchronize()
  launches = {k: v for k, v in _counts().items()
              if k.startswith('flash') or k in ('fwd', 'dx', 'dw')}
  log(f'f32 fused step: launches {launches} (expected {TR_LAYERS} of each '
      f'f32 flash kernel, none of the bf16 ones; {4 * TR_LAYERS} forward, '
      'dx and dw)')
  check(launches == dict(flash_fwd=0, flash_dkv=0, flash_dq=0,
                         flash_fwd_f32=TR_LAYERS, flash_dkv_f32=TR_LAYERS,
                         flash_dq_f32=TR_LAYERS, fwd=4 * TR_LAYERS,
                         dx=4 * TR_LAYERS, dw=4 * TR_LAYERS),
        f'f32 fused step launches {launches}')
  for step in steps.values():
    for _ in range(2):
      step()
  torch.cuda.synchronize()
  order = list(steps) + list(steps)[::-1]
  us = {name: [] for name in steps}
  for name in order:
    us[name].append(time_ms(steps[name], 5) * 1e3)
  rec = dict(step_vs_unfused=dict(out_rel_err=out_err, loss_err=loss_err,
                                  max_grad_rel_err=grad_err),
             launches_per_fused_step=launches)
  for name in steps:
    rec[f'{name}_us_per_step'] = us[name]
    log(f'f32 train step {name:7s}: us/step {[round(u, 1) for u in us[name]]}'
        f' (mean {float(np.mean(us[name])):.1f})')
  rec['unfused_over_fused'] = (float(np.mean(us['unfused']))
                               / float(np.mean(us['fused'])))
  log(f'  unfused/fused: {rec["unfused_over_fused"]:.3f}')
  # The fused step's device time by kernel, the flash kernels' and the f32
  # dw's summed, with their shares.
  log('f32 fused step, torch.profiler over 3 steps:')
  prof = profiled_kernel_time(torch, steps['fused'], 3,
                              match=('flash_', 'packed_dw_3xtf32_kernel'))
  rec['fused_kernels'] = prof
  total, parts = prof['kernel_us_per_step'], prof['matched_us_per_step']
  for name, label in (('flash_', 'the f32 flash kernels'),
                      ('packed_dw_3xtf32_kernel', 'the f32 dw')):
    part = parts and parts[name]
    log(f'  kernel time {total} us/step, of it {label} {part} (share '
        f'{_share(part, total)})')
  del models, steps
  torch.cuda.empty_cache()
  return launches, rec


def _tap_entry(name, source, replaces, by_path, points):
  """One tap kernel's JSON record: ms, plain_ms, bound_ms and library_ms
  are sums over the WRN main path's points (the four WRN-22-2 shapes at
  batch 128 in f32); bound_by is the kind that holds the larger share of
  that summed bound; launches are the main paths' (`by_path`); every
  point is listed."""
  main = [p for p in points if p['layer'].startswith('wrn')
          and p['n'] == WRN_BATCH and p['k'] == 3 and p['dtype'] == 'float32'
          and not p['empty_column']]
  by = {}
  for p in main:
    by[p['bound_by']] = by.get(p['bound_by'], 0.0) + p['bound_ms']
  return {'name': name, 'route': 'cuda', 'source': source,
          'replaces': replaces, 'launches': sum(by_path.values()),
          'launches_by_path': by_path,
          'max_abs_err': max(p['max_abs_err'] for p in points),
          'ms': sum(p['ms'] for p in main),
          'plain_ms': sum(p['plain_ms'] for p in main),
          'bound_ms': sum(p['bound_ms'] for p in main),
          'bound_by': max(by, key=by.get),
          'library_ms': sum(p['library_ms'] for p in main),
          'points': points}


def _kernel_entry(name, source, replaces, launches, by_path, points,
                  dtype='bfloat16'):
  """One kernel's JSON record: sums over its points of `dtype`; bound_by
  is the kind of bound that holds the larger share of the summed bound."""
  bf16 = [p for p in points if p['dtype'] == dtype]
  by = {}
  for p in bf16:
    by[p['bound_by']] = by.get(p['bound_by'], 0.0) + p['bound_ms']
  return {'name': name, 'route': 'cuda', 'source': source,
          'replaces': replaces, 'launches': launches,
          'launches_by_path': by_path,
          'max_abs_err': max(p['max_abs_err'] for p in points),
          'ms': sum(p['ms'] for p in bf16),
          'plain_ms': sum(p['plain_ms'] for p in bf16),
          'bound_ms': sum(p['bound_ms'] for p in bf16),
          'bound_by': max(by, key=by.get),
          'library_ms': sum(p['library_ms'] for p in bf16),
          'points': points}


# The forward / dx kernels' design, named in their JSON entries; each
# point names its branch.
MM_DESIGN = ('branches by mm_branch (ops/block_sparse_packed.py): wgmma '
             '(bf16, m > 32): packed_mm_wgmma_kernel<kTransW, TN, KC>, '
             'tiles of 128 rows x TN (16 / 32 / 64 / 128) columns, KC (16 / '
             '32 / 64) deep a stage, by mm_tile (128 x 128 x 64 at blocks of '
             '128 and 512, two thread blocks an SM); wgmma m64nTNk16 by two '
             'consumer warpgroups on a 3-4-deep ring of (128 x KC x, W '
             'block) boxes that one producer warp fills by TMA, x through a '
             '3-D map by segment and W through a 4-D map, so that boxes stop '
             'at the segment and the block (a ragged last stage reads '
             'zeros), epilogue staged in shared memory; ffma (f32, m > 32): '
             'packed_mm_ffma_kernel, 64 x 128 tiles, 8 x 8 register '
             'micro-tiles on FMA; decode (m <= 32): packed_mm_decode_kernel '
             '(its own entry)')
DECODE_DESIGN = ('packed_mm_decode_kernel: tiles of an m-tile of 8 / 16 / 32 '
                 'rows x 64 columns of one output block-column; the tile\'s '
                 'contraction (its column\'s actives in list order, in '
                 '128-byte chunks, k ascending) cut into S contiguous ranges, '
                 'one block each, the S blocks a thread-block cluster (S in '
                 '1, 2, 4, 8 by ops/mm_split.py decode_plan: one to two '
                 'waves); one producer thread streams W boxes (4-D map over '
                 'W) and x boxes (3-D map over x by segment) through a 4-deep '
                 'TMA ring; bf16 yT = WT xT by wgmma m64nNk16, f32 one fmaf '
                 'chain an output; f32 partials added in rank order through '
                 'distributed shared memory, one cast, one launch, no '
                 'workspace')
# The dw kernels' designs, named in their JSON entries.
DW_DESIGN = ('bf16: packed_dw_wgmma_kernel, 128 x 128 tiles, wgmma '
             'm64n128k16 by two consumer warpgroups on a 4-deep ring of '
             '64-row x and gy tiles that one producer warp fills by TMA; '
             'f32: packed_dw_3xtf32_kernel (its own entry); the m-sum '
             'split into slices where the tiles leave SMs idle')
DW_F32_DESIGN = ('packed_dw_3xtf32_kernel: f32-accurate products in 3xTF32 '
                 '(a_hi b_hi + a_hi b_lo + a_lo b_hi on tf32 wgmma); tiles '
                 'of 128 x 128, and of 64 x 16 for blocks at most 16 '
                 'columns wide (dw_tile); a 3-4-deep ring of 32-row m-chunks of '
                 'x and gy (32 x 32 boxes) that a producer warp fills by '
                 'TMA; three warps of their own transpose each gy '
                 'chunk into K-major hi / lo B tiles; two consumer '
                 'warpgroups (one at 64 rows) take xT as the register A '
                 'operand, loaded column-wise from the box in k-step order '
                 '0, 2, 4, 6, 1, 3, 5, 7 and split in registers, and run '
                 'wgmma m64nNk8 tf32 three passes a k-step into an '
                 'accumulator started afresh every 4 stages and added to '
                 'the tile\'s f32 sum; one block an SM at 128 x 128, three at '
                 '64 x 16; the m-sum split '
                 'into slices where the tiles leave SMs idle')
DW_REDUCTION = ('packed_dw_reduce_kernel: adds the slices\' f32 partials '
                'in slice order, one cast (only where S > 1)')
# The tap conv's forward / dx: the kernel of each branch of tap_branch
# (ops/block_sparse_conv.py) and the design of the new one.
TAP_BRANCH_KERNELS = {
    'mm': ('1x1: csrc/packed_mm.cu forward / dx kernels over the index\'s '
           'lists, the branch mm_branch names (bf16 m > 32: '
           'packed_mm_wgmma_kernel)'),
    'wgmma': 'bf16 KxK, blocks of 16s: tap_conv_wgmma_kernel',
    'tf32': ('KxK in f32, and in bf16 at blocks of 8s: tap_w_split_kernel '
             '(the blocks\' K-major f32 copy: hi / lo in f32), then '
             'tap_conv_tf32_kernel (3xTF32 in f32, one exact tf32 product '
             'a k-step in bf16)')}
TAP_DESIGN = ('tap_conv_wgmma_kernel: implicit GEMM on wgmma; one block of '
              'two warpgroups per (128 pixels, output tile of up to 128 '
              'channels), heaviest first; a tile covers one block-column, '
              'or a group of them where blocks are 64 wide or less and the '
              'union of their entries cuts the x copies by a quarter with a '
              'block still for every SM (tap_wgmma_gcols), each x tile '
              'multiplied 16 columns a wgmma into the columns that hold its '
              'entry only; the tile width named by the caller '
              '(tap_wgmma_tile); entries as '
              '16-channel k-steps, 4 a ring stage (several entries a stage '
              'at blocks of 16 / 32); every thread copies its part of the '
              '128 x 64 shifted x tile (a warp on whole 128-byte rows) and '
              'the 64 x N W piece by zero-filling cp.async into the swizzled '
              'layouts wgmma reads (W MN-major forward, K-major dx, read in '
              'place); a stage completes on its mbarrier; 3 stages (4 at N = '
              '64), 2-4 blocks an SM; epilogue staged in shared memory, '
              '16-byte stores')
TAP_TF32_DESIGN = ('tap_conv_tf32_kernel<T, N, kGroups>: implicit GEMM on '
                   'tf32 wgmma, in f32 3xTF32 (a_hi b_hi + a_hi b_lo + a_lo '
                   'b_hi, the first two one product twice as wide), in '
                   'bf16 one product a k-step (a bf16 value widened to f32 '
                   'is exact in tf32); one block of two '
                   'warpgroups and a copying warp per (128 pixels, output '
                   'tile of one block-column, or a group of two 16-wide '
                   'ones, in bf16 also of two 8-wide ones: tap_tf32_tile), '
                   'heaviest first; each group\'s '
                   'entries in (input block, tap) order, in panels of one '
                   'input block and 16 channels; a panel\'s x tile (128 '
                   'pixel rows plus the span of its shifts, split by tap '
                   'row past 512 rows) copied once by TMA and read by every '
                   'tap of the panel at its row offset, one fragment load a '
                   'row and entry (16 bytes f32, 8 bf16), pixels outside '
                   'the image predicated to zero; a bf16 chunk of 8 '
                   'channels in one k-step (tf_half_channel); W as a '
                   'K-major f32 copy (tap_w_split_kernel, in x\'s channel '
                   'order), a TMA box a column and entry, 2 entries a stage '
                   'of a 4-deep ring; the copying warp reads a host-built '
                   'stage table, a row a stage; a group\'s products '
                   'predicated on the columns that hold each entry; in f32 '
                   'the sum flushed into y every 32 stages, in bf16 cast '
                   'once')
TAP_DW_DESIGN = ('entries grouped by (input block, output block), up to 9 '
                 'taps in bf16 and 4 in f32 (2, at 4 thread blocks an SM, '
                 'where the pairs hold 2.5 taps or fewer on average), from '
                 'one gy tile and one shift-widened x tile per chunk, '
                 'out-of-image pixels masked per tap; bf16 mma.sync '
                 'm16n8k16 fed by ldmatrix, f32 FMA; the pixel sum split '
                 'into slices where the groups leave SMs idle; a 1x1 '
                 "kernel's dw on the packed dw kernels")
TAP_DW_REDUCTION = ('tap_dw_reduce_kernel: adds the slices\' f32 partials '
                    'in slice order, one cast (only where S > 1)')
# The bf16 flash kernels' designs, named in their JSON entries.
FLASH_DESIGN = {
    'fwd': ('wgmma on a TMA ring: a block of two warpgroups per (128-row q '
            'tile, b*h), heaviest tiles first; S = Q Kt by wgmma m64n128 '
            'from shared memory, the online softmax on the accumulator '
            'fragments (quad shuffles), P rounded to bf16 in registers as '
            'the A operand of O += P V (wgmma RS, V MN-major); (K, V) tiles '
            'of 128 rows through a 2-3-deep ring that warp 0 fills; epilogue '
            'staged in shared memory'),
    'dkv': ('wgmma on a TMA ring: a block of two warpgroups per (128-row k '
            'tile, b*h), K and V resident, heaviest tiles first; per 64-row '
            '(Q, dO) tile from the diagonal, St = K Qt and dPt = V dOt by '
            'wgmma m64n64, Pt and dSt on the fragments, rounded to bf16 as '
            'the A operands of dV += Pt dO and dK += dSt Q (wgmma RS); a '
            '3-deep ring that warp 0 fills, lse and D by cp.async'),
    'dq': ('wgmma on a TMA ring: a block of two warpgroups per (128-row q '
           'tile, b*h), Q and dO resident, heaviest tiles first, lse and D '
           'in registers; per 64-row (K, V) tile up to the diagonal, S = Q '
           'Kt and dP = dO Vt by wgmma m64n64, P and dS on the fragments, dS '
           'rounded to bf16 as the A operand of dQ += dS K (wgmma RS, K '
           'MN-major); a 4-deep ring that warp 0 fills; epilogue staged in '
           'shared memory'),
}
# The f32 forward's design, named in its JSON entry.
FLASH_F32_FWD_DESIGN = (
    'register-tiled FFMA: a block of 128 threads per (64-row q tile, b*h), '
    'two blocks an SM, heaviest tiles first; 8 x 4 logits and 8 rows x '
    'hd/16 outputs a thread, operands as float4s from unpadded, '
    'XOR-swizzled shared tiles (Q, K, V row-major; P transposed); the '
    'online softmax in registers (expf); V and the next K by cp.async '
    'behind the products, two barriers a tile')

# The f32 backward kernels' designs, named in their JSON entries.
FLASH_F32_BWD_DESIGN = {
    'dkv': ('3xTF32 wgmma on a TMA ring: a block of two warpgroups per (32-'
            'row k tile at hd 128, 64 below, b*h), K and V resident and '
            'split into tf32 hi and lo, heaviest tiles first; per 64-row (Q, '
            'dO) tile from the diagonal, S = Q Kt (warpgroup 0) and dP = dO '
            'Vt (warpgroup 1) by wgmma m64nNk8 tf32 in three passes, Q and dO '
            'fragments loaded from the swizzled tile and split in registers; '
            'P and dS on the fragments, written transposed and split as the '
            'B operands of dVt += dOt P (warpgroup 0) and dKt += Qt dS '
            '(warpgroup 1); a 2-4-deep ring that warp 0 fills'),
    'dq': ('3xTF32 wgmma on a TMA ring: a block of two warpgroups per (32-'
           'row q tile at hd 128, 64 below, b*h), Q and dO resident and split '
           'into tf32 hi and lo, heaviest tiles first, lse and D in '
           'registers; per 64-row (K, V) tile up to the diagonal, St = K Qt '
           '(warpgroup 0) and dPt = V dOt (warpgroup 1) in three passes, K '
           'and V fragments split in registers; Pt through shared memory to '
           'warpgroup 1, dS written split as the B operand of dQt += Kt dSt, '
           'each warpgroup half of its columns; a 2-4-deep ring that warp 0 '
           'fills'),
}

# ------------------------------------------------------- the zoo (22) -----
def _zoo_setup(torch, name, kw, device, dtype):
  """(model, SparseTraining, depthwise paths) of phase 22: the registry
  model with seeded weights, RigL at ERK ZOO_SPARSITY over the per_neuron
  generator's masks, depthwise kernels excluded by the mask rule."""
  import functools
  from rigl_tpu_torch.models import registry
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
  from rigl_tpu_torch.transforms import algorithms
  from rigl_tpu_torch.transforms.sparse_training import SparseTraining
  model = registry.create_model(
      name, dtype=dtype, generator=torch.Generator().manual_seed(SEED + 22),
      device=device, **kw).to(dtype)
  dense = set(getattr(model, 'dense_layer_paths', list)())

  def rule(path, leaf):
    return path not in dense and masks_lib.default_mask_rule(path, leaf)
  freq = next(z[5] for z in ZOO if z[0] == name)
  st = SparseTraining(
      functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                        nesterov=True),
      algorithms.RigL(schedule=UpdateSchedule(
          begin_step=0, end_step=25000, frequency=freq, drop_fraction=0.3,
          drop_fraction_anneal='cosine')),
      distribution='erdos_renyi_kernel', default_sparsity=ZOO_SPARSITY,
      mask_rule=rule, mask_generator='per_neuron')
  return model, st, dense


def _zoo_f64_step(torch, name, kw, device, masks, batch):
  """(loss, {path: dense gradient on the CPU}) of the first step's loss in
  float64 on `device`, from the seeded initial weights, `masks` and
  `batch`, BatchNorm statistics frozen."""
  from rigl_tpu_torch.models.common import frozen_batch_stats
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.train import steps
  model, _, _ = _zoo_setup(torch, name, kw, device, torch.float64)
  params = masks_lib.param_dict(model)
  eff = {p: ((t.detach() * masks[p].to(device, torch.float64))
             .requires_grad_() if p in masks else t)
         for p, t in params.items()}
  loss_fn = steps.make_loss_fn(model, 1e-4, 0.1)
  b = {'image': batch['image'].to(device, torch.float64),
       'label': batch['label'].to(device)}
  with frozen_batch_stats(model):
    loss, _ = loss_fn(eff, b)
  grads = torch.autograd.grad(loss, list(eff.values()))
  return float(loss.detach()), {p: g.detach().cpu()
                                for p, g in zip(eff, grads)}


def _zoo_model_run(torch, device, card, name, kw, batch_size, dataset,
                   n_steps, freq):
  """Phase 22 for one model (module docstring); returns its record."""
  import numpy as np
  from rigl_tpu_torch.data import datasets, pipeline
  from rigl_tpu_torch.train import steps
  t_start = time.perf_counter()
  model, st, dense = _zoo_setup(torch, name, kw, device, torch.float32)
  state = steps.init_train_state(SEED, model, st)
  masks = state.sparse.masks
  check(not dense & set(masks), f'zoo {name}: a depthwise kernel is masked')
  init_counts = {p: int(m.sum()) for p, m in masks.items()}
  fan_ins = {p: sorted(set(m.reshape(-1, m.shape[-1]).sum(0).tolist()))
             for p, m in masks.items()}
  uneven = [p for p, f in fan_ins.items() if len(f) != 1]
  check(not uneven, f'zoo {name}: per_neuron fan-ins differ at {uneven}')
  n_updates = len(range(0, n_steps, freq))
  hints = st.predict_update_iters(n_steps + n_updates)
  train, _, info = datasets.create_dataset(
      dataset, batch_size, n_synthetic=batch_size * (len(hints) + 2),
      seed=SEED)
  check(info['source'] == 'synthetic', f'zoo {name}: data {info}')
  it = pipeline.prefetch_to_device(train.repeat(), 2, device)
  first = next(it)
  check(first['image'].device == device,
        f'zoo {name}: prefetch gave {first["image"].device}')
  # The first step in float64 on the card and on the CPU, from the same
  # weights, masks and batch (ZOO_F64_RTOL).
  cpu_batch = {k: v.cpu() for k, v in first.items()}
  loss_g, grads_g = _zoo_f64_step(torch, name, kw, device, masks, cpu_batch)
  loss_c, grads_c = _zoo_f64_step(torch, name, kw, 'cpu', masks, cpu_batch)
  loss_err = abs(loss_g - loss_c) / abs(loss_c)
  grad_errs = {p: float((g - grads_c[p]).abs().max()
                        / grads_c[p].abs().max().clamp(min=1e-30))
               for p, g in grads_g.items()}
  worst = max(grad_errs, key=grad_errs.get)
  hot = steps.make_train_step(model, st, weight_decay=1e-4,
                              label_smoothing=0.1, update_hint=False)
  upd = steps.make_train_step(model, st, weight_decay=1e-4,
                              label_smoothing=0.1, update_hint=True)
  events, progress, counts_after, batch = [], [], [], first
  torch.cuda.synchronize()
  for i, hint in enumerate(hints):
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    state, m = (upd if hint else hot)(state, batch)
    ev[1].record()
    events.append(ev)
    progress.append(dict(step=int(m['step']),
                         updated=bool(m['mask_updated']),
                         hint_ok=bool(m.get('update_hint_ok', True)),
                         loss=float(m['loss'])))
    if progress[-1]['updated']:
      counts = {p: int(mk.sum()) for p, mk in state.sparse.masks.items()}
      counts_after.append(counts)
      moved = [p for p in counts if counts[p] != init_counts[p]]
      check(not moved, f'zoo {name}: active counts moved at {moved[:3]}')
    if i + 1 < len(hints):
      batch = next(it)
  torch.cuda.synchronize()
  step_ms = [a.elapsed_time(b) for (a, b), p in zip(events, progress)
             if not p['updated']]
  losses = [p['loss'] for p in progress]
  upd_steps = [p['step'] for p in progress if p['updated']]
  # The device-busy share: two more hot steps on the last batch under the
  # profiler, against two timed on the host clock.
  prof = profiled_kernel_time(torch, lambda: hot(state, batch), 2)
  t0 = time.perf_counter()
  for _ in range(2):
    hot(state, batch)
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / 2
  busy = (None if prof['kernel_us_per_step'] is None
          else prof['kernel_us_per_step'] / 1e3 / wall_ms)
  zeroed = [p for p in dense if not bool((state.params[p] != 0).all())]
  log(f'zoo {name} ({card}): {n_steps} steps in {len(progress)} '
      f'iterations, updates at steps {upd_steps}; step '
      f'{float(np.median(step_ms)):.2f} ms (median, CUDA events), busy '
      f'{busy if busy is None else round(busy, 3)}; losses '
      f'{[round(x, 4) for x in losses]}; {len(masks)} masked layers at '
      f'their init counts after each update, fan-ins equal at init; '
      f'{len(dense)} depthwise kernels unmasked, {len(zeroed)} zeroed')
  by_layer = [(p, init_counts[p], int(fan_ins[p][0])) for p in init_counts]
  log(f'  (layer, active count, fan-in) at init: {by_layer}; active counts '
      f'after each update: {[list(c.values()) for c in counts_after]}')
  log(f'  first step, float64 card vs CPU: loss {loss_g:.9f} vs '
      f'{loss_c:.9f} (rel {loss_err:.2e}); max rel grad err '
      f'{grad_errs[worst]:.2e} at {worst} (tol {ZOO_F64_RTOL})')
  check(loss_err <= ZOO_F64_RTOL, f'zoo {name}: f64 loss rel {loss_err}')
  check(grad_errs[worst] <= ZOO_F64_RTOL,
        f'zoo {name}: f64 grad {worst} rel {grad_errs[worst]}')
  check(all(p['hint_ok'] for p in progress), f'zoo {name}: a hint missed')
  check(progress[-1]['step'] == n_steps,
        f'zoo {name}: ended at step {progress[-1]["step"]}')
  check(upd_steps == list(range(0, n_steps, freq)),
        f'zoo {name}: updates at {upd_steps}')
  check(all(np.isfinite(losses)), f'zoo {name}: non-finite loss {losses}')
  check(not zeroed, f'zoo {name}: depthwise weights zeroed at {zeroed[:3]}')
  rec = dict(card=card, batch=batch_size, image=list(info['shape']),
             steps=n_steps, iterations=len(progress),
             update_steps=upd_steps, losses=losses,
             step_ms=float(np.median(step_ms)), step_ms_all=step_ms,
             busy=busy, profiled_step_wall_ms=wall_ms,
             kernel_us_per_step=prof['kernel_us_per_step'],
             masked_layers=len(masks), active=sum(init_counts.values()),
             active_by_layer=init_counts, counts_after_updates=counts_after,
             fan_in_by_layer={p: int(f[0]) for p, f in fan_ins.items()},
             depthwise_unmasked=len(dense),
             first_step_f64=dict(loss_card=loss_g, loss_cpu=loss_c,
                                 loss_rel_err=loss_err,
                                 max_grad_rel_err=grad_errs[worst],
                                 worst=worst, tol=ZOO_F64_RTOL),
             phase_s=time.perf_counter() - t_start)
  del model, st, state, hot, upd, it
  torch.cuda.empty_cache()
  return rec


def phase_zoo(torch, device, card):
  """Phase 22: the dense-masked zoo (module docstring, constants ZOO_*).
  Returns its record; every figure stands beside the card's name and
  power limit."""
  return {name: _zoo_model_run(torch, device, card, name, kw, batch, data,
                               n, freq)
          for name, kw, batch, data, n, freq in ZOO}



# ---------------------------------------------------------- the trainer (23) --
def _trainer_snapshot(state):
  """Copies of a TrainState's params, masks and momentum buffers."""
  from rigl_tpu_torch.train.checkpoint import optimizer_slots
  slots = optimizer_slots(state.optimizer, list(state.params))
  return dict(
      params={p: t.detach().clone() for p, t in state.params.items()},
      masks={p: m.clone() for p, m in state.sparse.masks.items()},
      momentum={p: s['momentum_buffer'].clone() for p, s in slots.items()
                if 'momentum_buffer' in s})


def _trainer_instrument(torch, trainer, rec):
  """Wraps the trainer's train steps (its _make_step, which train() calls
  for the plain and the update step): each iteration's CUDA events, launch
  counts by counter, hint, loss and step go into rec['iters']; after an
  update, every block layer's active count is checked against its static
  count; with rec['capture_first'] the state the first iteration starts
  from is copied into rec['first_state']."""
  make = trainer._make_step

  def wrapped_make(update_hint=None):
    step = make(update_hint)

    def run(state, batch):
      if rec.get('capture_first') and 'first_state' not in rec:
        rec['first_state'] = _trainer_snapshot(state)
      before = _counts()
      ev = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
      ev[0].record()
      new, m = step(state, batch)
      ev[1].record()
      after = _counts()
      rec['iters'].append(dict(
          hint=update_hint, events=ev, loss=m['loss'], step=int(m['step']),
          updated=bool(m['mask_updated']),
          hint_ok=bool(m.get('update_hint_ok', True)),
          launches={k: after[k] - before[k] for k in after}))
      if m['mask_updated']:
        _rn50_counts_ok(trainer.sparse_training, new)
      rec['last'] = (step, batch)
      return new, m
    return run

  trainer._make_step = wrapped_make


def _trainer_rn50(torch, device, card, root, tmp):
  """Phase 23's ResNet-50 run (module docstring, constants TRAINER_*):
  returns (launches of the main path's run, record)."""
  import numpy as np
  from rigl_tpu_torch.drivers import common
  from rigl_tpu_torch.drivers import train as train_driver
  from rigl_tpu_torch.ops import block_mask as bm_lib
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.train import trainer as trainer_lib
  from rigl_tpu_torch.train.checkpoint import CheckpointManager
  from rigl_tpu_torch.train.eval_loop import evaluate_checkpoints
  from rigl_tpu_torch.train.export import export_model, load_for_inference
  from torch.func import functional_call
  out = str(Path(tmp) / 'rn50')
  argv = [f'--config={root / TRAINER_CONFIG}', f'--output_dir={out}',
          '--device=cuda'] + [f'--override={o}' for o in TRAINER_OVERRIDES]
  t_start = time.perf_counter()
  t1, out_dir = train_driver.build_trainer(argv)
  cfg, st = t1.config, t1.sparse_training
  check(out_dir == out and cfg.checkpoint_dir == out,
        f'trainer: output dir {out_dir}, checkpoints {cfg.checkpoint_dir}')
  check(next(t1.model.parameters()).device == device
        and next(t1.model.parameters()).dtype == torch.float32,
        'trainer: the model is not float32 on the card')
  rec1 = {'iters': []}
  _trainer_instrument(torch, t1, rec1)
  logs = []
  orig_train = t1.train
  t1.train = lambda progress_fn=None, **kw: orig_train(
      progress_fn=lambda m: (logs.append(m), (progress_fn or print)(m)),
      **kw)
  state0 = t1.init_state()
  paths = [p for p in bm_lib.block_executable_layers(
      state0.sparse.masks, st.block, conv3x3=cfg.block_conv3x3)
           if p in (state0.sparse.block_packs or {})]
  n_1x1 = sum(tuple(state0.sparse.masks[p].shape[:2]) == (1, 1)
              for p in paths)
  n_3x3 = len(paths) - n_1x1
  sizes = {p: m.numel() for p, m in state0.sparse.masks.items()}
  # ERK's sparsity as the initial masks realise it (at block 128 a
  # layer's zeros are whole blocks, floor(s * blocks) of them), beside
  # its nominal figure.
  erk = float(masks_lib.calculate_sparsity(state0.sparse.masks))
  erk_nominal = (sum(st.sparsities[p] * n for p, n in sizes.items())
                 / sum(sizes.values()))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  _zero_counts()
  result = common.run_and_report(t1, out_dir)
  torch.cuda.synchronize()
  launches = _counts()
  peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
  state = t1.state
  iters = rec1['iters']
  n_batches = trainer_lib.simulate_step_sequence(t1.algo, cfg.train_steps)
  upd_steps = [it['step'] for it in iters if it['updated']]
  # Each iteration's tap entry calls (fwd, dx, dw), and of them the 1x1s
  # on packed_mm.cu's kernels (the mm branch).
  per_iter = [tuple(it['launches'][f'tap{mm}_{op}']
                    for mm in ('', '_mm') for op in ('fwd', 'dx', 'dw'))
              for it in iters]
  want_iter = (len(paths),) * 3 + (n_1x1,) * 3
  bad = [(i, got) for i, got in enumerate(per_iter) if got != want_iter]
  others = {k: v for k, v in launches.items()
            if not k.startswith('tap_') and v}
  losses = [float(it['loss']) for it in iters]
  log_losses = [float(m['loss']) for m in logs if 'loss' in m]
  ms = [it['events'][0].elapsed_time(it['events'][1]) for it in iters]
  plain_ms = [t for t, it in zip(ms, iters) if not it['hint']][1:]
  upd_ms = [t for t, it in zip(ms, iters) if it['hint']]
  # The checkpoint steps: the step at each checkpoint_every-th batch, and
  # the final one.
  ckpt_want = sorted({it['step'] for i, it in enumerate(iters)
                      if (i + 1) % cfg.checkpoint_every == 0}
                     | {cfg.train_steps})
  ckpt_steps = CheckpointManager(out).all_steps()
  premask_ok = all(bool((state.params[p][m == 0] == 0).all())
                   for p, m in state.sparse.masks.items())
  log(f'trainer rn50 ({card}): {cfg.model} depth '
      f'{cfg.model_kwargs.get("depth")} float32, batch {cfg.batch_size}, '
      f'block {st.block}, {len(paths)} convs on the tap route ({n_1x1} 1x1 '
      f'on the mm branch, {n_3x3} 3x3 on the tf32 branch); {len(iters)} '
      f'iterations to step {state.sparse.step} (simulate_step_sequence: '
      f'{n_batches}), updates at steps {upd_steps}; checkpoints at '
      f'{ckpt_steps} (want {ckpt_want})')
  log(f'  step ms (CUDA events): plain {[round(t, 2) for t in plain_ms]} '
      f'(median {float(np.median(plain_ms)):.2f}), update '
      f'{[round(t, 2) for t in upd_ms]}; peak memory {peak_gb:.2f} GiB; '
      f'losses {[round(x, 4) for x in losses]}; at the logs '
      f'{[round(x, 4) for x in log_losses]}')
  log(f'  launches per iteration (tap fwd / dx / dw, of them mm fwd / dx '
      f'/ dw): {sorted(set(per_iter))} (want {want_iter}: {n_1x1} mm + '
      f'{n_3x3} tf32); other '
      f'counters {others}; global sparsity {result["global_sparsity"]:.5f} '
      f'(ERK at init {erk:.5f}, nominal {erk_nominal:.5f})')
  check(result['batches'] == n_batches == len(iters),
        f'trainer: {result["batches"]} batches, {len(iters)} iterations, '
        f'simulate_step_sequence {n_batches}')
  check(state.sparse.step == cfg.train_steps,
        f'trainer: ended at step {state.sparse.step}')
  check(n_1x1 == RN50_1X1 and n_3x3 > 0,
        f'trainer: {n_1x1} 1x1 and {n_3x3} 3x3 convs routed')
  check(not bad, f'trainer: iterations whose tap launches are not '
        f'{want_iter}: {bad[:3]}')
  check(not others, f'trainer: other kernels ran: {others}')
  check(all(it['hint_ok'] for it in iters), 'trainer: a hint missed')
  check(premask_ok, 'trainer: params not zero at inactive positions')
  check(abs(result['global_sparsity'] - erk) <= 0.01,
        f'trainer: global sparsity {result["global_sparsity"]} vs ERK {erk}')
  check(all(np.isfinite(losses)), f'trainer: non-finite loss {losses}')
  check(set(ckpt_want) <= set(ckpt_steps),
        f'trainer: checkpoints {ckpt_steps}, want {ckpt_want}')
  _rn50_counts_ok(st, state)

  # One step's loss and gradients, kernels against dense-times-mask; then
  # against cuDNN in TF32, the error that plain TF32 products give here.
  loss_k, loss_p, loss_err, errs = _rn50_step_vs_plain(
      torch, t1.model, st, state, rec1['last'][1], paths)
  _, _, tf32_loss_err, tf32_errs = _rn50_step_vs_plain(
      torch, t1.model, st, state, rec1['last'][1], paths, plain_tf32=True)
  kernel_paths = [p for p in errs if p.endswith('kernel')]
  tols = {p: TRAINER_KERNEL_RTOL if p in kernel_paths else TRAINER_BN_RTOL
          for p in errs}
  worst = sorted(errs, key=errs.get)[-3:]
  step_errs = dict(
      loss=loss_err, routed=max(errs[p] for p in paths),
      kernels=max(errs[p] for p in kernel_paths),
      other=max(errs[p] for p in errs if p not in kernel_paths),
      tf32_loss=tf32_loss_err, tf32_routed=max(tf32_errs[p] for p in paths),
      tf32_kernels=max(tf32_errs[p] for p in kernel_paths))
  log(f'  one step on the trained state, kernels vs dense-times-mask '
      f'(cuDNN, TF32 off): loss {loss_k:.7f} vs {loss_p:.7f} (rel '
      f'{loss_err:.2e}, tol {TRAINER_LOSS_RTOL}); max rel grad err of the '
      f'routed convs {step_errs["routed"]:.2e}, of every kernel '
      f'{step_errs["kernels"]:.2e} (tol {TRAINER_KERNEL_RTOL}), of the '
      f'BatchNorm tensors {step_errs["other"]:.2e} (tol {TRAINER_BN_RTOL});'
      f' largest at {[(n, float(f"{errs[n]:.2e}")) for n in worst]}; '
      f'cuDNN in TF32 against the kernels: loss {tf32_loss_err:.2e}, routed '
      f'{step_errs["tf32_routed"]:.2e}, every kernel '
      f'{step_errs["tf32_kernels"]:.2e}')
  check(loss_err <= TRAINER_LOSS_RTOL,
        f'trainer step loss: rel error {loss_err}')
  for p, err in errs.items():
    check(err <= tols[p], f'trainer step grad {p}: rel error {err} (tol '
          f'{tols[p]})')

  # The eval loop on the checkpoints against evaluate() on the state.
  direct = t1.evaluate(state)
  polled = evaluate_checkpoints(t1, out, eval_once=True)
  eval_err = max(abs(polled[0][k] - direct[k]) for k in direct)
  log(f'  eval loop (eval_once) at step {polled[0]["step"]}: {polled[0]}; '
      f'evaluate on the state: {direct} (max abs diff {eval_err:.2e})')
  check(polled[0]['step'] == cfg.train_steps,
        f'trainer: eval loop took step {polled[0]["step"]}')
  check(eval_err <= TRAINER_EXPORT_RTOL * max(abs(v) for v in direct.values()),
        f'trainer: eval loop metrics differ by {eval_err}')

  # Export and reload for inference against the trained model's eval-mode
  # logits on one batch.
  image = rec1['last'][1]['image']
  export_dir = export_model(str(Path(tmp) / 'export'), cfg.model,
                            t1.model_kwargs, state.params,
                            state.sparse.masks, state.batch_stats)
  apply_fn, manifest = load_for_inference(export_dir, device='cuda')
  got = apply_fn(image)
  with torch.no_grad():
    eff = masks_lib.apply_masks(state.params, state.sparse.masks)
    want = functional_call(t1.model, {masks_lib.torch_name(p): t for p, t in
                                      {**state.batch_stats, **eff}.items()},
                           (image,), {'train': False})
  export_err = _rel(got, want)
  log(f'  export -> load_for_inference: logits {tuple(got.shape)} on '
      f'{got.device}, rel err {export_err:.2e} against the trained model '
      f'(tol {TRAINER_EXPORT_RTOL}); manifest global sparsity '
      f'{manifest["global_sparsity"]:.5f}')
  check(got.device == device and got.shape == want.shape,
        f'trainer export: logits {got.shape} on {got.device}')
  check(export_err <= TRAINER_EXPORT_RTOL,
        f'trainer export: logits rel error {export_err}')
  check(abs(manifest['global_sparsity'] - result['global_sparsity']) < 1e-6,
        'trainer export: manifest sparsity')
  final = _trainer_snapshot(state)
  del t1, state, state0, apply_fn, got, want, eff, rec1, image
  torch.cuda.empty_cache()

  # A second trainer from the same config, train_steps 14: auto-resume
  # from step 12.
  argv2 = [a for a in argv if 'train_steps=' not in a] + [
      f'--override=train_steps={TRAINER_RESUME_STEPS}']
  t2, _ = train_driver.build_trainer(argv2)
  rec2 = {'iters': [], 'capture_first': True}
  _trainer_instrument(torch, t2, rec2)
  result2 = t2.train(progress_fn=lambda m: None)
  first = rec2['first_state']
  differ = [f'{kind}/{p}' for kind in ('params', 'masks', 'momentum')
            for p, t in final[kind].items()
            if not torch.equal(t, first[kind][p])]
  want2 = trainer_lib.simulate_step_sequence(
      t2.algo, TRAINER_RESUME_STEPS, start_step=cfg.train_steps,
      start_last_update=max(upd_steps))
  log(f'  resume: a second trainer (train_steps {TRAINER_RESUME_STEPS}) '
      f'restored step {cfg.train_steps}: params, masks and momentum '
      f'{"equal" if not differ else "DIFFER"} ({len(final["params"])} '
      f'params, {len(final["masks"])} masks, {len(final["momentum"])} '
      f'momentum buffers); {result2["batches"]} batches (want {want2}) to '
      f'step {t2.state.sparse.step}')
  check(len(final['momentum']) == len(final['params']),
        'trainer: momentum buffers missing')
  check(not differ, f'trainer resume: differs at {differ[:4]}')
  check(result2['batches'] == want2,
        f'trainer resume: {result2["batches"]} batches, want {want2}')
  check(t2.state.sparse.step == TRAINER_RESUME_STEPS,
        f'trainer resume: ended at step {t2.state.sparse.step}')

  # The device-busy share of two plain steps on the resumed state.
  step, batch = rec2['last']
  holder = {'state': t2.state}

  def hot():
    holder['state'], _ = step(holder['state'], batch)
  prof = profiled_kernel_time(torch, hot, 2, match=TRAINER_KERNELS)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(2):
    hot()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / 2
  busy = (None if prof['kernel_us_per_step'] is None
          else prof['kernel_us_per_step'] / 1e3 / wall_ms)
  log(f'  busy share of a plain step: {busy} (kernels '
      f'{prof["kernel_us_per_step"]} us against {wall_ms:.2f} ms on the '
      f'host clock); the port\'s kernels, us a step: '
      f'{prof.get("matched_us_per_step")}')
  del t2, holder, step, batch, rec2, first, final
  torch.cuda.empty_cache()
  return launches, dict(
      card=card, config=TRAINER_CONFIG, overrides=list(TRAINER_OVERRIDES),
      reduced=TRAINER_REDUCED, dtype='float32', block=list(st.block),
      routed=dict(total=len(paths), mm_1x1=n_1x1, tf32_3x3=n_3x3),
      iterations=len(iters), steps=cfg.train_steps,
      update_steps=upd_steps, losses=losses, log_losses=log_losses,
      step_ms_plain=float(np.median(plain_ms)), step_ms_plain_all=plain_ms,
      step_ms_update=upd_ms, busy=busy, busy_wall_ms=wall_ms,
      kernel_us_per_step=prof['kernel_us_per_step'],
      device_ms_by_kernel=prof['device_ms_by_kernel'],
      port_kernels_us_per_step=prof['matched_us_per_step'],
      port_kernels_by_kernel=prof['matched_by_kernel'],
      peak_memory_gib=peak_gb,
      launches_per_iteration=dict(
          tap_fwd=len(paths), tap_dx=len(paths), tap_dw=len(paths),
          by_kernel={
              'mm 1x1 (packed_mm_ffma_kernel / packed_dw_3xtf32_kernel, '
              'dense storage)': n_1x1,
              'tf32 3x3 (tap_conv_tf32_kernel / tap_dw_kernel)': n_3x3}),
      global_sparsity=result['global_sparsity'], erk_sparsity=erk,
      erk_nominal=erk_nominal,
      checkpoints=ckpt_steps, result=result,
      step_vs_plain=dict(rel_err=step_errs, tol=dict(
          loss=TRAINER_LOSS_RTOL, kernels=TRAINER_KERNEL_RTOL,
          other=TRAINER_BN_RTOL)),
      eval_loop=dict(polled=polled[0], direct=direct, max_abs_diff=eval_err),
      export=dict(logits_rel_err=export_err, tol=TRAINER_EXPORT_RTOL),
      resume=dict(steps=TRAINER_RESUME_STEPS, batches=result2['batches'],
                  equal=not differ),
      phase_s=time.perf_counter() - t_start)


def _trainer_wrn(torch, card):
  """Phase 23's WRN-22-2 run through drivers.cifar (its defaults, on
  synthetic CIFAR-10); returns its record."""
  import numpy as np
  from rigl_tpu_torch.drivers import cifar
  from rigl_tpu_torch.drivers import common
  from rigl_tpu_torch.train import trainer as trainer_lib
  t_start = time.perf_counter()
  trainer, out = cifar.build_trainer(['--device=cuda'] + list(TRAINER_WRN))
  result = common.run_and_report(trainer, out)
  cfg = trainer.config
  want = trainer_lib.simulate_step_sequence(trainer.algo, cfg.train_steps)
  losses = [m['loss'] for m in trainer.metrics_history if 'loss' in m]
  log(f'trainer wrn ({card}): {cfg.model} {cfg.model_kwargs} through '
      f'drivers.cifar, {result["batches"]} batches (want {want}) to step '
      f'{trainer.state.sparse.step}; losses {losses}; global sparsity '
      f'{result["global_sparsity"]:.5f} (want {cfg.sparsity})')
  check(result['batches'] == want, f'trainer wrn: {result["batches"]} '
        f'batches, want {want}')
  check(trainer.state.sparse.step == cfg.train_steps,
        f'trainer wrn: ended at step {trainer.state.sparse.step}')
  check(losses and all(np.isfinite(losses + [result['eval_loss']])),
        f'trainer wrn: losses {losses}, eval {result["eval_loss"]}')
  check(abs(result['global_sparsity'] - cfg.sparsity) <= 0.01,
        f'trainer wrn: global sparsity {result["global_sparsity"]}')
  rec = dict(card=card, argv=list(TRAINER_WRN), batches=result['batches'],
             losses=losses, result=result,
             phase_s=time.perf_counter() - t_start)
  del trainer
  torch.cuda.empty_cache()
  return rec


def phase_trainer(torch, device, card, root):
  """Phase 23: the config-driven Trainer through its drivers (module
  docstring).  Returns (the ResNet-50 run's launches, record)."""
  import shutil
  import tempfile
  t_start = time.perf_counter()
  tmp = tempfile.mkdtemp(prefix='chip_smoke_trainer_')
  try:
    launches, rn50 = _trainer_rn50(torch, device, card, root, tmp)
    wrn = _trainer_wrn(torch, card)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  wall = time.perf_counter() - t_start
  log(f'phase 23 wall time: {wall:.1f} s ({card})')
  return launches, dict(rn50=rn50, wrn=wrn, wall_s=wall, card=card)

T0 = time.perf_counter()


def phase_moe_kernels(torch, device):
  """Phase 24's kernel points: each expert's forward, dx and packed dw vs
  plain at the MoE arm's expert shapes, 1024 -> 4096 (fc1) and 4096 ->
  1024 (fc2), m = 512 rows (block (256, 256), s = 0.8, bf16), and the
  forward and dx at m = 4, a batch-4 decode step (the decode branch)."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(SEED + 24)
  bk, bn = MOE_BLOCK
  bf16 = torch.bfloat16
  m_train = int(TR_BATCH * TR_SEQ / MOE_EXPERTS * MOE_CAPACITY)
  records = {'fwd': [], 'dx': [], 'dw': []}
  for name, kdim, ndim in (('fc1', MOE_D_MODEL, MOE_D_FF),
                           ('fc2', MOE_D_FF, MOE_D_MODEL)):
    nk, nn_ = kdim // bk, ndim // bn
    n_act = nk * nn_ - get_n_zeros(nk * nn_, SPARSITY)
    packing = bsp.make_packing(random_occupancy(gen, nk, nn_, n_act), n_act)
    w = (torch.randn(n_act, bk, bn, generator=gen) / kdim ** 0.5).to(
        device, bf16)
    for m in (m_train, TR_BATCH):
      x = torch.randn(m, kdim, generator=gen).to(device, bf16)
      gy = torch.randn(m, ndim, generator=gen).to(device, bf16)
      ops = _product_ops(torch, x, gy, w, packing, MOE_BLOCK)
      for op, (counter, run, plain, library) in ops.items():
        if op == 'dw' and m == TR_BATCH:
          continue                     # no dw at a decode step
        branch = None if op == 'dw' else bsp.mm_branch(
            m, bk if op == 'fwd' else bn, bf16)
        before = bsp.mm_decode_launches
        rec, _ = kernel_point(
            torch, f'moe {op:3s} {name} m={m:3d} bfloat16', counter, run,
            plain, library, bound(op, m, packing, MOE_BLOCK, bf16),
            branch=branch)
        check(branch != 'decode' or bsp.mm_decode_launches > before,
              f'moe {op} {name} m={m}: the decode kernel did not run')
        rec.update(path='moe_lm', layer=name, m=m, dtype='bfloat16',
                   k=kdim, n=ndim, n_active=n_act)
        if op == 'dw':
          rec['split'] = dw_split(f'moe dw  {name} m={m}', bsp.dw_plan(
              m, n_act, MOE_BLOCK, bf16, sm_count(torch)))
        records[op].append(rec)
  return records


class _SharedRouting:
  """The kernel path's routing, replayed in the plain path.  Recording,
  every top1_gather_dispatch call keeps its (src, flat_ec, kept) and the
  smallest top-1 / top-2 router-probability margin is noted; replaying,
  each call takes the recorded slots, computes the gate and the aux loss
  from its own logits at the recorded choices (so the gradient reaches
  the router as on the kernel path), and counts the tokens whose own
  argmax would have picked another expert."""

  def __init__(self, torch, ep):
    self.torch, self.ep, self.real = torch, ep, ep.top1_gather_dispatch
    self.calls, self.margin, self.flips, self.replayed = [], 1.0, 0, 0

  @contextlib.contextmanager
  def patched(self, fn):
    self.ep.top1_gather_dispatch = fn
    try:
      yield
    finally:
      self.ep.top1_gather_dispatch = self.real

  def record(self, logits, capacity, token_axes=()):
    out = self.real(logits, capacity, token_axes)
    top2 = self.torch.softmax(logits.detach().float(), -1).topk(2).values
    self.margin = min(self.margin, float((top2[:, 0] - top2[:, 1]).min()))
    self.calls.append(out[:3])
    return out

  def replay(self, logits, capacity, token_axes=()):
    del token_axes
    torch = self.torch
    src, flat_ec, kept = self.calls[self.replayed]
    self.replayed += 1
    n_experts = logits.shape[1]
    choice = flat_ec // capacity
    probs = torch.softmax(logits.float(), -1)
    self.flips += int((probs.argmax(-1) != choice).sum())
    frac = torch.nn.functional.one_hot(choice, n_experts).float().mean(0)
    aux = n_experts * torch.sum(frac * probs.mean(0))
    return src, flat_ec, kept, probs.gather(1, choice[:, None])[:, 0], aux


def _moe_step_vs_plain(torch, device, tr, batch):
  """One MoE train step's loss (aux included) and gradients, kernel path
  against the plain path (the dense MoE twin holding the unpacked
  kernels) from the same state and batch, the kernel path's routing
  replayed in the plain path; and the step's launches."""
  from torch.func import functional_call
  from rigl_tpu_torch.parallel import packed_ep as ep
  from rigl_tpu_torch.train import packed_lm as tlm
  x, y = batch
  params = tr.params
  routing = _SharedRouting(torch, ep)
  before = _counts()
  with routing.patched(routing.record):
    loss = tr._loss(x, y)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
  torch.cuda.synchronize()
  per_step = _since(before)
  views = {n: v.detach().clone().requires_grad_() for n, v in
           tlm.dense_twin_params({n: p.detach() for n, p in params.items()},
                                 tr.packings, tr.cfg.block).items()}
  with routing.patched(routing.replay):
    logits, aux = functional_call(tr.dense_twin, views, (x,),
                                  {'with_aux': True})
    plain_loss = tlm._lm_loss(logits, y) + tr.cfg.aux_loss_weight * aux
    plain = dict(zip(views, torch.autograd.grad(plain_loss,
                                                list(views.values()))))
  loss, plain_loss = float(loss.detach()), float(plain_loss.detach())
  loss_err = abs(loss - plain_loss) / abs(plain_loss)
  grad_errs = _grad_errors(torch, tr.model, grads, plain)
  return per_step, dict(loss=loss, plain_loss=plain_loss, loss_err=loss_err,
                        max_grad_rel_err=max(grad_errs.values()),
                        grad_rel_err=grad_errs,
                        router_calls=len(routing.calls),
                        min_top2_margin=routing.margin,
                        plain_flips_kept_out=routing.flips)


def _moe_decode_vs_full(torch, device, tr, tokens):
  """Teacher-forced KV-cache decoding (MOE_PROMPT prefill tokens, then
  MOE_GENERATE single tokens, batch TR_BATCH) against the full causal
  forward at capacity factor E, which drops no token, on a float32 copy
  of the trained model.  Returns (rel error, decode launches)."""
  import numpy as np
  from rigl_tpu_torch.models.packed_moe import PackedMoETransformer
  from rigl_tpu_torch.serve import decode as dec
  cfg = tr.cfg
  kw = dict(cfg.model_kwargs(), dtype=torch.float32,
            capacity_factor=float(MOE_EXPERTS))
  model = PackedMoETransformer(sparsity=tr.sparsity_spec, block=cfg.block,
                               bm=cfg.bm, device=device, **kw)
  for name, mod in model.named_modules():
    if hasattr(mod, 'set_packing'):
      mod.set_packing(tr.model.get_submodule(name).packing)
  model.load_state_dict(tr.model.state_dict())
  n = MOE_PROMPT + MOE_GENERATE
  seqs = torch.as_tensor(np.asarray(tokens[:TR_BATCH * n], np.int64)
                         .reshape(TR_BATCH, n)).to(device)
  twin = dec.decode_twin(model, n)
  cache = dec.init_cache(twin, TR_BATCH)
  before = _counts()
  with torch.inference_mode():
    got = torch.cat([twin(seqs[:, :MOE_PROMPT], cache)] + [
        twin(seqs[:, t:t + 1], cache) for t in range(MOE_PROMPT, n)], 1)
    torch.cuda.synchronize()
    launches = _since(before)
    full = model(seqs)
  del model, twin, cache
  return _rel(got, full), launches


def phase_moe_lm(torch, device, card):
  """The MoE LM main path (constants MOE_*): kernel points at its shapes
  (phase_moe_kernels), then one train step against the plain path with
  the routing shared; RigL for 30 steps with updates at 0, 10 and 20
  (each update checked: every expert's count kept, grown slots' weights
  and Adam slots zero; at least one expert's mask changed, the aux loss
  finite, the loss falling); SET and SNFS 6 steps with one update each;
  16 greedy tokens at batch 4 from 64-token prompts with kv_chunk 0 and
  128 (L = 1024), which must agree, and decode against the full causal
  forward at capacity factor E (MOE_DECODE_RTOL); a save / restore round
  trip whose next step's loss is equal; and the figures: step ms (host
  clock and CUDA events), update ms, the device-busy share, a step's
  device time by kernel, the dense twin's step and the peak memory.
  Returns (kernel points, launches of the RigL run, serving launches,
  record)."""
  import tempfile
  import numpy as np
  from rigl_tpu_torch.drivers.packed_lm import synthetic_stream
  from rigl_tpu_torch.models.packed_moe import DenseMoETransformer
  from rigl_tpu_torch.parallel import packed_ep as ep
  from rigl_tpu_torch.train import packed_lm as tlm
  t_phase = time.perf_counter()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  points = phase_moe_kernels(torch, device)
  tokens = synthetic_stream(200_000, seed=SEED)
  base = dict(vocab_size=LM_VOCAB, num_layers=MOE_LAYERS,
              d_model=MOE_D_MODEL, d_ff=MOE_D_FF, num_heads=MOE_HEADS,
              seq_len=TR_SEQ, sparsity=SPARSITY, block=MOE_BLOCK, bm=MOE_BM,
              dtype='bfloat16', learning_rate=1e-3, warmup_steps=5,
              batch_size=TR_BATCH, drop_fraction=0.3,
              drop_fraction_anneal='cosine', seed=SEED,
              n_experts=MOE_EXPERTS, capacity_factor=MOE_CAPACITY)
  per_kind = MOE_LAYERS * (2 + 2 * MOE_EXPERTS)

  tr = tlm.PackedLMTrainer(tlm.PackedLMConfig(**base), device=device)
  tr.init_state()
  per_step, vs_plain = _moe_step_vs_plain(torch, device, tr,
                                          tr.sample_batch(tokens))
  log(f'moe ({card}): step vs plain: launches {per_step} (expected fwd, '
      f'dx and dw {per_kind} each, no decode); loss {vs_plain["loss"]:.6f} '
      f'vs plain {vs_plain["plain_loss"]:.6f} (rel {vs_plain["loss_err"]:.3e}'
      f'), max rel grad err {vs_plain["max_grad_rel_err"]:.3e} (tol '
      f'{STEP_RTOL}); routing of {vs_plain["router_calls"]} router calls '
      f'shared: smallest top-1 / top-2 margin '
      f'{vs_plain["min_top2_margin"]:.3e}, {vs_plain["plain_flips_kept_out"]}'
      f' tokens the plain path alone would have routed elsewhere')
  check(all(per_step[k] == per_kind for k in ('fwd', 'dx', 'dw'))
        and per_step['decode'] == 0, f'moe step launches {per_step}')
  check(vs_plain['loss_err'] <= STEP_RTOL,
        f'moe step loss error {vs_plain["loss_err"]}')
  for name, err in vs_plain['grad_rel_err'].items():
    check(err <= STEP_RTOL, f'moe step grad {name}: rel error {err}')
  del tr

  _zero_counts()
  tr, rigl = _lm_run(torch, device, tokens, base, 'moe', 'rigl', LM_STEPS,
                     10, 20)
  launches = _since({k: 0 for k in _counts()})
  experts = [n for n, pk in tr.packings.items() if ep.is_expert_stacked(pk)]
  grown_experts = sum(g[n] for g in rigl['blocks_grown_by_kernel']
                      for n in experts)
  check(rigl['update_steps'] == [0, 10, 20],
        f'moe rigl updates at {rigl["update_steps"]}, not [0, 10, 20]')
  check(grown_experts > 0, 'moe rigl: no expert mask changed')
  check(np.mean(rigl['losses'][-5:]) < np.mean(rigl['losses'][:5]),
        f'moe rigl loss did not fall: {rigl["losses"]}')
  check(all(launches[k] > 0 for k in ('fwd', 'dx', 'dw')),
        f'moe: a packed kernel was not launched: {launches}')
  x, y = tr.sample_batch(tokens)
  with torch.no_grad():
    _, aux = tr.model(x, with_aux=True)
  aux = float(aux)
  check(math.isfinite(aux), f'moe: aux loss {aux}')
  log(f'  moe rigl launches {launches}; blocks grown in the experts '
      f'{grown_experts}; aux loss after training {aux:.4f} (summed over '
      f'{MOE_LAYERS} layers)')

  # The figures, on the trained trainer: a step by CUDA events, its
  # kernels by torch.profiler, the dense twin's step beside it.
  step_ms = time_ms(lambda: tr.train_step(x, y), 10)
  prof = profiled_kernel_time(torch, lambda: tr.train_step(x, y), 3,
                              match=('packed_mm', 'packed_dw'))
  busy = _share(prof['kernel_us_per_step'], step_ms * 1e3)
  gen = torch.Generator().manual_seed(SEED + 25)
  dense = DenseMoETransformer(generator=gen, device=device,
                              **tr.cfg.model_kwargs())
  opt = torch.optim.Adam(dense.parameters(), lr=1e-3)

  def dense_step():
    opt.zero_grad(set_to_none=True)
    logits, aux_ = dense(x, with_aux=True)
    loss = tlm._lm_loss(logits, y) + tr.cfg.aux_loss_weight * aux_
    loss.backward()
    opt.step()
    return float(loss.detach())

  dense_ms = time_ms(dense_step, 10)
  del dense, opt
  log(f'  moe step: {step_ms:.3f} ms (CUDA events, the loss read each step), '
      f'{rigl["step_ms"]:.3f} ms (median, host clock); kernels '
      f'{prof["kernel_us_per_step"]} us a step (busy share {busy}); dense '
      f'twin step {dense_ms:.3f} ms; updates {rigl["update_ms"]} ms')

  out = {}
  prompt = np.asarray(tokens[:TR_BATCH * MOE_PROMPT], np.int32).reshape(
      TR_BATCH, MOE_PROMPT)
  _zero_counts()
  for kv_chunk in (0, 128):
    t0 = time.perf_counter()
    out[kv_chunk] = tr.generate(prompt, MOE_GENERATE, max_len=1024,
                                kv_chunk=kv_chunk)
    log(f'  moe generate {MOE_GENERATE} greedy tokens, batch {TR_BATCH}, '
        f'L = 1024, kv_chunk {kv_chunk}: '
        f'{(time.perf_counter() - t0) * 1e3:.1f} ms')
  serve_launches = _since({k: 0 for k in _counts()})
  check(out[0].shape == (TR_BATCH, MOE_GENERATE),
        f'moe generate shape {out[0].shape}')
  check((out[0] == out[128]).all(), 'moe: kv_chunk=128 tokens differ: '
        f'{out[0].tolist()} vs {out[128].tolist()}')
  check(serve_launches['decode'] > 0, 'moe: no decode-branch launch')
  decode_err, decode_launches = _moe_decode_vs_full(torch, device, tr,
                                                    tokens[1000:])
  log(f'  moe serving launches {serve_launches}; decode vs full causal '
      f'forward at capacity factor {MOE_EXPERTS} (f32): rel err '
      f'{decode_err:.3e} (tol {MOE_DECODE_RTOL}), launches {decode_launches}')
  check(decode_err <= MOE_DECODE_RTOL, f'moe decode error {decode_err}')
  check(decode_launches['decode'] > 0, 'moe f32 decode: no decode launch')

  with tempfile.TemporaryDirectory(prefix='chip_smoke_moe_') as tmp:
    tr.save(tmp)
    back = tlm.PackedLMTrainer(tr.cfg, device=device)
    check(back.restore(tmp), 'moe: no checkpoint to restore')
  batch = tr.sample_batch(tokens)
  again = back.sample_batch(tokens)
  check(all(bool(torch.equal(a, b)) for a, b in zip(batch, again)),
        'moe restore: batches differ')
  resumed = (tr.train_step(*batch), back.train_step(*again))
  log(f'  moe save / restore: the next step loss {resumed[0]!r} and '
      f'{resumed[1]!r}')
  check(resumed[0] == resumed[1], f'moe restore: losses {resumed}')
  del back, tr

  others = {}
  for algo in ('set', 'snfs'):
    t, others[algo] = _lm_run(torch, device, tokens, base, 'moe', algo, 6,
                              5, 5)
    check(len(others[algo]['update_steps']) == 1,
          f'moe {algo} updates at {others[algo]["update_steps"]}')
    del t
  # The driver at its defaults (d_model 256, block (16, 16), RigL) with 8
  # experts, on the card as it runs without --device.
  import io
  from rigl_tpu_torch.drivers import packed_lm as driver
  with contextlib.redirect_stdout(io.StringIO()):
    res = driver.main(['--n_experts=8', '--train_steps=6',
                       '--maskupdate_frequency=3', '--log_every=3',
                       '--lm_dtype=bfloat16', '--generate_steps=4'])
  log(f'  moe driver --n_experts=8: {res["train_steps"]} steps, '
      f'{res["mask_updates"]} updates, loss {res["final_loss"]:.4f}, eval '
      f'{res["eval_ce_nats"]:.4f} nats, generated {res["generated_tokens"]}'
      f' on {res["device"]}')
  check(res['device'] == 'cuda' and res['mask_updates'] == 2
        and math.isfinite(res['final_loss'])
        and len(res['generated_tokens']) == 4, f'moe driver: {res}')
  peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
  wall = time.perf_counter() - t_phase
  log(f'  moe phase: peak memory {peak_gb:.2f} GiB, {wall:.1f} s ({card})')
  torch.cuda.empty_cache()
  rec = dict(card=card, step_vs_plain=vs_plain,
             launches_per_step=per_step, rigl=rigl, **others,
             aux_after_training=aux, step_ms_cuda_events=step_ms,
             device_busy_share=busy, dense_twin_step_ms=dense_ms,
             generated=out[0].tolist(), kv_chunk_equal=True,
             serving_launches=serve_launches,
             decode_vs_full_rel_err=decode_err, restored_losses=resumed,
             driver={k: res[k] for k in ('train_steps', 'mask_updates',
                                         'final_loss', 'eval_ce_nats',
                                         'device')},
             peak_memory_gib=peak_gb, wall_s=wall, **prof)
  return points, launches, serve_launches, rec


# ------------------------------------------------------ sparse RL (25) -----
RL_ATARI = ('configs/rl_dqn_atari_rigl.json',
            'configs/rl_dqn_atari_rigl_impala_net.json')
# The Atari presets' cuts, every other value the preset's (NatureDQN /
# Impala at width 1.0, batch 32, learn_every 4, lr 2.5e-4, RigL, ERK 0.9,
# min_replay 500, target_update_period 100): total_env_steps 1e7 -> 1120
# (156 learn iterations after the 500-transition warm-up) and
# maskupdate_frequency 5000 -> 50, so RigL updates at steps 0, 50, 100
# and 150, the target syncs at steps 0 and 100 (after a plain step and
# after the update), and 48 plain steps are left before the next update
# for the measurements that follow.
RL_ATARI_ENV_STEPS = 1120
RL_ATARI_FREQUENCY = 50
# One learn step on the card against the same step on the CPU, both in
# float64 from the card's float32 state, as phase 22 does: in float32 a
# ReLU or Huber boundary that the two devices' sums put on either side
# moves a gradient entry by 2e-3 of its value (a conv bias's, on the
# H100), while in float64 the devices differ by the order of their sums
# alone, 1e-15 of the largest values, far inside RL_F64_RTOL; after Adam
# a weight whose gradient is near 0 moves by lr * m / (sqrt(v) + eps),
# so the params within RL_F64_RTOL of the layer's largest plus
# RL_F64_ATOL.  Masks equal.
RL_F64_RTOL, RL_F64_ATOL = 1e-9, 1e-9
# Windows of the measurements, all of plain learn steps.
RL_LEARN_TIMED = 10
RL_CHUNKS_TIMED = 15
RL_SYNC_CHUNKS = 5
RL_BUSY_CHUNKS = 5
# tests/test_rl.py's slow learning checks at their own settings:
# (agent, config, hidden, env, total env steps, the bound on the final
# average return).
RL_LEARN = (
    ('dqn', dict(training_method='rigl', sparsity=0.5, buffer_capacity=5000,
                 min_replay=200, batch_size=64, learn_every=2,
                 target_update_period=50, epsilon_decay_steps=2000,
                 maskupdate_frequency=200, maskupdate_begin_step=100,
                 learning_rate=3e-3), (64, 64), 'cartpole', 6000, 35.0),
    ('ppo', dict(training_method='rigl', sparsity=0.5, rollout_length=256,
                 num_epochs=4, num_minibatches=4, learning_rate=1e-3,
                 maskupdate_frequency=100, maskupdate_begin_step=50),
     (64, 64), 'cartpole', 256 * 60, 40.0),
    ('sac', dict(training_method='rigl', sparsity=0.5,
                 buffer_capacity=20000, min_replay=500, batch_size=128,
                 learn_every=1, learning_rate=3e-3,
                 maskupdate_frequency=1000, maskupdate_begin_step=500),
     (64, 64), 'pendulum', 12000, -900.0),
)
# The other presets, a few hundred env steps each at their widths (only
# total_env_steps cut): the DQN past its min_replay of 500, PPO two
# rollouts of 256 (80 update steps at num_epochs 10), SAC past its
# min_replay of 1000.
RL_PRESETS = (('configs/rl_dqn_gym_sparse.json', 800),
              ('configs/rl_ppo_mujoco_sparse.json', 512),
              ('configs/rl_sac_mujoco_sparse.json', 1200))


def _erk_sparsity(st):
  """The global sparsity of ERK's per-layer zero counts at init."""
  from rigl_tpu_torch.sparsity import distributions
  total = sum(math.prod(s) for s in st.layer_shapes.values())
  zeros = sum(distributions.get_n_zeros(math.prod(s), st.sparsities[p])
              for p, s in st.layer_shapes.items())
  return zeros / total


@contextlib.contextmanager
def _dqn_recorder(torch, rec):
  """Wraps SparseDQN._learn while the block runs: the first call's agent,
  masks and counts; each mask update's counts (against init) and whether
  a mask changed; each target sync's masks and params against the
  online ones, and whether they alias them."""
  from rigl_tpu_torch.rl import dqn
  orig = dqn.SparseDQN._learn

  def learn(self, state, idx=None):
    if 'agent' not in rec:
      rec.update(agent=self, updates=[], syncs=[], learns=0,
                 init_counts={p: int(m.sum())
                              for p, m in state.sparse.masks.items()},
                 init_sparsity=float(
                     dqn.masks_lib.calculate_sparsity(state.sparse.masks)))
    new = orig(self, state, idx)
    rec['learns'] += 1
    if new.sparse.masks is not state.sparse.masks:
      counts = {p: int(m.sum()) for p, m in new.sparse.masks.items()}
      rec['updates'].append(dict(
          step=new.sparse.step, counts_kept=counts == rec['init_counts'],
          changed=[p for p, m in new.sparse.masks.items()
                   if not torch.equal(m, state.sparse.masks[p])]))
    if new.target_masks is not state.target_masks:
      rec['syncs'].append(dict(
          step=new.sparse.step,
          masks_equal=all(torch.equal(new.target_masks[p], m)
                          for p, m in new.sparse.masks.items()),
          params_equal=all(torch.equal(new.target_params[p], t)
                           for p, t in new.params.items()),
          aliased=any(new.target_params[p].data_ptr() == t.data_ptr()
                      for p, t in new.params.items())))
    return new

  dqn.SparseDQN._learn = learn
  try:
    yield rec
  finally:
    dqn.SparseDQN._learn = orig


def _rl_f64_copy(torch, agent, state, device):
  """(agent, state) on `device` in float64 holding `state` (a DQNState on
  the card): the network, optimizer slots, masks, targets and replay
  copied, float tensors of the parameters' shapes widened."""
  import copy
  from rigl_tpu_torch.rl import dqn, replay
  from rigl_tpu_torch.rl.envs import EnvState
  from rigl_tpu_torch.train.checkpoint import optimizer_slots
  net = copy.deepcopy(agent.net).to(device=device, dtype=torch.float64)
  for m in net.modules():
    if hasattr(m, 'dtype'):
      m.dtype = torch.float64
  out = dqn.SparseDQN(net, type(agent.env)(device=device), agent.config)
  base = out.init(agent.config.seed)
  move = lambda t: t.detach().to(device).clone()  # noqa: E731
  wide = lambda t: t.detach().to(device, torch.float64).clone()  # noqa: E731
  with torch.no_grad():
    for p, t in base.params.items():
      t.copy_(state.params[p])
  slots = optimizer_slots(state.optimizer, list(state.params))
  for p, t in base.params.items():
    base.optimizer.state[t] = {
        k: (wide(v) if torch.is_tensor(v) and v.shape == t.shape else
            v.clone() if torch.is_tensor(v) else v)
        for k, v in slots[p].items()}
  b = state.buffer
  return out, base.replace(
      target_params={p: wide(t) for p, t in state.target_params.items()},
      target_masks={p: move(t) for p, t in state.target_masks.items()},
      sparse=state.sparse.replace(
          masks={p: move(m) for p, m in state.sparse.masks.items()}),
      buffer=replay.ReplayBuffer(obs=move(b.obs), action=move(b.action),
                                 reward=move(b.reward),
                                 next_obs=move(b.next_obs),
                                 done=move(b.done), ptr=b.ptr, size=b.size),
      env_state=EnvState(obs=move(state.env_state.obs),
                         done=move(state.env_state.done),
                         t=move(state.env_state.t),
                         gen=torch.Generator(device=device)),
      env_steps=state.env_steps)


def _rl_learn_vs_cpu(torch, agent, state):
  """One plain learn step in float64 on the card against the same step in
  float64 on the CPU, from the card's state (module constants RL_F64_*);
  returns its record.  The card's own state does not move."""
  from rigl_tpu_torch.rl import dqn, replay
  idx = replay.sample_indices(state.buffer, state.gen,
                              agent.config.batch_size)
  out = {}
  for name, dev in (('card', agent.device), ('cpu', torch.device('cpu'))):
    a, s = _rl_f64_copy(torch, agent, state, dev)
    i = idx.to(dev)
    eff = dqn.effective(s.params, s.sparse.masks, a.config.premask_params,
                        grad=True)
    loss = a._loss(eff, s.target_params, s.target_masks,
                   replay.gather(s.buffer, i))
    grads = dqn.grads_of(loss, eff)
    new = a._learn(s, idx=i)
    out[name] = dict(loss=float(loss.detach()),
                     grads={p: g.detach().cpu() for p, g in grads.items()},
                     params={p: t.detach().cpu().clone()
                             for p, t in new.params.items()},
                     masks={p: m.cpu() for p, m in new.sparse.masks.items()},
                     step=new.sparse.step)
  card, host = out['card'], out['cpu']
  check(card['step'] == host['step'], 'rl: card and CPU steps differ')
  def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

  grad_err = max(rel(g, host['grads'][p]) for p, g in card['grads'].items())
  step_err = max(float((t - host['params'][p]).abs().max()
                       - RL_F64_RTOL * host['params'][p].abs().max())
                 for p, t in card['params'].items())
  loss_err = abs(card['loss'] - host['loss']) / abs(host['loss'])
  masks_equal = all(torch.equal(m, host['masks'][p])
                    for p, m in card['masks'].items())
  log(f'  learn step in float64, card vs CPU: loss {card["loss"]:.12f} vs '
      f'{host["loss"]:.12f} (rel {loss_err:.2e}), max rel grad err '
      f'{grad_err:.2e} (tol {RL_F64_RTOL}), params past {RL_F64_RTOL} x '
      f'max |w| by {step_err:.2e} (atol {RL_F64_ATOL}), masks equal '
      f'{masks_equal}')
  check(loss_err <= RL_F64_RTOL, f'rl: loss rel {loss_err}')
  check(grad_err <= RL_F64_RTOL, f'rl: grad rel {grad_err}')
  check(step_err <= RL_F64_ATOL, f'rl: params off by {step_err}')
  check(masks_equal, 'rl: card and CPU masks differ')
  return dict(dtype='float64', loss_card=card['loss'], loss_cpu=host['loss'],
              loss_rel_err=loss_err, max_grad_rel_err=grad_err,
              rtol=RL_F64_RTOL, params_excess=step_err, atol=RL_F64_ATOL,
              masks_equal=masks_equal)


def _count_syncs(torch, fn):
  """Host syncs of one fn() call, by torch.cuda.set_sync_debug_mode's
  warnings."""
  import warnings
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode('default')
  return sum('synchroniz' in str(w.message) for w in caught)


def _rl_measure(torch, agent, holder, learn=True):
  """Env steps a second of collect_and_learn (host clock), the learn
  step's ms (CUDA events), host syncs per env step and per learn step
  (set_sync_debug_mode), the device-busy share (torch.profiler), on the
  state in `holder`, which advances."""
  def chunk():
    holder['s'], _ = agent.collect_and_learn(holder['s'])

  def env_step():
    holder['s'] = agent._env_step(holder['s'])

  rec = {}
  if learn:
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(RL_LEARN_TIMED)]
    for a, b in ev:
      a.record()
      holder['s'] = agent._learn(holder['s'])
      b.record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in ev)
    rec['learn_ms'] = ms[len(ms) // 2]
    rec['learn_syncs'] = _count_syncs(
        torch, lambda: holder.update(s=agent._learn(holder['s'])))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(RL_CHUNKS_TIMED):
    chunk()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  steps = RL_CHUNKS_TIMED * agent.config.learn_every
  rec['env_steps_per_s'] = steps / wall
  rec['chunk_ms'] = wall * 1e3 / RL_CHUNKS_TIMED
  rec['env_step_syncs'] = _count_syncs(torch, env_step)
  rec['chunk_syncs'] = (sum(_count_syncs(torch, chunk)
                            for _ in range(RL_SYNC_CHUNKS)) / RL_SYNC_CHUNKS)
  prof = profiled_kernel_time(torch, chunk, RL_BUSY_CHUNKS)
  t0 = time.perf_counter()
  for _ in range(RL_BUSY_CHUNKS):
    chunk()
  torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3 / RL_BUSY_CHUNKS
  rec['busy'] = (None if prof['kernel_us_per_step'] is None
                 else prof['kernel_us_per_step'] / 1e3 / wall_ms)
  rec['kernel_us_per_chunk'] = prof['kernel_us_per_step']
  return rec


def _rl_atari(torch, device, card, path):
  """Phase 25(a) for one Atari preset (module constants RL_ATARI_*)."""
  import numpy as np
  from rigl_tpu_torch.drivers import rl as rl_driver
  t0 = time.perf_counter()
  preset, agent_kwargs = rl_driver.load_preset(path)
  preset.update(total_env_steps=RL_ATARI_ENV_STEPS,
                maskupdate_frequency=RL_ATARI_FREQUENCY, log_every=0)
  rec = {}
  torch.cuda.reset_peak_memory_stats()
  with _dqn_recorder(torch, rec):
    result = rl_driver.run(agent_kwargs=agent_kwargs, progress_fn=None,
                           device='cuda', **preset)
  train_s = time.perf_counter() - t0
  agent, state = rec['agent'], rec['agent'].state
  st, cfg = agent.st, agent.config
  n_chunks = RL_ATARI_ENV_STEPS // cfg.learn_every
  n_learn = n_chunks - (-(-cfg.min_replay // cfg.learn_every)) + 1
  plan = st.predict_update_iters(n_learn)
  erk = _erk_sparsity(st)
  final_sparsity = float(result['global_sparsity'])
  upd_steps = [u['step'] for u in rec['updates']]
  kept = all(u['counts_kept'] for u in rec['updates'])
  log(f'rl {path} ({card}): {type(agent.net).__name__} width '
      f'{preset.get("width", 1.0)}, {result["env_steps"]:.0f} env steps, '
      f'{rec["learns"]} learn iterations (want {n_learn}) to step '
      f'{result["learn_steps"]:.0f}; updates at steps {upd_steps}, every '
      f'layer at its init count: {kept}; '
      f'layers changed {[len(u["changed"]) for u in rec["updates"]]}; '
      f'syncs at {[s["step"] for s in rec["syncs"]]}; sparsity init '
      f'{rec["init_sparsity"]:.5f} final {final_sparsity:.5f} (ERK '
      f'{erk:.5f}); avg return {result["avg_return"]:.3f} over '
      f'{result["episodes"]:.0f} episodes; {train_s:.1f} s')
  check(result['env_steps'] == RL_ATARI_ENV_STEPS, f'rl {path}: env steps')
  check(rec['learns'] == n_learn, f'rl {path}: {rec["learns"]} learns')
  check(result['learn_steps'] == n_learn - sum(plan),
        f'rl {path}: learn steps {result["learn_steps"]}')
  check(len(upd_steps) == sum(plan) >= 3, f'rl {path}: updates {upd_steps}')
  check(all(u['counts_kept'] for u in rec['updates']),
        f'rl {path}: a layer\'s active count moved')
  check(any(u['changed'] for u in rec['updates']),
        f'rl {path}: no mask changed')
  check(abs(rec['init_sparsity'] - erk) <= 0.01
        and abs(final_sparsity - erk) <= 0.01,
        f'rl {path}: sparsity {rec["init_sparsity"]} / {final_sparsity} '
        f'against ERK {erk}')
  check(len(rec['syncs']) >= 2 and all(
      s['masks_equal'] and s['params_equal'] and not s['aliased']
      for s in rec['syncs']), f'rl {path}: target syncs {rec["syncs"]}')
  check(np.isfinite(result['avg_return']), f'rl {path}: return')
  check(not st.predict_update_iters(
      RL_LEARN_TIMED + 1 + RL_CHUNKS_TIMED + 1 + RL_SYNC_CHUNKS
      + 2 * RL_BUSY_CHUNKS, state.sparse.step,
      state.sparse.last_update_step).count(True),
        f'rl {path}: a mask update would land in the measurements')
  vs_cpu = _rl_learn_vs_cpu(torch, agent, state)
  holder = {'s': state}
  measured = _rl_measure(torch, agent, holder)
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  busy = measured['busy']
  log(f'  {measured["env_steps_per_s"]:.1f} env steps/s in '
      f'collect_and_learn ({measured["chunk_ms"]:.2f} ms a chunk of '
      f'{cfg.learn_every} env steps + a learn), learn step '
      f'{measured["learn_ms"]:.3f} ms (median, CUDA events), busy '
      f'{busy if busy is None else round(busy, 3)}; '
      f'host syncs: {measured["env_step_syncs"]} an env step, '
      f'{measured["learn_syncs"]} a learn step, '
      f'{measured["chunk_syncs"]:.1f} a collect_and_learn; peak '
      f'{peak:.3f} GiB ({card})')
  check(measured['env_step_syncs'] == 0,
        f'rl {path}: {measured["env_step_syncs"]} syncs in an env step')
  out = dict(card=card, preset=path, cuts=dict(
      total_env_steps=RL_ATARI_ENV_STEPS,
      maskupdate_frequency=RL_ATARI_FREQUENCY),
      network=type(agent.net).__name__,
      result=result, learn_iterations=rec['learns'], update_steps=upd_steps,
      sync_steps=[s['step'] for s in rec['syncs']],
      init_sparsity=rec['init_sparsity'], erk_sparsity=erk,
      active_by_layer=rec['init_counts'], learn_vs_cpu=vs_cpu,
      peak_gib=peak, train_s=train_s, **measured,
      phase_s=time.perf_counter() - t0)
  del agent, state, holder, rec
  torch.cuda.empty_cache()
  return out


def _rl_learning(torch, card, agent_kind, kw, hidden, env_name, steps,
                 bound):
  """Phase 25(b): one of test_rl.py's slow learning checks on the card."""
  import numpy as np
  from rigl_tpu_torch.rl import dqn, envs, networks, ppo, sac
  t0 = time.perf_counter()
  env = envs.ENVS[env_name](device='cuda')
  if agent_kind == 'dqn':
    agent = dqn.SparseDQN(networks.MLPQNetwork(
        env.num_actions, hidden, obs_shape=env.obs_shape, device=env.device),
        env, dqn.DQNConfig(**kw))
    result = agent.train(total_env_steps=steps, log_every=0)
  elif agent_kind == 'ppo':
    agent = ppo.SparsePPO(env, ppo.PPOConfig(**kw), hidden=hidden)
    result = agent.train(total_env_steps=steps)
  else:
    agent = sac.SparseSAC(env, sac.SACConfig(**kw), hidden=hidden)
    result = agent.train(total_env_steps=steps, log_every=0)
  wall = time.perf_counter() - t0
  log(f'rl learning {agent_kind} on {env_name} ({card}): avg return '
      f'{result["avg_return"]:.2f} over {result["episodes"]:.0f} episodes '
      f'(bound {bound}), {result["env_steps"]:.0f} env steps in {wall:.1f} s '
      f'({result["env_steps"] / wall:.1f} env steps/s), sparsity '
      f'{result.get("global_sparsity")}')
  check(np.isfinite(result['avg_return']) and result['avg_return'] > bound,
        f'rl learning {agent_kind}: avg return {result["avg_return"]}')
  check(result['episodes'] > (10 if agent_kind == 'sac' else 5),
        f'rl learning {agent_kind}: {result["episodes"]} episodes')
  return dict(agent=agent_kind, env=env_name, config=kw, hidden=hidden,
              total_env_steps=steps, bound=bound, result=result, wall_s=wall,
              env_steps_per_s=result['env_steps'] / wall)


def _rl_preset(torch, card, path, steps):
  """Phase 25(c): a preset at its widths, `steps` env steps, through
  drivers.rl.run; its throughput, host syncs a chunk and peak memory on
  the agent's final state."""
  import numpy as np
  from rigl_tpu_torch.drivers import rl as rl_driver
  from rigl_tpu_torch.rl import dqn, ppo, sac
  preset, agent_kwargs = rl_driver.load_preset(path)
  preset.update(total_env_steps=steps, log_every=0)
  built = []
  classes = (dqn.SparseDQN, ppo.SparsePPO, sac.SparseSAC)
  origs = [c.train for c in classes]

  def keep(orig):
    def train(self, *a, **k):
      built.append(self)
      return orig(self, *a, **k)
    return train

  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  for c, o in zip(classes, origs):
    c.train = keep(o)
  try:
    result = rl_driver.run(agent_kwargs=agent_kwargs, progress_fn=None,
                           device='cuda', **preset)
  finally:
    for c, o in zip(classes, origs):
      c.train = o
  wall = time.perf_counter() - t0
  agent = built[0]
  holder = {'s': agent.state}
  if preset['agent'] == 'ppo':
    def rollout():
      holder['s'] = agent._rollout(holder['s'])[0]
    syncs = _count_syncs(torch, rollout) / agent.config.rollout_length
    measured = dict(rollout_syncs_per_env_step=syncs)
  else:
    measured = _rl_measure(torch, agent, holder, learn=False)
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f'rl {path} ({card}): {result["env_steps"]:.0f} env steps in '
      f'{wall:.1f} s ({result["env_steps"] / wall:.1f} env steps/s with '
      f'learning), avg return {result["avg_return"]:.2f}, sparsity '
      f'{result.get("global_sparsity")}; {measured}; peak {peak:.3f} GiB')
  check(result['env_steps'] == steps, f'rl {path}: env steps')
  check(np.isfinite(result['avg_return']), f'rl {path}: return')
  check(abs(result['global_sparsity'] - preset['end_sparsity']) <= 0.01,
        f'rl {path}: sparsity {result["global_sparsity"]}')
  check(measured.get('env_step_syncs', measured.get(
      'rollout_syncs_per_env_step')) == 0, f'rl {path}: syncs {measured}')
  return dict(card=card, preset=path, total_env_steps=steps, result=result,
              wall_s=wall, run_env_steps_per_s=result['env_steps'] / wall,
              peak_gib=peak, **measured)


def phase_rl(torch, device, card):
  """Phase 25: sparse RL through drivers.rl and the agents (module
  docstring, constants RL_*).  Returns its record."""
  t0 = time.perf_counter()
  atari = {Path(p).stem: _rl_atari(torch, device, card, p) for p in RL_ATARI}
  learning = [_rl_learning(torch, card, *spec) for spec in RL_LEARN]
  presets = {Path(p).stem: _rl_preset(torch, card, p, n)
             for p, n in RL_PRESETS}
  wall = time.perf_counter() - t0
  log(f'phase 25 wall time: {wall:.1f} s ({card})')
  return dict(card=card, atari=atari, learning=learning, presets=presets,
              wall_s=wall)


# ------------------------------------------ analysis and flop count (26) --
ANALYSIS_CONFIG = 'configs/lenet_rigl.json'
# The LeNet-5 run's cuts (the preset otherwise: batch 128, momentum 0.05,
# RigL every 100 steps, ERK 0.9, premask, static update steps, synthetic
# MNIST): 11719 steps -> 300, checkpoints every 100 batches and at the
# end (RigL's update batches leave the step behind: steps 99, 198, 297,
# 300).
ANALYSIS_OVERRIDES = ('train_steps=300', 'checkpoint_every=100',
                      'log_every=100')
ANALYSIS_LANCZOS = 32
ANALYSIS_METAINIT = 10
# Lanczos's extreme Ritz values lie inside the exact spectrum in exact
# arithmetic; both are float32 products of the same operator, so the
# slack is 1e-3 of the spectrum's largest magnitude.
ANALYSIS_RITZ_SLACK = 1e-3
# Interpolation at t = 0 / 1 against the checkpoint's own loss: (1 - t) a
# + t b at t = -2.8e-17 (linspace's 0) and 1.0 is a and b in float32.
ANALYSIS_END_RTOL = 1e-6
FLOPS_RN50 = ('resnet', dict(depth=50, num_classes=1000), (1, 224, 224, 3))


def phase_analysis(torch, device, card):
  """Phase 26: the analysis harness on a checkpointed Trainer run and the
  flop count (module docstring, constants ANALYSIS_*).  Returns its
  record."""
  import shutil
  import tempfile
  import numpy as np
  from rigl_tpu_torch.drivers import analysis as adriver
  from rigl_tpu_torch.drivers import train as train_driver
  from rigl_tpu_torch.models import registry
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.utils import flops
  t0 = time.perf_counter()
  tmp = tempfile.mkdtemp(prefix='chip_smoke_analysis_')
  rec = dict(card=card)
  try:
    run_dir = str(Path(tmp) / 'lenet')
    train = train_driver.main(
        ['--device=cuda', f'--config={ANALYSIS_CONFIG}',
         f'--output_dir={run_dir}']
        + [f'--override={o}' for o in ANALYSIS_OVERRIDES])
    trainer = adriver._load_trainer(run_dir, device='cuda')
    steps = adriver._manager(trainer).all_steps()
    log(f'analysis ({card}): {ANALYSIS_CONFIG} through drivers.train, '
        f'{train["batches"]} batches, checkpoints {steps}, eval loss '
        f'{train["eval_loss"]:.4f}, sparsity {train["global_sparsity"]:.4f}')
    check(len(steps) >= 3 and steps[-1] == 300,
          f'analysis: checkpoints {steps}')

    def timed(argv):
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      t = time.perf_counter()
      res = adriver.main(['--device=cuda', f'--run_dir={run_dir}'] + argv)
      torch.cuda.synchronize()
      return res, time.perf_counter() - t, \
          torch.cuda.max_memory_allocated() / 2 ** 30

    exact, exact_s, exact_gib = timed(
        ['--config=configs/lenet_hessian.json', f'--ckpt_steps={steps[-1]}'])
    lanczos, lanczos_s, lanczos_gib = timed(
        ['--config=configs/lenet_hessian.json',
         f'--lanczos_order={ANALYSIS_LANCZOS}'])
    e = exact['results'][0]
    lz = {r['step']: r for r in lanczos['results']}[steps[-1]]
    slack = ANALYSIS_RITZ_SLACK * max(abs(e['max_eig']), abs(e['min_eig']))
    log(f'  hessian exact at batch 60000, step {e["step"]}: n_active '
        f'{e["n_active"]}, eigenvalues [{e["min_eig"]:.6g}, '
        f'{e["max_eig"]:.6g}], trace {e["trace"]:.6g}; {exact_s:.1f} s, '
        f'peak {exact_gib:.2f} GiB ({card})')
    log(f'  lanczos order {ANALYSIS_LANCZOS} on {len(lanczos["results"])} '
        f'checkpoints: Ritz [{lz["min_eig"]:.6g}, {lz["max_eig"]:.6g}] at '
        f'step {steps[-1]} (slack {slack:.3g}); {lanczos_s:.1f} s, peak '
        f'{lanczos_gib:.2f} GiB')
    check(e['min_eig'] - slack <= lz['min_eig'] and
          lz['max_eig'] <= e['max_eig'] + slack,
          f'analysis: Ritz values {lz["min_eig"]}, {lz["max_eig"]} outside '
          f'[{e["min_eig"]}, {e["max_eig"]}]')
    check(len(lanczos['results']) == len(steps), 'analysis: lanczos steps')
    interp, interp_s, _ = timed(['--config=configs/lenet_interpolate.json'])
    pts = interp['points']
    batch = adriver._analysis_batch(trainer, 0)
    loss = adriver._loss_fn(trainer, batch)
    mgr = adriver._manager(trainer)
    ends = {}
    for t, step in ((0.0, interp['step_a']), (1.0, interp['step_b'])):
      state = mgr.restore(trainer.state, step=step)
      eff = masks_lib.apply_masks(state.params, state.sparse.masks)
      with torch.no_grad():
        want = float(loss(eff, state.batch_stats))
      got = min(pts, key=lambda p: abs(p['t'] - t))['loss']
      ends[t] = dict(step=step, loss=got, checkpoint_loss=want)
      check(abs(got - want) <= ANALYSIS_END_RTOL * abs(want),
            f'analysis: interpolation at t={t}: {got} vs {want}')
    log(f'  interpolate {interp["step_a"]} -> {interp["step_b"]}: '
        f'{len(pts)} points, losses '
        f'{[round(p["loss"], 4) for p in pts[::4]]} (every 4th), ends '
        f'equal to the checkpoints\' {ends}; {interp_s:.1f} s')
    check(len(pts) == 29 and all(np.isfinite(p['loss']) for p in pts),
          'analysis: interpolation points')
    meta, meta_s, meta_gib = timed(
        ['--mode=metainit', f'--metainit_steps={ANALYSIS_METAINIT}'])
    log(f'  metainit {meta["n_steps"]} steps: GQ {meta["gq_first"]:.5f} -> '
        f'{meta["gq_last"]:.5f}; {meta_s:.1f} s, peak {meta_gib:.2f} GiB')
    check(meta['n_steps'] == ANALYSIS_METAINIT and np.isfinite(
        meta['gq_last']) and meta['gq_last'] < meta['gq_first'],
          f'analysis: metainit {meta}')
    name, kw, shape = FLOPS_RN50
    counts = {}
    for dev in ('cuda', 'cpu'):
      model = registry.create_model(name, data_shape=shape[1:], device=dev,
                                    **kw)
      counts[dev] = flops.count_model(model, shape)
    log(f'  count_model RN50: dense flops {counts["cuda"]["dense_flops"]} '
        f'on the card, {counts["cpu"]["dense_flops"]} on the CPU; params '
        f'{counts["cuda"]["total_params"]}')
    check(counts['cuda'] == counts['cpu'], 'analysis: flop counts differ')
    rec.update(train=train, checkpoints=steps,
               hessian=dict(exact=e, exact_s=exact_s, exact_peak_gib=exact_gib,
                            lanczos=lanczos['results'], lanczos_s=lanczos_s,
                            lanczos_peak_gib=lanczos_gib, slack=slack,
                            batch=60000),
               interpolate=dict(points=pts, ends=ends, seconds=interp_s),
               metainit=dict(meta, seconds=meta_s, peak_gib=meta_gib),
               rn50_flops=dict(dense_flops=counts['cuda']['dense_flops'],
                               total_params=counts['cuda']['total_params']))
  finally:
    shutil.rmtree(tmp, ignore_errors=True)
  rec['wall_s'] = time.perf_counter() - t0
  log(f'phase 26 wall time: {rec["wall_s"]:.1f} s ({card})')
  torch.cuda.empty_cache()
  return rec


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: FAIL: no CUDA device', file=sys.stderr)
    return 1
  root = Path(__file__).resolve().parent
  if not all((root / 'rigl_tpu_torch' / 'csrc' / f'{name}.cu').is_file()
             for name in LIBRARIES):
    print('chip_smoke: FAIL: run from a checkout holding rigl_tpu_torch/',
          file=sys.stderr)
    return 1
  sys.path.insert(0, str(root))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device('cuda', 0)
  try:
    card = phase_device(torch)
    phase_build()
    serve_points, decode_floor = phase_kernel(torch, device)
    train_points = phase_train_kernels(torch, device)
    step_points = phase_step_kernels(torch, device)
    narrow_points = phase_narrow_tiles(torch, device)
    autograd_errs = phase_autograd(torch, device)
    packed, dense = build_models(torch, device)
    (serve_launches, decode_launches), logit_errs = phase_serve(
        torch, device, packed, dense)
    speed = phase_speed(torch, device, packed, dense)
    del packed, dense
    torch.cuda.empty_cache()
    train_launches, training = phase_train(torch, device)
    training['speed'] = phase_train_speed(torch, device)
    torch.cuda.empty_cache()
    flash_points = phase_flash(torch, device, torch.bfloat16)
    step_launches, train_step = phase_train_step(torch, device)
    lm_launches, lm = phase_lm(torch, device)
    tap_points_ = phase_tap_kernels(torch, device)
    tap_route = phase_tap_route(torch, device)
    wrn_launches, wrn = phase_wrn(torch, device)
    wrn['speed'] = phase_wrn_speed(torch, device)
    dense_points = phase_dense_kernels(torch, device)
    rn50_launches, rn50 = phase_rn50(torch, device)
    occ_launches, rn50['occupancy'] = phase_rn50_occupancy(torch, device)
    rn50_tap_launches, rn50['speed'] = phase_rn50_speed(torch, device)
    history_points, arms_launches = phase_history_kernels(torch, device)
    mlp_launches, block_mlp = phase_block_mlp(torch, device)
    flash_f32_points = phase_flash(torch, device, torch.float32)
    f32_launches, f32_step = phase_f32_train_step(torch, device)
    zoo = phase_zoo(torch, device, card)
    trainer_launches, trainer = phase_trainer(torch, device, card, root)
    moe_points, moe_launches, moe_serve_launches, moe = phase_moe_lm(
        torch, device, card)
    rl = phase_rl(torch, device, card)
    analysis = phase_analysis(torch, device, card)
  except SmokeFailure as e:
    print(f'chip_smoke: FAIL: {e}', file=sys.stderr)
    return 1
  check_names = sorted(m for m in sys.modules
                       if m.split('.')[0] in ('jax', 'flax', 'rigl_tpu'))
  if check_names:
    print(f'chip_smoke: FAIL: JAX modules loaded: {check_names}',
          file=sys.stderr)
    return 1
  src = 'rigl_tpu_torch/csrc/packed_mm.cu'
  tpu = 'rigl_tpu/ops/pallas/block_sparse_packed.py'
  packed_paths = {
      'fwd': {'serving': serve_launches, 'training': train_launches[0]},
      'dx': {'training': train_launches[1]}, 'dw': {}}
  for op, by_path in packed_paths.items():
    by_path.update(train_step=step_launches[op], lm=lm_launches[op],
                   moe_lm=moe_launches[op])
  # The Trainer's ResNet-50: its 1x1s on the tap route's mm branch run the
  # f32 forward / dx (packed_mm_ffma_kernel) and dw of packed_mm.cu in
  # dense storage; the tap entries below count its 3x3s.
  for op in ('fwd', 'dx'):
    packed_paths[op]['trainer_rn50'] = trainer_launches[f'tap_mm_{op}']
  f32_dw_paths = {'training': train_launches[2],
                  'f32_train_step': f32_launches['dw'],
                  'trainer_rn50': trainer_launches['tap_mm_dw']}
  kernels = [
      _kernel_entry(name, src, f'{tpu}:{line}',
                    sum(packed_paths[op].values()), packed_paths[op], points)
      for name, op, line, points in (
          ('packed_mm_fwd_kernel', 'fwd', 178,
           serve_points + train_points['fwd'] + step_points['fwd']
           + narrow_points['fwd']),
          ('packed_mm_dx_kernel', 'dx', 178,
           train_points['dx'] + step_points['dx'] + narrow_points['dx']),
          ('packed_dw_wgmma_kernel', 'dw', 345,
           [p for p in train_points['dw'] + step_points['dw']
            if p['dtype'] == 'bfloat16']))]
  kernels[-1].update(design=DW_DESIGN, reduction=DW_REDUCTION)
  for entry, op in zip(kernels, ('fwd', 'dx', 'dw')):
    # The MoE arm's expert shapes (phase 24), apart from the sums above.
    entry['moe_lm_points'] = [p for p in moe_points[op]
                              if p.get('branch') != 'decode']
  f32_dw = _kernel_entry(
      'packed_dw_3xtf32_kernel', src, f'{tpu}:345',
      sum(f32_dw_paths.values()), f32_dw_paths,
      [p for p in train_points['dw'] + step_points['dw']
       if p['dtype'] == 'float32'], dtype='float32')
  f32_dw.update(design=DW_F32_DESIGN, reduction=DW_REDUCTION,
                also_replaces=f'{tpu}:362 (_dw_panel_kernel)',
                not_on_paths={'wrn_training': (
                    'no f32 block dw: WRN-22-2\'s packed convs are all 3x3 '
                    '(tap_dw_kernel) and its 1x1 shortcuts dense convs')})
  kernels.append(f32_dw)
  for entry in kernels[:2]:
    entry['design'] = MM_DESIGN
  decode_paths = {'serving': decode_launches,
                  'moe_lm': moe_serve_launches['decode']}
  decode = _kernel_entry(
      'packed_mm_decode_kernel', src, f'{tpu}:178',
      sum(decode_paths.values()), decode_paths,
      [p for p in serve_points if p['branch'] == 'decode'])
  decode.update(design=DECODE_DESIGN, branch='decode (m <= 32)',
                library='torch.matmul on the unpacked W (cuBLAS)',
                floor_ms_by_slices=decode_floor,
                moe_lm_points=[p for op in ('fwd', 'dx')
                               for p in moe_points[op]
                               if p.get('branch') == 'decode'])
  kernels.insert(0, decode)
  flash_tpu = 'jax/experimental/pallas/ops/tpu/flash_attention.py'
  for name, op, line in (('flash_fwd_wgmma_kernel', 'fwd', 758),
                         ('flash_bwd_dkv_wgmma_kernel', 'dkv', 1121),
                         ('flash_bwd_dq_wgmma_kernel', 'dq', 1456)):
    n = step_launches[f'flash_{op}']
    entry = _kernel_entry(name, 'rigl_tpu_torch/csrc/flash_attn.cu',
                          f'{flash_tpu}:{line}', n, {'train_step': n},
                          flash_points[op])
    entry['called_from'] = 'rigl_tpu/models/packed_transformer.py:52'
    entry['design'] = FLASH_DESIGN[op]
    if op == 'fwd':
      entry['padded_head_dim'] = flash_points['padded']
    if op != 'fwd':
      entry['library'] = ('scaled_dot_product_attention backward (dq, dk '
                          'and dv in one call)')
    kernels.append(entry)
  conv_tpu = 'rigl_tpu/ops/pallas/block_sparse_conv.py'
  for i, (name, op, line) in enumerate((
      ('tap_conv_fwd: tap_conv_tf32_kernel, tap_conv_wgmma_kernel, '
       'packed_mm 1x1', 'fwd', 117),
      ('tap_conv_dx: tap_conv_tf32_kernel, tap_conv_wgmma_kernel, '
       'packed_mm 1x1', 'dx', 117),
      ('tap_dw_kernel', 'dw', 473))):
    by_path = {'wrn_training': wrn_launches[i],
               'rn50_tap': rn50_tap_launches['rigl_tap'][f'tap_{op}'],
               'rn50_tap3x3': rn50_tap_launches['rigl_tap3x3'][f'tap_{op}'],
               'trainer_rn50': (trainer_launches[f'tap_{op}']
                                - trainer_launches[f'tap_mm_{op}'])}
    entry = _tap_entry(name, 'rigl_tpu_torch/csrc/tap_conv.cu',
                       f'{conv_tpu}:{line}', by_path,
                       tap_points_[op] + tap_route.get(op, []))
    if op != 'dw':
      entry['also_replaces'] = f'{conv_tpu}:355 (_conv_kernel_v5, B5)'
      entry.update(design=TAP_DESIGN, tf32_design=TAP_TF32_DESIGN,
                   branches=TAP_BRANCH_KERNELS,
                   branch_by_path={'wrn_training': 'tf32', 'rn50_tap': 'mm',
                                   'rn50_tap3x3': 'mm (1x1), wgmma (3x3)',
                                   'trainer_rn50': 'tf32 (3x3; its 1x1s '
                                                   'in packed_mm_*_kernel)'},
                   rn50_route={k: v for k, v in tap_route['sums'].items()
                               if k.startswith(op)})
    else:
      entry.update(design=TAP_DW_DESIGN, reduction=TAP_DW_REDUCTION,
                   rn50_route={k: v for k, v in tap_route['sums'].items()
                               if k.startswith(op)})
    kernels.append(entry)
  v4_tpu = 'rigl_tpu/ops/pallas/block_sparse_v4.py:60 (_v4_kernel, B7)'
  v3_tpu = 'rigl_tpu/ops/pallas/block_sparse_v3.py:28 (_v3_kernel, B8)'
  occ_paths = dict(occ_launches, rn50_matmul=rn50_launches)
  for name, key, counter, replaces in (
      ('dense_mm_fwd_kernel (flat form)', 'v4_fwd', 'v4_fwd', v4_tpu),
      ('dense_mm_dx_kernel (flat form)', 'v4_dx', 'v4_dx', v4_tpu),
      ('dense_mm_fwd_kernel (index-list form)', 'v3_fwd', 'v3_fwd', v3_tpu),
      ('dense_mm_dx_kernel (index-list form)', 'v3_dx', 'v3_dx', v3_tpu),
      ('dense_dw_kernel', 'dw', 'dw_gather',
       'rigl_tpu/ops/pallas/block_sparse_v3.py:160 (_dw_v2_kernel, B9)')):
    by_path = {path: c[counter] for path, c in occ_paths.items()
               if c[counter]}
    entry = _kernel_entry(name, src, replaces, sum(by_path.values()),
                          by_path, dense_points[key])
    entry['kernel'] = ('the mm kernels, dense storage' if key != 'dw'
                       else 'the dw kernels, dense storage')
    if key != 'dw':
      entry['design'] = MM_DESIGN
    entry['library'] = 'torch.matmul on the masked dense W' if key != 'dw' \
        else 'torch.matmul xᵀ @ gy'
    if key == 'dw':
      entry.update(design=DW_DESIGN, reduction=DW_REDUCTION)
    kernels.append(entry)
  pallas = 'rigl_tpu/ops/pallas'
  v6_paths = {op: {'v6_mlp': mlp_launches['v6'].get(f'v6_{op}', 0),
                   'arms': arms_launches.get(f'v6_{op}', 0)}
              for op in ('fwd', 'dx')}
  v1_paths = {op: {'v1_mlp': mlp_launches['v1'][f'v1_{op}'],
                   'arms': arms_launches[f'v1_{op}']}
              for op in ('fwd', 'dx', 'dw')}
  for name, key, replaces, kernel, by_path in (
      ('dense_mm_fwd_kernel (gather form, B11)', 'gather',
       f'{pallas}/block_sparse_v2.py:44 (_gather_kernel)',
       'the mm kernels, dense storage', {'arms': arms_launches['gather']}),
      ("dense_mm_fwd_kernel (dense control, B9')", 'control',
       f'{pallas}/block_sparse_v3.py:261 (_dense_kernel)',
       'the mm kernels, dense storage, all blocks active',
       {'arms': arms_launches['control']}),
      ('dense_mm_fwd_kernel (v6 form, B10)', 'v6_fwd',
       f'{pallas}/block_sparse_v6.py:65 (_v6_kernel)',
       'the mm kernels, dense storage', v6_paths['fwd']),
      ('dense_mm_dx_kernel (v6 form, B10)', 'v6_dx',
       f'{pallas}/block_sparse_v6.py:65 (_v6_kernel, transposed packing)',
       'the mm kernels, dense storage, dx mode', v6_paths['dx']),
      ('dense_mm_fwd_kernel (v1 form, B12)', 'v1_fwd',
       f'{pallas}/block_sparse.py:40 (_fwd_kernel)',
       'the mm kernels, dense storage', v1_paths['fwd']),
      ('dense_mm_dx_kernel (v1 form, B12)', 'v1_dx',
       f'{pallas}/block_sparse.py:40 (_fwd_kernel on w.T)',
       'the mm kernels, dense storage, dx mode', v1_paths['dx']),
      ('dense_dw_kernel (v1 form, B12)', 'v1_dw',
       f'{pallas}/block_sparse.py:85 (_dw_kernel)',
       'the dw kernels, dense storage', v1_paths['dw'])):
    entry = _kernel_entry(name, src, replaces, sum(by_path.values()),
                          by_path, history_points[key])
    entry['kernel'] = kernel
    entry['library'] = ('torch.matmul xᵀ @ gy' if key == 'v1_dw' else
                        'torch.matmul on the masked dense W')
    if key != 'v1_dw':
      entry['design'] = MM_DESIGN
    if key == 'v1_dw':
      entry.update(design=DW_DESIGN, reduction=DW_REDUCTION)
    kernels.append(entry)
  for name, op, line, counter in (
      ('flash_fwd_f32_kernel', 'fwd', 758, 'flash_fwd_f32'),
      ('flash_bwd_dkv_f32_kernel', 'dkv', 1121, 'flash_dkv_f32'),
      ('flash_bwd_dq_f32_kernel', 'dq', 1456, 'flash_dq_f32')):
    n = f32_launches[counter]
    entry = _kernel_entry(name, 'rigl_tpu_torch/csrc/flash_attn.cu',
                          f'{flash_tpu}:{line} (float32)', n,
                          {'f32_train_step': n}, flash_f32_points[op],
                          dtype='float32')
    entry['called_from'] = 'rigl_tpu/models/packed_transformer.py:52'
    if op == 'fwd':
      entry.update(design=FLASH_F32_FWD_DESIGN,
                   padded_head_dim=flash_f32_points['padded'])
    else:
      entry['design'] = FLASH_F32_BWD_DESIGN[op]
      entry['library'] = ('scaled_dot_product_attention backward (dq, dk '
                          'and dv in one call)')
    kernels.append(entry)
  training['autograd_rel_err'] = autograd_errs
  record = {'card': card, 'kernels': kernels,
            'serving': dict(speed, **logit_errs), 'training': training,
            'train_step': train_step, 'lm': lm, 'wrn': wrn, 'rn50': rn50,
            'history': dict(v6_fwd_bwd=history_points['v6_fwd_bwd'],
                            arms_launches=arms_launches,
                            mlp_launches=mlp_launches, block_mlp=block_mlp),
            'f32_train_step': f32_step, 'zoo': zoo, 'trainer': trainer,
            'moe_lm': moe, 'rl': rl, 'analysis': analysis,
            'wall_s': time.perf_counter() - T0}
  log(f'chip_smoke wall time: {record["wall_s"]:.1f} s')
  print(json.dumps(record), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
