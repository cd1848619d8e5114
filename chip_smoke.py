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
     packed_dw_3xtf32_kernel's shares summed.

Every dw point (phases 3, 12, 15 and 19) also logs how its kernel split
the reduction (ops/dw_split.py): S slices, the grid and the workspace's
bytes.  Each main path runs with the launch counts set to 0 just before
it and read just after.  The line before the last is the JSON record: `kernels`
(per kernel: the sums over its bf16 points, f32 for the f32 flash
kernels and the f32 dw, of ms, plain_ms, bound_ms and library_ms, its
launches on the main paths, and every point), `serving`, `training`,
`train_step`, `lm`, `wrn`, `rn50`, `history`, `f32_train_step` and the
script's wall time.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this script, it exits non-zero and prints
no result.
"""

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


def _product_ops(torch, x, gy, w, packing):
  """{op: (counter, kernel call, plain call, torch.matmul call)} for the
  forward, dx and packed dw of one packed layer on the same inputs."""
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  wd = bsp.unpack_dense(w, packing, BLOCK)
  return {
      'fwd': ('packed_mm_launches',
              lambda: bsp.packed_matmul(x, w, packing, BLOCK),
              lambda: bsp.packed_matmul_reference(x, w, packing, BLOCK),
              lambda: torch.matmul(x, wd)),
      'dx': ('packed_mm_dx_launches',
             lambda: bsp.packed_matmul_dx_cuda(gy, w, packing, BLOCK),
             lambda: bsp.packed_matmul_dx_reference(gy, w, packing, BLOCK),
             lambda: torch.matmul(gy, wd.T)),
      'dw': ('packed_dw_launches',
             lambda: bsp.packed_dw_cuda(x, gy, w, packing, BLOCK),
             lambda: bsp.packed_dw_reference(x, gy, packing, BLOCK, w.dtype),
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
  errs = {}
  for name, g in grads.items():
    layer = name.rsplit('.', 1)[0]
    sub = packed_model.get_submodule(layer)
    if hasattr(sub, 'packing'):
      got = unpack_dense(g, sub.packing, sub.block)
      want = plain[f'{layer}.d.kernel'] * unpack_dense(
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
  from rigl_tpu_torch.train.packed_lm import PackedLMConfig, PackedLMTrainer
  from rigl_tpu_torch.transforms.packed_training import repack_permutation
  tokens = synthetic_stream(200_000, seed=SEED)
  base = dict(vocab_size=LM_VOCAB, num_layers=TR_LAYERS, d_model=D_MODEL,
              d_ff=D_FF, num_heads=HEADS, seq_len=TR_SEQ, sparsity=SPARSITY,
              block=BLOCK, bm=512, dtype='bfloat16', learning_rate=1e-3,
              warmup_steps=5, batch_size=TR_BATCH, drop_fraction=0.3,
              drop_fraction_anneal='cosine', seed=SEED)

  def run(algo, steps, frequency, end):
    cfg = PackedLMConfig(algo=algo, train_steps=steps,
                         maskupdate_begin_step=0, maskupdate_end_step=end,
                         maskupdate_frequency=frequency, **base)
    tr = PackedLMTrainer(cfg, device=device)
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
      mu, nu = tr.adam_slots()
      grown = 0
      for name, pk in tr.packings.items():
        check(int(occ[name].sum()) == tr.params[name].shape[0],
              f'{algo} update: {name} count changed')
        new = (repack_permutation(old[name], pk) < 0).to(device)
        grown += int(new.sum())
        for t in (tr.params[name].detach(), mu[name], nu[name]):
          check(not bool(t[new].any()), f'{algo} update: grown slot of '
                f'{name} not zero')
      updates.append(dict(step=tr.step, ms=ms, grown=grown))
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
               blocks_grown=[u['grown'] for u in updates], losses=losses,
               step_ms=float(np.median(gaps)) * 1e3 if gaps else None,
               wall_s=wall)
    log(f'lm {algo}: {res["train_steps"]} steps in {wall:.2f} s, updates '
        f'at {rec["update_steps"]} ({[round(m, 1) for m in rec["update_ms"]]}'
        f' ms, grown {rec["blocks_grown"]}); step {rec["step_ms"]:.2f} ms '
        f'(median, host clock); loss {losses[0]:.4f} -> {losses[-1]:.4f}')
    check(all(np.isfinite(losses)), f'{algo}: non-finite loss')
    return tr, rec

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


def _rn50_step_vs_plain(torch, model, st, state, batch, routing):
  """One step's loss and per-tensor gradients through the kernels (the
  block packs of the paths in `routing`: the 'matmul' route's flat
  packings or the tap route's TapPacks) against the plain path
  (dense-times-mask execution on cuDNN), from the same state, statistics
  frozen; the gradients of masked tensors compared on their active
  entries."""
  from rigl_tpu_torch.models.common import frozen_batch_stats
  from rigl_tpu_torch.train import steps
  loss_fn = steps.make_loss_fn(model, 1e-4, 0.1)
  entries = {p: state.sparse.block_packs[p] for p in routing}
  out = {}
  with frozen_batch_stats(model):
    for name, e in (('kernel', entries), ('plain', None)):
      loss, _ = loss_fn(state.params, batch, e)
      grads = torch.autograd.grad(loss, list(state.params.values()))
      out[name] = (float(loss.detach()), dict(zip(state.params, grads)))
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

T0 = time.perf_counter()


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
    by_path.update(train_step=step_launches[op], lm=lm_launches[op])
  f32_dw_paths = {'training': train_launches[2],
                  'f32_train_step': f32_launches['dw']}
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
  decode = _kernel_entry(
      'packed_mm_decode_kernel', src, f'{tpu}:178', decode_launches,
      {'serving': decode_launches},
      [p for p in serve_points if p['branch'] == 'decode'])
  decode.update(design=DECODE_DESIGN, branch='decode (m <= 32)',
                library='torch.matmul on the unpacked W (cuBLAS)',
                floor_ms_by_slices=decode_floor)
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
               'rn50_tap3x3': rn50_tap_launches['rigl_tap3x3'][f'tap_{op}']}
    entry = _tap_entry(name, 'rigl_tpu_torch/csrc/tap_conv.cu',
                       f'{conv_tpu}:{line}', by_path,
                       tap_points_[op] + tap_route.get(op, []))
    if op != 'dw':
      entry['also_replaces'] = f'{conv_tpu}:355 (_conv_kernel_v5, B5)'
      entry.update(design=TAP_DESIGN, tf32_design=TAP_TF32_DESIGN,
                   branches=TAP_BRANCH_KERNELS,
                   branch_by_path={'wrn_training': 'tf32', 'rn50_tap': 'mm',
                                   'rn50_tap3x3': 'mm (1x1), wgmma (3x3)'},
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
            'f32_train_step': f32_step,
            'wall_s': time.perf_counter() - T0}
  log(f'chip_smoke wall time: {record["wall_s"]:.1f} s')
  print(json.dumps(record), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
