#!/usr/bin/env python3
"""Device time of the f32 packed dw (rigl_tpu_torch packed_dw_cuda) at
blocks of (16, 16), the packed conv driver's default block, on one CUDA
card.

    python3 /path/to/scripts/f32_dw_narrow.py

Run from the root of a checkout: it imports rigl_tpu_torch from the
working directory, so the same script times two trees when it is run from
the root of each (in mirrored order, in one session, to compare them).
Shapes: the pointwise (1x1) convs of the driver's default model
(PackedConvNet, stem 32, stages 64:2,128:2,128:1, MNIST, batch 100) and of
PackedMobileNetV1's first three stages (CIFAR-10, batch 100), their active
blocks at ERK 0.8; then three long-m 1x1 shapes at WRN-22-2's widths and
batch 128, half the blocks active.  At each: the call as the tree plans it
(tile and split), its error against the plain version, the time of
torch.matmul xᵀ @ gy on the same inputs, and the bound (the larger of the
bytes over 3.35 TB/s and the active blocks' FLOPs over 495 / 3 TFLOP/s).
In a tree whose plan names dw tiles (dw_tile), it also times the call at
each f32 tile forced, at one and at the planned thread blocks an SM.
Prints the card's name and power limit, then one JSON object a shape.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from rigl_tpu_torch.layers.packed_dense import random_occupancy  # noqa: E402
from rigl_tpu_torch.ops import block_sparse_packed as bsp  # noqa: E402

BLOCK = (16, 16)
# (model and layer, m = batch x output pixels, cin, cout, active blocks).
SHAPES = (('convnet stage0.pw', 100 * 14 * 14, 32, 64, 4),
          ('convnet stage1.pw', 100 * 7 * 7, 64, 128, 8),
          ('convnet stage2.pw', 100 * 7 * 7, 128, 128, 10),
          ('mbv1 stage0.pw', 100 * 16 * 16, 32, 64, 8),
          ('mbv1 stage1.pw', 100 * 8 * 8, 64, 128, 32),
          ('mbv1 stage2.pw', 100 * 8 * 8, 128, 128, 59),
          ('wrn widths 16->32', 128 * 32 * 32, 16, 32, 1),
          ('wrn widths 32->64', 128 * 16 * 16, 32, 64, 4),
          ('wrn widths 64->128', 128 * 8 * 8, 64, 128, 16))
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 495e12 / 3
TOL = 1e-4   # of max(1, max |plain|), as the card tests hold it


def device_ms(fn, iters=50):
  """Device time of one fn() call: CUDA events around `iters` calls that
  the host queued while the device slept, so that the window holds the
  calls' device work and launch gaps, not the host's time to issue them."""
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  sleep_s = max(0.05, 2 * iters * (time.perf_counter() - t0))
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(int(sleep_s * 2e9))
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def variants():
  """{label: (tile code, blocks an SM)} of the tree's f32 tiles, each at
  its planned blocks an SM and at one; {} where the plan names no tile."""
  if not hasattr(bsp, 'dw_tile'):
    return {}
  out = {}
  for code, (tm, tn, _, per_sm) in enumerate(bsp.DW_TILES):
    if code:
      for n in sorted({per_sm, 1}):
        out[f'{tm}x{tn} at {n} an SM'] = (code, n)
  return out


def forced(run, plan, code, per_sm):
  """[device ms of run(), slices of plan()] with dw_plan at tile `code`
  and per_sm blocks an SM."""
  rule, tiles = bsp.dw_tile, bsp.DW_TILES
  try:
    bsp.dw_tile = lambda block, dtype: code
    bsp.DW_TILES = tuple(t if i != code else t[:3] + (per_sm,)
                         for i, t in enumerate(tiles))
    return [device_ms(run), plan().slices]
  finally:
    bsp.dw_tile, bsp.DW_TILES = rule, tiles


def main():
  if not torch.cuda.is_available():
    print('f32_dw_narrow: no CUDA device', file=sys.stderr)
    return 1
  print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip(), flush=True)
  dev = torch.device('cuda', 0)
  gen = torch.Generator().manual_seed(0)
  for name, m, cin, cout, n_act in SHAPES:
    nk, nn_ = cin // BLOCK[0], cout // BLOCK[1]
    occ = random_occupancy(gen, nk, nn_, n_act)
    packing = bsp.make_packing(occ, n_act)
    x = torch.randn(m, cin, generator=gen).to(dev)
    gy = torch.randn(m, cout, generator=gen).to(dev)
    w = torch.zeros(n_act, *BLOCK, device=dev)

    def run():
      return bsp.packed_dw_cuda(x, gy, w, packing, BLOCK)
    want = bsp.packed_dw_reference(x, gy, packing, BLOCK)
    err = float((run() - want).abs().max())
    tol = TOL * max(1.0, float(want.abs().max()))
    moved = 4 * (m * (int(occ.any(1).sum()) * BLOCK[0]
                      + int(occ.any(0).sum()) * BLOCK[1])
                 + n_act * BLOCK[0] * BLOCK[1])
    flops = 2.0 * m * n_act * BLOCK[0] * BLOCK[1]
    rec = dict(layer=name, m=m, cin=cin, cout=cout, n_active=n_act,
               max_abs_err=err, tol=tol, ms=device_ms(run),
               library_ms=device_ms(lambda: torch.matmul(x.T, gy)),
               bound_ms=max(moved / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
    def plan():
      return bsp.dw_plan(m, n_act, BLOCK, torch.float32,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    rec['slices'] = plan().slices
    if getattr(plan(), 'tile', None) is not None:
      rec['tile'] = list(bsp.DW_TILES[plan().tile][:2])
    rec['ms_and_slices_by_variant'] = {
        label: forced(run, plan, code, per_sm)
        for label, (code, per_sm) in variants().items()}
    print(json.dumps(rec), flush=True)
    if err > tol:
      print(f'f32_dw_narrow: {name}: error {err} > {tol}', file=sys.stderr)
      return 1
  return 0


if __name__ == '__main__':
  sys.exit(main())
