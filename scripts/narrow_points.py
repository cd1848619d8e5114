#!/usr/bin/env python3
"""Device time of the forward / dx kernels at narrow and ragged blocks, in
bf16, on one CUDA card: the packed matmul at block (96, 96) (m = 1024, K =
N = 3072) and at block (16, 16) (m = 25088, K = N = 512: MobileNetV1's
14 x 14 pointwise convs at batch 128), s = 0.8; and the tap conv at block
(8, 8) at WRN-22-2's g1_b1/conv1 shape (batch 128, 16 x 16, 64 -> 64, its
ERK-0.8 sparsity).

    python3 /path/to/scripts/narrow_points.py [LABEL]

Run from the root of a checkout: it imports rigl_tpu_torch from the
working directory, so the same script times two trees when it is run from
the root of each (in mirrored order, on one card, to compare them).
Its timing, plain-version and bound helpers are chip_smoke.py's, from the
script's own checkout, so both trees are measured alike.  At each point:
the branch the tree takes (and its tile, where the tree has mm_tile or
tap_tf32_tile), the error against the plain version (a failure exits 1),
the kernel's device time twice (CUDA events around 50 calls queued behind
a sleep), the library call's (torch.matmul on the unpacked W; cuDNN's
F.conv2d and conv2d_input, TF32 off) and the bound (the larger of the
bytes over 3.35 TB/s and the FLOPs over 989 TFLOP/s).  Prints the card's
name and power limit, then one JSON object a point.
"""

import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

_SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'chip_smoke.py')


def _smoke():
  spec = importlib.util.spec_from_file_location('smoke_helpers', _SMOKE)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _mm_points(cs, torch, device):
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.ops import block_sparse_packed as bsp
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(cs.SEED + 7)
  dtype = torch.bfloat16
  for block, width, m in (((96, 96), 3072, 1024), ((16, 16), 512, 25088)):
    nb = width // block[0]
    n_act = nb * nb - get_n_zeros(nb * nb, cs.SPARSITY)
    packing = bsp.make_packing(random_occupancy(gen, nb, nb, n_act), n_act)
    x = torch.randn(m, width, generator=gen).to(device, dtype)
    gy = torch.randn(m, width, generator=gen).to(device, dtype)
    w = (torch.randn(n_act, *block, generator=gen) / width ** 0.5).to(
        device, dtype)
    wd = bsp.unpack_dense(w, packing, block)
    ops = {'fwd': (lambda: bsp.packed_matmul_cuda(x, w, packing, block),
                   lambda: bsp.packed_matmul_reference(x, w, packing, block),
                   lambda: torch.matmul(x, wd)),
           'dx': (lambda: bsp.packed_matmul_dx_cuda(gy, w, packing, block),
                  lambda: bsp.packed_matmul_dx_reference(gy, w, packing,
                                                         block),
                  lambda: torch.matmul(gy, wd.T))}
    for op, (run, plain, library) in ops.items():
      rec = dict(point=f'mm {op} block {block} m={m}', op=op,
                 block=list(block), m=m, k=width, n=width, n_active=n_act,
                 branch=bsp.mm_branch(m, block[0], dtype),
                 library='torch.matmul on the unpacked W')
      if hasattr(bsp, 'mm_tile'):
        rec['tile'] = list(bsp.MM_TILES[bsp.mm_tile(block[1], block[0])])
      yield rec, run, plain, library, cs.bound(op, m, packing, block, dtype)


def _tap_points(cs, torch, device):
  import torch.nn.functional as F
  from torch.nn.grad import conv2d_input
  from rigl_tpu_torch.ops import block_sparse_conv as bsc
  from rigl_tpu_torch.sparsity.layer_sparsity import resolve_sparsity
  gen = torch.Generator().manual_seed(cs.SEED + 11)
  dtype, block = torch.bfloat16, (8, 8)
  k, n, hw, cin, cout = 3, 128, 16, 64, 64
  s = resolve_sparsity(cs._wrn_spec(), 'g1_b1/conv1/kernel')
  occ, n_act = cs._tap_occupancy(torch, gen, k, cin, cout, s, False, block)
  packing = dict(zip(('cols', 'rows', 'taps'),
                     bsc.pack_tap_active(occ, n_act)))
  index = bsc.tap_index(packing, (k, k, cin, cout), block)
  mask = occ.repeat_interleave(block[0], 1).repeat_interleave(block[1], 2)
  w = ((torch.randn(k, k, cin, cout, generator=gen) / (k * k * cin) ** 0.5)
       * mask.reshape(k, k, cin, cout)).to(device, dtype)
  x = torch.randn(n, hw, hw, cin, generator=gen).to(device, dtype)
  gy = torch.randn(n, hw, hw, cout, generator=gen).to(device, dtype)
  xc, gyc = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
  wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
  ops = {'fwd': (x, lambda: F.conv2d(xc, wc, padding=1), 'F.conv2d'),
         'dx': (gy, lambda: conv2d_input(xc.shape, wc, gyc, padding=1),
                'conv2d_input')}
  for op, (a, library, lib_name) in ops.items():
    rec = dict(point=f'tap {op} wrn g1_b1/conv1 block (8, 8)', op=op,
               block=list(block), n=n, hw=hw, cin=cin, cout=cout,
               sparsity=s, n_active=n_act,
               branch=bsc.tap_branch(k, k, *block, dtype), library=lib_name)
    if rec['branch'] == 'tf32':
      rec['tile'] = list(bsc.tap_tf32_tile(index, op, n * hw * hw,
                                           cs.sm_count(torch), dtype))
    yield (rec, lambda a=a, op=op: bsc.tap_conv_cuda(a, w, index, op),
           lambda a=a, op=op: bsc.tap_conv_reference(a, w, index, op),
           library, cs.tap_bound(op, n, hw, index, dtype))


def main():
  import torch
  if not torch.cuda.is_available():
    print('narrow_points: no CUDA device', file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cs = _smoke()
  label = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=False).stdout.strip()
  print(f'card: {card}', flush=True)
  device = torch.device('cuda')
  failed = False
  for points in (_mm_points, _tap_points):
    for rec, run, plain, library, bound_ in points(cs, torch, device):
      got, want = run(), plain()
      torch.cuda.synchronize()
      err = float((got.float() - want.float()).abs().max())
      scale = max(1.0, float(want.float().abs().max()))
      ok = (bool(torch.isfinite(got).all())
            and err <= cs.TOL['bfloat16'] * scale)
      failed |= not ok
      rec.update(tree=label, card=card, max_abs_err=err,
                 max_rel_err=err / scale, ok=ok,
                 ms=[cs.device_ms(run, 50), cs.device_ms(run, 50)],
                 library_ms=cs.device_ms(library, 50), bound_ms=bound_[0],
                 bound_by=bound_[1])
      print(json.dumps(rec), flush=True)
      del got, want
  return 1 if failed else 0


if __name__ == '__main__':
  sys.exit(main())
