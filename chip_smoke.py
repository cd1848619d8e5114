#!/usr/bin/env python3
"""Smoke run of rigl_tpu_torch's serving path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the JAX
package.  Phases, each fatal on failure:

  1. device: torch / CUDA versions, the card's name and power limit;
  2. build: compiles rigl_tpu_torch/csrc/packed_mm.cu with nvcc (into the
     git-ignored rigl_tpu_torch/_build/) and prints ptxas' report;
  3. kernel vs plain: the packed matmul kernel against its plain PyTorch
     version at the serving model's four layer shapes (s = 0.8, block
     (512, 512)), at m = 8 (decode) and m = 1024 (prefill) in bf16, plus
     f32 at one shape; errors, device times of both (torch.profiler), the
     kernel's call-loop time and the host time to issue one call;
  4. serving: a 4-layer d_model 2048 / d_ff 8192 / 16-head, vocab 256 bf16
     PackedTransformer with seeded random occupancy and weights serves a
     greedy request (batch 8, prompt 128, 128 steps; the kernel launch
     count must grow by exactly 4 layers x 4 projections x 128 passes)
     and a left-padded mixed-length sampled
     request; its logits are held against the plain path (the dense twin
     holding the unpacked kernels) and against its own full causal
     forward;
  5. speed: us/token of the packed model and the dense twin at batch 8
     and 1, and the device-busy share of a batch-8 request.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
LAYERS, D_MODEL, D_FF, HEADS, VOCAB = 4, 2048, 8192, 16, 256
SPARSITY, BLOCK = 0.8, (512, 512)
BATCH, PROMPT, STEPS = 8, 128, 128
MAX_LEN = PROMPT + STEPS
# Kernel vs plain: both sum in f32 and round once, so bf16 outputs differ by
# at most a few bf16 ulps (2^-8 relative) from the order of the f32 sums;
# f32 outputs by f32 summation order over K <= 8192 terms.
TOL = {'bfloat16': 2e-2, 'float32': 1e-4}   # x max(1, max |plain|)
# Whole-model logits, kernel path vs the plain path, bf16: rounding points
# differ in every projection of 4 layers; relative to max |logit|.
LOGIT_RTOL = 5e-2


class SmokeFailure(Exception):
  pass


def check(cond, msg):
  if not cond:
    raise SmokeFailure(msg)


def log(msg):
  print(msg, flush=True)


def device_ms(fn, iters):
  """Device time of one fn() call: the sum of the kernel times that
  torch.profiler records over `iters` calls, after a warm-up, / iters."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  total_us = sum(e.self_device_time_total for e in prof.key_averages())
  check(total_us > 0, 'the profiler recorded no device time')
  return total_us / 1e3 / iters


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
  from rigl_tpu_torch.ops import _build
  t0 = time.perf_counter()
  so = _build.build('packed_mm')
  _build.load('packed_mm')
  log(f'build: {so.relative_to(Path(__file__).resolve().parent)} in '
      f'{time.perf_counter() - t0:.2f} s')
  for line in so.with_suffix('.log').read_text().splitlines():
    if 'registers' in line or 'spill' in line or 'error' in line:
      log(f'  ptxas: {line.strip()}')


def layer_shapes():
  return {'qkv': (D_MODEL, 3 * D_MODEL), 'out': (D_MODEL, D_MODEL),
          'fc1': (D_MODEL, D_FF), 'fc2': (D_FF, D_MODEL)}


def phase_kernel(torch, device):
  """Kernel vs plain at the slice's shapes; returns per-point records."""
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
    before = bsp.packed_mm_launches
    got = bsp.packed_matmul(x, w, packing, BLOCK)
    torch.cuda.synchronize()
    check(bsp.packed_mm_launches == before + 1,
          f'{name} m={m}: the kernel was not launched')
    want = bsp.packed_matmul_reference(x, w, packing, BLOCK)
    check(bool(torch.isfinite(got).all()), f'{name} m={m}: non-finite')
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = TOL[str(dtype).split('.')[-1]] * scale
    empty = (packing.column_index('cpu')[0].diff() == 0).nonzero().flatten()
    zero_cols = all(not bool(got[:, int(j) * bn:(int(j) + 1) * bn].any())
                    for j in empty)
    ms = device_ms(lambda: bsp.packed_matmul(x, w, packing, BLOCK), 20)
    plain_ms = device_ms(
        lambda: bsp.packed_matmul_reference(x, w, packing, BLOCK), 20)
    loop_ms = time_ms(lambda: bsp.packed_matmul(x, w, packing, BLOCK), 20)
    issue_ms = host_ms(lambda: bsp.packed_matmul(x, w, packing, BLOCK), 20)
    rec = dict(layer=name, m=m, dtype=str(dtype).split('.')[-1], k=kdim,
               n=ndim, n_active=n_act, empty_columns=len(empty),
               max_abs_err=err, max_rel_err=err / scale, tol=tol, ms=ms,
               plain_ms=plain_ms, loop_ms=loop_ms, host_ms=issue_ms)
    log(f'kernel {name:3s} m={m:4d} {rec["dtype"]:8s} actives {n_act:2d} '
        f'empty cols {len(empty):2d}  max|err| {err:.3e} (rel '
        f'{err / scale:.3e}, tol {tol:.3e})  device: kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms  call loop {loop_ms:.4f} ms  host '
        f'{issue_ms:.4f} ms')
    check(err <= tol, f'{name} m={m} {dtype}: error {err} > {tol}')
    check(zero_cols, f'{name} m={m}: an empty column is not zero')
    records.append(rec)
  return records


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

  bsp.packed_mm_launches = 0
  t0 = time.perf_counter()
  out = generate(twin, prompt, STEPS)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = bsp.packed_mm_launches
  expect = LAYERS * 4 * STEPS
  log(f'request 1 (greedy, batch {BATCH}, prompt {PROMPT}, {STEPS} steps): '
      f'{dt:.3f} s, packed_mm launches {launches} (expected {expect})')
  check(launches == expect, f'launches {launches} != {expect}')
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
  return launches, dict(prefill_rel_err=err_plain / scale,
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
        for e in stats[:6]:
          log(f'    {e.self_device_time_total / 1e3:8.2f} ms '
              f'{e.count:6d} x {e.key[:90]}')
  return rows


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: FAIL: no CUDA device', file=sys.stderr)
    return 1
  root = Path(__file__).resolve().parent
  if not (root / 'rigl_tpu_torch' / 'csrc' / 'packed_mm.cu').is_file():
    print('chip_smoke: FAIL: run from a checkout holding rigl_tpu_torch/',
          file=sys.stderr)
    return 1
  sys.path.insert(0, str(root))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  device = torch.device('cuda', 0)
  try:
    phase_device(torch)
    phase_build()
    points = phase_kernel(torch, device)
    packed, dense = build_models(torch, device)
    launches, logit_errs = phase_serve(torch, device, packed, dense)
    speed = phase_speed(torch, device, packed, dense)
  except SmokeFailure as e:
    print(f'chip_smoke: FAIL: {e}', file=sys.stderr)
    return 1
  check_names = sorted(m for m in sys.modules
                       if m.split('.')[0] in ('jax', 'flax', 'rigl_tpu'))
  if check_names:
    print(f'chip_smoke: FAIL: JAX modules loaded: {check_names}',
          file=sys.stderr)
    return 1
  bf16 = [p for p in points if p['dtype'] == 'bfloat16']
  kernels = [{
      'name': 'packed_mm_fwd_kernel', 'route': 'cuda',
      'source': 'rigl_tpu_torch/csrc/packed_mm.cu',
      'replaces': 'rigl_tpu/ops/pallas/block_sparse_packed.py:178',
      'launches': launches,
      'max_abs_err': max(p['max_abs_err'] for p in points),
      'ms': sum(p['ms'] for p in bf16),
      'plain_ms': sum(p['plain_ms'] for p in bf16),
      'points': points}]
  record = {'kernels': kernels, 'serving': dict(speed, **logit_errs)}
  print(json.dumps(record), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
