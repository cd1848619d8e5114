"""The decode branch's split plan, on the CPU.

ops/mm_split.py `decode_plan` cuts each output tile's contraction of
csrc/packed_mm.cu's `packed_mm_decode_kernel` (m <= 32) into S ranges of
whole chunks, one block of an S-block cluster each.  The kernel runs only
on a CUDA card (test_torch_kernels_cuda.py); here the plan at serving's
shapes and at the MLP's, its edges (an empty packing, empty columns,
columns shorter than S chunks), its constants against the kernel's
source, and a plain walk of the kernel's ranges, boxes and rank-order
reduction -- held against the plain versions that test_torch_packed_mm.py
holds against JAX -- are checked; and, with the same segment boxes, the
wgmma branch's ragged walk of a contraction in KC-deep stages (m > 32,
bf16).  Both sides sum the same f32 products
in another order: 1e-5 of the largest value.  No JAX here."""

import math
import re
from pathlib import Path

import pytest
import torch

from rigl_tpu_torch.layers.packed_dense import random_occupancy
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.ops import dw_split
from rigl_tpu_torch.ops import mm_split
from rigl_tpu_torch.sparsity.distributions import get_n_zeros

RTOL = 1e-5
SMS = 132   # an H100's SMs
SOURCE = Path(tbsp.__file__).resolve().parent.parent / 'csrc' / 'packed_mm.cu'
# The serving model (chip_smoke.py): d_model 2048, d_ff 8192, block (512,
# 512), s = 0.8; (K, N) of each projection.
SERVING = {'qkv': (2048, 6144), 'out': (2048, 2048), 'fc1': (2048, 8192),
           'fc2': (8192, 2048)}
BLOCK = (512, 512)
# S of each serving projection at m <= 8: the output block-columns are W's
# (forward) or its block-rows (dx), 8 tiles of 64 columns each; S doubles
# while tiles x S stays within 4 blocks on each of the 132 SMs.
SERVING_S = {('qkv', 'fwd'): 4, ('out', 'fwd'): 8, ('fc1', 'fwd'): 4,
             ('fc2', 'fwd'): 8, ('qkv', 'dx'): 8, ('out', 'dx'): 8,
             ('fc1', 'dx'): 8, ('fc2', 'dx'): 4}


def _serving_packing(layer, seed=0):
  kdim, ndim = SERVING[layer]
  nk, nn_ = kdim // BLOCK[0], ndim // BLOCK[1]
  n_act = nk * nn_ - get_n_zeros(nk * nn_, 0.8)
  gen = torch.Generator().manual_seed(seed)
  return tbsp.make_packing(random_occupancy(gen, nk, nn_, n_act), n_act)


def _plan(packing, block, m, dtype, mode, slices=None):
  """decode_plan's arguments as the wrappers pass them."""
  bk, bn = block
  nk, nn_ = packing.shape
  if mode == 'dx':
    return mm_split.decode_plan(m, bk, nk, bn, packing.longest('dx'), dtype,
                                SMS, slices)
  return mm_split.decode_plan(m, bn, nn_, bk, packing.longest('fwd'), dtype,
                              SMS, slices)


@pytest.mark.parametrize('mode', ['fwd', 'dx'])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m', [1, 8])
@pytest.mark.parametrize('layer', sorted(SERVING))
def test_serving_shapes_fill_a_wave_in_clusters_of_at_most_8(layer, m, dtype,
                                                             mode):
  """Serving's four projections at m = 1 and 8: S as SERVING_S says (the
  narrow layers -- fc2's 4 block-columns, out's -- get 8), the grid (S x
  column tiles, one m-tile of 8 rows), and clusters that fill at least a
  wave of the SMs and at most BLOCKS_PER_SM blocks an SM."""
  packing = _serving_packing(layer)
  plan = _plan(packing, BLOCK, m, dtype, mode)
  nk, nn_ = packing.shape
  groups = nn_ if mode == 'fwd' else nk
  col_tiles = groups * BLOCK[0] // mm_split.TILE
  assert plan.slices == SERVING_S[(layer, mode)]
  assert plan.slices in (1, 2, 4, 8) and plan.rows == 8
  assert plan.tiles == col_tiles
  assert plan.grid == (plan.slices * col_tiles, 1)
  assert SMS <= plan.tiles * plan.slices <= mm_split.BLOCKS_PER_SM * SMS
  assert plan.chunks >= plan.slices   # each rank of the longest has work
  assert plan.smem_bytes * 3 <= mm_split.SMEM_PER_SM
  assert plan.bytes_in_flight_per_sm(SMS) >= 2 * plan.stage_bytes


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_mlp_shape_at_m_1024_takes_one_slice(dtype):
  """At the MLP shape (4096 x 4096, block 512, s = 0.8) and m = 1024 the
  tiles alone fill the card: S = 1, 32 m-tiles of 32 rows."""
  nb = 8
  n_act = nb * nb - get_n_zeros(nb * nb, 0.8)
  gen = torch.Generator().manual_seed(4)
  packing = tbsp.make_packing(random_occupancy(gen, nb, nb, n_act), n_act)
  for mode in ('fwd', 'dx'):
    plan = _plan(packing, BLOCK, 1024, dtype, mode)
    assert plan.slices == 1 and plan.rows == 32
    assert plan.grid == (nb * 8, 32)


def test_empty_packing_and_empty_columns():
  """No active at all: longest 0, S = 1.  A grid with an empty block-column
  and block-row: longest is the fullest column's (row's) count, which the
  plan reads."""
  empty = tbsp.make_packing(torch.zeros(4, 3, dtype=torch.int32), 0)
  assert empty.longest('fwd') == empty.longest('dx') == 0
  for mode in ('fwd', 'dx'):
    plan = _plan(empty, (128, 128), 8, torch.bfloat16, mode)
    assert plan.slices == 1 and plan.chunks == 0
  occ = torch.tensor([[1, 0, 1], [1, 0, 0], [1, 0, 1], [0, 0, 0]],
                     dtype=torch.int32)
  packing = tbsp.make_packing(occ, int(occ.sum()))
  assert packing.longest('fwd') == 3 and packing.longest('dx') == 2
  plan = _plan(packing, (128, 128), 8, torch.bfloat16, 'fwd')
  assert plan.chunks == 3 * 2 and plan.slices == 4   # capped by 6 chunks


@pytest.mark.parametrize('seed', range(4))
def test_longest_counts_the_fullest_column_and_row(seed):
  gen = torch.Generator().manual_seed(seed)
  occ = random_occupancy(gen, 5, 7, 12)
  packing = tbsp.make_packing(occ, 12)
  assert packing.longest('fwd') == int(occ.sum(0).max())
  assert packing.longest('dx') == int(occ.sum(1).max())


@pytest.mark.parametrize('seg,dtype,most', [
    (64, torch.bfloat16, 1), (128, torch.bfloat16, 2),
    (64, torch.float32, 2), (16, torch.float32, 1)])
def test_longest_column_shorter_than_s_chunks_caps_s(seg, dtype, most):
  """One active a column: the plan gives no rank of it an empty range (S
  at most its chunks: 64 bf16 or 32 f32 a chunk), where the tiles alone
  would take S = 8."""
  plan = mm_split.decode_plan(8, 64, 1, seg, 1, dtype, SMS)
  assert plan.tiles == 1 and plan.chunks == most and plan.slices == most


def test_forced_slices_keep_the_grid_rule():
  for s in (1, 2, 4, 8):
    plan = mm_split.decode_plan(20, 512, 3, 512, 2, torch.bfloat16, SMS, s)
    assert plan.slices == s and plan.rows == 32
    assert plan.grid == (s * 3 * 8, 1)


def test_plan_constants_match_the_kernel():
  """TILE, STAGES, the W stage, the partial's row and the m-tile rule are
  the kernel's (csrc/packed_mm.cu), and smem_bytes is DecLayout's kSmem:
  the ring, the f32 partial, the partials received, the barriers."""
  src = SOURCE.read_text()
  consts = dict(re.findall(r'constexpr int (kDec\w+) = ([^;]+);', src))
  assert consts['kDecTile'].split()[0] == str(mm_split.TILE)
  assert consts['kDecStages'].split()[0] == str(mm_split.STAGES)
  assert consts['kDecWBytes'].split()[0] == str(mm_split.STAGE_W_BYTES)
  assert consts['kDecPartLd'].startswith('kDecTile + 4')
  assert 'a.m <= 8 ? 8 : a.m <= 16 ? 16 : 32' in src
  for m, n in ((1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (1024, 32)):
    assert mm_split.tile_rows(m) == n
  for rows in (8, 16, 32):
    stage = mm_split.STAGE_W_BYTES + rows * 128
    bars = (mm_split.STAGES * stage + rows * (mm_split.TILE + 4) * 4
            + rows * mm_split.TILE * 4)
    plan = mm_split.decode_plan(rows, 64, 1, 64, 1, torch.bfloat16, SMS)
    assert plan.smem_bytes == 1024 + bars + 2 * mm_split.STAGES * 8 + 8


def test_decode_slices_passes_the_plan(monkeypatch):
  """The wrappers' S: the plan's for the decode branch, 1 for the others
  (the SM count read from the device)."""
  monkeypatch.setattr(dw_split, 'sm_count', lambda device: SMS)
  packing = _serving_packing('fc2')
  nk, nn_ = packing.shape
  args = (8, 512, nn_, 512, packing.longest('fwd'), torch.bfloat16, 'cuda')
  assert tbsp.decode_slices('decode', *args) == 8
  for branch in ('wgmma', 'ffma'):
    assert tbsp.decode_slices(branch, *args) == 1


def _seg_box(a, m0, rows, s, k0, chunk, seg_w):
  """a[m0 : m0 + rows, segment s from k0, chunk wide] with zeros past m and
  past the segment: the x box of the kernel's 3-D tensor map."""
  out = torch.zeros(rows, chunk, dtype=a.dtype)
  width = max(0, min(chunk, seg_w - k0))
  part = a[m0:m0 + rows, s * seg_w + k0:s * seg_w + k0 + width]
  out[:part.shape[0], :part.shape[1]] = part
  return out


def _box(t, r0, c0, rows, cols):
  """t[r0:r0+rows, c0:c0+cols] with zeros past t's edges: a W box."""
  out = torch.zeros(rows, cols, dtype=t.dtype)
  part = t[r0:r0 + rows, c0:c0 + cols]
  out[:part.shape[0], :part.shape[1]] = part
  return out


def _decode_walk(a, w, packing, block, mode, chunk, slices):
  """packed_mm_decode_kernel's walk in plain f32: for each (m-tile, output
  block-column g, 64-column tile at n0), the tile's contraction -- g's
  actives in list order, each cut into `chunk`-deep chunks -- cut into
  `slices` ranges of whole chunks; each rank sums its range's products of
  the x box (zeros past the segment and past m) and the W box (zeros past
  the block) into a partial; the partials are added in rank order and
  stored masked to rows < m and columns < the block's width."""
  bk, bn = block
  seg_w, out_w = (bn, bk) if mode == 'dx' else (bk, bn)
  if mode == 'dx':
    ptr, seg_idx, slots = (t.tolist() for t in packing.row_index('cpu'))
  else:
    ptr, seg_idx = (t.tolist() for t in packing.column_index('cpu'))
    slots = list(range(len(seg_idx)))
  m = a.shape[0]
  rows = mm_split.tile_rows(m)
  per_active = -(-seg_w // chunk)
  y = torch.full((m, (len(ptr) - 1) * out_w), float('nan'))
  for g in range(len(ptr) - 1):
    total = (ptr[g + 1] - ptr[g]) * per_active
    per_rank = -(-total // slices)
    for n0 in range(0, out_w, mm_split.TILE):
      for m0 in range(0, m, rows):
        parts = []
        for q in range(slices):
          first = min(total, q * per_rank)
          acc = torch.zeros(rows, mm_split.TILE)
          for c in range(first, min(total, first + per_rank)):
            e = ptr[g] + c // per_active
            k0 = (c % per_active) * chunk
            xb = _seg_box(a, m0, rows, seg_idx[e], k0, chunk, seg_w)
            blk = w[slots[e]]
            if mode == 'dx':
              acc += xb @ _box(blk, n0, k0, mm_split.TILE, chunk).T
            else:
              acc += xb @ _box(blk, k0, n0, chunk, mm_split.TILE)
          parts.append(acc)
        tile = parts[0]
        for p in parts[1:]:
          tile = tile + p
        r = min(rows, m - m0)
        cols = min(mm_split.TILE, out_w - n0)
        y[m0:m0 + r, g * out_w + n0:g * out_w + n0 + cols] = tile[:r, :cols]
  return y


@pytest.mark.parametrize('slices', [1, 2, 4, 8])
@pytest.mark.parametrize('block,dtype', [((128, 128), torch.bfloat16),
                                         ((64, 32), torch.bfloat16),
                                         ((16, 8), torch.float32),
                                         ((96, 64), torch.float32)])
@pytest.mark.parametrize('m', [5, 31])
def test_decode_walk_matches_plain(m, block, dtype, slices):
  """The walk at every S -- columns with fewer chunks than S (ranks with
  empty ranges join the sum), an empty block-row and column, a segment
  narrower than a chunk, ragged m -- gives the plain versions' sums,
  exactly zero in the empty column."""
  bk, bn = block
  occ = torch.tensor([[1, 0, 1, 0], [1, 0, 0, 1], [1, 0, 1, 1],
                      [0, 0, 0, 0]], dtype=torch.int32)
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator().manual_seed(m + bk)
  w = torch.randn(n_act, bk, bn, generator=gen)
  x = torch.randn(m, 4 * bk, generator=gen)
  gy = torch.randn(m, 4 * bn, generator=gen)
  chunk = mm_split.CHUNK[dtype]
  for a, mode, want in (
      (x, 'fwd', tbsp.packed_matmul_reference(x, w, packing, block)),
      (gy, 'dx', tbsp.packed_matmul_dx_reference(gy, w, packing, block))):
    got = _decode_walk(a, w, packing, block, mode, chunk, slices)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= RTOL * scale, mode
  y = _decode_walk(x, w, packing, block, 'fwd', chunk, slices)
  assert not y[:, bn:2 * bn].any()


@pytest.mark.parametrize('mode', ['fwd', 'dx'])
def test_decode_walk_keeps_a_nonfinite_segment_in_its_columns(mode):
  """A NaN in one segment of x (gy for dx) reaches only the output
  block-columns whose actives read that segment: the x box stops at its
  segment, so no other column multiplies it, even by the zeros past a
  block."""
  block = (64, 32)
  occ = torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 0]], dtype=torch.int32)
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator().manual_seed(3)
  w = torch.randn(n_act, *block, generator=gen)
  seg_w = block[1] if mode == 'dx' else block[0]
  out_w = block[0] if mode == 'dx' else block[1]
  a = torch.randn(5, 3 * seg_w, generator=gen)
  a[2, 1 * seg_w + 7] = float('nan')   # segment 1, row 2
  y = _decode_walk(a, w, packing, block, mode, 64, 4)
  reads = occ[:, 1] if mode == 'dx' else occ[1]   # groups reading seg 1
  for g in range(3):
    cols = y[:, g * out_w:(g + 1) * out_w]
    assert bool(torch.isnan(cols[2]).all()) == bool(reads[g]), g
    assert bool(torch.isfinite(cols[[0, 1, 3, 4]]).all()), g
    if not reads[g]:
      assert bool(torch.isfinite(cols).all()), g


@pytest.mark.parametrize('seg', [8, 16, 24, 40, 96, 200])
@pytest.mark.parametrize('mode', ['fwd', 'dx'])
def test_wgmma_ragged_chunks_match_plain(seg, mode):
  """packed_mm_wgmma_kernel's contraction walk at a segment of `seg`: each
  active's segment in KC-deep stages (KC from mm_tile: 16, 32 or 64; the
  last stage ragged), x's box through the 3-D map (_seg_box: zeros past
  the segment) times the W block's KC rows (zeros past the block), gives
  the plain product; with every other segment of x NaN, the sum is the
  same, finite: no box reads past its segment."""
  out_w = 24
  block = (seg, out_w) if mode == 'fwd' else (out_w, seg)
  _, kc = tbsp.MM_TILES[tbsp.mm_tile(out_w, seg)]
  assert kc == (16 if seg <= 16 else 64 if seg % 64 == 0 else 32)
  gen = torch.Generator().manual_seed(seg)
  occ = torch.tensor([[1, 1], [0, 1], [1, 1]], dtype=torch.int32)
  if mode == 'dx':
    occ = occ.T.contiguous()
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  w = torch.randn(n_act, *block, generator=gen)
  n_seg = occ.shape[0] if mode == 'fwd' else occ.shape[1]
  a = torch.randn(200, n_seg * seg, generator=gen)
  if mode == 'fwd':
    ptr, seg_idx = (t.tolist() for t in packing.column_index('cpu'))
    slots = list(range(n_act))
    want = tbsp.packed_matmul_reference(a, w, packing, block)
  else:
    ptr, seg_idx, slots = (t.tolist() for t in packing.row_index('cpu'))
    want = tbsp.packed_matmul_dx_reference(a, w, packing, block)
  scale = max(1.0, float(want.abs().max()))
  for g in range(len(ptr) - 1):
    total = torch.zeros(a.shape[0], out_w)
    for s_keep in range(n_seg):   # the segment left finite
      a_nan = a.clone()
      for s in range(n_seg):
        if s != s_keep:
          a_nan[:, s * seg:(s + 1) * seg] = float('nan')
      acc = torch.zeros(a.shape[0], out_w)
      for e in range(ptr[g], ptr[g + 1]):
        if seg_idx[e] != s_keep:
          continue
        blk = w[slots[e]] if mode == 'fwd' else w[slots[e]].T
        for k0 in range(0, seg, kc):
          xb = _seg_box(a_nan, 0, a.shape[0], seg_idx[e], k0, kc, seg)
          acc += xb @ _box(blk, k0, 0, kc, out_w)
      assert bool(torch.isfinite(acc).all()), (g, s_keep)
      total += acc
    got = total.to(want.dtype)
    assert float((got - want[:, g * out_w:(g + 1) * out_w]).abs().max()) <= (
        RTOL * scale), g


def test_bytes_in_flight_per_sm():
  """The figure phase 3a prints: blocks an SM (within shared memory) x the
  stages a block fills x a stage's bytes."""
  plan = mm_split.decode_plan(8, 512, 4, 512, 4, torch.bfloat16, SMS)
  assert plan.slices == 8 and plan.grid == (256, 1)
  per_sm = math.ceil(256 / SMS)
  stages = min(mm_split.STAGES, math.ceil(plan.chunks / 8))
  assert plan.bytes_in_flight_per_sm(SMS) == per_sm * stages * (8192 + 1024)
