"""The plan of the forward / dx kernels, on the CPU.

ops/block_sparse_packed.py `mm_branch` names the branch of
csrc/packed_mm.cu that each forward / dx call launches (dispatch_mm, by
the branch's position in MM_BRANCHES), and `mm_tile` the wgmma branch's
tile (TN columns, KC contraction a stage; its position in MM_TILES).  The
wgmma branch addresses a W block by its (block-row, block-column) in a
4-D tensor map over W, which it derives from the entry's element offset
woffs (dense storage) or its packed slot, and x by (column in segment,
segment, row) in a 3-D one; boxes of 128 rows x KC of x (zeros past the
segment and past m), KC x TN (forward) or TN x KC (dx) of the block
(zeros outside it).  The kernels run only on a CUDA card
(test_torch_kernels_cuda.py); here the rules, the codes, the block
coordinates of every list form, and a plain walk of the wgmma branch's
tiles and boxes -- held against the plain versions that
test_torch_dense_block_mm.py and test_torch_packed_mm.py hold against JAX
-- are checked.  Both sides sum the same f32 products in another order:
1e-5 of the largest value.  No JAX here."""

import re
from pathlib import Path

import pytest
import torch

from rigl_tpu_torch.layers.packed_dense import random_occupancy
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.ops import block_sparse_v3 as tv3
from rigl_tpu_torch.ops import block_sparse_v4 as tv4
from rigl_tpu_torch.ops import block_sparse_v6 as tv6
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
ROWS = 128   # packed_mm_wgmma_kernel's output tile rows (MM_TILE_ROWS)
SOURCE = Path(tbsp.__file__).resolve().parent.parent / 'csrc' / 'packed_mm.cu'


@pytest.mark.parametrize('m,seg,dtype,want', [
    (1, 512, torch.bfloat16, 'decode'), (8, 512, torch.bfloat16, 'decode'),
    (32, 128, torch.float32, 'decode'), (32, 96, torch.bfloat16, 'decode'),
    (33, 512, torch.bfloat16, 'wgmma'), (1024, 128, torch.bfloat16, 'wgmma'),
    (33, 64, torch.bfloat16, 'wgmma'), (1000, 32, torch.bfloat16, 'wgmma'),
    (1024, 96, torch.bfloat16, 'wgmma'), (64, 8, torch.bfloat16, 'wgmma'),
    (33, 512, torch.float32, 'ffma'), (1024, 12, torch.float32, 'ffma')])
def test_mm_branch_rule(m, seg, dtype, want):
  """decode at m <= 32 in either dtype; above it ffma in f32 and wgmma in
  bf16, whatever the contraction per active (its boxes stop at the
  segment)."""
  assert tbsp.mm_branch(m, seg, dtype) == want


def test_mm_branch_codes_match_dispatch_mm():
  """MM_BRANCHES' positions are the codes of dispatch_mm's MmBranch."""
  enum = re.search(r'enum MmBranch \{([^}]*)\}', SOURCE.read_text()).group(1)
  codes = {name.lower(): int(v) for name, v in
           re.findall(r'kMm(\w+) = (\d+)', enum)}
  assert codes == {b: i for i, b in enumerate(tbsp.MM_BRANCHES)}


@pytest.mark.parametrize('out_w,seg,want', [
    (8, 8, (16, 16)), (16, 16, (16, 16)), (24, 24, (32, 32)),
    (40, 40, (64, 32)), (96, 96, (128, 32)), (8, 16, (16, 16)),
    (16, 8, (16, 16)), (16, 24, (16, 32)), (24, 16, (32, 16)),
    (40, 96, (64, 32)), (96, 40, (128, 32)), (128, 128, (128, 64)),
    (512, 512, (128, 64)), (64, 192, (64, 64)), (192, 64, (128, 64)),
    (16, 200, (16, 32)), (200, 16, (128, 16))])
def test_mm_tile_rule(out_w, seg, want):
  """The wgmma call's tile at blocks of 8, 16, 24, 40 and 96 (and the
  main paths' 128 and 512): TN the narrowest of 16 / 32 / 64 that holds
  the block-column, else 128; KC 16 for a segment of at most 16, 64 where
  64 divides it, else 32."""
  assert tbsp.MM_TILES[tbsp.mm_tile(out_w, seg)] == want
  assert tbsp.mm_plan('wgmma', out_w, seg) == tbsp.mm_tile(out_w, seg)
  for branch in ('decode', 'ffma'):
    assert tbsp.mm_plan(branch, out_w, seg) == 0


def test_mm_tiles_match_the_kernel():
  """MM_TILES' positions are the codes of launch_mm_wgmma's cases, each
  instantiating packed_mm_wgmma_kernel at that (TN, KC); the tile's rows
  are kMmRows; the main paths' tile, 128 x 64, is code 0."""
  text = SOURCE.read_text()
  body = re.search(r'cudaError_t launch_mm_wgmma\(const MmArgs& a, int tile\) '
                   r'\{(.*?)\n\}', text, re.S).group(1)
  cases = {int(c): (int(tn), int(kc)) for c, tn, kc in re.findall(
      r'case (\d+): return launch_mm_tile<kTransW, (\d+), (\d+)>', body)}
  assert cases == dict(enumerate(tbsp.MM_TILES))
  assert tbsp.MM_TILES[0] == (128, 64)
  rows = re.search(r'constexpr int kMmRows = (\d+);', text).group(1)
  assert int(rows) == tbsp.MM_TILE_ROWS == ROWS


def test_main_path_shapes_take_the_new_kernels():
  """Every forward / dx shape of the main paths above decode (blocks of
  512 and 128) takes the wgmma branch in bf16 and ffma in f32; serving's
  m = 8 takes decode."""
  for m, block in ((1024, (512, 512)), (2048, (512, 512)),
                   (6272, (128, 128)), (401408, (128, 128)),
                   (1024, (128, 128))):
    for seg in block:
      assert tbsp.mm_branch(m, seg, torch.bfloat16) == 'wgmma'
      assert tbsp.mm_branch(m, seg, torch.float32) == 'ffma'
  assert tbsp.mm_branch(8, 512, torch.bfloat16) == 'decode'


def _occupancy(nk, nn_, seed, empty=True):
  gen = torch.Generator().manual_seed(seed)
  n_act = max(1, (nk * nn_) // 2)
  occ = random_occupancy(gen, nk, nn_, n_act)
  if empty:   # an empty block-row and block-column
    occ[nk - 1, :] = 0
    occ[:, nn_ - 1] = 0
    occ[0, 0] = 1
  return occ


def _dense_lists(occ, block, n):
  """{(form, mode): DenseLists} of every dense-storage list form over a
  (K, N = n) weight: v3 / B11 / B12 (occupancy_lists), v4 (flat_lists), v6
  (entry_lists of pack_columns)."""
  nk, nn_ = occ.shape
  n_act = int(occ.sum())
  cols, rows = tv4.pack_flat_active(occ, n_act)
  packing = tv6.make_packing(occ, n_act)
  shape = (nk * block[0], n)
  return {
      ('v3', 'fwd'): tv3.occupancy_lists(occ, block, n),
      ('v3', 'dx'): tv3.occupancy_lists(occ, block, n, 'dx'),
      ('v4', 'fwd'): tv4.flat_lists(cols, rows, block, shape),
      ('v4', 'dx'): tv4.flat_lists(cols, rows, block, shape, 'dx'),
      ('v6', 'fwd'): tv6.entry_lists(*packing['fwd'], block, n, nn_),
      ('v6', 'dx'): tv6.entry_lists(*packing['bwd'], block, n, nk, 'dx')}


def _block_of(woff, block, n):
  """The (block-row, block-column) packed_mm_wgmma_kernel's producer
  derives from an entry's element offset, W (K, N = n) row-major."""
  bk, bn = block
  return woff // (bk * n), woff % n // bn


@pytest.mark.parametrize('block', [(128, 128), (64, 32), (32, 64), (16, 8)])
def test_block_coordinates_address_the_block_of_woffs(block):
  """For every entry of every dense list form (an empty block-row and
  column included), the coordinates the kernel derives from woffs name a
  block of the grid whose first element is woffs -- the block the plain
  version reads -- and it is the entry's: (seg, g) forward, (g, seg) for
  dx."""
  bk, bn = block
  occ = _occupancy(5, 4, bk + bn)
  nk, nn_ = occ.shape
  n = nn_ * bn
  for (form, mode), lists in _dense_lists(occ, block, n).items():
    beg, end, seg, woffs = (t.tolist() for t in lists)
    seen = set()
    for g, (b, e) in enumerate(zip(beg, end)):
      for a in range(b, e):
        br, bc = _block_of(woffs[a], block, n)
        assert 0 <= br < nk and 0 <= bc < nn_, (form, mode)
        assert br * bk * n + bc * bn == woffs[a], (form, mode)
        assert (br, bc) == ((seg[a], g) if mode == 'fwd' else (g, seg[a])), (
            form, mode)
        assert occ[br, bc], (form, mode)
        seen.add((br, bc))
    assert seen == {tuple(i) for i in occ.nonzero().tolist()}, (form, mode)


def test_packed_slots_address_the_packed_blocks():
  """Packed storage: the kernel reads block (slot, 0) of W viewed as
  (n_active, bk, 1, bn) -- slot a forward, slots[e] for dx -- and every
  slot lies inside the packing."""
  occ = _occupancy(6, 5, 3)
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  col_ptr, rows = packing.column_index('cpu')
  row_ptr, cols, slots = packing.row_index('cpu')
  assert int(col_ptr[-1]) == int(row_ptr[-1]) == n_act
  fwd = {}
  for j in range(occ.shape[1]):
    for a in range(int(col_ptr[j]), int(col_ptr[j + 1])):
      fwd[(int(rows[a]), j)] = a
  dx = {}
  for k in range(occ.shape[0]):
    for e in range(int(row_ptr[k]), int(row_ptr[k + 1])):
      dx[(k, int(cols[e]))] = int(slots[e])
  assert fwd == dx and sorted(fwd.values()) == list(range(n_act))


def _box(t, r0, c0, rows, cols):
  """t[r0:r0+rows, c0:c0+cols] with zeros past t's edges: a TMA box."""
  out = torch.zeros(rows, cols, dtype=t.dtype)
  part = t[r0:r0 + rows, c0:c0 + cols]
  out[:part.shape[0], :part.shape[1]] = part
  return out


def _seg_x_box(x, m0, s, k0, kc, seg_w):
  """x[m0 : m0 + 128, segment s from k0, kc wide] with zeros past m and
  past the segment: the x box of the kernel's 3-D tensor map."""
  out = torch.zeros(ROWS, kc, dtype=x.dtype)
  width = max(0, min(kc, seg_w - k0))
  part = x[m0:m0 + ROWS, s * seg_w + k0:s * seg_w + k0 + width]
  out[:part.shape[0], :part.shape[1]] = part
  return out


def _wgmma_walk(x, w4, lists, block, mode, slot_of=None, tile=None):
  """packed_mm_wgmma_kernel's walk in plain f32 at the tile (TN, KC) that
  mm_tile names (or `tile`): for each (column subtile, m-tile) and each
  (active, KC-deep chunk, the last ragged), x's box of its segment at
  (k0, seg_idx, m0) and the W box(es) of the active's block -- w4 is W as
  (block-row, bk, block-column, bn); the block (slot_of(a), 0) in packed
  storage, else from woffs -- summed into a 128 x TN tile, stored masked
  to rows < m and columns < the block's width.  Forward boxes of W
  columns (64 at TN >= 64, else 16) that start past the block are not
  loaded: stale, NaN here, feeding only masked columns."""
  bk, bn = block
  seg_w, out_w = (bn, bk) if mode == 'dx' else (bk, bn)
  tn, kc = tile or tbsp.MM_TILES[tbsp.mm_tile(out_w, seg_w)]
  wbox = 64 if tn >= 64 else 16
  n = w4.shape[2] * bn
  m = x.shape[0]
  beg, end, seg, woffs = (None if t is None else t.tolist() for t in lists)
  y = torch.full((m, len(beg) * out_w), float('nan'))
  for g in range(len(beg)):
    for n0 in range(0, out_w, tn):
      for m0 in range(0, m, ROWS):
        acc = torch.zeros(ROWS, tn)
        for a in range(beg[g], end[g]):
          br, bc = ((slot_of(a), 0) if slot_of else
                    _block_of(woffs[a], block, n))
          blk = w4[br, :, bc, :]
          for k0 in range(0, seg_w, kc):
            xb = _seg_x_box(x, m0, seg[a], k0, kc, seg_w)
            if mode == 'dx':
              acc += xb @ _box(blk, n0, k0, tn, kc).T
            else:
              wb = _box(blk, k0, n0, kc, tn)
              for b in range(0, tn, wbox):
                if b >= out_w - n0:   # not loaded: stale, masked columns
                  wb[:, b:b + wbox] = float('nan')
              acc += xb @ wb
        rows = min(ROWS, m - m0)
        cols = min(tn, out_w - n0)
        y[m0:m0 + rows, g * out_w + n0:g * out_w + n0 + cols] = (
            acc[:rows, :cols])
  return y


@pytest.mark.parametrize('block', [(128, 128), (64, 192), (192, 64)])
@pytest.mark.parametrize('m', [33, 200])
def test_wgmma_walk_matches_plain_dense(block, m):
  """The walk over every dense list form -- ragged m, an out_w that 128
  does not divide, bn = 64, an empty block-row and column -- gives the
  plain version's sums, exactly zero in the empty column."""
  bk, bn = block
  occ = _occupancy(3, 3, m)
  nk, nn_ = occ.shape
  gen = torch.Generator().manual_seed(m)
  w = torch.randn(nk * bk, nn_ * bn, generator=gen)
  w4 = w.view(nk, bk, nn_, bn)
  x = torch.randn(m, nk * bk, generator=gen)
  gy = torch.randn(m, nn_ * bn, generator=gen)
  for (form, mode), lists in _dense_lists(occ, block, nn_ * bn).items():
    a = gy if mode == 'dx' else x
    got = _wgmma_walk(a, w4, lists, block, mode)
    want = tv3.dense_mm_reference(a, w, lists, block, mode)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= RTOL * scale, (form, mode)
  y = _wgmma_walk(x, w4, _dense_lists(occ, block, nn_ * bn)[('v3', 'fwd')],
                  block, 'fwd')
  assert not y[:, (nn_ - 1) * bn:].any()


@pytest.mark.parametrize('block', [(128, 128), (64, 64), (192, 128)])
def test_wgmma_walk_matches_plain_packed(block):
  """The walk over packed storage -- W as (n_active, bk, 1, bn), block
  (a, 0) forward and (slots[e], 0) for dx -- gives packed_matmul's and
  packed_matmul_dx's plain versions."""
  bk, bn = block
  occ = _occupancy(3, 4, 7)
  nk, nn_ = occ.shape
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator().manual_seed(1)
  w = torch.randn(n_act, bk, bn, generator=gen)
  w4 = w.view(n_act, bk, 1, bn)
  x = torch.randn(70, nk * bk, generator=gen)
  gy = torch.randn(70, nn_ * bn, generator=gen)
  col_ptr, rows = packing.column_index('cpu')
  row_ptr, cols, slots = packing.row_index('cpu')
  fwd = (col_ptr[:-1], col_ptr[1:], rows, None)
  dx = (row_ptr[:-1], row_ptr[1:], cols, None)
  for a, lists, mode, slot_of, want in (
      (x, fwd, 'fwd', lambda e: e,
       tbsp.packed_matmul_reference(x, w, packing, block)),
      (gy, dx, 'dx', lambda e: int(slots[e]),
       tbsp.packed_matmul_dx_reference(gy, w, packing, block))):
    got = _wgmma_walk(a, w4, lists, block, mode, slot_of)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= RTOL * scale, mode


@pytest.mark.parametrize('tile', range(len(tbsp.MM_TILES)))
def test_wgmma_walk_at_every_tile_keeps_nan_in_its_segment(tile):
  """Every tile of the wgmma branch, forced, walked over packed storage at
  a ragged block (24, 40) -- a segment that no KC divides, columns no TN
  divides -- gives the plain versions' sums; with x's last segment and
  gy's last segment NaN, only the outputs that read them (the block-rows
  / block-columns of their actives) come out NaN: a box stops at its
  segment."""
  block = (24, 40)
  bk, bn = block
  occ = torch.tensor([[1, 0, 1], [1, 1, 0], [0, 1, 0]], dtype=torch.int32)
  nk, nn_ = occ.shape
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator().manual_seed(tile)
  w = torch.randn(n_act, bk, bn, generator=gen)
  w4 = w.view(n_act, bk, 1, bn)
  x = torch.randn(150, nk * bk, generator=gen)
  gy = torch.randn(150, nn_ * bn, generator=gen)
  col_ptr, rows = packing.column_index('cpu')
  row_ptr, cols, slots = packing.row_index('cpu')
  fwd = (col_ptr[:-1], col_ptr[1:], rows, None)
  dx = (row_ptr[:-1], row_ptr[1:], cols, None)
  forced = tbsp.MM_TILES[tile]
  for a, lists, mode, slot_of, plain in (
      (x, fwd, 'fwd', lambda e: e, tbsp.packed_matmul_reference),
      (gy, dx, 'dx', lambda e: int(slots[e]),
       tbsp.packed_matmul_dx_reference)):
    want = plain(a, w, packing, block)
    got = _wgmma_walk(a, w4, lists, block, mode, slot_of, forced)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= RTOL * scale, mode
    seg_w, out_w = (bk, bn) if mode == 'fwd' else (bn, bk)
    a = a.clone()
    a[:, -seg_w:] = float('nan')
    got = _wgmma_walk(a, w4, lists, block, mode, slot_of, forced)
    reads = occ[-1] if mode == 'fwd' else occ[:, -1]   # the last segment's
    for j in range(got.shape[1] // out_w):
      span = got[:, j * out_w:(j + 1) * out_w]
      assert bool(span.isnan().all() if reads[j] else
                  torch.isfinite(span).all()), (mode, j)
