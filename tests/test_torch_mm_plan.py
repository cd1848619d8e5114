"""The plan of the forward / dx kernels, on the CPU.

ops/block_sparse_packed.py `mm_branch` names the branch of
csrc/packed_mm.cu that each forward / dx call launches (dispatch_mm, by
the branch's position in MM_BRANCHES).  The wgmma branch addresses a W
block by its (block-row, block-column) in a 4-D tensor map over W, which
it derives from the entry's element offset woffs (dense storage) or its
packed slot; boxes of 128 rows x 64 of x and 64 x 64 (forward) or 128 x
64 (dx) of the block, zeros outside x and outside the block.  The kernels
run only on a CUDA card (test_torch_kernels_cuda.py); here the rule, the
codes, the block coordinates of every list form, and a plain walk of the
wgmma branch's tiles and boxes -- held against the plain versions that
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

RTOL = 1e-5
TILE, CHUNK = 128, 64   # packed_mm_wgmma_kernel's output tile and box depth
SOURCE = Path(tbsp.__file__).resolve().parent.parent / 'csrc' / 'packed_mm.cu'


@pytest.mark.parametrize('m,seg,dtype,want', [
    (1, 512, torch.bfloat16, 'decode'), (8, 512, torch.bfloat16, 'decode'),
    (32, 128, torch.float32, 'decode'), (32, 96, torch.bfloat16, 'decode'),
    (33, 512, torch.bfloat16, 'wgmma'), (1024, 128, torch.bfloat16, 'wgmma'),
    (33, 64, torch.bfloat16, 'wgmma'), (1000, 32, torch.bfloat16, 'tiled'),
    (1024, 96, torch.bfloat16, 'tiled'), (64, 8, torch.bfloat16, 'tiled'),
    (33, 512, torch.float32, 'ffma'), (1024, 12, torch.float32, 'ffma')])
def test_mm_branch_rule(m, seg, dtype, want):
  """decode at m <= 32 in either dtype; above it ffma in f32, wgmma in
  bf16 where 64 divides the contraction per active, tiled otherwise."""
  assert tbsp.mm_branch(m, seg, dtype) == want


def test_mm_branch_codes_match_dispatch_mm():
  """MM_BRANCHES' positions are the codes of dispatch_mm's MmBranch."""
  enum = re.search(r'enum MmBranch \{([^}]*)\}', SOURCE.read_text()).group(1)
  codes = {name.lower(): int(v) for name, v in
           re.findall(r'kMm(\w+) = (\d+)', enum)}
  assert codes == {b: i for i, b in enumerate(tbsp.MM_BRANCHES)}


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


def _wgmma_walk(x, w4, lists, block, mode, slot_of=None):
  """packed_mm_wgmma_kernel's walk in plain f32: for each (column
  subtile, m-tile) and each (active, 64-deep chunk), x's box at (seg_idx
  * seg + k0, m0) and the W box(es) of the active's block -- w4 is W as
  (block-row, bk, block-column, bn); the block (slot_of(a), 0) in packed
  storage, else from woffs -- summed into a 128 x 128 tile, stored masked
  to rows < m and columns < the block's width."""
  bk, bn = block
  seg_w, out_w = (bn, bk) if mode == 'dx' else (bk, bn)
  n = w4.shape[2] * bn
  m = x.shape[0]
  beg, end, seg, woffs = (None if t is None else t.tolist() for t in lists)
  y = torch.full((m, len(beg) * out_w), float('nan'))
  for g in range(len(beg)):
    for n0 in range(0, out_w, TILE):
      for m0 in range(0, m, TILE):
        acc = torch.zeros(TILE, TILE)
        for a in range(beg[g], end[g]):
          br, bc = ((slot_of(a), 0) if slot_of else
                    _block_of(woffs[a], block, n))
          blk = w4[br, :, bc, :]
          for k0 in range(0, seg_w, CHUNK):
            xb = _box(x, m0, seg[a] * seg_w + k0, TILE, CHUNK)
            if mode == 'dx':
              acc += xb @ _box(blk, n0, k0, TILE, CHUNK).T
            else:
              wb = _box(blk, k0, n0, CHUNK, TILE)
              if out_w - n0 <= CHUNK:   # the second box is not loaded:
                wb[:, CHUNK:] = float('nan')   # stale, masked columns
              acc += xb @ wb
        rows = min(TILE, m - m0)
        cols = min(TILE, out_w - n0)
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
