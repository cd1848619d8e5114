"""The split of the dw kernels' reduction, on the CPU.

ops/dw_split.py plans how packed_dw_kernel's m-sum and tap_dw_kernel's
pixel sum are cut into slices of whole chunks; block_sparse_conv groups a
tap index's dw entries by (input block, output block) for the tap dw
kernel.  The kernels run only on a CUDA card (test_torch_kernels_cuda.py);
here the plan and the groups are checked, and a plain walk of the groups
and slices -- each slice's f32 partial, added in slice order, as the
kernels' reduction adds them -- is held against the plain versions that
test_torch_tap_conv.py and test_torch_dense_block_mm.py hold against JAX.
Both sides sum the same f32 products in another order: 1e-5 of the
largest value.  No JAX here."""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from rigl_tpu_torch.ops import block_sparse_conv as tbsc
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.ops import block_sparse_v3 as tv3
from rigl_tpu_torch.ops import dw_split
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5
SMS = 132   # an H100's SM count; the kernels read the card's own
MAX_TAPS = sorted(set(tbsc.TAP_GROUP_TAPS.values())
                  | {tbsc.TAP_SPARSE_TAPS})   # bf16's, f32's, sparse


def _slice_bounds(length, chunk, slices):
  """[(begin, end)] of every slice in slice order, as the kernels walk
  them: slice s starts at s * dw_split.slice_rows."""
  rows = dw_split.slice_rows(length, chunk, slices)
  return [(s * rows, min(length, (s + 1) * rows)) for s in range(slices)]


# --------------------------------------------------------------- the plan --
PLAN_CASES = [
    # (tiles, length, chunk): the MLP's 13 blocks of 512 at m = 1024 in
    # bf16 (16 tiles each), in f32 on the FMA kernel of earlier designs
    # (64 each, chunks of 16) and on the 3xTF32 kernel (16 each, chunks of
    # 32); RN50's largest 1x1 call (2
    # blocks of 128 over 401408 rows) and its smallest (16 blocks over
    # 6272); WRN-22-2's first group on the tap kernel (4 groups of one
    # tile over 131072 pixels); and short or ragged sums.
    (13 * 16, 1024, 64), (13 * 64, 1024, 16), (13 * 16, 1024, 32),
    (2, 401408, 64),
    (16, 6272, 64), (64, 6272, 16), (4, 131072, 256), (1, 100, 64),
    (3, 127, 64), (3, 128, 64), (5, 1000, 64), (1, 1, 16), (200, 5000, 64),
    (131, 10 ** 6, 64), (1, 10 ** 6, 256)]


@pytest.mark.parametrize('tiles,length,chunk', PLAN_CASES)
def test_split_plan_covers_every_chunk_once_within_the_waves(tiles, length,
                                                             chunk):
  s = dw_split.split_plan(tiles, length, chunk, SMS)
  assert s >= 1
  assert s == 1 or tiles * s <= dw_split.MAX_WAVES * SMS
  bounds = _slice_bounds(length, chunk, s)
  assert len(bounds) == s
  assert bounds[0][0] == 0 and bounds[-1][1] == length
  for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
    assert e0 == b1                            # no gap, no overlap
  for b, e in bounds:
    assert e > b                               # no slice empty
    assert b % chunk == 0                      # whole chunks
    assert (e - b) % chunk == 0 or e == length
  chunks = -(-length // chunk)
  owners = [sum(b <= c * chunk < e for b, e in bounds) for c in range(chunks)]
  assert owners == [1] * chunks                # each chunk in one slice
  if length < 2 * chunk or (tiles >= SMS and tiles % SMS == 0):
    assert s == 1                              # short, or full rounds
  elif tiles < SMS // 2 and chunks >= SMS:
    assert tiles * s > SMS // 2                # it fills much of the card


def test_split_plan_keeps_the_grid_where_it_fills_the_card():
  """S = 1 at the MLP training shape (K = N = 4096, block 512, s = 0.8:
  13 actives) in both dtypes, and at m under two chunks; the largest RN50
  1x1 call splits."""
  for dtype in (torch.bfloat16, torch.float32):
    plan = tbsp.dw_plan(1024, 13, (512, 512), dtype, SMS)
    assert plan.slices == 1 and plan.workspace_bytes == 0
    assert plan.grid[2] == 1 and plan.slice_rows >= 1024
  for m in (1, 63, 127):
    assert tbsp.dw_plan(m, 2, (128, 128), torch.bfloat16, SMS).slices == 1
  rn50 = tbsp.dw_plan(401408, 2, (128, 128), torch.bfloat16, SMS)
  assert rn50.slices > 1
  assert rn50.workspace_bytes == rn50.slices * 2 * 128 * 128 * 4
  assert rn50.grid == (2, 1, rn50.slices)


# ------------------------------------------------------------- the tiles --
# (block, f32 tile): the MLP's and the transformer's 512, RN50's 128, the
# card tests' narrow and ragged blocks, the conv nets' 16.
TILE_CASES = [((512, 512), (128, 128)), ((128, 128), (128, 128)),
              ((256, 128), (128, 128)), ((192, 64), (128, 128)),
              ((96, 96), (128, 128)), ((64, 32), (128, 128)),
              ((32, 64), (128, 128)), ((16, 8), (64, 16)), ((16, 16), (64, 16)),
              ((16, 48), (128, 128)), ((128, 16), (64, 16)),
              ((1024, 256), (128, 128))]


@pytest.mark.parametrize('block,tile', TILE_CASES)
def test_dw_tile_rule(block, tile):
  """f32 takes 64 x 16 for blocks at most 16 columns wide, else 128 x 128;
  bf16 takes its 128 x 128 tile whatever the block.  The plan's grid and
  workspace follow the tile, its slices whole chunks of the tile's."""
  code = tbsp.dw_tile(block, torch.float32)
  assert code > 0 and tbsp.DW_TILES[code][:2] == tile
  assert tbsp.dw_tile(block, torch.bfloat16) == 0
  assert tbsp.DW_TILES[0] == (128, 128, 64, 1)
  plan = tbsp.dw_plan(6272, 5, block, torch.float32, SMS)
  tiles = -(-block[0] // tile[0]) * -(-block[1] // tile[1])
  assert plan.tile == code and plan.grid == (5, tiles, plan.slices)
  assert plan.workspace_bytes == (0 if plan.slices == 1 else
                                  plan.slices * 5 * tiles * tile[0]
                                  * tile[1] * 4)
  assert plan.slice_rows % tbsp.DW_TILES[code][2] == 0


def test_dw_tile_codes_match_dispatch_dw():
  """DW_TILES in the order of csrc/packed_mm.cu's DwTile codes: kDwBf16,
  then kDw<rows>x<columns>."""
  source = (Path(tbsp.__file__).resolve().parents[1] / 'csrc'
            / 'packed_mm.cu').read_text()
  enum = re.search(r'enum DwTile \{([^}]*)\}', source).group(1)
  codes = dict((name, int(code))
               for name, code in re.findall(r'kDw(\w+) = (\d+)', enum))
  assert codes.pop('Bf16') == 0
  assert {f'{r}x{c}': i for i, (r, c, _, _) in enumerate(tbsp.DW_TILES)
          if i > 0} == codes


def test_f32_tiling_is_the_3xtf32_kernels():
  """DW_TILES' f32 entries: 128 x 128 and 64 x 16, 32 rows of m a ring
  stage (kDwChunk), one and three thread blocks an SM; the MLP's 13
  blocks of 512 give 208 tiles, which keep S = 1 (two rounds of 132 SMs);
  the conv nets' blocks of 16 plan over three blocks an SM."""
  assert tbsp.DW_TILES[1:] == ((128, 128, 32, 1), (64, 16, 32, 3))
  plan = tbsp.dw_plan(1024, 13, (512, 512), torch.float32, SMS)
  assert plan.grid == (13, 16, 1) and plan.slice_rows == 1024
  narrow = tbsp.dw_plan(100352, 60, (16, 16), torch.float32, SMS)
  assert narrow.grid == (60, 1, narrow.slices)
  assert narrow.slices == dw_split.split_plan(
      60, 100352, 32, 3 * SMS, 64 * 16 * 4 / (32 * 80 * 4))


# ------------------------------------------------------------ tap groups --
def _tap_index(ksize, cin, cout, block, seed, density=0.5, packed=False):
  kh, kw = ksize
  t_dim, nk, nn_ = kh * kw, cin // block[0], cout // block[1]
  gen = torch.Generator().manual_seed(seed)
  occ = (torch.rand(t_dim, nk, nn_, generator=gen) < density).to(torch.int32)
  if nn_ > 1:
    occ[:, :, nn_ - 1] = 0                     # an empty output column
  occ[:, 0, 0] = 1                             # a pair with every tap
  n_act = int(occ.sum())
  if packed:
    occ2d = occ.reshape(t_dim * nk, nn_)
    packing = tbsp.make_packing(occ2d, n_act)
    return tbsc.packed_tap_index(packing, ksize, cin, block), occ
  cols, rows, taps = tbsc.pack_tap_active(occ, n_act)
  index = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                         (kh, kw, cin, cout), block)
  return index, occ


def test_split_plan_splits_a_grid_with_a_mostly_empty_last_round():
  """334 tiles on 264 slots run in two rounds, the second a quarter full:
  the plan splits the sum so that the rounds fill, and the modelled time
  falls by at least MIN_GAIN."""
  s = dw_split.split_plan(334, 6272, 256, 264, 0.56)
  assert s > 1 and 334 * s <= dw_split.MAX_WAVES * 264


@pytest.mark.parametrize('max_taps', MAX_TAPS)
@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('ksize,density', [((3, 3), 0.5), ((3, 3), 1.0),
                                           ((5, 5), 0.6), ((1, 1), 1.0),
                                           ((3, 5), 0.3)])
def test_tap_groups_hold_each_entry_once(ksize, density, packed, max_taps):
  index, occ = _tap_index(ksize, 32, 48, (16, 16), 3, density, packed)
  gr = index.dw_groups(max_taps)
  ptr = gr.ptr.tolist()
  n_groups = len(ptr) - 1
  assert ptr[0] == 0 and ptr[-1] == index.n_entries
  assert gr.rblks.shape == gr.cblks.shape == (n_groups,)
  sizes = [b - a for a, b in zip(ptr, ptr[1:])]
  assert all(1 <= n <= max_taps for n in sizes)
  want = {(t, r, j): off for t, r, j, off in zip(*(a.tolist()
                                                    for a in index.dw))}
  got = {}
  for g in range(n_groups):
    r, j = int(gr.rblks[g]), int(gr.cblks[g])
    taps = gr.taps[ptr[g]:ptr[g + 1]].tolist()
    assert taps == sorted(taps)
    for e in range(ptr[g], ptr[g + 1]):
      key = (int(gr.taps[e]), r, j)
      assert key not in got                    # each entry exactly once
      got[key] = int(gr.woffs[e])
  assert got == want
  assert len(got) == int(occ.sum())
  # A (cin-block, cout-block) pair's taps fill groups of max_taps before
  # the next.
  pair_taps = occ[:, 0, 0].sum().item()
  first = [n for g, n in enumerate(sizes)
           if (int(gr.rblks[g]), int(gr.cblks[g])) == (0, 0)]
  assert sum(first) == pair_taps
  assert first[:-1] == [max_taps] * (len(first) - 1)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_tap_group_size_follows_the_taps_per_pair(dtype):
  """An index whose active pairs hold many taps takes the dtype's groups;
  one with about one tap a pair takes TAP_SPARSE_TAPS."""
  dense, _ = _tap_index((3, 3), 32, 48, (16, 16), 3, 1.0)
  assert dense.taps_per_pair > tbsc.TAP_SPARSE_MEAN
  assert tbsc.tap_dw_taps(dense, dtype) == tbsc.TAP_GROUP_TAPS[dtype]
  occ = torch.zeros(9, 4, 4, dtype=torch.int32)
  occ[torch.arange(16) % 9, torch.arange(16) // 4, torch.arange(16) % 4] = 1
  cols, rows, taps = tbsc.pack_tap_active(occ, 16)
  sparse = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                          (3, 3, 64, 64), (16, 16))
  assert sparse.taps_per_pair == 1.0
  assert tbsc.tap_dw_taps(sparse, dtype) == tbsc.TAP_SPARSE_TAPS


def test_tap_groups_of_an_empty_index():
  index = tbsc.tap_index({'cols': torch.tensor([0, -1], dtype=torch.int32),
                          'rows': torch.tensor([0, 0], dtype=torch.int32),
                          'taps': torch.tensor([-1, -1], dtype=torch.int32)},
                         (3, 3, 16, 16), (16, 16))
  assert index.n_entries == 0
  for max_taps in MAX_TAPS:
    groups = index.dw_groups(max_taps)
    assert groups.ptr.tolist() == [0] and groups.rblks.numel() == 0


# ------------------------------------------------- plain walk of the split --
def _walk_tap_dw(x, gy, index, max_taps, slices, out_dtype):
  """The tap dw as the split kernels compute it: for each slice of
  TAP_DW_CHUNK-pixel chunks and each group, every tap's f32 partial over
  the slice's pixels; the partials added in slice order, cast once."""
  n, h, wd, _ = x.shape
  kh, kw, bk, bn = index.kh, index.kw, index.bk, index.bn
  xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
  g2 = gy.float().reshape(-1, gy.shape[-1])
  gr = index.dw_groups(max_taps)
  ptr = gr.ptr.tolist()
  sums = {}
  for b, e in _slice_bounds(n * h * wd, tbsc.TAP_DW_CHUNK, slices):
    for g in range(len(ptr) - 1):
      r, j = int(gr.rblks[g]), int(gr.cblks[g])
      for k in range(ptr[g], ptr[g + 1]):
        dy, dx = divmod(int(gr.taps[k]), kw)
        xs = xp[:, dy:dy + h, dx:dx + wd, r * bk:(r + 1) * bk].reshape(-1, bk)
        part = xs[b:e].T @ g2[b:e, j * bn:(j + 1) * bn]
        off = int(gr.woffs[k])
        sums[off] = part if off not in sums else sums[off] + part
  out = torch.zeros(index.w_shape, dtype=torch.float32)
  flat = out.reshape(-1)
  for off, total in sums.items():
    tbsc._block(flat, off, bk, bn, index.w_ld).copy_(total)
  return out.to(out_dtype)


@pytest.mark.parametrize('slices', [1, 2, 3])
@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5), (1, 1)])
def test_tap_walk_of_groups_and_slices_equals_plain(ksize, packed, slices):
  """3 images of 12 x 16: 576 pixels, two whole chunks and a ragged one;
  the groups of each dtype."""
  index, _ = _tap_index(ksize, 32, 32, (16, 16), 7, 0.5, packed)
  gen = torch.Generator().manual_seed(11)
  x = torch.randn(3, 12, 16, 32, generator=gen)
  gy = torch.randn(3, 12, 16, 32, generator=gen)
  want = tbsc.tap_dw_reference(x, gy, index, torch.float32)
  scale = max(1.0, float(want.abs().max()))
  for max_taps in MAX_TAPS:
    got = _walk_tap_dw(x, gy, index, max_taps, slices, torch.float32)
    assert float((got - want).abs().max()) <= RTOL * scale


def _walk_dense_dw(x, gy, entries, block, slices, chunk, out_dtype):
  """The gathered dw as the split kernel computes it: each slice's f32
  partial of every flagged block, added in slice order, cast once."""
  bk, bn = block
  dw = torch.zeros((x.shape[1], gy.shape[1]), dtype=out_dtype)
  flags = (entries.flags.tolist() if entries.flags is not None
           else [1] * entries.rows.numel())
  bounds = _slice_bounds(x.shape[0], chunk, slices)
  for r, c, f in zip(entries.rows.tolist(), entries.cols.tolist(), flags):
    if not f:
      continue
    total = None
    for b, e in bounds:
      part = (x[b:e, r * bk:(r + 1) * bk].float().T
              @ gy[b:e, c * bn:(c + 1) * bn].float())
      total = part if total is None else total + part
    dw[r * bk:(r + 1) * bk, c * bn:(c + 1) * bn] = total.to(out_dtype)
  return dw


@pytest.mark.parametrize('slices', [1, 2, 4])
@pytest.mark.parametrize('m', [200, 256])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_dense_walk_of_slices_equals_plain(m, dtype, slices):
  """The gathered dw with every block flagged by an occupancy (B12's
  entries) at ragged and whole m, in the kernels' chunk of the dtype."""
  chunk = tbsp.DW_TILES[tbsp.dw_tile((16, 32), dtype)][2]
  gen = torch.Generator().manual_seed(m)
  nk, nn_, block = 3, 4, (16, 32)
  occ = (torch.rand(nk, nn_, generator=gen) < 0.5).to(torch.int32)
  occ[0, 0] = 1
  entries = tv3.occupancy_dw_entries(occ)
  x = torch.randn(m, nk * block[0], generator=gen).to(dtype)
  gy = torch.randn(m, nn_ * block[1], generator=gen).to(dtype)
  slices = min(slices, -(-m // chunk))
  got = _walk_dense_dw(x, gy, entries, block, slices, chunk, torch.float32)
  want = tv3.dense_dw_reference(x, gy, entries, block, torch.float32)
  scale = max(1.0, float(want.abs().max()))
  assert float((got - want).abs().max()) <= RTOL * scale
  for k in range(nk):
    for j in range(nn_):
      if not occ[k, j]:
        assert not got[k * 16:(k + 1) * 16, j * 32:(j + 1) * 32].any()
