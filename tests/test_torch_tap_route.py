"""The tap conv's forward / dx branches and its index, on the CPU.

ops/block_sparse_conv.py `tap_branch` names the branch of each forward /
dx call: 'mm' for a 1x1 kernel (csrc/packed_mm.cu's forward / dx kernels
over the index's lists), 'wgmma' for a bf16 KxK kernel with blocks of
16s and 'tf32' for every other KxK one, f32 and bf16 at blocks of 8s
(csrc/tap_conv.cu, by the branch's position in TAP_BRANCHES).  The
kernels run only on a CUDA card (test_torch_kernels_cuda.py); here the
rule, its codes, the 1x1 lists against block_sparse_v4's and v3's (both
routes sum the same entries in the same order), the wgmma branch's group
lists and the tf32 branch's panel lists walked in Python to the plain
sums (in bf16 with its own fragment order at blocks of 8s), and the train
step's TapIndex, built once per mask update and kept on the layer's
TapPack.  No JAX here."""

import functools
import re
from pathlib import Path

import pytest
import torch
from torch import nn

from rigl_tpu_torch.layers.packed_dense import random_occupancy
from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Dense
from rigl_tpu_torch.ops import block_sparse_conv as tbsc
from rigl_tpu_torch.ops import block_sparse_v3 as tv3
from rigl_tpu_torch.ops import block_sparse_v4 as tv4
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import steps
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import SparseTraining

SOURCE = Path(tbsc.__file__).resolve().parent.parent / 'csrc' / 'tap_conv.cu'
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize('kh,kw,bk,bn,dtype,want', [
    (1, 1, 128, 128, BF16, 'mm'), (1, 1, 16, 16, F32, 'mm'),
    (1, 1, 8, 8, BF16, 'mm'), (1, 1, 4, 12, F32, 'mm'),
    (3, 3, 16, 16, BF16, 'wgmma'), (3, 3, 128, 128, BF16, 'wgmma'),
    (5, 5, 48, 80, BF16, 'wgmma'), (3, 5, 32, 64, BF16, 'wgmma'),
    (3, 3, 8, 8, BF16, 'tf32'), (3, 3, 16, 8, BF16, 'tf32'),
    (5, 5, 24, 16, BF16, 'tf32'),
    (3, 3, 16, 16, F32, 'tf32'), (3, 3, 4, 4, F32, 'tf32'),
    (5, 5, 128, 128, F32, 'tf32')])
def test_tap_branch_rule(kh, kw, bk, bn, dtype, want):
  """mm for every 1x1; KxK: wgmma in bf16 where 16 divides both block
  sides, tf32 otherwise (f32, and a bf16 block of 8s)."""
  assert tbsc.tap_branch(kh, kw, bk, bn, dtype) == want


@pytest.mark.parametrize('bk,bn,dtype,match', [
    (16, 16, torch.float16, 'float32 or bfloat16'),
    (12, 16, BF16, 'multiple of 8'), (16, 4, BF16, 'multiple of 8'),
    (6, 6, F32, 'multiple of 4')])
def test_tap_branch_refusals(bk, bn, dtype, match):
  """Another dtype, or a block that is not whole 16-byte copies, has no
  branch."""
  for kh, kw in ((1, 1), (3, 3)):
    with pytest.raises(ValueError, match=match):
      tbsc.tap_branch(kh, kw, bk, bn, dtype)


def test_tap_branch_codes_match_dispatch_conv():
  """TAP_BRANCHES' positions are the codes of dispatch_conv's TapBranch."""
  enum = re.search(r'enum TapBranch \{([^}]*)\}', SOURCE.read_text()).group(1)
  codes = {name.lower(): int(v) for name, v in
           re.findall(r'kTap(\w+) = (\d+)', enum)}
  assert codes == {b: i for i, b in enumerate(tbsc.TAP_BRANCHES)}


def test_rn50_route_shapes_take_mm_and_wgmma():
  """The RN50 step's default route (block (128, 128), bf16): its 1x1s
  take mm, its 3x3s (with block_conv3x3) wgmma; WRN in bf16 (block 16)
  wgmma, in f32 tf32."""
  assert tbsc.tap_branch(1, 1, 128, 128, BF16) == 'mm'
  assert tbsc.tap_branch(3, 3, 128, 128, BF16) == 'wgmma'
  assert tbsc.tap_branch(3, 3, 16, 16, BF16) == 'wgmma'
  assert tbsc.tap_branch(3, 3, 16, 16, F32) == 'tf32'


def _columns(lists):
  """[[(seg, woffs) of each entry of output column g, in order], ...]."""
  beg, end, seg, woffs = (t.tolist() for t in lists)
  return [[(seg[a], woffs[a]) for a in range(b, e)]
          for b, e in zip(beg, end)]


@pytest.mark.parametrize('nk,nn_,block,seed', [
    (2, 3, (128, 128), 0), (4, 16, (128, 128), 1), (16, 4, (128, 128), 2),
    (3, 5, (16, 32), 3), (5, 2, (64, 16), 4)])
def test_1x1_lists_equal_b7_and_b8_lists(nk, nn_, block, seed):
  """A 1x1 TapIndex's forward and dx DenseLists (TapIndex.mm_lists) hold,
  column by column and in order, the entries of block_sparse_v4's flat
  lists (B7, the 'matmul' route) and v3's occupancy lists (B8) for the
  same block mask, over the (cin, cout) view: both routes sum the same
  products in the same order.  An empty block-row and column included."""
  gen = torch.Generator().manual_seed(seed)
  n_act = max(1, nk * nn_ // 3)
  occ = random_occupancy(gen, nk, nn_, n_act)
  occ[nk - 1, :] = 0
  occ[:, 0] = 0
  n_act = int(occ.sum())
  cin, cout = nk * block[0], nn_ * block[1]
  cols, rows, taps = tbsc.pack_tap_active(occ[None], n_act)
  index = tbsc.tap_index(tbsc.TapPack(cols, rows, taps), (1, 1, cin, cout),
                         block)
  fcols, frows = tv4.pack_flat_active(occ, n_act)
  for mode in ('fwd', 'dx'):
    got = index.mm_lists(mode, 'cpu')
    assert isinstance(got, tv3.DenseLists)
    assert all(t.dtype == torch.int32 for t in got)
    want_v4 = tv4.flat_lists(fcols, frows, block, (cin, cout), mode)
    want_v3 = tv3.occupancy_lists(occ, block, cout, mode)
    assert _columns(got) == _columns(want_v4) == _columns(want_v3), mode
  assert index.mm_lists('fwd', 'cpu') is index.mm_lists('fwd', 'cpu')


def test_1x1_packed_index_has_no_mm_lists():
  """A packed-storage 1x1 index has no 'mm' lists: PackedConv runs its
  1x1s as PackedConv1x1 on packed_matmul, so tap_conv_cuda refuses one."""
  from rigl_tpu_torch.ops import block_sparse_packed as tbsp
  occ = torch.tensor([[1, 0, 1], [0, 1, 1]], dtype=torch.int32)
  index = tbsc.packed_tap_index(tbsp.make_packing(occ, 4), (1, 1), 32,
                                (16, 16))
  with pytest.raises(ValueError, match='packed'):
    index.mm_lists('fwd', 'cpu')


@pytest.mark.parametrize('gcols,out_w,want', [
    (1, 16, 16), (2, 16, 32), (3, 16, 48), (4, 16, 64), (5, 16, 128),
    (8, 16, 128), (1, 32, 32), (2, 32, 64), (4, 32, 128), (1, 48, 48),
    (2, 48, 128), (1, 64, 64), (2, 64, 128), (1, 80, 128), (1, 128, 128),
    (1, 256, 128)])
def test_wgmma_tile_rule(gcols, out_w, want):
  """The wgmma call's output tile: the narrowest that holds the group,
  else the widest (a wide column takes several)."""
  assert tbsc.tap_wgmma_tile(gcols, out_w) == want


def test_wgmma_tiles_match_the_kernel():
  """TAP_WGMMA_TILES are the tiles launch_wgmma instantiates, and
  TAP_WGMMA_ROWS the pixels a thread block (kWgRows): the Python side
  chooses the tile and the grid from them."""
  text = SOURCE.read_text()
  body = re.search(r'cudaError_t launch_wgmma\(const ConvArgs& a\) \{(.*?)\n\}',
                   text, re.S).group(1)
  cases = [int(n) for n, m in re.findall(
      r'case (\d+): return launch_tile<(\d+), kTrans>', body) if n == m]
  assert tuple(cases) == tbsc.TAP_WGMMA_TILES
  rows = re.search(r'constexpr int kWgRows = (\d+);', text).group(1)
  assert int(rows) == tbsc.TAP_WGMMA_ROWS
  assert tbsc.TAP_WGMMA_TILE == max(tbsc.TAP_WGMMA_TILES)


@pytest.mark.parametrize('out_w,ncols,want', [
    (16, 2, 2), (16, 8, 8), (16, 32, 8), (32, 16, 4), (48, 4, 2),
    (64, 8, 2), (80, 4, 1), (128, 4, 1), (192, 2, 1), (16, 5, 5)])
def test_tap_group_cols(out_w, ncols, want):
  """A group holds as many block-columns as fit 128 channels where blocks
  are at most 64 wide, else one; its tile holds it."""
  assert tbsc.tap_group_cols(out_w, ncols) == want
  assert want * out_w <= tbsc.tap_wgmma_tile(want, out_w) or want == 1


def _walk_groups(a, w, index, mode, gcols):
  """The wgmma branch's sums, walked in Python from TapGroupLists: for
  each group, each union entry, each column of the group with a weight
  offset (not -1), the shifted input block times the weight block (read
  transposed for dx), in f32."""
  fwd = mode == 'fwd'
  seg, out_w = (index.bk, index.bn) if fwd else (index.bn, index.bk)
  ptr, taps, kblks, woffs, order, gcols = index.group_lists(mode, 'cpu',
                                                            gcols)
  ptr, taps, kblks, woffs = (t.tolist() for t in (ptr, taps, kblks, woffs))
  n, h, wd, _ = a.shape
  cy = index.cout if fwd else index.cin
  ap = tbsc._padded(a, index.kh, index.kw)
  wf = w.float().reshape(-1)
  y = torch.zeros(n, h, wd, cy)
  assert sorted(order.tolist()) == list(range(len(ptr) - 1))
  for g in order.tolist():
    for u in range(ptr[g], ptr[g + 1]):
      dy, dx = divmod(taps[u], index.kw)
      xs = ap[:, dy:dy + h, dx:dx + wd, kblks[u] * seg:(kblks[u] + 1) * seg]
      for c in range(gcols):
        off = woffs[u * gcols + c]
        if off < 0:
          continue
        blk = (tbsc._block(wf, off, out_w, seg, index.w_ld).T if not fwd
               else tbsc._block(wf, off, seg, out_w, index.w_ld))
        col = (g * gcols + c) * out_w
        y[..., col:col + out_w] += xs @ blk
  return y


@pytest.mark.parametrize('ksize,cin,cout,block', [
    ((3, 3), 64, 64, (16, 16)), ((3, 3), 32, 96, (16, 32)),
    ((5, 5), 48, 80, (16, 16)), ((3, 3), 256, 256, (128, 128)),
    ((3, 3), 96, 192, (48, 64))])
def test_group_lists_walk_to_the_plain_sums(ksize, cin, cout, block):
  """The wgmma branch's group lists (TapIndex.group_lists): each group's
  entries are the union of its columns' (tap, input block) pairs,
  ascending, with -1 where a column lacks the pair; the groups in order
  of their entry counts, most first; with one column a group they are the
  column lists.  Walked in Python they give tap_conv_reference's sums
  (f32, another order: 1e-5), forward and dx, with an empty output column
  and an empty tap."""
  kh, kw = ksize
  gen = torch.Generator().manual_seed(cin + cout)
  occ = (torch.rand(kh * kw, cin // block[0], cout // block[1],
                    generator=gen) < 0.4).to(torch.int32)
  occ[:, :, 0] = 0
  occ[0] = 0
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  index = tbsc.tap_index(tbsc.TapPack(cols, rows, taps),
                         (kh, kw, cin, cout), block)
  x = torch.randn(2, 5, 7, cin, generator=gen)
  gy = torch.randn(2, 5, 7, cout, generator=gen)
  w4 = torch.randn(kh, kw, cin, cout, generator=gen)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    out_w = block[1] if mode == 'fwd' else block[0]
    ncols = (cout if mode == 'fwd' else cin) // out_w
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    scale = max(1.0, float(want.abs().max()))
    for gcols in sorted({1, tbsc.tap_group_cols(out_w, ncols)}):
      lists = index.group_lists(mode, 'cpu', gcols)
      assert lists.gcols == gcols
      counts = lists.ptr.diff()
      assert counts[lists.order].tolist() == sorted(counts.tolist(),
                                                     reverse=True)
      for g in range(len(counts)):
        span = slice(int(lists.ptr[g]), int(lists.ptr[g + 1]))
        pairs = list(zip(lists.taps[span].tolist(),
                         lists.kblks[span].tolist()))
        assert pairs == sorted(set(pairs))
      if gcols == 1:
        col = index.fwd if mode == 'fwd' else index.dx
        assert all(torch.equal(a, b) for a, b in zip(lists[:4], col))
      got = _walk_groups(a, w4, index, mode, gcols)
      assert float((got - want).abs().max()) <= 1e-5 * scale, (mode, gcols)
  assert index.group_lists('fwd', 'cpu', 1) is index.group_lists('fwd',
                                                                 'cpu', 1)


def _tap_index_at(ksize, cin, cout, block, sparsity, seed):
  """The TapIndex of a random occupancy at `sparsity` over the conv's
  (tap, input block, output block) grid."""
  kh, kw = ksize
  gen = torch.Generator().manual_seed(seed)
  nk, nn_ = kh * kw * cin // block[0], cout // block[1]
  n_act = max(1, round((1 - sparsity) * nk * nn_))
  occ = random_occupancy(gen, nk, nn_, n_act).reshape(kh * kw,
                                                      cin // block[0], nn_)
  cols, rows, taps = tbsc.pack_tap_active(occ, n_act)
  return tbsc.tap_index(tbsc.TapPack(cols, rows, taps), (kh, kw, cin, cout),
                        block)


def test_wgmma_group_width_follows_the_union_and_the_grid():
  """tap_wgmma_gcols takes the widest groups where their unions hold at
  most TAP_GROUP_CUT of the entries and the grid still gives every SM a
  thread block; else one column a group; always one at blocks wider than
  64 (a column fills the tile)."""
  dense = _tap_index_at((3, 3), 64, 64, (16, 16), 0.3, 0)     # 4 columns
  sparse = _tap_index_at((3, 3), 512, 512, (16, 16), 0.96, 1)
  wide = _tap_index_at((3, 3), 256, 256, (128, 128), 0.5, 2)
  for mode in ('fwd', 'dx'):
    union = int(dense.group_lists(mode, 'cpu', 4).ptr[-1])
    assert union <= tbsc.TAP_GROUP_CUT * dense.n_entries
    assert tbsc.tap_wgmma_gcols(dense, mode, 128 * 56 * 56, 132) == 4
    # 4 pixel tiles x 1 group: fewer thread blocks than SMs.
    assert tbsc.tap_wgmma_gcols(dense, mode, 4 * 128, 132) == 1
    union = int(sparse.group_lists(mode, 'cpu', 8).ptr[-1])
    assert union > tbsc.TAP_GROUP_CUT * sparse.n_entries
    assert tbsc.tap_wgmma_gcols(sparse, mode, 128 * 14 * 14, 132) == 1
    assert tbsc.tap_wgmma_gcols(wide, mode, 128 * 28 * 28, 132) == 1


# ------------------------------------------------ the tf32 branch (f32) --
def _c_int(name: str) -> int:
  """An integer constant of tap_conv.cu, `constexpr int name = <int>;`."""
  return int(re.search(r'constexpr int ' + name + r' = (\d+);',
                       SOURCE.read_text()).group(1))


def _tf_channel():
  """tap_conv.cu's tf_channel(kk, k), the one-line C function, as Python."""
  body = re.search(r'constexpr int tf_channel\(int kk, int k\) \{\s*return '
                   r'(.*?);', SOURCE.read_text(), re.S).group(1)
  expr = ' '.join(body.replace(' / ', ' // ').split())
  return lambda kk, k: eval(expr, {'kk': kk, 'k': k})


def _tf_half_channel():
  """tap_conv.cu's tf_half_channel(k), the one-line C function, as
  Python."""
  body = re.search(r'constexpr int tf_half_channel\(int k\) \{\s*return '
                   r'(.*?);', SOURCE.read_text(), re.S).group(1)
  expr = ' '.join(body.replace(' / ', ' // ').split())
  return lambda k: eval(expr, {'k': k})


def _lane_channel(kk, k, half):
  """The channel of its chunk that the kernel's fragment loads put at
  index k of k-step kk (thread q = k % 4 of a quad, its value j = k // 4):
  thread q loads channels 4 q .. 4 q + 3 and takes 2 kk + j of them; bf16
  at a chunk of 8 channels (`half`), channels 4 (q % 2) .. (lanes q and
  q + 2 read the same 8 bytes) of which it takes 2 (q // 2) + j, k-step 0
  only (None: k-step 1 is not run)."""
  q, j = k % 4, k // 4
  if half:
    return None if kk else 4 * (q % 2) + 2 * (q // 2) + j
  return 4 * q + 2 * kk + j


def test_tf32_constants_match_the_kernel():
  """TAP_TF32_TILES are the tiles launch_tf32 instantiates, and the rows a
  thread block, channels an x tile and entries a stage are the kernel's:
  the Python side plans the grid and the panels from them.  tf_channel is
  a permutation of each k-step pair's 16 channels that gives thread q of a
  quad channels 4 q .. 4 q + 3, its one load (16 bytes in f32, 8 in
  bf16); tf_half_channel a permutation of a bf16 chunk of 8 channels into
  k-step 0; both are the channels the fragment loads take
  (_lane_channel)."""
  text = SOURCE.read_text()
  body = re.search(r'cudaError_t launch_tf32\(const ConvArgs& a\) \{(.*?)\n\}',
                   text, re.S).group(1)
  assert tuple(int(n) for n in re.findall(r'case (\d+):', body)) == (
      tbsc.TAP_TF32_TILES)
  assert _c_int('kTfRows') == tbsc.TAP_TF32_ROWS
  assert _c_int('kTfChunk') == tbsc.TAP_TF32_CHUNK
  assert _c_int('kTfEntries') == tbsc.TAP_TF32_ENTRIES
  assert _c_int('kTfMaxXRows') == tbsc.TAP_TF32_XROWS
  ch = _tf_channel()
  got = [ch(kk, k) for kk in range(2) for k in range(8)]
  assert sorted(got) == list(range(16))
  for q in range(4):
    assert {ch(kk, q + 4 * j) for kk in range(2) for j in range(2)} == set(
        range(4 * q, 4 * q + 4))
  half = _tf_half_channel()
  assert sorted(half(k) for k in range(8)) == list(range(8))
  for kk in range(2):
    for k in range(8):
      assert _lane_channel(kk, k, False) == ch(kk, k)
      assert _lane_channel(kk, k, True) == (None if kk else half(k))


@pytest.mark.parametrize('ksize', [(3, 3), (5, 5), (3, 5)])
def test_tf32_x_tiles_fit_shared_memory_at_every_tile(ksize):
  """At every image width, every x tile of the tf32 branch's panels holds
  at most TAP_TF32_XROWS rows, and the kernel's shared-memory plan
  (TfPlan: kTfStages stages of kTfEntries W entries, hi and lo, 64 bytes a
  row, and an x tile in whole boxes of kTfBoxRows rows) at that many rows
  fits kTfMaxSmem at each of TAP_TF32_TILES, block-128 columns (tile 64)
  included: no call the branch is routed is refused for its halo."""
  stages, ents = _c_int('kTfStages'), _c_int('kTfEntries')
  box = _c_int('kTfBoxRows')
  limit = 227 * 1024
  assert re.search(r'constexpr int kTfMaxSmem = 227 \* 1024;',
                   SOURCE.read_text())
  def smem(n, xrows):
    return 1024 + stages * (ents * 2 * n * 64 + -(-xrows // box) * box * 64
                            + ents * 16 + 16)
  assert all(smem(n, tbsc.TAP_TF32_XROWS) <= limit
             for n in tbsc.TAP_TF32_TILES)
  index = _tap_index_at(ksize, 256, 256, (128, 128), 0.5, 1)
  for width in (7, 32, 56, 64, 80, 95, 128, 160, 191, 192, 224):
    for mode in ('fwd', 'dx'):
      gcols, tile = tbsc.tap_tf32_tile(index, mode, 2 * width * width, 132)
      xrows = index.panel_lists(mode, 'cpu', gcols, width).xrows
      assert xrows <= tbsc.TAP_TF32_XROWS, (width, mode)
      assert smem(tile, xrows) <= limit, (width, mode)


@pytest.mark.parametrize('cin,cout,block,pixels,want', [
    (16, 32, (16, 16), 128 * 32 * 32, (2, 32)),   # WRN g0_b0/conv1
    (32, 16, (16, 16), 128 * 32 * 32, (1, 16)),   # one column
    (128, 128, (16, 16), 128 * 8 * 8, (2, 32)),   # WRN g2: 4 x 64 tiles
    (512, 512, (16, 16), 128 * 7 * 7, (2, 32)),   # RN50 g3
    (64, 64, (16, 16), 128, (1, 16)),             # one pixel tile
    (96, 160, (48, 80), 1024, (1, 64)),           # blocks of 80
    (128, 384, (64, 192), 4096, (1, 64)),         # a column over 64
    (8, 24, (4, 12), 4096, (1, 16)),              # blocks of 12
    (64, 96, (16, 32), 128 * 256, (1, 64))])      # blocks of 32
def test_tf32_tile_rule(cin, cout, block, pixels, want):
  """The tf32 call's (gcols, tile) in the forward: groups of
  TAP_TF32_GROUP block-columns where blocks are 16 wide, the layer has
  that many columns and the groups' thread blocks still cover 132 SMs;
  else one column a tile: 16 where it is at most 16 wide, else tiles of
  64."""
  index = _tap_index_at((3, 3), cin, cout, block, 0.5, 0)
  assert tbsc.tap_tf32_tile(index, 'fwd', pixels, 132) == want


@pytest.mark.parametrize('cin,cout,block,pixels,want', [
    (64, 64, (8, 8), 128 * 16 * 16, (4, 32)),     # WRN g1_b1/conv1, block 8
    (64, 64, (8, 8), 128 * 8, (1, 16)),           # too few pixel tiles
    (64, 64, (8, 8), 128 * 40, (2, 16)),          # room for groups of 2
    (8, 64, (8, 8), 128 * 16 * 16, (4, 32)),      # one input block
    (64, 16, (8, 8), 128 * 16 * 16, (2, 16)),     # two columns
    (64, 8, (8, 8), 128 * 16 * 16, (1, 16)),      # one column
    (64, 64, (16, 8), 128 * 16 * 16, (4, 32)),    # forward out_w 8
    (96, 64, (24, 16), 128 * 16 * 16, (2, 32)),   # forward out_w 16
    (48, 80, (24, 40), 128 * 16 * 16, (1, 64))])  # a column over 16
def test_tf32_tile_rule_bf16(cin, cout, block, pixels, want):
  """The tf32 call's (gcols, tile) in bf16 (blocks of 8s): groups of the
  widest of TAP_TF32_GROUPS_8 block-columns 8 wide (tile 32 or 16), or
  TAP_TF32_GROUP 16 wide (tile 32), where the layer has that many and the
  groups' thread blocks cover 132 SMs; else one column a tile, 16 where
  it is at most 16 wide, else tiles of 64.  f32 keeps its groups to
  columns 16 wide."""
  index = _tap_index_at((3, 3), cin, cout, block, 0.5, 0)
  assert tbsc.tap_tf32_tile(index, 'fwd', pixels, 132, BF16) == want
  if block[1] == 8:
    assert tbsc.tap_tf32_tile(index, 'fwd', pixels, 132, F32)[0] == 1


def _walk_stages(a, w, index, mode, gcols, width, dtype=F32):
  """The tf32 branch's sums, walked in Python from its stage table as the
  kernel walks it: for each group (in `order`), each stage row, each entry
  slot with channels to read, the x tile of its panel (TAP_TF32_CHUNK
  channels from the row's x channel, pixel rows from lo; its channels past
  the chunk's width -- the next input block's -- NaN) read at the slot's
  row offset, pixels outside the image zero, its channels taken as the
  fragment loads take them (_lane_channel: in f32 a lane past the chunk's
  quads loads none; a bf16 chunk of 8 fills k-step 0 and runs no k-step
  1), times, for each column of the group the slot's mask holds, the
  block its W row names, laid out as tap_w_split_kernel copies it (channel
  tf_channel(kk, k) at index 8 kk + k; a bf16 chunk of 8
  tf_half_channel(k) at k); in f64.  Checks on the
  way: a group's entries run in (input block, chunk, tap) order, each
  shift lies within its panel's x tile boxes, and a slot's W rows and
  mask agree (the zero block where a column lacks the entry)."""
  fwd = mode == 'fwd'
  seg, out_w = (index.bk, index.bn) if fwd else (index.bn, index.bk)
  pl = index.panel_lists(mode, 'cpu', gcols, width)
  ent, zero = tbsc.TAP_TF32_ENTRIES, index.n_entries * out_w
  n, h, wd, cx = a.shape
  m = n * h * wd
  xf = a.double().reshape(m, cx)
  pix = torch.arange(m)
  ph, pw = (pix // wd) % h, pix % wd
  chan, half_chan = _tf_channel(), _tf_half_channel()
  wf = w.double().reshape(-1)
  dw = index.dw
  cy = index.cout if fwd else index.cin
  y = torch.zeros(m, cy, dtype=torch.float64)
  sptr, stab = pl.sptr.tolist(), pl.stab.tolist()
  counts = [sptr[g + 1] - sptr[g] for g in range(len(sptr) - 1)]
  assert sorted(pl.order.tolist()) == list(range(len(counts)))
  assert [counts[g] for g in pl.order.tolist()] == sorted(counts,
                                                          reverse=True)
  for g in range(len(counts)):
    seen, boxes = [], 0
    for row in stab[sptr[g]:sptr[g + 1]]:
      ch0, lo, nbox, _, k0 = row[:5]
      boxes = nbox or boxes        # a panel's first stage copies its tile
      assert boxes and k0 % tbsc.TAP_TF32_CHUNK == 0
      cw = min(tbsc.TAP_TF32_CHUNK, seg - k0)
      for e in range(ent):
        off, dydx, mask, quads = row[8 + 4 * e:12 + 4 * e]
        wrows = row[8 + 4 * ent + e * gcols:8 + 4 * ent + (e + 1) * gcols]
        if quads == 0:   # a slot past the panel's entries reads nothing
          assert mask == 0 and dydx >> 16 == -(1 << 14)
          assert wrows == [zero] * gcols
          continue
        assert quads == cw // 4 and off % 64 == 0
        dy, dx = dydx >> 16, ((dydx & 0xFFFF) ^ 0x8000) - 0x8000
        tap = (dy + index.kh // 2) * index.kw + dx + index.kw // 2
        shift = off // 64 + lo
        assert shift == dy * width + dx
        # Every shifted row the tile's 128 pixels read lies in its boxes.
        assert 0 <= shift - lo <= (boxes * tbsc.TAP_TF32_BOX
                                   - tbsc.TAP_TF32_ROWS)
        kb = (ch0 - k0) // seg
        seen.append((kb, k0, tap))
        ok = ((ph + dy >= 0) & (ph + dy < h) & (pw + dx >= 0)
              & (pw + dx < wd))
        src = (pix + shift).clamp(0, m - 1)
        xs = torch.full((m, tbsc.TAP_TF32_CHUNK), float('nan'),
                        dtype=torch.float64)
        xs[:, :cw] = xf[src, ch0:ch0 + cw] * ok[:, None]
        half = dtype == BF16 and cw <= 8
        a_log = torch.zeros(m, tbsc.TAP_TF32_CHUNK, dtype=torch.float64)
        w_order = [None] * tbsc.TAP_TF32_CHUNK   # W copy: index -> channel
        for kk in range(2):
          for k in range(8):
            ch = _lane_channel(kk, k, half)
            if ch is not None and (dtype == BF16 or k % 4 < quads):
              a_log[:, 8 * kk + k] = xs[:, ch]   # contraction index 8 kk + k
            if not half:
              w_order[8 * kk + k] = chan(kk, k)
            elif kk == 0:
              w_order[k] = half_chan(k)
        for c in range(gcols):
          assert wrows[c] % out_w == 0
          assert ((mask >> c) & 1) == (wrows[c] != zero)
          if wrows[c] == zero:
            continue
          eid = wrows[c] // out_w
          t, r, j = int(dw.taps[eid]), int(dw.rblks[eid]), int(dw.cblks[eid])
          assert (t if fwd else index.kh * index.kw - 1 - t) == tap
          assert (r if fwd else j) == kb
          assert (j if fwd else r) == g * gcols + c
          blk = tbsc._block(wf, int(dw.woffs[eid]), index.bk, index.bn,
                            index.w_ld)
          kmaj = blk.T if fwd else blk          # out_w x seg, K-major
          b_log = torch.zeros(tbsc.TAP_TF32_CHUNK, out_w, dtype=torch.float64)
          for i, ch in enumerate(w_order):
            if ch is not None and k0 + ch < seg:
              b_log[i] = kmaj[:, k0 + ch]
          col = (g * gcols + c) * out_w
          y[:, col:col + out_w] += a_log @ b_log
    assert seen == sorted(set(seen))   # (input block, chunk, tap) order
  return y.reshape(n, h, wd, cy)


@pytest.mark.parametrize('ksize,cin,cout,block,width', [
    ((3, 3), 64, 64, (16, 16), 7), ((5, 5), 48, 80, (16, 16), 9),
    ((3, 5), 32, 96, (16, 32), 6), ((3, 3), 64, 48, (32, 16), 5),
    ((3, 3), 24, 40, (12, 20), 4), ((3, 5), 48, 32, (16, 16), 200)])
def test_panel_lists_walk_to_the_plain_sums(ksize, cin, cout, block, width):
  """The tf32 branch's panel lists (TapIndex.panel_lists), forward and dx
  at both group widths: each group's stage table, walked in Python as the
  kernel walks it with the W copy's contraction order (_walk_stages: the
  union of the columns' entries in (input block, chunk, tap) order, each
  shift within its panel's x tile, masks and W rows agreeing), gives
  tap_conv_reference's sums (f32 against f64: 1e-5), an empty output
  column and an empty tap included.  Blocks of 32 and of 12 / 20 take
  several and partial chunks; an image 200 wide splits the panels by tap
  row (its halo would pass TAP_TF32_XROWS)."""
  kh, kw = ksize
  gen = torch.Generator().manual_seed(cin + cout + width)
  occ = (torch.rand(kh * kw, cin // block[0], cout // block[1],
                    generator=gen) < 0.4).to(torch.int32)
  occ[:, :, 0] = 0
  occ[0] = 0
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  index = tbsc.tap_index(tbsc.TapPack(cols, rows, taps),
                         (kh, kw, cin, cout), block)
  x = torch.randn(2, 3, width, cin, generator=gen)
  gy = torch.randn(2, 3, width, cout, generator=gen)
  w4 = torch.randn(kh, kw, cin, cout, generator=gen)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    out_w = block[1] if mode == 'fwd' else block[0]
    ncols = (cout if mode == 'fwd' else cin) // out_w
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    scale = max(1.0, float(want.abs().max()))
    widths = {1, tbsc.TAP_TF32_GROUP} if out_w == 16 and ncols > 1 else {1}
    for gcols in sorted(widths):
      lists = index.panel_lists(mode, 'cpu', gcols, width)
      assert lists.gcols == gcols
      assert all(t.dtype == torch.int32 for t in lists[:3])
      if width == 200:
        assert lists.xrows == tbsc.TAP_TF32_ROWS + kw - 1
      got = _walk_stages(a, w4, index, mode, gcols, width)
      assert float((got - want).abs().max()) <= 1e-5 * scale, (mode, gcols)
  assert index.panel_lists('fwd', 'cpu', 1, width) is index.panel_lists(
      'fwd', 'cpu', 1, width)


@pytest.mark.parametrize('ksize,cin,cout,block,width', [
    ((3, 3), 32, 32, (8, 8), 7), ((3, 3), 48, 40, (16, 8), 6),
    ((5, 5), 72, 48, (24, 16), 5), ((3, 5), 16, 24, (8, 8), 200)])
def test_bf16_panel_walk_keeps_the_next_block_out(ksize, cin, cout, block,
                                                  width):
  """The bf16 instance of the tf32 branch at blocks of 8s, forward and dx
  at every group width (one column; two 8- or 16-wide columns; four
  8-wide ones): the stage
  table walked with bf16's fragment loads and W copy (_walk_stages: a
  chunk of 8 channels -- a block of 8, the tail of a block of 24 -- in one
  k-step by tf_half_channel, a full chunk by tf_channel), the x tile's
  channels past the chunk (the next input block's) NaN, gives
  tap_conv_reference's sums, finite: no lane reads past its block."""
  kh, kw = ksize
  gen = torch.Generator().manual_seed(cin + cout + width)
  occ = (torch.rand(kh * kw, cin // block[0], cout // block[1],
                    generator=gen) < 0.4).to(torch.int32)
  occ[:, :, 0] = 0
  occ[0] = 0
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  index = tbsc.tap_index(tbsc.TapPack(cols, rows, taps),
                         (kh, kw, cin, cout), block)
  assert tbsc.tap_branch(kh, kw, *block, BF16) == 'tf32'
  x = torch.randn(2, 3, width, cin, generator=gen)
  gy = torch.randn(2, 3, width, cout, generator=gen)
  w4 = torch.randn(kh, kw, cin, cout, generator=gen)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    out_w = block[1] if mode == 'fwd' else block[0]
    ncols = (cout if mode == 'fwd' else cin) // out_w
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    scale = max(1.0, float(want.abs().max()))
    widths = {1} | {g for g in (tbsc.TAP_TF32_GROUP,
                                *tbsc.TAP_TF32_GROUPS_8)
                    if g * out_w <= 32 and out_w in (8, 16) and ncols > 1}
    for gcols in sorted(widths):
      got = _walk_stages(a, w4, index, mode, gcols, width, BF16)
      assert bool(torch.isfinite(got).all()), (mode, gcols)
      assert float((got - want).abs().max()) <= 1e-5 * scale, (mode, gcols)


# ---------------------------------------------- the index, once a packing --
BLOCK = (8, 8)


class TinyNet(nn.Module):
  """1x1, 3x3 and strided 1x1 convs, all block-eligible under (8, 8), and
  a dense head (tests/test_torch_block_execution.py's TinyNet)."""

  def __init__(self):
    super().__init__()
    gen = torch.Generator().manual_seed(0)
    conv = functools.partial(common.ConvFixedPad, block=BLOCK,
                             generator=gen, device='cpu')
    self.c1 = conv(8, 16, 1, 1)
    self.c3x3 = conv(16, 16, 3, 1)
    self.c2 = conv(16, 32, 1, 2)
    self.head = Dense(32, 10, generator=gen, device='cpu')
    common.set_conv_paths(self)

  def forward(self, x, train=False, block_masks=None):
    x = torch.relu(self.c1(x, block_masks))
    x = torch.relu(self.c3x3(x, block_masks))
    x = torch.relu(self.c2(x, block_masks))
    return self.head(x.mean(dim=(1, 2)))


def _tap_step():
  """The dense-masked RigL step of TinyNet with every conv on the tap
  kernels (block_conv3x3), mask updates at steps 0 and 2."""
  model = TinyNet()
  st = SparseTraining(
      functools.partial(torch.optim.SGD, lr=0.05, momentum=0.9),
      algorithms.get_algorithm('rigl', schedule=UpdateSchedule(
          begin_step=0, end_step=100, frequency=2, drop_fraction=0.5)),
      distribution='uniform', default_sparsity=0.5, block=BLOCK, seed=3)
  state = steps.init_train_state(0, model, st, has_batch_stats=False)
  fn = steps.make_train_step(model, st, has_batch_stats=False, block=BLOCK,
                             block_conv3x3=True)
  return fn, state


def _batches(n):
  gen = torch.Generator().manual_seed(1)
  return [{'image': torch.randn(2, 4, 4, 8, generator=gen),
           'label': torch.randint(0, 10, (2,), generator=gen)}
          for _ in range(n)]


def test_train_step_builds_the_tap_index_once_per_packing(monkeypatch):
  """Steps with the same masks build each conv's TapIndex once (on the
  layer's TapPack); a mask update makes new packs, whose first step
  builds new ones; and the step's losses and parameters are bitwise
  those of a run whose packs keep nothing (plain dicts: an index built
  on every call)."""
  built = []

  class Counting(tbsc.TapIndex):
    def __init__(self, *args, **kwargs):
      built.append(kwargs['kernel_size'])
      super().__init__(*args, **kwargs)

  monkeypatch.setattr(tbsc, 'TapIndex', Counting)
  fn, state = _tap_step()
  fn_ref, state_ref = _tap_step()
  packs = state.sparse.block_packs
  assert set(packs) == {'c1/conv/kernel', 'c3x3/conv/kernel',
                        'c2/conv/kernel'}
  assert all(isinstance(e, tbsc.TapPack)
             and set(e) == {'cols', 'rows', 'taps'} for e in packs.values())
  per_iteration = []
  for batch in _batches(5):
    before = dict(state.sparse.block_packs)
    n = len(built)
    state, m = fn(state, batch)
    per_iteration.append((len(built) - n, bool(m['mask_updated'])))
    plain = {p: dict(e) for p, e in state_ref.sparse.block_packs.items()}
    state_ref = state_ref.replace(
        sparse=state_ref.sparse.replace(block_packs=plain))
    state_ref, m_ref = fn_ref(state_ref, batch)
    assert float(m['loss']) == float(m_ref['loss'])
    same = all(state.sparse.block_packs[p] is e for p, e in before.items())
    assert same != bool(m['mask_updated'])
  for p, t in state.params.items():
    assert torch.equal(t, state_ref.params[p]), p
  # The update iterations (steps 0 and 2) swap the packs; the first hot
  # step after each builds three indices, and the next (step 1) none.
  assert [u for _, u in per_iteration] == [True, False, False, True, False]
  assert [n for n, _ in per_iteration[1:3]] == [3, 0]
  assert per_iteration[4] == (3, False)
