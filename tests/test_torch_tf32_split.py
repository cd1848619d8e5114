"""Error-compensated TF32 (3xTF32), the products of the f32 flash backward
(rigl_tpu_torch/csrc/flash_attn.cu, section "f32"), modelled in plain
torch on the CPU: no JAX, no card.

The tensor cores read a tf32 operand as the top 19 bits of its f32
pattern (10 mantissa bits, the rest ignored: truncation toward zero).
The kernels split each f32 operand x into hi = x and lo = x minus hi's
truncation (hopper.cuh `tf32_split`, held here against its expressions
read from the source) and take a b as a_hi b_hi + a_hi b_lo + a_lo b_hi,
three tf32 wgmma products summed in f32.  Here tf32 is that truncation
done on the bits, each tf32 product is exact in f32 (11 x 11 significant
bits), and the sums are torch's f32 matmuls.  Were the tensor cores to
round rather than truncate, the errors would only shrink.  The backward
built from such products stays within FLASH_F32_TOL (1e-4 of each
output's largest value, the card tests' and chip_smoke.py's tolerance)
of float64 with a margin held at 10x: these inputs measure 6.5e-7 to
2.8e-6, 35x or more under it, where one tf32 pass gives 1.6e-3 to 5.0e-3.  The model also walks the
kernels' shared-memory addressing (f32_sw128, the fragment loads, the
k-step order), each formula evaluated from its C source, checks that the
fragments read the elements the tf32 fragment layout names and that each
warp-wide access falls on 32 distinct banks.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rigl_tpu_torch.ops import flash_attention as tfa

FLASH_F32_TOL = 1e-4
MARGIN = 10.0


@pytest.fixture(scope='module', autouse=True)
def one_thread():
  """One intra-op thread: these products are small, and beside the other
  test workers more threads only contend (about 0.5 s for the file on
  one thread, several times that on eight)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


CSRC = Path(tfa.__file__).resolve().parents[1] / 'csrc'
HOPPER = (CSRC / 'hopper.cuh').read_text()
FLASH = (CSRC / 'flash_attn.cu').read_text()
NAN_BITS = 0x7FFFFFFF


def tf32(x: torch.Tensor) -> torch.Tensor:
  """x (f32) as the tensor cores read a tf32 operand: the 13 low mantissa
  bits cleared."""
  return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_bits(x: torch.Tensor):
  """(hi, lo) as tf32_split stores them: hi = x, lo = x - tf32(x)."""
  return x, x - tf32(x)


def split(x: torch.Tensor):
  """(hi, lo) as the tensor cores read them."""
  hi, lo = split_bits(x)
  return tf32(hi), tf32(lo)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b in 3xTF32, summed in f32."""
  a_hi, a_lo = split(a)
  b_hi, b_lo = split(b)
  return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b in one tf32 pass."""
  return tf32(a) @ tf32(b)


def backward(q, k, v, do, lse, d, scale, mm):
  """(dq, dk, dv) by the kernels' formulas with every product through
  `mm`, in f32: P = exp(scale q kᵀ - lse) (0 above the diagonal), dS = P
  (do vᵀ - D) scale, dv = Pᵀ do, dk = dSᵀ q, dq = dS k."""
  s = q.shape[-2]
  mask = torch.ones(s, s, dtype=torch.bool).tril()
  p = torch.where(mask, torch.exp(mm(q, k.mT) * scale - lse[..., None]), 0.)
  ds = p * (mm(do, v.mT) - d[..., None]) * scale
  return mm(ds, k), mm(ds.mT, q), mm(p.mT, do)


def _inputs(s, hd, seed):
  rng = np.random.default_rng(seed)
  q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, hd),
                                                      dtype=np.float32))
                 for _ in range(4))
  return q, k, v, do


def _rel(got, want):
  return float((got.double() - want).abs().max() / want.abs().max())


# The card tests' (S, hd) (tests/test_torch_kernels_cuda.py
# test_flash_f32_kernels_match_plain), one head each: the error is a
# statistic of each head's sums, which more heads only sample again.
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('s', [5, 64, 130, 512, 1000])
def test_three_pass_backward_within_tolerance_of_f64(s, hd):
  q, k, v, do = _inputs(s, hd, 7 * s + hd)
  scale = hd ** -0.5
  q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
  o64, lse64 = tfa.flash_attention_fwd_reference(q64, k64, v64, scale)
  d64 = (do64 * o64).sum(-1)
  want = backward(q64, k64, v64, do64, lse64, d64, scale, torch.matmul)
  got = backward(q, k, v, do, lse64.float(), d64.float(), scale, mm3)
  errs = [_rel(g, w) for g, w in zip(got, want)]
  assert max(errs) * MARGIN <= FLASH_F32_TOL, errs


def test_one_pass_misses_the_tolerance():
  """One tf32 pass rounds both operands to 11 significant bits: at the
  train step's (S, hd) = (512, 128) the backward misses 1e-4, which is
  why the kernels take three."""
  q, k, v, do = _inputs(512, 128, 0)
  scale = 128 ** -0.5
  q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
  o64, lse64 = tfa.flash_attention_fwd_reference(q64, k64, v64, scale)
  d64 = (do64 * o64).sum(-1)
  want = backward(q64, k64, v64, do64, lse64, d64, scale, torch.matmul)
  got = backward(q, k, v, do, lse64.float(), d64.float(), scale, mm1)
  assert max(_rel(g, w) for g, w in zip(got, want)) > FLASH_F32_TOL


def test_tf32_reads_truncated():
  one = 1.0
  ulp = 2.0 ** -10   # tf32's spacing in [1, 2)
  x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp - 2 ** -23,
                    one + 3 * ulp / 2, 3.0, 0.0, -0.0], dtype=torch.float32)
  want = torch.tensor([one, -one, one, one + ulp, 3.0, 0.0, -0.0])
  assert torch.equal(tf32(x).view(torch.int32), want.view(torch.int32))


def test_split_keeps_20_bits():
  """hi + lo as read is x to 2^-20 |x|: lo is below one tf32 step of x
  (2^-10 |x|) and is read to 10 bits in turn."""
  rng = np.random.default_rng(1)
  x = torch.from_numpy((rng.standard_normal(4096)
                        * 2.0 ** rng.integers(-20, 20, 4096)).astype(
                            np.float32))
  hi, lo = split(x)
  assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
  assert bool((lo.abs() <= x.abs() * 2.0 ** -10).all())
  err = (x.double() - hi.double() - lo.double()).abs()
  assert bool((err <= x.double().abs() * 2.0 ** -20).all())


def test_split_keeps_nan_and_the_product_carries_it():
  """A NaN operand is NaN in every product it enters, in either operand:
  the card's NaN (0x7FFFFFFF, either sign) reads as a NaN hi, and a NaN
  whose mantissa lies in the ignored bits reads as an infinite hi with a
  NaN lo.  (A split that rounded by a bare add-and-mask would turn
  0x7FFFFFFF into -0 and the product finite.)"""
  bits = torch.tensor([NAN_BITS, -1, 0x7F800001, 0x7FFFF000],
                      dtype=torch.int32)
  nan = bits.view(torch.float32)
  hi, lo = split(nan)
  assert bool((torch.isnan(hi) | torch.isnan(lo)).all())
  assert bool(torch.isnan(hi[[0, 1, 3]]).all()) and bool(torch.isnan(lo[2]))
  for i in range(4):
    a = torch.ones(4, 8)
    a[1, 5] = nan[i]
    got = mm3(a, torch.ones(8, 3))
    assert bool(torch.isnan(got[1]).all())
    assert torch.equal(got[[0, 2, 3]], torch.full((3, 3), 8.))
    assert bool(torch.isnan(mm3(torch.ones(3, 8), a.T)[:, 1]).all())


# ---- the kernels' formulas, read from their C source ---------------------
def _c_expr(pattern: str, src: str) -> str:
  """The C expression `pattern`'s first group matches in `src`, as Python:
  casts and unsigned suffixes dropped, integer division as //,
  threadIdx.x as tid."""
  found = re.search(pattern, src, re.S)
  assert found, pattern
  expr = re.sub(r'static_cast<\w+>', '', found.group(1))
  expr = re.sub(r'\b(0x[0-9A-Fa-f]+|\d+)u\b', r'\1', expr)
  expr = expr.replace('threadIdx.x', 'tid').replace(' / ', ' // ')
  return ' '.join(expr.split())


def _c_function(name: str, args: str, src: str):
  """The one-line C function `name` (its body a single return), as a
  Python function of `args`."""
  expr = _c_expr(name + r'\([^)]*\) \{\s*return (.*?);\n\}', src)
  return eval(f'lambda {args}: {expr}')   # noqa: S307 (the repo's source)


def _struct(name: str, src: str) -> str:
  found = re.search(r'struct ' + name + r' \{(.*?)\n\};', src, re.S)
  assert found, name
  return found.group(1)


f32_sw128 = _c_function('f32_sw128', 'r, c, rows', HOPPER)
kstep_row = _c_function('kstep_row', 'i', FLASH)
kstep_pos = _c_function('kstep_pos', 'row', FLASH)


def _as_uint(x):
  return np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)


def _as_float(u):
  return np.asarray(u, np.uint64).astype(np.uint32).view(np.float32)


def test_split_model_is_the_kernels_split():
  """split_bits above stores tf32_split's bits (its two expressions
  evaluated from hopper.cuh) on random patterns and every special one:
  zeros, infinities, the largest finite, subnormals and NaNs of either
  sign, with the ignored bits at and around half a step (NaN results
  compared as NaN: the card's arithmetic gives 0x7FFFFFFF, the host's
  keeps the payload)."""
  body = re.search(r'void tf32_split\(.*?\{(.*?)\n\}', HOPPER, re.S)
  assert body
  hi_e = _c_expr(r'hi = (.*?);', body.group(1))
  lo_e = _c_expr(r'lo = (.*?);', body.group(1))
  rng = np.random.default_rng(3)
  special = [0, 0x80000000, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF,
             0x00000001, 0x00001000, 0x00000FFF, 0x807FFFFF, 0x7FFFFFFF,
             0xFFFFFFFF, 0x7F800001, 0x7FC00000, 0x7FFFF000, 0xFFC00000,
             0x3F800FFF, 0x3F801000, 0xBF801000, 0x3F803000]
  u = np.concatenate([np.array(special, np.uint64),
                      rng.integers(0, 2 ** 32, 1 << 14, dtype=np.uint64)])
  env = {'x': _as_float(u), '__float_as_uint': _as_uint,
         '__uint_as_float': _as_float}
  with np.errstate(invalid='ignore'):
    env['hi'] = eval(hi_e, env)
    want = (env['hi'], eval(lo_e, env))
    x = torch.from_numpy(u.astype(np.uint32).view(np.int32)).view(
        torch.float32)
    got = [_as_uint(t.numpy()) for t in split_bits(x)]
  for g, w in zip(got, want):
    g_nan, w_nan = np.isnan(_as_float(g)), np.isnan(_as_float(w))
    assert np.array_equal(g_nan, w_nan)
    assert np.array_equal(g[~g_nan], w[~w_nan])


def _banks(offsets):
  """The distinct 4-byte banks a warp's 32 accesses of 4 bytes touch."""
  return len({(o // 4) % 32 for o in offsets})


def _row_frag():
  """Tf32RowFrag<64> over a tile at 0 (hopper.cuh): address(tid, kk, i)
  of fragment register i at k-step kk."""
  body = _struct('Tf32RowFrag', HOPPER)
  r = _c_expr(r'const int r = (.*?);', body)
  at = _c_expr(r'at\[h\]\[a\] = (.*?);', body)
  load = _c_expr(r'ld_shared_f32\((.*?)\);', body)
  at, load = (compile(e, 'hopper.cuh', 'eval') for e in (at, load))

  @functools.cache
  def constructed(tid):   # the constructor's table, once a thread
    env = {'tid': tid, 'lane': tid % 32, 'tile': 0, 'kRows': 64}
    env['r'] = eval(r, env)
    env['at'] = [[eval(at, dict(env, h=h, a=a)) for a in range(8)]
                 for h in range(2)]
    return env

  def address(tid, kk, i):
    return eval(load, dict(constructed(tid), kk=kk, i=i))
  return address


def _col_frag():
  """ColFrag<HD> over a tile at 0 (flash_attn.cu): address(tid, m0, kk,
  i), and whether the load is on (m < HD)."""
  body = _struct('ColFrag', FLASH)
  m = _c_expr(r'const int m = (.*?);', body)
  at = compile(_c_expr(r'at\[i\] = (.*?);', body), 'flash_attn.cu', 'eval')
  load = compile(_c_expr(r'"r"\((at\[i\] .*?)\),', body), 'flash_attn.cu',
                 'eval')
  funcs = {'f32_sw128': f32_sw128, 'kstep_row': kstep_row,
           'kF32Stream': 64}

  @functools.cache
  def constructed(tid, m0):
    env = dict(funcs, tid=tid, lane=tid % 32, m0=m0, tile=0)
    env['m'] = eval(m, env)
    env['at'] = [eval(at, dict(env, i=j)) for j in range(4)]
    return env

  def address(tid, m0, kk, i):
    return eval(load, dict(constructed(tid, m0), kk=kk, i=i))
  return address


def _transposed_at():
  """transposed_at(rows) (flash_attn.cu): this thread's four addresses."""
  found = re.search(r'void transposed_at\(.*?\n\}', FLASH, re.S)
  assert found
  r = compile(_c_expr(r'const int r = (.*?);', found.group(0)),
              'flash_attn.cu', 'eval')
  at = compile(_c_expr(r'at\[2 \* h \+ v\] = (.*?);', found.group(0)),
               'flash_attn.cu', 'eval')

  def address(tid, rows):
    out = [0] * 4
    for h in range(2):
      for v in range(2):
        env = {'tid': tid, 'lane': tid % 32, 'h': h, 'v': v, 'rows': rows,
               'f32_sw128': f32_sw128, 'kstep_pos': kstep_pos}
        env['r'] = eval(r, env)
        out[2 * h + v] = eval(at, env)
    return out
  return address


def test_source_formulas_keep_their_known_values():
  """Spot values of the parsed formulas, so that a parse that read the
  wrong text cannot pass by agreeing with itself."""
  assert [kstep_row(i) for i in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]
  assert f32_sw128(0, 0, 64) == 0 and f32_sw128(1, 0, 64) == 128 + 16
  assert f32_sw128(0, 33, 64) == 64 * 128 + 4
  assert f32_sw128(3, 13, 32) == 3 * 128 + ((3 ^ 3) << 4) + 4


def test_kstep_order_is_a_permutation_and_its_inverse():
  rows = [kstep_row(i) for i in range(8)]
  assert sorted(rows) == list(range(8))
  assert [kstep_pos(r) for r in rows] == list(range(8))


def test_fragment_loads_fall_on_distinct_banks():
  """Tf32RowFrag (over a streamed 64-row tile's columns, hd up to 128)
  and ColFrag (over its rows in kstep_row order, the M columns in two
  m-tiles), as the source computes them: fragment register i of lane l
  in warp w reads A's element (16 w + l / 4 + 8 (i & 1), l % 4 + 4 (i >>
  1)) of its k-step (the tf32 A layout), and at every warp, k-step and
  register the 32 lanes' loads hit 32 distinct banks."""
  row_frag, col_frag = _row_frag(), _col_frag()
  for warp in range(4):
    for i in range(4):
      for kk in range(16):
        offs = [row_frag(32 * warp + lane, kk, i) for lane in range(32)]
        assert offs == [f32_sw128(16 * warp + lane // 4 + 8 * (i & 1),
                                  8 * kk + lane % 4 + 4 * (i >> 1), 64)
                        for lane in range(32)]
        assert _banks(offs) == 32
      for kk in range(8):
        for mt in range(2):
          offs = [col_frag(32 * warp + lane, 64 * mt, kk, i)
                  for lane in range(32)]
          assert offs == [
              f32_sw128(8 * kk + kstep_row(lane % 4 + 4 * (i >> 1)),
                        64 * mt + 16 * warp + lane // 4 + 8 * (i & 1), 64)
              for lane in range(32)]
          assert _banks(offs) == 32


def test_transposed_writes_fall_on_distinct_banks():
  """The Pᵀ / dSᵀ (dK/dV) and dS (dQ) writes, at transposed_at's
  addresses plus 1024 j: accumulator element (row 16 w + lane / 4 + 8 h,
  column 8 j + 2 (lane % 4) + v) of S lands at row = its column, position
  kstep_pos of its row in the row's k-step; for each (j, h, v) the warp's
  32 stores hit 32 distinct banks."""
  transposed_at = _transposed_at()
  for n_own in (16, 32, 64):
    for warp in range(4):
      ats = [transposed_at(32 * warp + lane, n_own) for lane in range(32)]
      for j in range(n_own // 8):
        for h in range(2):
          for v in range(2):
            offs = [at[2 * h + v] + 1024 * j for at in ats]
            want = []
            for lane in range(32):
              q = 16 * warp + lane // 4 + 8 * h
              k = 8 * j + 2 * (lane % 4) + v
              want.append(f32_sw128(k, 8 * (q // 8) + kstep_pos(q % 8),
                                    n_own))
            assert offs == want
            assert _banks(offs) == 32


def test_transposed_product_order_matches():
  """dVᵀ = dOᵀ P in the kernels' order: A from ColFrag (row 8 kk +
  kstep_row(k) of the dO tile), B = Pᵀ at position 8 kk + k holding q
  row 8 kk + kstep_row(k) (written at kstep_pos): the k-steps sum the same
  terms as dOᵀ P."""
  rng = np.random.default_rng(2)
  do = rng.standard_normal((64, 32))
  p = rng.standard_normal((64, 16))   # q rows x owned k
  bt = np.zeros((16, 64))             # Pᵀ as stored: [k][position]
  for q in range(64):
    bt[:, 8 * (q // 8) + kstep_pos(q % 8)] = p[q]
  got = np.zeros((32, 16))
  for kk in range(8):
    for kpos in range(8):
      got += np.outer(do[8 * kk + kstep_row(kpos)], bt[:, 8 * kk + kpos])
  np.testing.assert_allclose(got, do.T @ p, rtol=1e-12, atol=1e-12)
