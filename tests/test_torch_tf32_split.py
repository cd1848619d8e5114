"""Error-compensated TF32 (3xTF32), the products of the f32 flash backward
(rigl_tpu_torch/csrc/flash_attn.cu, section "f32") and of the f32 dw
(csrc/packed_mm.cu packed_dw_3xtf32_kernel, at the end of this file),
modelled in plain torch on the CPU: no JAX, no card.

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
warp-wide access falls on 32 distinct banks; and it checks that a bf16
value widened to f32 is its own tf32 read, the premise of the tap conv's
bf16 instance (one tf32 product a k-step).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rigl_tpu_torch.ops import dw_split
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
kstep_row = _c_function('kstep_row', 'i', HOPPER)
kstep_pos = _c_function('kstep_pos', 'row', HOPPER)


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


def test_bf16_widened_is_its_own_tf32_hi():
  """Every one of the 65536 bf16 patterns, widened to f32 as the bf16
  instance of tap_conv_tf32_kernel widens it (the 16 bits shifted up: the
  value torch's bf16-to-f32 conversion gives), is read by the tensor cores
  as itself: tf32 keeps 10 mantissa bits, bf16 has 7.  tf32_split (its
  expressions from hopper.cuh) gives hi == the value for every pattern,
  NaN and infinities included, and lo == +0 for every finite one, so on
  finite inputs the one product a_hi b_hi that the bf16 instance runs is
  the three of 3xTF32.  An infinity's lo is NaN (inf - inf): 3xTF32 would
  turn an infinite input into NaN, where one product keeps it infinite, as
  a bf16 product does; a NaN's lo is NaN too."""
  body = re.search(r'void tf32_split\(.*?\{(.*?)\n\}', HOPPER, re.S)
  hi_e = _c_expr(r'hi = (.*?);', body.group(1))
  lo_e = _c_expr(r'lo = (.*?);', body.group(1))
  bits = np.arange(1 << 16, dtype=np.uint64)
  wide = bits << 16
  x = _as_float(wide)
  conv = torch.from_numpy(bits.astype(np.uint16).view(np.int16)).view(
      torch.bfloat16).float().numpy()
  nan = np.isnan(x)
  assert np.array_equal(np.isnan(conv), nan)
  assert np.array_equal(_as_uint(conv)[~nan], wide[~nan])
  env = {'x': x, '__float_as_uint': _as_uint, '__uint_as_float': _as_float}
  with np.errstate(invalid='ignore'):
    env['hi'] = eval(hi_e, env)
    lo = _as_float(eval(lo_e, env))
  assert np.array_equal(env['hi'], wide)
  read = tf32(torch.from_numpy(x.copy())).numpy()
  assert np.array_equal(_as_uint(read)[~nan], wide[~nan])
  assert bool(np.isnan(read[nan]).all())
  finite = np.isfinite(x)
  assert not _as_uint(lo[finite]).any()   # +0: every bit clear
  assert bool(np.isnan(lo[~finite]).all())
  assert int((~finite & ~nan).sum()) == 2   # the two infinities
  rng = np.random.default_rng(7)
  pick = rng.choice(np.flatnonzero(finite), (2, 64, 96))
  # Finite bf16 patterns, scaled into range and rounded back to bf16.
  a = torch.from_numpy(x[pick[0]][:, :32].copy())
  b = torch.from_numpy(x[pick[1]][:32, :].copy())
  a = (a / a.abs().max()).bfloat16().float()
  b = (b / b.abs().max()).bfloat16().float()
  assert torch.equal(tf32(a) @ tf32(b), mm3(a, b))


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


def _col_frag(rows=64):
  """Tf32ColFrag<rows> over a tile at 0 (hopper.cuh): address(tid, m0, kk,
  i) of fragment register i at k-step kk."""
  body = _struct('Tf32ColFrag', HOPPER)
  m = _c_expr(r'const int m = (.*?);', body)
  at = compile(_c_expr(r'at\[i\] = (.*?);', body), 'hopper.cuh', 'eval')
  load = compile(_c_expr(r'"r"\((at\[i\] .*?)\),', body), 'hopper.cuh',
                 'eval')
  funcs = {'f32_sw128': f32_sw128, 'kstep_row': kstep_row, 'kRows': rows}

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
  and Tf32ColFrag (over its rows in kstep_row order, the M columns in two
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
  """dVᵀ = dOᵀ P in the kernels' order: A from Tf32ColFrag (row 8 kk +
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


# ---- the f32 dw: csrc/packed_mm.cu packed_dw_3xtf32_kernel ---------------
# dw = xᵀ gy, summed over m in k-steps of 8 rows, each k-step's three tf32
# products added to an f32 accumulator (a tile's, or a slice's partial,
# the partials added in slice order).  Its shared-memory formulas are read
# from the source: x as it lands is the register A operand (Tf32ColFrag
# over a chunk of kDwChunk rows), gy is transposed by DwTranspose into
# K-major hi / lo B tiles.
MM = (CSRC / 'packed_mm.cu').read_text()
DW_TOL = 1e-4        # the f32 dw's card tolerance, of max(1, max |plain|)
DW_SPLIT_TOL = 1e-5  # split against unsplit, as the card tests hold it


def _mm_int(name):
  """An integer constant of packed_mm.cu, `constexpr int name = ...;`."""
  env = {}
  for const in ('kDwChunk', 'kDwBoxBytes'):
    env[const] = eval(_c_expr(r'constexpr int ' + const + r' = (.*?);', MM),
                      env)
  return env[name]


def _c_ternary(expr):
  """A C expression whose `a ? b : c` are each parenthesised or the whole
  expression, none nested, as Python (|| and && too)."""
  expr = expr.replace(' || ', ' or ').replace(' && ', ' and ')
  inner = r'\(([^()?]*?) \? ([^()?]*?) : ([^()?]*?)\)'
  expr = re.sub(inner, r'((\2) if (\1) else (\3))', expr)
  found = re.fullmatch(r'([^?]*?) \? ([^?]*?) : ([^?]*)', expr)
  if not found:
    return expr
  return f'({found.group(2)}) if ({found.group(1)}) else ({found.group(3)})'


def _dw_plan(tm, tn):
  """DwTf32Plan<tm, tn>'s constants, each evaluated from its source line
  in order."""
  env = {'TM': tm, 'TN': tn, 'kDwChunk': _mm_int('kDwChunk'),
         'kDwBoxBytes': _mm_int('kDwBoxBytes')}
  body = _struct('DwTf32Plan', MM)
  for name, expr in re.findall(r'static constexpr int (\w+) = (.*?);', body,
                               re.S):
    expr = _c_expr(r'(.*)', expr.replace('std::min', 'min'))
    env[name] = eval(_c_ternary(expr), dict(env, min=min))
  return env


def _dw_transpose(tm, tn):
  """(plan, [(thread t, [(j, h, i, gy offset, (m, n), hi offset in the B
  tile)] for each of its loads in program order), ...]): DwTranspose<P,
  TN> from its source, each load's gy offset turned back into its (row m,
  column n) of the gy boxes, each store's offset kept."""
  plan = _dw_plan(tm, tn)
  body = _struct('DwTranspose', MM)

  def expr(pattern):
    return compile(_c_ternary(_c_expr(pattern, body).replace('P::', '')),
                   'packed_mm.cu', 'eval')
  consts = dict(plan, f32_sw128=f32_sw128)
  for name in ('kUnits', 'kPer'):
    consts[name] = eval(expr(r'static constexpr int ' + name + r' =(.*?);'),
                        consts)
  ld_e = expr(r'ld\[v\] = (.*?);')
  u_e, n_e, kk_e = (expr(r'const int ' + v + r' = (.*?);')
                    for v in ('u', 'n', 'kk'))
  on_e = expr(r'units \+= (.*?);')
  gy_e, st_e = expr(r'gy\[j\] = (.*?);'), expr(r'st\[j\]\[h\] = (.*?);')
  g_e = expr(r'const uint32_t g = (.*?);')
  load_e = expr(r'x\[v\] = ld_shared_f32\((.*?)\);')
  elem_e = expr(r'tf32_split\(x\[(.*?)\],')
  hi_e = expr(r'st_shared_v4\((stage \+ P::kHi \+ .*?),')
  gy_at = {f32_sw128(m, c, plan['kDwChunk']): (m, c)
           for m in range(plan['kDwChunk'])
           for c in range(32 * plan['kGyBoxes'])}
  out = []
  for t in range(plan['kTransposers']):
    env = dict(consts, t=t)
    env['ld'] = [eval(ld_e, dict(env, v=v)) for v in range(8)]
    gy, st, units = [], [], 0
    for j in range(consts['kPer']):
      env['j'] = j
      env['u'] = eval(u_e, env)
      env['n'], env['kk'] = eval(n_e, env), eval(kk_e, env)
      units += bool(eval(on_e, env))
      gy.append(eval(gy_e, env))
      st.append([eval(st_e, dict(env, h=h)) for h in range(2)])
    env.update(gy=gy, st=st)
    loads = []
    for j in range(units):
      for h in range(2):
        store = eval(hi_e, dict(env, j=j, h=h, stage=0)) - plan['kHi']
        g = eval(g_e, dict(env, j=j, stage=0)) - plan['kGy']
        for i in range(4):
          v = eval(elem_e, dict(env, h=h, i=i))
          offset = eval(load_e, dict(env, j=j, v=v, g=g))
          loads.append((j, h, i, offset, gy_at[offset], store + 4 * i))
    out.append((t, loads))
  return plan, out


# (tm, tn): every f32 tile dw_tile names.
DW_VARIANTS = [(128, 128), (64, 16)]


def _rz(x64):
  """x64 (float64) to float32 toward zero: the tensor cores' f32
  accumulation modelled as dropping the low bits of each sum."""
  y = x64.float()
  over = y.double().abs() > x64.abs()
  return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _dw3(x, gy, chunk, slices=1, fresh=True):
  """xᵀ gy as the kernel sums it: each slice of whole chunks
  (dw_split.slice_rows) in k-steps of 8 rows, rows past m zero; each
  k-step's three tf32 products (a_hi b_hi, a_hi b_lo, a_lo b_hi), each an
  exact sum of 8, added in turn to a tensor-core accumulator that drops
  the low bits (_rz).  With `fresh`, as the kernel, that accumulator
  starts afresh every kFlush chunks (DwTf32Plan) and is added
  to the slice's f32 sum (rounded to nearest); without, one accumulator
  takes the whole slice.  The slices' partials are added in slice
  order."""
  steps_fresh = _dw_plan(128, 128)['kFlush'] * chunk // 8
  m = x.shape[0]
  rows = dw_split.slice_rows(m, chunk, slices)
  total = None
  for b in range(0, m, rows):
    xs, gs = x[b:b + rows], gy[b:b + rows]
    pad = -xs.shape[0] % chunk
    xs = torch.cat([xs, xs.new_zeros(pad, xs.shape[1])])
    gs = torch.cat([gs, gs.new_zeros(pad, gs.shape[1])])
    (x_hi, x_lo), (g_hi, g_lo) = split(xs), split(gs)
    steps = xs.shape[0] // 8

    def per_step(a, g):
      return torch.bmm(a.reshape(steps, 8, -1).mT.double(),
                       g.reshape(steps, 8, -1).double())
    terms = (per_step(x_hi, g_hi), per_step(x_hi, g_lo),
             per_step(x_lo, g_hi))
    acc = torch.zeros(x.shape[1], gy.shape[1])
    tc = torch.zeros_like(acc)
    for k in range(steps):
      if fresh and k and k % steps_fresh == 0:
        acc, tc = acc + tc, torch.zeros_like(acc)
      for term in terms:
        tc = _rz(tc.double() + term[k])
    acc = acc + tc if fresh else tc
    total = acc if total is None else total + acc
  return total


def test_dw_chunk_is_the_kernels_and_the_plans():
  from rigl_tpu_torch.ops import block_sparse_packed as tbsp
  assert _mm_int('kDwChunk') == tbsp.DW_TILES[1][2] == 32
  assert _mm_int('kDwBoxBytes') == 32 * 128


@pytest.mark.parametrize('code', [1, 2])
def test_dw_plans_blocks_an_sm_as_the_kernel_runs_them(code):
  """DW_TILES' f32 tiles are DwTf32Plan's, and the thread blocks an SM
  that dw_plan sizes its split for are the kernel's kPerSm (its launch
  bounds): as many as 228 KB of shared memory hold, within 2048 threads;
  one at 128 x 128, three at 64 x 16."""
  from rigl_tpu_torch.ops import block_sparse_packed as tbsp
  tm, tn, chunk, per_sm = tbsp.DW_TILES[code]
  plan = _dw_plan(tm, tn)
  assert (chunk, per_sm) == (plan['kDwChunk'], plan['kPerSm'])
  assert per_sm * (plan['kSmem'] + 1024) <= 228 * 1024
  assert (per_sm + 1) * (plan['kSmem'] + 1024) > 228 * 1024
  assert per_sm * plan['kThreads'] <= 2048
  assert per_sm == {(128, 128): 1, (64, 16): 3}[(tm, tn)]
  assert re.search(r'__launch_bounds__\(DwTf32Plan<TM, TN>::kThreads,\s*'
                   r'DwTf32Plan<TM, TN>::kPerSm\)', MM)


@pytest.mark.parametrize('m', [16384, 16381])
def test_three_pass_dw_within_tolerance_of_f64(m):
  """A long m over narrow K and N (K = 16, N = 32: the sums, not the
  widths, carry the error), unsplit and in 3 slices: within DW_TOL of
  float64 with the 10x margin, and split within DW_SPLIT_TOL of unsplit
  with the same margin, where one tf32 pass misses DW_TOL (these measure
  1.4e-6 to 1.6e-6, 7.3e-7 to 7.6e-7, and 7.0e-4 to 7.8e-4)."""
  rng = np.random.default_rng(m)
  x = torch.from_numpy(rng.standard_normal((m, 16), dtype=np.float32))
  gy = torch.from_numpy(rng.standard_normal((m, 32), dtype=np.float32))
  want = x.double().T @ gy.double()
  scale = max(1.0, float(want.abs().max()))
  chunk = _mm_int('kDwChunk')
  got = {s: _dw3(x, gy, chunk, s) for s in (1, 3)}
  for s, g in got.items():
    err = float((g.double() - want).abs().max()) / scale
    assert err * MARGIN <= DW_TOL, (s, err)
  diff = float((got[1] - got[3]).abs().max()) / scale
  assert diff * MARGIN <= DW_SPLIT_TOL, diff
  one = float((tf32(x).T @ tf32(gy)).double().sub(want).abs().max()) / scale
  assert one > DW_TOL, one


def test_one_accumulator_over_m_misses_the_split_tolerance():
  """Why the kernel starts its tensor-core accumulator afresh every few
  chunks:
  with one accumulator over the whole m-sum the dropped low bits add up
  with the products summed, and at the card tests' m = 4099 split and
  unsplit differ by more than DW_SPLIT_TOL (3.0e-5 here; 1.9e-5 to
  2.5e-5 measured on the card with such a kernel), where the fresh
  accumulators keep 10x within it (7.8e-7)."""
  rng = np.random.default_rng(4099)
  x = torch.from_numpy(rng.standard_normal((4099, 16), dtype=np.float32))
  gy = torch.from_numpy(rng.standard_normal((4099, 32), dtype=np.float32))
  scale = float((x.double().T @ gy.double()).abs().max())
  chunk = _mm_int('kDwChunk')
  for fresh, over in ((False, True), (True, False)):
    a, b = (_dw3(x, gy, chunk, s, fresh) for s in (1, 3))
    diff = float((a - b).abs().max()) / scale
    assert (diff > DW_SPLIT_TOL) == over, (fresh, diff)
    assert over or diff * MARGIN <= DW_SPLIT_TOL, (fresh, diff)


@pytest.mark.parametrize('tm,tn', DW_VARIANTS)
def test_dw_transpose_writes_each_element_once_where_the_fragments_read(
    tm, tn):
  """DwTranspose as the source computes it: every gy element (row m,
  column n < TN) of a chunk is loaded by one thread once, a thread's
  columns agreeing with it mod 32, and its hi / lo land at row n, position
  8 (m / 8) + kstep_pos(m % 8) of the K-major B tile (f32_sw128 with TN
  rows), where Tf32ColFrag's k-step order reads row m; lo sits P::kLo -
  P::kHi past hi."""
  plan, threads = _dw_transpose(tm, tn)
  b_at = {f32_sw128(n, p, tn): (n, p) for n in range(tn) for p in range(32)}
  seen = {}
  for t, loads in threads:
    for _, _, _, _, (m, n), store in loads:
      assert n % 32 == t % min(tn, 32)
      assert b_at[store] == (n, 8 * (m // 8) + kstep_pos(m % 8))
      assert (m, n) not in seen
      seen[(m, n)] = t
  assert set(seen) == {(m, n) for m in range(32) for n in range(tn)}
  assert plan['kLo'] - plan['kHi'] == tn * 128


@pytest.mark.parametrize('tm,tn', DW_VARIANTS)
def test_dw_transpose_falls_on_distinct_banks(tm, tn):
  """A warp's loads of one (j, h, i) fall on 32 distinct banks (16 at TN
  = 16, where the warp's halves read one row's 16 columns each); each
  quarter-warp's 16-byte stores on 8 distinct 16-byte bank groups."""
  plan, threads = _dw_transpose(tm, tn)
  for w in range(plan['kTransposers'] // 32):
    warp = [threads[t] for t in range(32 * w, 32 * w + 32)]
    counts = {len(lanes) for _, lanes in warp}
    assert len(counts) == 1   # every lane of a warp takes as many units
    for step in range(counts.pop()):
      loads = [lanes[step] for _, lanes in warp]
      assert _banks([l[3] for l in loads]) == (16 if tn == 16 else 32)
      if loads[0][2] == 0:   # the 16-byte store of (j, h)
        for q in range(4):
          groups = {(l[5] // 16) % 8 for l in loads[8 * q:8 * q + 8]}
          assert len(groups) == 8


def test_dw_fragments_read_the_x_box_in_kstep_order():
  """The consumers' A fragments, Tf32ColFrag<kDwChunk> at the kernel's
  base (wg * 2 boxes, m0 0): register i of lane l in warp w of warpgroup
  wg reads x row 8 kk + kstep_row(l % 4 + 4 (i >> 1)), column 64 wg + 16
  w + l / 4 + 8 (i & 1) of the chunk's boxes as TMA writes them, on 32
  distinct banks."""
  found = re.search(r'Tf32ColFrag<kDwChunk> frag\((.*?)\);', MM, re.S)
  assert found
  tile_e, m0_e, limit_e = (_c_expr(r'(.*)', a)
                           for a in found.group(1).split(', '))
  chunk = _mm_int('kDwChunk')
  frag = _col_frag(chunk)
  for wg in range(2):
    env = {'base': 0, 'wg': wg, 'kDwBoxBytes': _mm_int('kDwBoxBytes')}
    tile, m0 = eval(tile_e, env), eval(m0_e, env)
    assert eval(limit_e, env) == 64 and m0 == 0
    for warp in range(4):
      for kk in range(chunk // 8):
        for i in range(4):
          offs = [tile + frag(128 * wg + 32 * warp + lane, m0, kk, i)
                  for lane in range(32)]
          assert offs == [
              f32_sw128(8 * kk + kstep_row(lane % 4 + 4 * (i >> 1)),
                        64 * wg + 16 * warp + lane // 4 + 8 * (i & 1), chunk)
              for lane in range(32)]
          assert _banks(offs) == 32


@pytest.mark.parametrize('tn', [16, 128])
def test_dw_stage_products_give_xt_gy(tn):
  """One chunk through the source's formulas: x and gy laid out as TMA
  writes them, gy transposed by DwTranspose into the B tile, A read in
  kstep_row order; the k-steps' sums over positions give xᵀ gy."""
  rng = np.random.default_rng(tn)
  x = rng.standard_normal((32, 128))
  gy = rng.standard_normal((32, max(tn, 32)))
  _, threads = _dw_transpose(128, tn)
  b = np.zeros(tn * 32)
  for _, loads in threads:
    for _, _, _, _, (m, n), store in loads:
      b[store // 4] = gy[m, n]
  got = np.zeros((128, tn))
  for kk in range(4):
    for p in range(8):
      a_col = x[8 * kk + kstep_row(p)]          # A[r][p] over r
      b_row = np.array([b[f32_sw128(n, 8 * kk + p, tn) // 4]
                        for n in range(tn)])
      got += np.outer(a_col, b_row)
  np.testing.assert_allclose(got, x.T @ gy[:, :tn], rtol=1e-12, atol=1e-12)


# ---- the f32 tap conv: csrc/tap_conv.cu tap_conv_3xtf32_kernel ------------
# Each output sums its column's entries, 16 channels (two k-steps of 8) an
# entry at blocks of 16: per k-step a_hi (b_hi | b_lo) as one product into
# two accumulators (at output tiles of at most 64) and a_lo b_hi into the
# first, each product an exact sum of 8 added to the tensor cores'
# accumulator, which drops the low bits; every kTfFlush stages of
# kTfEntries entries the sum goes into y in f32 and starts afresh.
TAP = (CSRC / 'tap_conv.cu').read_text()
TAP_TOL = 1e-4   # the tap conv's f32 card tolerance, of max(1, max |plain|)


def _tap_int(name):
  return int(re.search(r'constexpr int ' + name + r' = (\d+);',
                       TAP).group(1))


def _tap3(x, w, k_steps_per_flush):
  """x (P, 8 L) @ w (8 L, 16) as the kernel sums it: k-step by k-step, the
  a_hi b_hi and a_lo b_hi terms into one accumulator and a_hi b_lo into a
  second (each added to its accumulator toward zero, _rz), both flushed
  into an f32 sum (rounded to nearest) every k_steps_per_flush k-steps
  and at the end."""
  (x_hi, x_lo), (w_hi, w_lo) = split(x), split(w)
  steps = x.shape[1] // 8
  total = torch.zeros(x.shape[0], w.shape[1])
  main, second = torch.zeros_like(total), torch.zeros_like(total)
  for k in range(steps):
    if k and k % k_steps_per_flush == 0:
      total = total + main + second
      main, second = torch.zeros_like(total), torch.zeros_like(total)
    cut = slice(8 * k, 8 * k + 8)
    main = _rz(main.double() + x_hi[:, cut].double() @ w_hi[cut].double())
    second = _rz(second.double() + x_hi[:, cut].double() @ w_lo[cut].double())
    main = _rz(main.double() + x_lo[:, cut].double() @ w_hi[cut].double())
  return total + main + second


def _longest_phase12_chain():
  """The most k-steps any output column sums at chip_smoke.py phase 12's
  f32 block-16 shapes (WRN-22-2's four 3x3 and its 5x5 point, RN50's four
  stride-1 3x3s, ERK at 0.8, random occupancies as phase 12 draws them),
  forward or dx: 2 k-steps an entry."""
  from rigl_tpu_torch.layers.packed_dense import random_occupancy
  from rigl_tpu_torch.models.packed_convnet import (resnet_layer_shapes,
                                                    wrn_layer_shapes)
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  from rigl_tpu_torch.sparsity.layer_sparsity import (resolve_sparsity,
                                                      spec_for_model)
  wrn = spec_for_model(wrn_layer_shapes(22, 2), 'erdos_renyi_kernel', 0.8)
  rn50 = spec_for_model(resnet_layer_shapes(50, 1.0, (16, 16)),
                        'erdos_renyi_kernel', 0.8)
  shapes = [(wrn, 'g0_b0/conv1', 16, 32, 3), (wrn, 'g0_b0/conv2', 32, 32, 3),
            (wrn, 'g1_b1/conv1', 64, 64, 3), (wrn, 'g2_b1/conv1', 128, 128, 3),
            (wrn, 'g1_b1/conv1', 64, 64, 5),
            (rn50, 'g0_b1/conv3x3', 64, 64, 3),
            (rn50, 'g1_b1/conv3x3', 128, 128, 3),
            (rn50, 'g2_b1/conv3x3', 256, 256, 3),
            (rn50, 'g3_b1/conv3x3', 512, 512, 3)]
  gen = torch.Generator().manual_seed(0)
  longest = 0
  for spec, name, cin, cout, k in shapes:
    s = resolve_sparsity(spec, name + '/kernel')
    nk, nn_ = k * k * cin // 16, cout // 16
    occ = random_occupancy(gen, nk, nn_, nk * nn_ - get_n_zeros(nk * nn_, s))
    occ = occ.reshape(k * k, cin // 16, nn_)
    longest = max(longest, int(occ.sum((0, 1)).max()),
                  int(occ.sum((0, 2)).max()))
  return 2 * longest


def test_tap_chain_within_tolerance_at_the_chosen_flush():
  """The f32 tap conv's sums over the longest column of phase 12's f32
  shapes (x and W drawn as phase 12 draws them: N(0, 1), and N(0, 1) /
  sqrt(9 cin) with cin = 512) stay within TAP_TOL of float64 with the 10x
  margin (64 k-steps, 3.5e-6 here), flushing every kTfFlush stages; the
  kernel's constants are read from its source."""
  flush = _tap_int('kTfFlush') * _tap_int('kTfEntries') * 2
  steps = _longest_phase12_chain()
  assert 40 <= steps < flush   # no column of phase 12 reaches a flush
  rng = np.random.default_rng(steps)
  x = torch.from_numpy(rng.standard_normal((512, 8 * steps),
                                           dtype=np.float32))
  w = torch.from_numpy((rng.standard_normal((8 * steps, 16))
                        / np.sqrt(9 * 512)).astype(np.float32))
  want = x.double() @ w.double()
  scale = max(1.0, float(want.abs().max()))
  err = float((_tap3(x, w, flush).double() - want).abs().max()) / scale
  assert err * MARGIN <= TAP_TOL, err


def test_tap_flush_keeps_a_dense_5x5_chain_within_tolerance():
  """Why the kernel flushes: a dense 5x5 conv of 512 channels at blocks of
  16 sums 1600 k-steps a column; with one pair of accumulators over them
  the dropped low bits come within 1.3x of TAP_TOL (7.6e-5 here, unit
  weights), where a flush every kTfFlush stages keeps 10x inside it
  (7.8e-6)."""
  flush = _tap_int('kTfFlush') * _tap_int('kTfEntries') * 2
  steps = 25 * 32 * 2
  rng = np.random.default_rng(1600)
  x = torch.from_numpy(rng.standard_normal((64, 8 * steps),
                                           dtype=np.float32))
  w = torch.from_numpy(rng.standard_normal((8 * steps, 16),
                                           dtype=np.float32))
  want = x.double() @ w.double()
  scale = max(1.0, float(want.abs().max()))
  errs = [float((_tap3(x, w, f).double() - want).abs().max()) / scale
          for f in (flush, steps)]
  assert errs[0] * MARGIN <= TAP_TOL < errs[1] * MARGIN, errs
