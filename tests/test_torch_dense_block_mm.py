"""The port's dense-storage block-sparse matmuls (rigl_tpu_torch/ops/
block_sparse_v3.py, block_sparse_v4.py, ops/conv.py and
layers/block_sparse_dense.py) against the JAX package's on the CPU.

The same numpy-seeded inputs go through both; the JAX side runs its
Pallas kernels in interpret mode (the default off a TPU), the port its
plain versions (CPU tensors).  Index forms must be equal element by
element; products in float32 agree to 1e-5 relative to the output's
largest value (both sum the same blocks in f32, in another order), in
bfloat16 to 2e-2 (one rounding of the f32 sums, each side at its own
points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.layers import block_sparse_dense as jbsd
from rigl_tpu.ops import conv as jconv
from rigl_tpu.ops.pallas import block_sparse_v2 as jv2
from rigl_tpu.ops.pallas import block_sparse_v3 as jv3
from rigl_tpu.ops.pallas import block_sparse_v4 as jv4
from rigl_tpu_torch.layers.block_sparse_dense import BlockSparseDense
from rigl_tpu_torch.ops import block_sparse_v3 as tv3
from rigl_tpu_torch.ops import block_sparse_v4 as tv4
from rigl_tpu_torch.ops import conv as tconv
from torch_threads import one_thread  # noqa: F401


BLOCK = (8, 16)
TOL = {'float32': 1e-5, 'bfloat16': 2e-2}


def _occupancy(seed, nk, nn, kind):
  rs = np.random.RandomState(seed)
  occ = (rs.rand(nk, nn) < 0.5).astype(np.int32)
  occ[0, 0] = 1
  if kind == 'empty_column':
    occ[:, nn - 1] = 0
  elif kind == 'empty_row':
    occ[nk - 1, :] = 0
  elif kind == 'none':
    occ[:] = 0
  return occ


def _close(got, want, dtype='float32'):
  got = np.asarray(torch.as_tensor(got).float())
  want = np.asarray(jnp.asarray(want, jnp.float32))
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


KINDS = ['random', 'empty_column', 'empty_row', 'none']


@pytest.mark.parametrize('kind', KINDS)
def test_pack_flat_active_and_block_indices_equal_jax(kind):
  occ = _occupancy(1, 5, 7, kind)
  n_act = int(occ.sum())
  jc, jr = jv4.pack_flat_active(jnp.asarray(occ), n_act)
  tc, tr = tv4.pack_flat_active(torch.as_tensor(occ), n_act)
  np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  np.testing.assert_array_equal(
      tv4._occupancy(tc, tr, 5, 7).numpy(),
      np.asarray(jv4._occupancy(jc, jr, 5, 7)))
  jcnt, jidx = jv2.pack_block_indices(jnp.asarray(occ))
  tcnt, tidx = tv3.pack_block_indices(torch.as_tensor(occ))
  np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
  np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def _operands(seed, m, nk, nn, dtype):
  rs = np.random.RandomState(seed)
  bk, bn = BLOCK
  x = rs.randn(m, nk * bk).astype(np.float32)
  w = rs.randn(nk * bk, nn * bn).astype(np.float32)
  gy = rs.randn(m, nn * bn).astype(np.float32)
  jd = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
  td = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
  j = [jnp.asarray(a, jd) for a in (x, w, gy)]
  t = [torch.tensor(a).to(td) for a in (x, w, gy)]
  return j, t


def _jax_grads(fn, x, w, gy):
  y, vjp = jax.vjp(fn, x, w)
  dx, dw = vjp(gy)
  return y, dx, dw


def _torch_grads(fn, x, w, gy):
  x = x.clone().requires_grad_()
  w = w.clone().requires_grad_()
  y = fn(x, w)
  dx, dw = torch.autograd.grad(y, (x, w), gy)
  return y.detach(), dx, dw


# Every dw strategy ('auto' picks 'dense' at this shape) on the random
# grid in f32, both in bf16; the edge grids in f32 with the gathered dw
# (the dense dw is one matmul whatever the grid).
CASES = ([(v, 'random', d, 'float32') for v in ('v3', 'v4')
          for d in ('dense', 'gather', 'auto')]
         + [(v, k, 'gather', 'float32') for v in ('v3', 'v4')
            for k in KINDS[1:]]
         + [(v, 'random', d, 'bfloat16') for v in ('v3', 'v4')
            for d in ('dense', 'gather')])


@pytest.mark.parametrize('version,kind,dw_mode,dtype', CASES)
def test_matmul_forward_dx_dw_match_jax(version, kind, dw_mode, dtype):
  """y, dx and dw of block_sparse_matmul_v3 / _v4 in every dw_mode, with an
  empty column, an empty block-row and a layer with no active block."""
  nk, nn, m = 4, 3, 16
  occ = _occupancy(2, nk, nn, kind)
  (jx, jw, jgy), (tx, tw, tgy) = _operands(3, m, nk, nn, dtype)
  if version == 'v3':
    jfn = lambda x, w: jv3.block_sparse_matmul_v3(   # noqa: E731
        x, w, jnp.asarray(occ), BLOCK, 8, None, dw_mode)
    tfn = lambda x, w: tv3.block_sparse_matmul_v3(   # noqa: E731
        x, w, torch.as_tensor(occ), BLOCK, 8, dw_mode=dw_mode)
  else:
    n_act = int(occ.sum())
    jc, jr = jv4.pack_flat_active(jnp.asarray(occ), n_act)
    tc, tr = tv4.pack_flat_active(torch.as_tensor(occ), n_act)
    jfn = lambda x, w: jv4.block_sparse_matmul_v4(   # noqa: E731
        x, w, jc, jr, BLOCK, 8, None, dw_mode)
    tfn = lambda x, w: tv4.block_sparse_matmul_v4(   # noqa: E731
        x, w, tc, tr, BLOCK, 8, dw_mode=dw_mode)
  jy, jdx, jdw = _jax_grads(jfn, jx, jw, jgy)
  ty, tdx, tdw = _torch_grads(tfn, tx, tw, tgy)
  for got, want in ((ty, jy), (tdx, jdx), (tdw, jdw)):
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
  empty_cols = np.nonzero(occ.sum(0) == 0)[0]
  for j in empty_cols:   # exact zeros, as JAX's select gives
    assert not ty[:, j * BLOCK[1]:(j + 1) * BLOCK[1]].any()


@pytest.mark.parametrize('version', ['v3', 'v4'])
def test_ragged_rows_match_jax_on_padded_rows(version):
  """The port takes any m (the kernels mask ragged rows); JAX needs m to
  divide bm, so its callers pad: the port's 13 rows equal JAX's first 13
  of 16."""
  nk, nn = 4, 3
  occ = _occupancy(4, nk, nn, 'random')
  (jx, jw, jgy), (tx, tw, tgy) = _operands(5, 16, nk, nn, 'float32')
  if version == 'v3':
    jy = jv3.block_sparse_matmul_v3(jx, jw, jnp.asarray(occ), BLOCK, 8)
    ty = tv3.block_sparse_matmul_v3(tx[:13], tw, torch.as_tensor(occ), BLOCK)
  else:
    n = int(occ.sum())
    jy = jv4.block_sparse_matmul_v4(jx, jw, *jv4.pack_flat_active(
        jnp.asarray(occ), n), BLOCK, 8)
    ty = tv4.block_sparse_matmul_v4(tx[:13], tw, *tv4.pack_flat_active(
        torch.as_tensor(occ), n), BLOCK)
  _close(ty, jy[:13])


SHAPES = [(k, n, b) for k in (128, 512, 1024, 2048, 4096)
          for n in (128, 512, 1024, 2048)
          for b in ((128, 128), (256, 256), (512, 512))]


def test_auto_dw_choice_equals_jax_traffic_model():
  """'auto' picks what JAX's rule (block_sparse_v3.py:124-152, with its
  _AUTO_DENSITY) picks, at every shape of a grid that holds both
  outcomes."""
  picks = set()
  for k, n, (bk, bn) in SHAPES:
    gather_bytes = jv3._AUTO_DENSITY * (k // bk) * (n // bn) * (bk + bn)
    want = 'gather' if gather_bytes < (k + n) else 'dense'
    assert tv3.dw_mode_for((k, n), (bk, bn), 'auto') == want, (k, n, bk, bn)
    picks.add(want)
  assert picks == {'gather', 'dense'}
  assert tv3._AUTO_DENSITY == jv3._AUTO_DENSITY


def test_dw_blocksparse_v2_matches_jax():
  occ = _occupancy(6, 4, 3, 'empty_column')
  (jx, jw, jgy), (tx, tw, tgy) = _operands(7, 16, 4, 3, 'float32')
  want = jv3._dw_blocksparse_v2(jx, jgy, jnp.asarray(occ), BLOCK, 8,
                                jnp.float32, True)
  got = tv3._dw_blocksparse_v2(tx, tgy, torch.as_tensor(occ), BLOCK, 8,
                               torch.float32)
  _close(got, want)


@pytest.mark.parametrize('form', ['occupancy', 'flat'])
@pytest.mark.parametrize('stride', [1, 2])
def test_conv1x1_forward_and_grads_match_jax(form, stride):
  """block_sparse_conv1x1 (its own backward: dx through the transposed
  mode, dw the f32 product times the expanded occupancy) against JAX's."""
  rs = np.random.RandomState(8)
  cin, cout = 16, 32
  occ = _occupancy(9, cin // 8, cout // 16, 'empty_column')
  x = rs.randn(2, 6, 6, cin).astype(np.float32)
  k = rs.randn(1, 1, cin, cout).astype(np.float32)
  gy_shape = (2, 6 // stride, 6 // stride, cout)
  gy = rs.randn(*gy_shape).astype(np.float32)
  if form == 'flat':
    n = int(occ.sum())
    jm = dict(zip(('cols', 'rows'), jv4.pack_flat_active(jnp.asarray(occ),
                                                         n)))
    tm = dict(zip(('cols', 'rows'),
                  tv4.pack_flat_active(torch.as_tensor(occ), n)))
  else:
    jm, tm = jnp.asarray(occ), torch.as_tensor(occ)
  jy, jdx, jdw = _jax_grads(
      lambda a, b: jconv.block_sparse_conv1x1(a, b, jm, stride, BLOCK, 8),
      jnp.asarray(x), jnp.asarray(k), jnp.asarray(gy))
  ty, tdx, tdw = _torch_grads(
      lambda a, b: tconv.block_sparse_conv1x1(a, b, tm, stride, BLOCK, 8),
      torch.tensor(x), torch.tensor(k), torch.tensor(gy))
  for got, want in ((ty, jy), (tdx, jdx), (tdw, jdw)):
    _close(got, want)


@pytest.mark.parametrize('padding,stride', [('SAME', 1), ('SAME', 2),
                                            ('VALID', 1)])
def test_conv2d_im2col_matches_jax(padding, stride):
  rs = np.random.RandomState(10)
  kh, kw, cin, cout = 3, 3, 8, 16
  occ = _occupancy(11, kh * kw * cin // 8, cout // 16, 'random')
  x = rs.randn(2, 7, 7, cin).astype(np.float32)
  k = rs.randn(kh, kw, cin, cout).astype(np.float32)
  jy = jconv.block_sparse_conv2d(jnp.asarray(x), jnp.asarray(k),
                                 jnp.asarray(occ), stride, padding, BLOCK, 8)
  ty = tconv.block_sparse_conv2d(torch.tensor(x), torch.tensor(k),
                                 torch.as_tensor(occ), stride, padding,
                                 BLOCK, 8)
  assert tuple(ty.shape) == tuple(jy.shape)
  _close(ty, jy)


def test_block_sparse_dense_matches_jax():
  """BlockSparseDense's forward and gradients (kernel, bias, input) from
  the same kernel, bias and block mask as the flax layer."""
  rs = np.random.RandomState(12)
  block = (8, 16)
  layer = jbsd.BlockSparseDense(32, block=block, bm=8)
  x = rs.randn(5, 16).astype(np.float32)
  variables = layer.init(jax.random.key(0), jnp.asarray(x))
  occ = _occupancy(13, 2, 2, 'empty_column')
  mask = np.kron(occ, np.ones(block)).astype(np.float32)
  kernel = rs.randn(16, 32).astype(np.float32)
  bias = rs.randn(32).astype(np.float32)
  params = {'kernel': jnp.asarray(kernel), 'bias': jnp.asarray(bias)}

  def jloss(p, xin):
    y = layer.apply({'params': p, 'masks': {'kernel': jnp.asarray(mask)}},
                    xin)
    return jnp.sum(jnp.sin(y)), y

  (_, jy), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(params,
                                                        jnp.asarray(x))
  del variables
  tl = BlockSparseDense(16, 32, block=block, bm=8, device='cpu')
  with torch.no_grad():
    tl.kernel.copy_(torch.tensor(kernel))
    tl.bias.copy_(torch.tensor(bias))
    tl.mask.copy_(torch.tensor(mask))
  tx = torch.tensor(x, requires_grad=True)
  ty = tl(tx)
  gk, gb, gx = torch.autograd.grad(torch.sin(ty).sum(),
                                   (tl.kernel, tl.bias, tx))
  _close(ty.detach(), jy)
  _close(gk, jg['kernel'])
  _close(gb, jg['bias'])
  _close(gx, jgx)
