"""Port parity: rigl_tpu_torch.ops.block_sparse_conv against the JAX
package's tap conv (rigl_tpu/ops/pallas/block_sparse_conv.py).

`pack_tap_active` must give JAX's lists element by element (dummy entry
per column, sentinel); the occupancy must survive a round trip; and the
plain forward, dx and dw, which walk the tap index one shifted block
product at a time, must agree with JAX's `block_sparse_conv_tap` and its
`jax.vjp` (its Pallas kernels run in interpret mode on the CPU, as the
JAX tests run them) within 1e-5 of the largest value, in f32: both sum
the same products in f32, in another order.  The kernels themselves run
only on a CUDA card: their tests are in test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.ops.pallas import block_sparse_conv as jbsc
from rigl_tpu_torch.ops import block_sparse_conv as tbsc
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5


def _occupancy(t_dim, nk, nn_, holes, seed):
  """A (T, nk, nn) occupancy at density 0.5.  holes: 'none'; 'column'
  (cout-block 0 empty); 'tap' (tap 0 empty); 'both'; 'all' (no active)."""
  rs = np.random.RandomState(seed)
  occ = (rs.rand(t_dim, nk, nn_) < 0.5).astype(np.int32)
  occ.flat[rs.randint(occ.size)] = 1
  if holes in ('column', 'both'):
    occ[:, :, 0] = 0
  if holes in ('tap', 'both') and t_dim > 1:
    occ[0] = 0
  if holes == 'all':
    occ[:] = 0
  return occ


GRIDS = [(9, 2, 3), (25, 1, 2), (1, 4, 4), (9, 3, 1)]
HOLES = ['none', 'column', 'tap', 'both', 'all']


@pytest.mark.parametrize('holes', HOLES)
@pytest.mark.parametrize('grid', GRIDS, ids=lambda g: 'x'.join(map(str, g)))
def test_pack_tap_active_equals_jax_and_round_trips(grid, holes):
  occ = _occupancy(*grid, holes, seed=sum(grid))
  n_act = int(occ.sum())
  want = jbsc.pack_tap_active(jnp.asarray(occ), n_act)
  got = tbsc.pack_tap_active(torch.from_numpy(occ), n_act)
  assert len(got[0]) == n_act + grid[2] + 1
  for g, w in zip(got, want):
    assert g.dtype == torch.int32
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  back = tbsc._occupancy3(*got, *grid)
  np.testing.assert_array_equal(back.numpy(), occ)
  np.testing.assert_array_equal(
      np.asarray(jbsc._occupancy3(*want, *grid)), back.numpy())


def _close(got, want, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max(initial=0.0)
  assert err <= RTOL * max(np.abs(want).max(initial=0.0), 1.0), (what, err)


@pytest.mark.parametrize('holes', ['column', 'both', 'all'])
@pytest.mark.parametrize('n', [2, 16])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5), (1, 1)])
def test_plain_tap_conv_matches_jax(ksize, n, holes):
  """y, dx and dw of the tap conv on a (n, 6, 5, 32) input to 48 channels
  at block (16, 16): the plain versions on the index and autograd through
  block_sparse_conv_tap, against JAX's kernels and jax.vjp."""
  kh, kw = ksize
  cin, cout, block = 32, 48, (16, 16)
  occ = _occupancy(kh * kw, cin // 16, cout // 16, holes, seed=n + kh)
  n_act = int(occ.sum())
  rs = np.random.RandomState(kh * 100 + n)
  x = rs.randn(n, 6, 5, cin).astype(np.float32)
  w4 = (rs.randn(kh, kw, cin, cout) / 8).astype(np.float32)
  gy = rs.randn(n, 6, 5, cout).astype(np.float32)
  jpack = dict(zip(('cols', 'rows', 'taps'),
                   jbsc.pack_tap_active(jnp.asarray(occ), n_act)))
  y_j, vjp = jax.vjp(
      lambda a, b: jbsc.block_sparse_conv_tap(a, b, jpack, block, 2048),
      jnp.asarray(x), jnp.asarray(w4))
  dx_j, dw_j = vjp(jnp.asarray(gy))

  tpack = dict(zip(('cols', 'rows', 'taps'),
                   tbsc.pack_tap_active(torch.from_numpy(occ), n_act)))
  index = tbsc.tap_index(tpack, w4.shape, block)
  xt, wt, gt = (torch.from_numpy(a) for a in (x, w4, gy))
  _close(tbsc.tap_conv_reference(xt, wt, index), y_j, 'y')
  _close(tbsc.tap_conv_reference(gt, wt, index, 'dx'), dx_j, 'dx')
  _close(tbsc.tap_dw_reference(xt, gt, index), dw_j, 'dw')

  xr, wr = xt.clone().requires_grad_(), wt.clone().requires_grad_()
  y = tbsc.block_sparse_conv_tap(xr, wr, tpack, block)
  dx, dw = torch.autograd.grad(y, (xr, wr), gt)
  _close(y.detach(), y_j, 'autograd y')
  _close(dx, dx_j, 'autograd dx')
  _close(dw, dw_j, 'autograd dw')
  assert dw.dtype == torch.float32
  if holes == 'all':
    assert not y.any() and not dx.any() and not dw.any()
  else:
    # Empty cout-block 0: zero output columns, zero weight gradient.
    assert not y[..., :16].any() and not dw[..., :16].any()


def test_packed_index_reads_the_packed_storage():
  """packed_conv_tap over a 2D Packing of the (kh*kw*Cin, Cout) view and
  its packed gradient equal the dense-kernel tap conv and its dw gathered
  at the active blocks (JAX's gradient of the packed kernel)."""
  from rigl_tpu_torch.ops.block_sparse_packed import (make_packing,
                                                      pack_dense, unpack_dense)
  rs = np.random.RandomState(3)
  kh = kw = 3
  cin, cout, block = 32, 32, (16, 16)
  occ2 = (rs.rand(kh * kw * cin // 16, cout // 16) < 0.4).astype(np.int32)
  occ2[:, 1] = 0
  packing = make_packing(torch.from_numpy(occ2), int(occ2.sum()))
  kernel = torch.from_numpy(rs.randn(packing.n_active, 16, 16)
                            .astype(np.float32)).requires_grad_()
  x = torch.from_numpy(rs.randn(3, 4, 7, cin).astype(np.float32))
  gy = torch.from_numpy(rs.randn(3, 4, 7, cout).astype(np.float32))
  y = tbsc.packed_conv_tap(x, kernel, packing, (kh, kw), block)
  (dk,) = torch.autograd.grad(y, kernel, gy)

  occ3 = torch.from_numpy(occ2).reshape(kh * kw, cin // 16, cout // 16)
  tpack = dict(zip(('cols', 'rows', 'taps'),
                   tbsc.pack_tap_active(occ3, packing.n_active)))
  w4 = unpack_dense(kernel.detach(), packing, block).reshape(kh, kw, cin,
                                                             cout)
  w4 = w4.requires_grad_()
  y4 = tbsc.block_sparse_conv_tap(x, w4, tpack, block)
  (dw4,) = torch.autograd.grad(y4, w4, gy)
  _close(y.detach(), y4.detach(), 'y')
  _close(dk, pack_dense(dw4.reshape(-1, cout), packing, block), 'dk')
  assert tbsc.packed_tap_index(packing, (kh, kw), cin, block) is (
      tbsc.packed_tap_index(packing, (kh, kw), cin, block))


def test_batch_rule_and_refusals():
  """Any batch runs (the TPU's N % 16 rule is not the port's); even
  kernels and channels off the block raise, as in JAX; a CPU tensor never
  reaches the kernel, and no device but cpu or cuda is taken."""
  assert all(tbsc.tap_batch_ok(n) for n in (1, 7, 16, 100))
  assert tbsc.default_tap_bm() == jbsc.default_tap_bm() == 2048
  occ = np.ones((1, 1, 1), np.int32)
  pack = dict(zip(('cols', 'rows', 'taps'),
                  tbsc.pack_tap_active(torch.from_numpy(occ), 1)))
  with pytest.raises(ValueError, match='odd'):
    tbsc.tap_index(pack, (2, 2, 16, 16), (16, 16))
  with pytest.raises(ValueError, match='divide'):
    tbsc.tap_index(pack, (1, 1, 24, 16), (16, 16))
  x = torch.zeros(1, 2, 2, 16, device='meta')
  index = tbsc.tap_index(pack, (1, 1, 16, 16), (16, 16))
  with pytest.raises(ValueError, match='cpu or cuda'):
    tbsc.tap_conv(x, torch.zeros(1, 1, 16, 16, device='meta'), index)
