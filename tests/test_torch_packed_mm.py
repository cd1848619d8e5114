"""Port parity: rigl_tpu_torch.ops.block_sparse_packed against the JAX
package's packed engine.

The packing index maths must give the JAX entry lists element by element;
pack/unpack must agree exactly; the plain packed_matmul must agree with
JAX's `_mm_kernel` (run in interpret mode on the CPU, as the JAX tests run
it) within f32 summation-order error.  The kernel itself runs only on a
CUDA card: its tests are in test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rigl_tpu.layers.packed_dense import _pad_rows
from rigl_tpu.ops.pallas import block_sparse_packed as jbsp
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from torch_threads import one_thread  # noqa: F401


def _occupancies():
  """(name, (nk, nn) occupancy): empty columns, a full column, a single
  active, all actives in one column, and random draws."""
  rs = np.random.RandomState(0)
  out = []
  occ = np.zeros((4, 6), np.int32)
  occ[[0, 2, 3], 1] = 1
  occ[1, 4] = 1
  out.append(('empty_columns', occ))
  occ = np.zeros((3, 5), np.int32)
  occ[:, 2] = 1
  occ[0, 0] = 1
  out.append(('one_full_column', occ))
  occ = np.zeros((3, 4), np.int32)
  occ[2, 3] = 1
  out.append(('single_active', occ))
  occ = np.zeros((5, 3), np.int32)
  occ[[0, 1, 3], 0] = 1
  out.append(('all_in_one_column', occ))
  for i, (nk, nn_, dens) in enumerate([(4, 12, 0.2), (16, 4, 0.2),
                                       (6, 6, 0.5)]):
    occ = (rs.rand(nk, nn_) < dens).astype(np.int32)
    occ.flat[rs.randint(occ.size)] = 1
    out.append((f'random{i}_{nk}x{nn_}', occ))
  return out


OCC = _occupancies()
OCC_IDS = [name for name, _ in OCC]


def _pair(occ):
  n_act = int(occ.sum())
  return (jbsp.make_packing(jnp.asarray(occ), n_act),
          tbsp.make_packing(torch.from_numpy(occ), n_act))


def _np(a):
  return np.asarray(a)


@pytest.mark.parametrize('occ', [o for _, o in OCC], ids=OCC_IDS)
def test_make_packing_lists_equal_jax(occ):
  jp, tp = _pair(occ)
  assert tp.shape == jp.shape
  for direction in ('fwd', 'bwd'):
    for name, j, t in zip(('cols', 'rows', 'slots', 'valid'), jp[direction],
                          tp[direction]):
      assert t.dtype == torch.int32
      np.testing.assert_array_equal(t.numpy(), _np(j),
                                    err_msg=f'{direction} {name}')


def test_pack_columns_slots_truncates_and_all_empty_like_jax():
  occ = OCC[0][1]
  for n_act in (0, 2, int(occ.sum())):   # fewer slots than actives too
    j = jbsp.pack_columns_slots(jnp.asarray(occ), n_act)
    t = tbsp.pack_columns_slots(torch.from_numpy(occ), n_act)
    for a, b in zip(j, t):
      np.testing.assert_array_equal(b.numpy(), _np(a))


@pytest.mark.parametrize('occ', [o for _, o in OCC], ids=OCC_IDS)
def test_pack_unpack_dense_equal_jax(occ):
  jp, tp = _pair(occ)
  block = (8, 4)
  rs = np.random.RandomState(1)
  w = rs.randn(occ.shape[0] * block[0], occ.shape[1] * block[1]).astype(
      np.float32)
  packed_j = jbsp.pack_dense(jnp.asarray(w), jp, block)
  packed_t = tbsp.pack_dense(torch.from_numpy(w), tp, block)
  np.testing.assert_array_equal(packed_t.numpy(), _np(packed_j))
  np.testing.assert_array_equal(
      tbsp.unpack_dense(packed_t, tp, block).numpy(),
      _np(jbsp.unpack_dense(packed_j, jp, block)))


@pytest.mark.parametrize('occ', [o for _, o in OCC], ids=OCC_IDS)
def test_column_index_matches_fwd_lists(occ):
  """The kernel's per-column CSR lists exactly each column's actives, in
  slot order, with their block rows."""
  _, tp = _pair(occ)
  col_ptr, rows = tp.column_index('cpu')
  assert col_ptr.dtype == rows.dtype == torch.int32
  assert rows.shape == (tp.n_active,)
  assert col_ptr.shape == (occ.shape[1] + 1,)
  slot = 0
  for j in range(occ.shape[1]):
    ks = np.nonzero(occ[:, j])[0]
    assert col_ptr[j] == slot and col_ptr[j + 1] == slot + len(ks)
    np.testing.assert_array_equal(rows[slot:slot + len(ks)].numpy(), ks)
    slot += len(ks)
  assert tp.column_index('cpu')[0] is col_ptr           # cached
  bad = tbsp.Packing(tp.bwd, tp.fwd, tp.shape[::-1])    # not fwd order
  if tp.n_active > 1 and not torch.equal(tp.bwd[2][:tp.n_active],
                                         torch.arange(tp.n_active,
                                                      dtype=torch.int32)):
    with pytest.raises(ValueError, match='pack_columns_slots order'):
      bad.column_index('cpu')


@pytest.mark.parametrize('m', [5, 24, 64])
@pytest.mark.parametrize('occ', [o for _, o in OCC], ids=OCC_IDS)
def test_plain_packed_matmul_matches_jax_kernel(occ, m):
  """f32: the only difference is the order of the f32 sums."""
  jp, tp = _pair(occ)
  block = (16, 8)
  nk, nn_ = occ.shape
  rs = np.random.RandomState(m)
  x = rs.randn(m, nk * block[0]).astype(np.float32)
  w = rs.randn(int(occ.sum()), *block).astype(np.float32)
  # The JAX kernel's grid needs whole row tiles: pad rows as its
  # PackedDense does (_pad_rows), then crop.
  xp, bm, _ = _pad_rows(jnp.asarray(x), 512)
  want = _np(jbsp.packed_matmul(xp, jnp.asarray(w), jp, block, bm))[:m]
  got = tbsp.packed_matmul(torch.from_numpy(x), torch.from_numpy(w), tp,
                           block)
  assert got.shape == (m, nn_ * block[1]) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
  empty = occ.sum(0) == 0
  assert not got.reshape(m, nn_, block[1])[:, torch.from_numpy(empty)].any()


def test_cpu_path_launches_nothing_and_checks_n_out():
  occ = OCC[0][1]
  _, tp = _pair(occ)
  x = torch.ones(3, occ.shape[0] * 8)
  w = torch.ones(int(occ.sum()), 8, 8)
  before = tbsp.packed_mm_launches
  y = tbsp.packed_matmul(x, w, tp, (8, 8), n_out=occ.shape[1] * 8)
  assert tbsp.packed_mm_launches == before
  assert y.shape == (3, occ.shape[1] * 8)
  with pytest.raises(ValueError, match='n_out'):
    tbsp.packed_matmul(x, w, tp, (8, 8), n_out=8)
  with pytest.raises(ValueError, match='cpu or cuda'):
    tbsp.packed_matmul(x.to('meta'), w.to('meta'), tp, (8, 8))
