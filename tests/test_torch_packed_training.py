"""Port parity: packed RigL training in rigl_tpu_torch (packed_matmul's
backward, repack_permutation, transforms/packed_training,
train/packed_loop, the converter, checkpoints and the driver) against the
JAX package on the same numpy inputs.

Index maths (repack permutations, occupancies) must agree exactly; so must
drop/grow on packed storage and the optimizer slots it carries.  Products
and training trajectories agree within float32 summation-order error:
atol 1e-4 for gradients, as the JAX package's own oracle tests use, and
the tolerances stated at each trajectory check.  JAX's packed matmul runs
in interpret mode on the CPU, as its own tests run it; the port's runs its
plain versions (the kernels are held against those on the card, in
test_torch_kernels_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.ops import block_mask as jbm
from rigl_tpu.ops.pallas import block_sparse_packed as jbsp
from rigl_tpu.train import packed_loop as jloop
from rigl_tpu.transforms import packed_training as jpt
from rigl_tpu_torch import convert
from rigl_tpu_torch.data import datasets as tdata
from rigl_tpu_torch.drivers import packed_mlp as tdriver
from rigl_tpu_torch.layers.packed_dense import PackedDense
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.train import packed_loop as tloop
from rigl_tpu_torch.transforms import packed_training as tpt
from torch_threads import one_thread  # noqa: F401


BLK = (128, 128)
K = N = 512
GRAD_ATOL = 1e-4


def _t(a):
  return torch.from_numpy(np.array(a))


def _np(a):
  return np.asarray(a)


def _pair(occ):
  n_act = int(np.asarray(occ).sum())
  return (jbsp.make_packing(jnp.asarray(occ), n_act),
          tbsp.make_packing(_t(occ), n_act))


def _setup(sparsity=0.5, seed=0):
  """tests/test_packed_training.py's _setup, as numpy."""
  rs = np.random.RandomState(seed)
  w = (rs.randn(K, N) * 0.1).astype(np.float32)
  occ = rs.permutation(np.repeat([1, 0], [8, 8]).astype(np.int32)).reshape(
      4, 4)
  mask = np.asarray(jbm.expand_from_blocks(jnp.asarray(occ), (K, N), BLK))
  wm = w * mask
  jp, tp = _pair(occ)
  packed = _np(jbsp.pack_dense(jnp.asarray(wm), jp, BLK))
  grads = rs.randn(K, N).astype(np.float32)
  return wm, occ, int(occ.sum()), jp, tp, packed, grads


# ------------------------------------------------------ packing index ----
def test_repack_permutation_matches_jax():
  rs = np.random.RandomState(4)
  for trial, (nk, nn_, n_act) in enumerate([(4, 6, 9)] * 4 + [(3, 5, 15)]):
    occs = []
    for _ in range(2):
      occ = np.zeros(nk * nn_, np.int32)
      occ[rs.choice(nk * nn_, n_act, replace=False)] = 1
      occs.append(occ.reshape(nk, nn_))
    (jo, to), (jn, tn) = _pair(occs[0]), _pair(occs[1])
    got = tbsp.repack_permutation(to, tn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jbsp.repack_permutation(jo, jn)),
                                  f'trial {trial}')


def test_row_index_is_the_bwd_csr():
  """Block-row k's actives, in the bwd lists' order, with their columns
  and fwd slots; cached; a packing not in make_packing order raises."""
  rs = np.random.RandomState(5)
  occ = (rs.rand(5, 7) < 0.4).astype(np.int32)
  occ[2] = 0                                  # an empty block-row
  occ[0, 0] = 1
  _, tp = _pair(occ)
  row_ptr, cols, slots = tp.row_index('cpu')
  assert row_ptr.dtype == cols.dtype == slots.dtype == torch.int32
  col_ptr, rows = tp.column_index('cpu')
  e = 0
  for k in range(occ.shape[0]):
    js = np.nonzero(occ[k])[0]
    assert row_ptr[k] == e and row_ptr[k + 1] == e + len(js)
    np.testing.assert_array_equal(cols[e:e + len(js)].numpy(), js)
    for j, s in zip(js, slots[e:e + len(js)].tolist()):
      assert rows[s] == k and col_ptr[j] <= s < col_ptr[j + 1]
    e += len(js)
  assert tp.row_index('cpu')[0] is row_ptr
  np.testing.assert_array_equal(tp.dw_index('cpu')[1].numpy(),
                                tp.fwd[0][:tp.n_active].numpy())
  bad = tbsp.Packing(tp.fwd, tuple(t.flip(0) for t in tp.bwd), tp.shape)
  with pytest.raises(ValueError, match='make_packing order'):
    bad.row_index('cpu')


# ------------------------------------------------- matmul and backward ----
def _grad_case(occ, m, seed):
  """y and (dx, dw) of sum(sin(packed_matmul(x, w))) in JAX (interpret
  mode) and in the port (autograd through the plain versions)."""
  rs = np.random.RandomState(seed)
  blk = (16, 16)
  nk, nn_ = occ.shape
  jp, tp = _pair(occ)
  mask = np.asarray(jbm.expand_from_blocks(jnp.asarray(occ),
                                           (nk * blk[0], nn_ * blk[1]), blk))
  w = rs.randn(nk * blk[0], nn_ * blk[1]).astype(np.float32) * mask
  packed = _np(jbsp.pack_dense(jnp.asarray(w), jp, blk))
  x = rs.randn(m, nk * blk[0]).astype(np.float32)

  def f(x, wp):
    return jnp.sum(jnp.sin(jbsp.packed_matmul(x, wp, jp, blk, 16)))

  want_y = _np(jbsp.packed_matmul(jnp.asarray(x), jnp.asarray(packed), jp,
                                  blk, 16))
  want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(packed))
  tx, tw = _t(x).requires_grad_(), _t(packed).requires_grad_()
  y = tbsp.packed_matmul(tx, tw, tp, blk, 16)
  got = torch.autograd.grad(torch.sin(y).sum(), (tx, tw))
  return (y.detach().numpy(), want_y), [(g.numpy(), _np(w_))
                                        for g, w_ in zip(got, want)]


def _leading_empty_column():
  """test_packed_mm_variants_match_dense_oracle's grid: column 0 empty."""
  occ = np.zeros((4, 4), np.int32)
  occ[[0, 2, 3, 1, 2], [1, 1, 2, 3, 3]] = 1
  return occ


def _dw_branch_grid(n_act):
  """test_packed_dw_matches_dense_oracle_both_branches's grids: 12 actives
  on 4 x 8 take JAX's column-panel dw, 4 its per-block dw."""
  rs = np.random.RandomState(3)
  occ = np.zeros(32, np.int32)
  occ[rs.choice(32, n_act, replace=False)] = 1
  return occ.reshape(4, 8)


@pytest.mark.parametrize('grid', ['leading_empty_column', 'dw_panel_12',
                                  'dw_perblock_4'])
def test_packed_matmul_grads_match_jax(grid):
  occ = {'leading_empty_column': _leading_empty_column,
         'dw_panel_12': lambda: _dw_branch_grid(12),
         'dw_perblock_4': lambda: _dw_branch_grid(4)}[grid]()
  (y, want_y), grads = _grad_case(occ, 64, 7)
  np.testing.assert_allclose(y, want_y, atol=GRAD_ATOL)
  for got, want in grads:                     # dx, then dw (packed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_backward_computes_only_what_is_asked():
  occ = _leading_empty_column()
  _, tp = _pair(occ)
  x = torch.randn(8, 64)
  w = torch.randn(5, 16, 16, requires_grad=True)
  y = tbsp.packed_matmul(x, w, tp, (16, 16))
  (dw,) = torch.autograd.grad(y.sum(), (w,))
  want = tbsp.packed_dw_reference(x, torch.ones(8, 64), tp, (16, 16))
  np.testing.assert_allclose(dw.numpy(), want.numpy(), atol=1e-5)
  dx_only = torch.randn(8, 64, requires_grad=True)
  (dx,) = torch.autograd.grad(
      tbsp.packed_matmul(dx_only, w.detach(), tp, (16, 16)).sum(), (dx_only,))
  assert dx.shape == (8, 64)
  with pytest.raises(ValueError, match='cpu or cuda'):
    tbsp.packed_matmul(x.to('meta'), w.detach().to('meta'), tp, (16, 16))


@pytest.mark.parametrize('mode', ['no_input_needs_grad', 'no_grad',
                                  'inference_mode'])
def test_forward_without_grad_skips_the_function(mode):
  """A call that needs no gradient (serving) gives the same y as the plain
  version and records no autograd node."""
  _, tp = _pair(_leading_empty_column())
  x = torch.randn(8, 64)
  w = torch.randn(5, 16, 16, requires_grad=mode != 'no_input_needs_grad')
  ctx = {'no_input_needs_grad': torch.enable_grad, 'no_grad': torch.no_grad,
         'inference_mode': torch.inference_mode}[mode]
  with ctx():
    y = tbsp.packed_matmul(x, w, tp, (16, 16))
  assert y.grad_fn is None and not y.requires_grad
  np.testing.assert_array_equal(
      y.numpy(),
      tbsp.packed_matmul_reference(x, w.detach(), tp, (16, 16)).numpy())


# ------------------------------------------------- drop/grow on packed ----
def test_packed_drop_grow_matches_jax():
  wm, occ, n_active, jp, tp, packed, grads = _setup()
  grid = np.asarray(jbm.pool_to_blocks(jnp.abs(jnp.asarray(grads)), BLK,
                                       'sum'))
  want = jpt.packed_drop_grow(jnp.asarray(packed), jp, jnp.asarray(grid),
                              0.3, n_active)
  got = tpt.packed_drop_grow(_t(packed), tp, _t(grid), 0.3, n_active)
  np.testing.assert_array_equal(got.occupancy.numpy(), _np(want.occupancy))
  np.testing.assert_array_equal(got.packed.numpy(), _np(want.packed))
  np.testing.assert_array_equal(got.grown.numpy(), _np(want.grown))
  for a, b in zip(got.packing.fwd + got.packing.bwd,
                  want.packing.fwd + want.packing.bwd):
    np.testing.assert_array_equal(a.numpy(), _np(b))
  assert int(got.occupancy.sum()) == n_active and got.grown.any()
  np.testing.assert_array_equal(tpt.occupancy_grid(tp).numpy(),
                                _np(jpt.occupancy_grid(jp)))
  # Block |w| sums: float32 summation order over 128 x 128 terms.
  np.testing.assert_allclose(
      tpt.block_drop_scores(_t(packed), tp).numpy(),
      _np(jpt.block_drop_scores(jnp.asarray(packed), jp)), rtol=1e-6)


def _stamped(n_active, shape):
  """Fake slot state: the slot index + 1 stamped into every element."""
  return np.broadcast_to(np.arange(1, n_active + 1, dtype=np.float32)[
      :, None, None], shape).copy()


def test_permute_opt_state_matches_jax():
  wm, occ, n_active, jp, tp, packed, grads = _setup()
  grid = np.asarray(jbm.pool_to_blocks(jnp.abs(jnp.asarray(grads)), BLK,
                                       'sum'))
  out = jpt.packed_drop_grow(jnp.asarray(packed), jp, jnp.asarray(grid), 0.3,
                             n_active)
  mom = _stamped(n_active, packed.shape)
  want = jpt.permute_opt_state({'m': jnp.asarray(mom), 'count': jnp.ones(())},
                               jp, out.packing, out.grown)
  _, tnew = _pair(_np(out.occupancy))
  got = tpt.permute_opt_state({'m': _t(mom), 'count': torch.ones(())}, tp,
                              tnew, _t(_np(out.grown)))
  np.testing.assert_array_equal(got['m'].numpy(), _np(want['m']))
  assert float(got['count']) == 1.0
  grown = _np(out.grown)
  assert np.all(got['m'].numpy()[grown] == 0)
  survivors = got['m'].numpy()[~grown, 0, 0].astype(int)
  assert len(set(survivors)) == len(survivors)


@pytest.mark.parametrize('opt', ['sgd_momentum', 'sgd_before_first_step',
                                 'adam'])
def test_packed_rigl_update_matches_jax(opt):
  """Weights copied in place; every packed-axis slot of the torch
  optimizer (momentum_buffer, exp_avg, exp_avg_sq) carried for survivors
  and zeroed for grown blocks, exactly as optax's state through JAX's
  packed_rigl_update; a dense entry passes through."""
  wm, occ, n_active, jp, tp, packed, grads = _setup()
  rs = np.random.RandomState(9)
  head = rs.randn(4, 3).astype(np.float32)
  jparams = {'l': jnp.asarray(packed), 'head': jnp.asarray(head)}
  tparams = {'l': _t(packed).requires_grad_(),
             'head': _t(head).requires_grad_()}
  grow = {'l': jnp.asarray(grads)}
  if opt == 'adam':
    tx = optax.adam(1e-3)
    jopt = tx.init(jparams)
    g = {'l': jbsp.pack_dense(jnp.asarray(grads), jp, BLK),
         'head': jnp.ones_like(jparams['head'])}
    up, jopt = tx.update(g, jopt, jparams)
    jparams = optax.apply_updates(jparams, up)
    topt = torch.optim.Adam(list(tparams.values()), lr=1e-3)
    with torch.no_grad():
      for name, p in tparams.items():
        p.copy_(_t(_np(jparams[name])))
        topt.state[p].update(step=torch.tensor(1.0),
                             exp_avg=_t(_np(jopt[0].mu[name])),
                             exp_avg_sq=_t(_np(jopt[0].nu[name])))
    slots = {'exp_avg': lambda st: st[0].mu['l'],
             'exp_avg_sq': lambda st: st[0].nu['l']}
  else:
    tx = optax.sgd(0.1, momentum=0.9)
    jopt = tx.init(jparams)
    topt = torch.optim.SGD(list(tparams.values()), lr=0.1, momentum=0.9)
    if opt == 'sgd_momentum':
      mom = _stamped(n_active, packed.shape)
      jopt = (jopt[0]._replace(trace={'l': jnp.asarray(mom),
                                      'head': jnp.ones((4, 3))}), jopt[1])
      topt.state[tparams['l']]['momentum_buffer'] = _t(mom)
      topt.state[tparams['head']]['momentum_buffer'] = torch.ones(4, 3)
    slots = {'momentum_buffer': lambda st: st[0].trace['l']}
  # The pooled grids agree to float32 summation order; both updates then
  # take JAX's, so the comparison below is exact.
  jgrids = jpt.rigl_grow_grids(grow, BLK)
  np.testing.assert_allclose(
      tpt.rigl_grow_grids({'l': _t(grads)}, BLK)['l'].numpy(),
      _np(jgrids['l']), rtol=1e-6)
  tgrids = {'l': _t(_np(jgrids['l']))}
  want = jpt.packed_rigl_update(jparams, {'l': jp}, jopt, tx, jgrids, 0.3,
                                {'l': n_active})
  l_param = tparams['l']
  got = tpt.packed_rigl_update(tparams, {'l': tp}, topt, tgrids, 0.3,
                               {'l': n_active})
  assert got.params['l'] is l_param and got.optimizer is topt
  np.testing.assert_array_equal(got.occupancy['l'].numpy(),
                                _np(want.occupancy['l']))
  np.testing.assert_array_equal(l_param.detach().numpy(),
                                _np(want.params['l']))
  np.testing.assert_array_equal(tparams['head'].detach().numpy(),
                                _np(want.params['head']))
  if opt == 'sgd_before_first_step':
    assert not topt.state             # nothing to permute: optax's zeros
    assert not np.asarray(want.opt_state[0].trace['l']).any()
  else:
    for key, leaf in slots.items():
      np.testing.assert_array_equal(topt.state[l_param][key].numpy(),
                                    _np(leaf(want.opt_state)), key)
  perm = tbsp.repack_permutation(tp, got.packings['l']).numpy()
  assert (perm < 0).any()
  if opt == 'sgd_momentum':
    np.testing.assert_array_equal(
        topt.state[tparams['head']]['momentum_buffer'].numpy(),
        np.ones((4, 3), np.float32))


# ------------------------------------------------------------ trainer ----
CFG = dict(in_features=64, widths=(32, 32), num_classes=4, sparsity=0.5,
           block=(16, 16), bm=128, learning_rate=0.05, momentum=0.9,
           train_steps=12, batch_size=32, maskupdate_begin_step=0,
           maskupdate_end_step=8, maskupdate_frequency=4, drop_fraction=0.3,
           drop_fraction_anneal='cosine', seed=0)


def _data(seed=0, n=256):
  rs = np.random.RandomState(seed)
  y = rs.randint(0, CFG['num_classes'], n).astype(np.int32)
  proto = rs.randn(CFG['num_classes'], CFG['in_features'])
  x = (proto[y] + 0.5 * rs.randn(n, CFG['in_features'])).astype(np.float32)
  return x, y


def _jax_trainer(via, **over):
  tr = jloop.PackedMLPTrainer(jloop.PackedMLPConfig(**dict(CFG, via=via,
                                                           **over)))
  tr.init_state()
  return tr


def _jax_state(tr):
  return dict(
      params={k: _np(v) for k, v in tr.params.items()},
      occupancy={k: _np(jpt.occupancy_grid(pk))
                 for k, pk in tr.packings.items()},
      momentum={k: _np(v) for k, v in tr.opt_state[0].trace.items()},
      step=tr.step, last_update_step=tr.last_update_step,
      batches_seen=tr.batches_seen)


def _assert_same_state(jtr, ttr, atol, what):
  assert (ttr.step, ttr.last_update_step, ttr.batches_seen) == (
      jtr.step, jtr.last_update_step, jtr.batches_seen), what
  for name, pk in jtr.packings.items():
    np.testing.assert_array_equal(tpt.occupancy_grid(ttr.packings[name])
                                  .numpy(), _np(jpt.occupancy_grid(pk)),
                                  f'{what}: occupancy {name}')
  mom = ttr.momentum()
  for name, p in jtr.params.items():
    np.testing.assert_allclose(ttr.params[name].detach().numpy(), _np(p),
                               rtol=0, atol=atol, err_msg=f'{what}: {name}')
    np.testing.assert_allclose(mom[name].numpy(),
                               _np(jtr.opt_state[0].trace[name]), rtol=0,
                               atol=atol, err_msg=f'{what}: momentum {name}')


def _run_in_step(jtr, ttr, data, steps, atol, loss_rtol):
  """Both trainers, one train() call per step on the same batches (the
  seeded sampler), compared after each: occupancy exactly (so at every
  update), params and momentum within `atol`, the loss within
  `loss_rtol`."""
  for k in range(1, steps + 1):
    jtr.cfg.train_steps = ttr.cfg.train_steps = k
    jres, tres = jtr.train(data), ttr.train(data)
    assert tres['mask_updates'] == jres['mask_updates']
    np.testing.assert_allclose(tres['final_loss'], jres['final_loss'],
                               rtol=loss_rtol, err_msg=f'step {k} loss')
    _assert_same_state(jtr, ttr, atol, f'step {k}')


def test_trainer_matches_jax_dense_view():
  """A JAX trainer (dense view) converted to the port (kernel path, plain
  versions on the CPU): 12 steps with mask updates at steps 0, 4 and 8.
  Float32 summation order differs, so params and momentum agree within
  2e-6 (they are O(0.1-1)) and the loss within 1e-5 relative."""
  data = _data()
  jtr = _jax_trainer('dense_view')
  ttr = convert.packed_mlp_trainer_from_jax(
      dataclasses.asdict(jtr.cfg), _jax_state(jtr), device='cpu')
  assert ttr.via == 'dense_view' and ttr.device.type == 'cpu'
  ttr.via = 'kernel'
  _assert_same_state(jtr, ttr, 0.0, 'converted')
  occ0 = {k: tpt.occupancy_grid(p).numpy() for k, p in ttr.packings.items()}
  _run_in_step(jtr, ttr, data, 12, 2e-6, 1e-5)
  assert jtr.last_update_step == 8
  moved = any((tpt.occupancy_grid(p).numpy() != occ0[k]).any()
              for k, p in ttr.packings.items())
  assert moved, 'no update changed an occupancy'
  x, y = data
  assert ttr.evaluate(x, y) == jtr.evaluate(x, y)


def test_trainer_matches_jax_kernel_interpret():
  """JAX through its Pallas kernels in interpret mode (rows padded to bm),
  the port through packed_matmul: 5 steps, updates at steps 0 and 4."""
  data = _data(1)
  jtr = _jax_trainer('kernel')
  ttr = convert.packed_mlp_trainer_from_jax(
      tloop.PackedMLPConfig(**dict(CFG, via='kernel')), _jax_state(jtr),
      device='cpu')
  _run_in_step(jtr, ttr, data, 5, 2e-6, 1e-5)


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_checkpoint_round_trip_continues_identically(direction, tmp_path):
  """A checkpoint in the JAX trainer's npz layout, written by one package
  after 6 steps (an update at 4 included), restores into the other, which
  then trains on exactly as the writer does."""
  data = _data(2)
  jtr = _jax_trainer('dense_view', train_steps=6)
  ttr = convert.packed_mlp_trainer_from_jax(
      dataclasses.asdict(jtr.cfg), _jax_state(jtr), device='cpu')
  jtr.train(data)
  ttr.train(data)
  _assert_same_state(jtr, ttr, 2e-6, 'before the checkpoint')
  if direction == 'jax_to_port':
    jtr.save(str(tmp_path))
    reader = tloop.PackedMLPTrainer(
        tloop.PackedMLPConfig(**dict(CFG, via='dense_view')), device='cpu')
    assert reader.restore(str(tmp_path))
    _assert_same_state(jtr, reader, 0.0, 'restored')
    writer = jtr
    _run_in_step(writer, reader, data, 12, 2e-6, 1e-5)
  else:
    ttr.save(str(tmp_path))
    reader = _jax_trainer('dense_view')
    assert reader.restore(str(tmp_path))
    _assert_same_state(reader, ttr, 0.0, 'restored')
    _run_in_step(reader, ttr, data, 12, 2e-6, 1e-5)
  assert not tloop.PackedMLPTrainer(
      tloop.PackedMLPConfig(**CFG), device='cpu').restore(
          str(tmp_path / 'missing'))


def test_trainer_config_checks_and_via():
  cfg = tloop.PackedMLPConfig(**CFG)
  assert cfg.resolve_via('cpu') == 'dense_view'
  assert cfg.resolve_via('cuda') == 'kernel'
  odd = dataclasses.replace(cfg, block=(16, 6), widths=(48, 48))
  assert odd.resolve_via('cuda') == 'kernel'
  # A block the kernels cannot take raises on the card rather than running
  # the plain path there; the caller may name dense_view for it.
  for via in ('auto', 'kernel'):
    with pytest.raises(ValueError, match='dense_view'):
      tloop.PackedMLPTrainer(dataclasses.replace(odd, via=via),
                             device='cuda')
  assert tloop.PackedMLPTrainer(dataclasses.replace(odd, via='dense_view'),
                                device='cuda').via == 'dense_view'
  with pytest.raises(ValueError, match='must divide'):
    tloop.PackedMLPTrainer(dataclasses.replace(cfg, block=(24, 16)),
                           device='cpu')
  with pytest.raises(ValueError, match='via'):
    tloop.PackedMLPTrainer(dataclasses.replace(cfg, via='pallas'),
                           device='cpu')


def test_entry_points_default_to_the_card():
  """With no device named, PackedDense and the trainer put their state on
  the card; on a machine without one, torch raises instead of landing on
  the CPU."""
  cfg = tloop.PackedMLPConfig(**CFG)
  if torch.cuda.is_available():
    assert PackedDense(32, 32, block=(16, 16)).kernel.is_cuda
    tr = tloop.PackedMLPTrainer(cfg)
    tr.init_state()
    assert tr.params['l1'].is_cuda
    return
  with pytest.raises((AssertionError, RuntimeError)):
    PackedDense(32, 32, block=(16, 16))
  tr = tloop.PackedMLPTrainer(cfg)
  assert tr.device.type == 'cuda'
  with pytest.raises((AssertionError, RuntimeError)):
    tr.init_state()


# ---------------------------------------------------- data and driver ----
def test_datasets_match_jax():
  from rigl_tpu.data import datasets as jdata
  for a, b in zip(tdata.synthetic_arrays(10, (8, 8, 1), 64, 32, seed=3),
                  jdata.synthetic_arrays(10, (8, 8, 1), 64, 32, seed=3)):
    np.testing.assert_array_equal(a, b)
  ttr, tte, tinfo = tdata.create_dataset('mnist', 16, n_synthetic=64)
  jtr, jte, jinfo = jdata.create_dataset('mnist', 16, n_synthetic=64)
  for t, j in ((ttr, jtr), (tte, jte)):
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
  assert tinfo == jinfo
  # CIFAR-10 is ported: raw uint8 training images and standardized eval
  # images, as JAX's arrays hold them.
  ttr, tte, tinfo = tdata.create_dataset('cifar10', 16, n_synthetic=64)
  jtr, jte, jinfo = jdata.create_dataset('cifar10', 16, n_synthetic=64)
  np.testing.assert_array_equal(ttr.images, jtr.images)
  np.testing.assert_allclose(tte.images, jte.images, rtol=1e-6, atol=1e-6)
  assert tinfo == jinfo
  # ImageNet without TFRecords: the synthetic task, normalized by
  # MEAN_RGB / STDDEV_RGB, as in JAX.
  ttr, tte, tinfo = tdata.create_dataset('imagenet', 4, n_synthetic=8)
  jtr, jte, jinfo = jdata.create_dataset('imagenet', 4, n_synthetic=8)
  for t, j in ((ttr, jtr), (tte, jte)):
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
  assert tinfo == jinfo


def test_driver_trains_resumes_and_refuses_other_methods(tmp_path, capsys):
  args = ['--device=cpu', '--train_steps=6', '--widths=32',
          '--packed_block=16,16', '--batch_size=16',
          '--maskupdate_frequency=3', '--maskupdate_end_step=4',
          '--log_every=2', f'--output_dir={tmp_path}', '--end_sparsity=0.5']
  res = tdriver.main(args)
  assert res['train_steps'] == 6 and res['mask_updates'] == 2
  assert res['batches'] == 8 and res['data_source'] == 'synthetic'
  assert res['n_params_packed'] * 2 == res['n_params_dense_equiv']
  assert (tmp_path / 'packed_state.npz').exists()
  res = tdriver.main(args[:1] + ['--train_steps=8'] + args[2:])
  assert '# resumed at step 6' in capsys.readouterr().out
  assert res['train_steps'] == 8 and res['mask_updates'] == 0
  with pytest.raises(ValueError, match='rigl'):
    tdriver.main(['--training_method=set', '--device=cpu'])
