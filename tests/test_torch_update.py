"""Port parity: the mask-update maths of rigl_tpu_torch (sparsity/schedules,
sparsity/update, ops/block_mask) against the JAX package on the same
numpy inputs.

Gating must agree exactly and the drop-fraction anneals to one float32
ulp of their factor (both compute in float32; cos and pow may round
differently in the last place).  Drop/grow must be bit-exact: on the
TF-minted golden traces (tests/golden/drop_grow_traces.npz, mirroring
tests/test_golden_traces.py) and on rankings with ties, NaN, -0 and
infinities.  Pooling must be exact
on inputs whose block sums are exact in float32."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.ops import block_mask as jbm
from rigl_tpu.sparsity import schedules as jsch
from rigl_tpu.sparsity import update as jup
from rigl_tpu_torch.ops import block_mask as tbm
from rigl_tpu_torch.sparsity import schedules as tsch
from rigl_tpu_torch.sparsity import update as tup
from torch_threads import one_thread  # noqa: F401


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'golden')
NPZ = os.path.join(GOLDEN_DIR, 'drop_grow_traces.npz')
META = os.path.join(GOLDEN_DIR, 'drop_grow_traces_meta.json')

SCHEDULES = {
    'constant': dict(begin_step=0, end_step=1500, frequency=100,
                     drop_fraction=0.3, drop_fraction_anneal='constant'),
    'constant_forever': dict(begin_step=30, end_step=-1, frequency=70,
                             drop_fraction=0.25,
                             drop_fraction_anneal='constant'),
    'never': dict(begin_step=0, end_step=0, frequency=10, drop_fraction=0.3,
                  drop_fraction_anneal='constant'),
    'cosine': dict(begin_step=0, end_step=1500, frequency=100,
                   drop_fraction=0.3, drop_fraction_anneal='cosine'),
    'cosine_late': dict(begin_step=250, end_step=1750, frequency=37,
                        drop_fraction=0.5, drop_fraction_anneal='cosine'),
    'exponential': dict(begin_step=200, end_step=1700, frequency=50,
                        drop_fraction=0.3,
                        drop_fraction_anneal='exponential_2.5'),
    'exponential_1': dict(begin_step=0, end_step=2000, frequency=100,
                          drop_fraction=0.1,
                          drop_fraction_anneal='exponential'),
}
STEPS = np.arange(2001)


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax(name):
  kw = SCHEDULES[name]
  js, ts = jsch.UpdateSchedule(**kw), tsch.UpdateSchedule(**kw)
  assert ts.initial_last_update_step == js.initial_last_update_step
  jfire = jax.jit(js.is_update_iter)
  jlast = tlast = js.initial_last_update_step
  for step in STEPS.tolist():
    want = bool(jfire(step, jlast))
    got = ts.is_update_iter(step, tlast)
    assert got is want, (name, step)
    if want:
      jlast = tlast = step
  want = np.asarray(js.get_drop_fraction(jnp.asarray(STEPS)))
  got = ts.get_drop_fraction(torch.from_numpy(STEPS)).numpy()
  assert got.dtype == want.dtype == np.float32
  # One float32 ulp of the anneal's factor in [0, 1] (cos and pow round
  # differently in the last place), times the initial fraction.
  ulp = np.spacing(np.float32(1.0)) * kw['drop_fraction']
  np.testing.assert_allclose(got, want, rtol=0, atol=ulp)
  assert ts.get_drop_fraction(700).dtype == torch.float32


def test_schedule_lr_anneal_checks_and_constructors():
  lr = lambda step: 0.1 * 0.5 ** (step // 500)  # noqa: E731
  js = jsch.lr_schedule(0, 2000, 100, 0.3, lr)
  ts = tsch.lr_schedule(0, 2000, 100, 0.3, lr)
  for step in (0, 499, 500, 1234, 2000):
    assert float(ts.get_drop_fraction(step)) == float(
        js.get_drop_fraction(step))
  for make in ('constant_schedule', 'cosine_schedule'):
    j, t = getattr(jsch, make)(5, 900, 20, 0.4), getattr(tsch, make)(5, 900,
                                                                     20, 0.4)
    assert (t.begin_step, t.end_step, t.frequency, t.drop_fraction,
            t.drop_fraction_anneal) == (j.begin_step, j.end_step,
                                        j.frequency, j.drop_fraction,
                                        j.drop_fraction_anneal)
  for bad in (dict(drop_fraction_anneal='lr'),
              dict(drop_fraction_anneal='linear'),
              dict(drop_fraction_anneal='cosine', end_step=-1),
              dict(drop_fraction_anneal='exponential_2', begin_step=10,
                   end_step=10)):
    with pytest.raises(ValueError):
      tsch.UpdateSchedule(**bad)
  for token in ('exponential_2.5', 'exponential_4', 'exponential', 'foo_.5'):
    assert tsch.extract_number(token) == jsch.extract_number(token)


def _golden_cases():
  if not os.path.exists(META):
    return []
  with open(META) as f:
    return [c['name'] for c in json.load(f)['cases']]


@pytest.mark.parametrize('name', _golden_cases())
def test_drop_grow_matches_reference_traces(name):
  """The port's drop_grow_update on the TF-minted golden cases: masks,
  weights and slot resets bit-exact (tests/test_golden_traces.py)."""
  data = np.load(NPZ)
  with open(META) as f:
    case = next(c for c in json.load(f)['cases'] if c['name'] == name)
  g = lambda k: data[f'{name}/{k}']  # noqa: E731
  mask0, w0, drop = _t(g('mask0')), _t(g('w0')), _t(g('drop_score'))
  frac = float(g('drop_fraction'))
  if case['has_grow']:
    res = tup.drop_grow_update(mask0, w0, drop, _t(g('grow_score')), frac,
                               reinit_when_same=case['reinit_when_same'])
    np.testing.assert_array_equal(res.mask.numpy(), g('mask1'), name)
    np.testing.assert_array_equal(res.weights.numpy(), g('w1'), name)
    slot = np.where(res.new_connections.numpy(), 0.0, g('slot0'))
    np.testing.assert_array_equal(slot, g('slot1'), name)
  else:
    n_ones = int(np.sum(g('mask0')))
    n_keep = n_ones - int(n_ones * frac)
    mask = tup.topk_mask_from_scores(drop, n_keep).reshape(mask0.shape)
    np.testing.assert_array_equal(mask.numpy(), g('mask1'), name)


def test_drop_grow_evolution_matches_reference():
  """Six rounds of fake-SGD + drop/grow track the reference exactly."""
  data = np.load(NPZ)
  mask = _t(data['evolution/mask0'])
  w = _t(data['evolution/w0'])
  grads = data['evolution/grads']
  frac = float(data['evolution/drop_fraction'])
  lr = float(data['evolution/lr'])
  for t in range(grads.shape[0]):
    g = _t(grads[t])
    w = w - lr * g * mask
    res = tup.drop_grow_update(mask, w, (mask * w).abs(), g.abs(), frac)
    mask, w = res.mask, res.weights
    np.testing.assert_array_equal(mask.numpy(), data['evolution/masks'][t],
                                  f'round {t} mask')
    np.testing.assert_array_equal(w.numpy(), data['evolution/weights'][t],
                                  f'round {t} weights')


def _special_scores():
  rs = np.random.RandomState(0)
  out = {'random': rs.randn(97).astype(np.float32),
         'ties': rs.randint(0, 4, 64).astype(np.float32)}
  s = np.array([1.0, np.nan, 3.0, -np.nan, np.inf, 0.0, -0.0, 3.0, -np.inf,
                0.0, -0.0, np.nan, -1.0, 2.5, -np.inf, np.inf],
               np.float32)
  out['specials'] = s
  out['signed_zeros'] = np.array([0.0, -0.0] * 8, np.float32)[
      rs.permutation(16)]
  return out


@pytest.mark.parametrize('name', sorted(_special_scores()))
def test_ranking_matches_jax_top_k(name):
  """Ties toward the lower index; NaN above +inf, +0 above -0, -NaN last
  (XLA's total order), for the rank and for the masks built on it."""
  scores = _special_scores()[name]
  _, want = jax.lax.top_k(jnp.asarray(scores), scores.size)
  np.testing.assert_array_equal(tup._rank(_t(scores)).numpy(),
                                np.asarray(want))
  for n_keep in (0, 1, 5, scores.size // 2, scores.size):
    np.testing.assert_array_equal(
        tup.topk_mask_from_scores(_t(scores), n_keep).numpy(),
        np.asarray(jup.topk_mask_from_scores(jnp.asarray(scores), n_keep)))


@pytest.mark.parametrize('case', ['nan_grow', 'nan_drop', 'random_frac'])
def test_drop_grow_matches_jax_beyond_goldens(case):
  """NaN grow scores (the nan_to_num lift keeps the count), NaN drop
  scores, and drop fractions whose float32 product truncates near an
  integer: masks, weights and new connections equal JAX's."""
  rs = np.random.RandomState(1)
  shape = (12, 10)
  mask = (rs.rand(*shape) < 0.4).astype(np.float32)
  w = (rs.randn(*shape) * mask).astype(np.float32)
  drop = np.abs(w)
  grow = np.abs(rs.randn(*shape)).astype(np.float32)
  fracs = [0.3]
  if case == 'nan_grow':
    grow[rs.rand(*shape) < 0.3] = np.nan
  elif case == 'nan_drop':
    drop[0, :3] = np.nan
  else:
    fracs = [0.1, 0.2, 0.25, 0.3, 1 / 3, 0.5, 0.7, 1.0]
  grow_init = rs.randn(*shape).astype(np.float32)
  for frac in fracs:
    for reinit in (False, True):
      want = jup.drop_grow_update(
          jnp.asarray(mask), jnp.asarray(w), jnp.asarray(drop),
          jnp.asarray(grow), frac, grow_tensor=jnp.asarray(grow_init),
          reinit_when_same=reinit)
      got = tup.drop_grow_update(_t(mask), _t(w), _t(drop), _t(grow), frac,
                                 grow_tensor=_t(grow_init),
                                 reinit_when_same=reinit)
      for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
      assert float(got.mask.sum()) == float(mask.sum())


def test_prune_to_sparsity_and_grow_init_match_jax():
  rs = np.random.RandomState(2)
  score = rs.randint(0, 6, (8, 12)).astype(np.float32)
  for s in (0.0, 0.5, 0.83, 0.9):
    np.testing.assert_array_equal(
        tup.prune_to_sparsity(_t(score), s).numpy(),
        np.asarray(jup.prune_to_sparsity(jnp.asarray(score), s)))
  w = rs.randn(6, 5).astype(np.float32)
  g = rs.randn(6, 5).astype(np.float32)
  key = jax.random.key(0)
  gen = torch.Generator().manual_seed(0)
  for method in ('zeros', 'grad_scale', 'grad_scale_2', 'grad_sign',
                 'grad_sign_4'):
    np.testing.assert_array_equal(
        tup.grow_init_tensor(method, gen, _t(w), masked_grad=_t(g)).numpy(),
        np.asarray(jup.grow_init_tensor(method, key, jnp.asarray(w),
                                        masked_grad=jnp.asarray(g))))
  # Random methods draw from torch's generator: compare what is not random.
  init = rs.randn(6, 5).astype(np.float32)
  got = tup.grow_init_tensor('initial_dist_2', gen, _t(w),
                             initial_weights=_t(init)).numpy()
  np.testing.assert_array_equal(np.sort(got.ravel()),
                                np.sort(init.ravel() / 2))
  mean = np.abs(w).mean()
  got = tup.grow_init_tensor('random_uniform_2', gen, _t(w)).numpy()
  assert got.shape == w.shape and np.abs(got).max() <= mean / 2 + 1e-7
  got = tup.grow_init_tensor('random_normal', gen, _t(w)).numpy()
  assert got.shape == w.shape and np.isfinite(got).all() and got.std() > 0
  for method, kw in (('initial_dist', {}), ('grad_scale', {}),
                     ('grad_sign', {}), ('bogus', {})):
    with pytest.raises(ValueError):
      tup.grow_init_tensor(method, gen, _t(w), **kw)


@pytest.mark.parametrize('shape,block', [((32, 48), (8, 16)),
                                         ((3, 3, 8, 16), (8, 4)),
                                         ((64, 64), (16, 16))])
def test_pool_and_expand_match_jax(shape, block):
  """Integer-valued float32 data, so every block sum is exact in both."""
  rs = np.random.RandomState(3)
  x = rs.randint(-50, 50, shape).astype(np.float32)
  for reduce in ('sum', 'max', 'mean'):
    np.testing.assert_array_equal(
        tbm.pool_to_blocks(_t(x), block, reduce).numpy(),
        np.asarray(jbm.pool_to_blocks(jnp.asarray(x), block, reduce)))
  grid = np.asarray(jbm.pool_to_blocks(jnp.asarray(x), block, 'max')) > 0
  np.testing.assert_array_equal(
      tbm.expand_from_blocks(_t(grid.astype(np.int32)), shape, block).numpy(),
      np.asarray(jbm.expand_from_blocks(jnp.asarray(grid.astype(np.int32)),
                                        shape, block)))
  with pytest.raises(ValueError):
    tbm.pool_to_blocks(_t(x), (5, 7), 'sum')
