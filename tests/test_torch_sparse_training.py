"""The port's SparseTraining (rigl_tpu_torch/transforms/sparse_training.py)
step by step against the JAX package's, on the CPU.

A two-layer parameter dict (two masked kernels and an unmasked bias), the
same initial values, masks and per-step gradients go through both
packages' `step` for every algorithm, with the update hints of
`predict_update_iters`; JAX's drop noise and SET grow draws go into the
port through its seams.  Masks and step accounting must be equal at every
step; weights and momentum slots within 1e-6 of each tensor's largest
value plus 1e-7 (torch.optim.SGD and optax round p + (-lr) * buf and the
nesterov sum at their own points).  Also: the hints themselves, the
static block counts, premask_params' rejections, and the eval step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.sparsity.schedules import UpdateSchedule as JSchedule
from rigl_tpu.transforms import algorithms as jalgorithms
from rigl_tpu.transforms.sparse_training import SparseState as JState
from rigl_tpu.transforms.sparse_training import SparseTraining as JST
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import (SparseState,
                                                       SparseTraining)
from torch_threads import one_thread  # noqa: F401


SHAPES = {'a/kernel': (12, 16), 'b/kernel': (16, 8)}
RTOL, ATOL = 1e-6, 1e-7
ALGOS = ['rigl', 'rigl_inverted', 'set', 'static', 'momentum', 'snip', 'dnw',
         'prune', 'scratch', 'none']


def _kwargs(name):
  sched = dict(begin_step=0, end_step=20, frequency=3, drop_fraction=0.5,
               drop_fraction_anneal='cosine')
  if name in ('none', 'scratch', 'snip', 'dnw'):
    return {}, None
  kw = {'rigl': {'initial_acc_scale': 0.5}, 'momentum': {'momentum': 0.8},
        'prune': {'initial_sparsity': 0.2}}.get(name, {})
  return kw, sched


def _pair(name, nesterov=True, block=None, premask=False, opt=None,
          sched=None):
  """JAX's and the port's SparseTraining for algorithm `name`; by default
  over SGD with nesterov momentum, or over `opt` = (optax, torch.optim)
  transformations, with `sched` replacing the algorithm's schedule."""
  kw, default_sched = _kwargs(name)
  sched = sched or default_sched
  jtx, ttx = opt or (
      optax.sgd(0.1, momentum=0.9, nesterov=nesterov),
      functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                        nesterov=nesterov))
  jalgo = jalgorithms.get_algorithm(
      name, schedule=None if sched is None else JSchedule(**sched), **kw)
  talgo = algorithms.get_algorithm(
      name, schedule=None if sched is None else UpdateSchedule(**sched), **kw)
  jst = JST(jtx, jalgo, distribution='uniform', default_sparsity=0.5,
            block=block, premask_params=premask)
  tst = SparseTraining(ttx, talgo, distribution='uniform',
                       default_sparsity=0.5, block=block,
                       premask_params=premask)
  return jst, tst


def _tree(flat):
  out = {}
  for p, v in flat.items():
    layer, leaf = p.split('/')
    out.setdefault(layer, {})[leaf] = v
  return out


def _run_step_by_step(name, jst, tst, rs, n_iters, slots):
  """Runs both packages' `step` for n_iters iterations from the same
  parameters, masks and gradients, JAX's draws handed to the port, and
  holds masks and step accounting equal and weights and optimizer slots
  within RTOL of each tensor's largest finite value plus ATOL (NaNs equal
  in place).  `slots(jopt, path)` -> {torch state key: JAX slot}."""
  params = {p: rs.randn(*s).astype(np.float32) for p, s in SHAPES.items()}
  params['a/bias'] = rs.randn(16).astype(np.float32)
  jparams = _tree({p: jnp.asarray(v) for p, v in params.items()})
  _, jstate = jst.init(jax.random.key(0), jparams)
  jopt = jst.tx.init(jparams)
  tparams = {p: torch.tensor(v) for p, v in params.items()}
  topt, tstate = tst.init(0, tparams)
  masks = {p: torch.tensor(np.asarray(m)) for p, m in jstate.masks.items()}
  tstate = tstate.replace(
      masks=masks,
      ema_grads=(None if jstate.ema_grads is None else
                 {p: torch.zeros(SHAPES[p]) for p in SHAPES}))
  assert tst.sparsities == pytest.approx(jst.sparsities)

  class Seams:
    """JAX's draws for this step, handed to the port."""
    step = 0

  def drop_noise(step, layer_idx, path, mask, w):
    return torch.tensor(np.asarray(jst._drop_noise(
        jnp.int32(step), layer_idx, path, jnp.asarray(mask.numpy()), None)))

  def grow_score(algo, path, mask, weights, dense_grad, ema_grad, gen):
    if algo.name == 'set':
      i = list(SHAPES).index(path)
      return torch.tensor(np.asarray(jst._grow_score(
          algo, path, jnp.asarray(mask.numpy()), None, None, None,
          jst._layer_key(jnp.int32(Seams.step), i, 1))))
    return SparseTraining._grow_score(tst, algo, path, mask, weights,
                                      dense_grad, ema_grad, gen)

  def close(got, want, msg):
    tol = RTOL * float(np.nanmax(np.abs(want), initial=0.0)) + ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True,
                               err_msg=msg)

  tst._drop_noise = drop_noise
  tst._grow_score = grow_score
  hints = tst.predict_update_iters(n_iters)
  assert hints == jst.predict_update_iters(n_iters)
  for t, hint in enumerate(hints):
    grads = {p: rs.randn(*v.shape).astype(np.float32)
             for p, v in params.items()}
    Seams.step = tstate.step + (0 if tst.algo.skip_apply_on_update else 1)
    jparams, jopt, jstate, jm = jst.step(
        jparams, jopt, jstate, _tree({p: jnp.asarray(g)
                                      for p, g in grads.items()}),
        update_hint=hint)
    tparams, topt, tstate, tm = tst.step(
        tparams, topt, tstate, {p: torch.tensor(g)
                                for p, g in grads.items()},
        update_hint=hint)
    assert bool(jm['mask_updated']) == tm['mask_updated'], (name, t)
    assert tm.get('update_hint_ok', True), (name, t)
    assert tstate.step == int(jstate.step), (name, t)
    assert tstate.last_update_step == int(jstate.last_update_step)
    assert tstate.is_snipped == bool(jstate.is_snipped)
    for p, m in jstate.masks.items():
      np.testing.assert_array_equal(tstate.masks[p].numpy(), np.asarray(m),
                                    f'{name} step {t} mask {p}')
    flat_w = {f'{l}/{k}': v for l, d in jparams.items() for k, v in d.items()}
    for p, w in tparams.items():
      close(w.numpy(), np.asarray(flat_w[p]), f'{name} step {t} weights {p}')
      state = topt.state[w]
      want_slots = slots(jopt, p)
      assert not {k for k, v in state.items() if torch.is_tensor(v)
                  and v.shape == w.shape} - set(want_slots), (name, t, p)
      for key, want in want_slots.items():
        slot = state.get(key)
        want = np.asarray(want)
        close(np.zeros_like(want) if slot is None else slot.numpy(), want,
              f'{name} step {t} {key} {p}')
  return hints


def _flat(tree):
  return {f'{l}/{k}': v for l, d in tree.items() for k, v in d.items()}


@pytest.mark.parametrize('name', ALGOS)
def test_step_matches_jax_step_by_step(name):
  rs = np.random.RandomState(ALGOS.index(name))
  jst, tst = _pair(name)
  hints = _run_step_by_step(
      name, jst, tst, rs, 10,
      lambda jopt, p: {'momentum_buffer': _flat(jopt[0].trace)[p]})
  assert any(hints) or name in ('none', 'scratch')


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_initial_acc_scale_matches_jax_step_by_step(opt):
  """RigL with initial_acc_scale = 0.5 over SGD without momentum (no
  slot in either package: the reset does nothing) and over Adam, whose
  state torch creates only at its first step: the update at step 0 comes
  first, so the port creates that state as torch would and resets it as
  optax resets mu and nu.  nu takes g * 0.5, negative where g is, so the
  next step's sqrt gives NaN in both packages at such weights; the NaNs
  must match in place, and the masks stay equal at the update at step 3
  that ranks them."""
  if opt == 'sgd':
    pair = (optax.sgd(0.1), functools.partial(torch.optim.SGD, lr=0.1))
    slots = lambda jopt, p: {}
  else:
    pair = (optax.adam(1e-3), functools.partial(torch.optim.Adam, lr=1e-3))
    slots = lambda jopt, p: {'exp_avg': _flat(jopt[0].mu)[p],
                             'exp_avg_sq': _flat(jopt[0].nu)[p]}
  jst, tst = _pair('rigl', opt=pair,
                   sched=dict(begin_step=0, end_step=4, frequency=3,
                              drop_fraction=0.5))
  hints = _run_step_by_step(f'rigl/{opt}', jst, tst,
                            np.random.RandomState(11), 6, slots)
  assert [t for t, h in enumerate(hints) if h] == [0, 4], hints


@pytest.mark.parametrize('name', ALGOS)
def test_static_block_counts_and_packs_equal_jax(name):
  """Block-granular masks at block (4, 8): the same static counts and, for
  the same masks, the same pack forms and lists."""
  jst, tst = _pair(name, block=(4, 8))
  params = {p: np.zeros(s, np.float32) for p, s in SHAPES.items()}
  _, jstate = jst.init(jax.random.key(1), _tree(
      {p: jnp.asarray(v) for p, v in params.items()}))
  tst.init(0, {p: torch.tensor(v) for p, v in params.items()})
  assert tst.static_block_counts() == jst.static_block_counts()
  masks = {p: torch.tensor(np.asarray(m)) for p, m in jstate.masks.items()}
  tpacks = tst._compute_packs(masks) or {}
  jpacks = jstate.block_packs or {}
  assert set(tpacks) == set(jpacks)
  for p, e in jpacks.items():
    if isinstance(e, dict):
      assert set(tpacks[p]) == set(e)
      for k in e:
        np.testing.assert_array_equal(tpacks[p][k].numpy(), np.asarray(e[k]))
    else:
      np.testing.assert_array_equal(tpacks[p].numpy(), np.asarray(e))


def test_premask_rejections_and_mask_generator():
  for name in ('prune', 'dnw', 'snip'):
    with pytest.raises(ValueError, match='premask_params'):
      SparseTraining(None, algorithms.get_algorithm(name),
                     premask_params=True)
  with pytest.raises(ValueError, match='random_normal'):
    SparseTraining(None, algorithms.SET(grow_init='random_normal'),
                   premask_params=True)
  # A structured mask generator initialises each layer at the
  # distribution's sparsity, as JAX's does (tests/test_sparse_training.py
  # test_structured_mask_generator_init): per_neuron gives every output
  # neuron JAX's fan-in.
  jst = JST(optax.sgd(0.1), jalgorithms.SCRATCH, distribution='uniform',
            default_sparsity=0.5, mask_generator='per_neuron')
  tst = SparseTraining(functools.partial(torch.optim.SGD, lr=0.1),
                       algorithms.get_algorithm('scratch'),
                       distribution='uniform', default_sparsity=0.5,
                       mask_generator='per_neuron')
  _, jstate = jst.init(jax.random.key(0), _tree(
      {p: jnp.zeros(s) for p, s in SHAPES.items()}))
  _, tstate = tst.init(0, {p: torch.zeros(s) for p, s in SHAPES.items()})
  assert tst.sparsities == jst.sparsities
  assert tst.static_block_counts() == jst.static_block_counts() == {}
  for p in SHAPES:
    fan_ins = tstate.masks[p].sum(0).numpy()
    assert len(set(fan_ins.tolist())) == 1
    np.testing.assert_array_equal(fan_ins,
                                  np.asarray(jstate.masks[p]).sum(0))


def test_eval_step_matches_jax():
  """make_eval_step's loss, top-1 and top-5 on masked parameters equal
  JAX's for the same head."""
  import flax.linen as fnn
  from rigl_tpu.train import steps as jsteps
  from rigl_tpu_torch.train import steps
  from rigl_tpu_torch.train.train_state import TrainState
  rs = np.random.RandomState(5)
  kernel = rs.randn(6, 10).astype(np.float32)
  bias = rs.randn(10).astype(np.float32)
  mask = (rs.rand(6, 10) > 0.5).astype(np.float32)
  x = rs.randn(7, 6).astype(np.float32)
  y = rs.randint(0, 10, 7).astype(np.int32)

  class JHead(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
      return fnn.Dense(10, name='head')(x)

  class THead(torch.nn.Module):
    def __init__(self):
      super().__init__()
      self.head = torch.nn.Module()
      self.head.kernel = torch.nn.Parameter(torch.tensor(kernel))
      self.head.bias = torch.nn.Parameter(torch.tensor(bias))

    def forward(self, x, train=False):
      return x @ self.head.kernel + self.head.bias

  jstate = type('S', (), {})()
  jstate.params = {'params': {'head': {'kernel': jnp.asarray(kernel),
                                       'bias': jnp.asarray(bias)}}}
  jstate.sparse = JState(masks={'head/kernel': jnp.asarray(mask)},
                         step=jnp.int32(0), last_update_step=jnp.int32(0),
                         is_snipped=jnp.bool_(False))
  jstate.batch_stats = {}
  want = jsteps.make_eval_step(JHead(), has_batch_stats=False)(
      jstate, {'image': jnp.asarray(x), 'label': jnp.asarray(y)})
  model = THead()
  params = {'head/kernel': model.head.kernel, 'head/bias': model.head.bias}
  state = TrainState(params=params, batch_stats={}, optimizer=None,
                     sparse=SparseState(masks={'head/kernel':
                                               torch.tensor(mask)},
                                        step=0, last_update_step=0,
                                        is_snipped=False))
  got = steps.make_eval_step(model, has_batch_stats=False)(
      state, {'image': torch.tensor(x), 'label': torch.tensor(y)})
  for k in ('loss', 'top_1', 'top_5', 'count'):
    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                               err_msg=k)


def test_make_mask_dict_and_readouts_equal_jax():
  """make_mask_dict from the JAX key's integers gives JAX's masks exactly
  (the same numpy shuffles), and the sparsity readouts agree."""
  from rigl_tpu.sparsity import masks as jmasks
  from rigl_tpu_torch.sparsity import masks as tmasks
  rs = np.random.RandomState(9)
  flat = {'a/kernel': rs.randn(12, 16), 'b/kernel': rs.randn(3, 3, 4, 8),
          'a/bias': rs.randn(16)}
  key = jax.random.key(4)
  want = jmasks.make_mask_dict(key, _tree({p: jnp.asarray(v, jnp.float32)
                                           for p, v in flat.items()}),
                               default_sparsity=0.7)
  got = tmasks.make_mask_dict(np.asarray(jax.random.key_data(key)),
                              {p: torch.tensor(v) for p, v in flat.items()},
                              default_sparsity=0.7)
  assert list(got) == list(want)
  for p, m in want.items():
    np.testing.assert_array_equal(got[p].numpy(), np.asarray(m), p)
  np.testing.assert_allclose(float(tmasks.calculate_sparsity(got)),
                             float(jmasks.calculate_sparsity(want)),
                             rtol=1e-6)
  jl = jmasks.per_layer_sparsity(want)
  for p, v in tmasks.per_layer_sparsity(got).items():
    np.testing.assert_allclose(float(v), float(jl[p]), rtol=1e-6)
