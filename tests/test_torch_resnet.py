"""The port's ResNet (rigl_tpu_torch/models/resnet.py, models/common.py)
and its dense-masked train step against the JAX package's, on the CPU.

ResNet-50 at width 0.125, 32 px images, batch 2, block (16, 16), float32.
The port's initial values go to JAX by path, the JAX state comes back
through convert.py, and both packages run the same numpy inputs.
Tolerances: logits and batch statistics 1e-4 relative to the largest
value (the same convolutions and f32 BatchNorm statistics, summed in
another order through 53 layers); one train step's loss 1e-4, and its
updated parameters, momentum and statistics 1e-3 relative to each
tensor's largest value (gradients back through the same 53 layers, where
each batch-2 BatchNorm backward divides by the batch standard deviation;
the largest error measured, at a zero-initialised bn3 scale that holds
only its gradient, was 1.03e-4).  The JAX step runs the v4 matmul kernel
in Pallas interpret mode, the port its plain version, for the 9 eligible
1x1 convs of each group's first block (conv1, conv3 and the strided
projection: every kind of 1x1 the model has; the other 20 run
dense-times-mask), since each routed layer adds about a second to JAX's
compile; the JAX masks and packings are made on the host (numpy, and the
port's pack_flat_active, equal to JAX's by
tests/test_torch_dense_block_mm.py), for the same reason.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.models.resnet import ResNet as JResNet
from rigl_tpu.sparsity import distributions as jdist
from rigl_tpu.sparsity import masks as jmasks
from rigl_tpu.sparsity.schedules import UpdateSchedule as JSchedule
from rigl_tpu.train import steps as jsteps
from rigl_tpu.train.train_state import TrainState as JTrainState
from rigl_tpu.transforms import algorithms as jalgorithms
from rigl_tpu.transforms.sparse_training import SparseState as JSparseState
from rigl_tpu.transforms.sparse_training import SparseTraining as JST
from rigl_tpu_torch import convert
from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.resnet import ResNet
from rigl_tpu_torch.ops import block_mask as bm_lib
from rigl_tpu_torch.ops import block_sparse_v4 as tv4
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import steps
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import SparseTraining
from torch_threads import one_thread  # noqa: F401


WIDTH, BLOCK, BATCH, PX = 0.125, (16, 16), 2, 32
SCHED = dict(begin_step=1, end_step=100, frequency=5, drop_fraction=0.3)


def _close(got, want, rtol=1e-4, msg=''):
  got = np.asarray(torch.as_tensor(got).detach().float())
  want = np.asarray(want, np.float32)
  scale = max(1e-6, float(np.abs(want).max()))
  np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                             err_msg=msg)


def _block_masks(shapes, sparsities, rs):
  """Numpy masks at ERK densities: block-granular (tap cells for 3x3
  convs) where the block divides the layer, element-granular elsewhere."""
  out, counts = {}, {}
  bk, bn = BLOCK
  for p, s in shapes.items():
    keep = lambda *shape: (rs.rand(*shape) >= sparsities[p]).astype(   # noqa
        np.float32)
    if len(s) == 4 and s[:2] != (1, 1):
      if s[2] % bk or s[3] % bn:
        out[p] = keep(*s)
        continue
      occ = keep(s[0] * s[1], s[2] // bk, s[3] // bn)
      m = np.repeat(np.repeat(occ, bk, 1), bn, 2).reshape(s)
    else:
      rows, cols = int(np.prod(s[:-1])), s[-1]
      if rows % bk or cols % bn:
        out[p] = keep(*s)
        continue
      occ = keep(rows // bk, cols // bn)
      m = np.repeat(np.repeat(occ, bk, 0), bn, 1).reshape(s)
    out[p] = m
    counts[p] = int(occ.sum())
  return out, counts


@pytest.fixture(scope='module')
def jax_side():
  """The JAX model, its variables, masks, packings and one v4-route train
  step, built once for the module."""
  rs = np.random.RandomState(0)
  model = JResNet(depth=50, num_classes=10, width=WIDTH, block=BLOCK)
  x = rs.randn(BATCH, PX, PX, 3).astype(np.float32)
  labels = np.array([3, 7], np.int32)
  # Initial values from the port's model (its paths are flax's: see
  # test_depths_param_paths_and_shapes_equal_jax), which spares JAX's init
  # compile; running statistics off their init values, so eval-mode logits
  # test them.
  port = ResNet(50, num_classes=10, width=WIDTH, device='cpu',
                generator=torch.Generator().manual_seed(0))
  variables = {
      'params': bm_lib.nest_entries({
          p: jnp.asarray(t.detach().numpy())
          for p, t in masks_lib.param_dict(port).items()}),
      'batch_stats': bm_lib.nest_entries({
          masks_lib.path_str(n): jnp.asarray(
              t.numpy() + rs.rand(*t.shape).astype(np.float32))
          for n, t in port.named_buffers()})}
  params = {'params': variables['params']}
  st = JST(optax.sgd(0.1, momentum=0.9, nesterov=True),
           jalgorithms.RigL(schedule=JSchedule(**SCHED)),
           default_sparsity=0.8, block=BLOCK, premask_params=True,
           custom_sparsity_map=model.first_last_layer_map(False, True))
  shapes = jmasks.mask_shapes(params)
  st.layer_shapes = dict(shapes)
  st.sparsities = jdist.get_sparsities(shapes, 'erdos_renyi_kernel', 0.8,
                                       st.custom_sparsity_map)
  masks, counts = _block_masks(shapes, st.sparsities, rs)
  eligible = bm_lib.block_executable_layers(
      {p: torch.zeros(s) for p, s in shapes.items()}, BLOCK)
  assert len(eligible) == 29
  routing = {p: 'matmul' for p in eligible if '_block0/' in p}
  eligible = list(routing)
  packs = {}
  for p in eligible:
    occ = (bm_lib.pool_to_blocks(torch.as_tensor(masks[p]), BLOCK, 'max')
           > 0).to(torch.int32)
    cols, rows = tv4.pack_flat_active(occ, counts[p])
    packs[p] = {'cols': jnp.asarray(cols.numpy()),
                'rows': jnp.asarray(rows.numpy())}
  params = jmasks.apply_masks(params, {p: jnp.asarray(m)
                                       for p, m in masks.items()})
  sstate = JSparseState(
      masks={p: jnp.asarray(m) for p, m in masks.items()},
      step=jnp.int32(0), last_update_step=jnp.int32(
          st.algo.schedule.initial_last_update_step),
      is_snipped=jnp.bool_(False), block_packs=packs)
  state = JTrainState(params=params, batch_stats=variables['batch_stats'],
                      opt_state=st.tx.init(params), sparse=sstate,
                      rng=jax.random.key(1))
  fn = jax.jit(jsteps.make_train_step(
      model, st, weight_decay=1e-4, label_smoothing=0.1, block=BLOCK,
      update_hint=False))
  new_state, metrics = fn(state, {'image': jnp.asarray(x),
                                  'label': jnp.asarray(labels)})
  apply = jax.jit(lambda v, a, train: model.apply(
      v, a, train=train, mutable=['batch_stats']), static_argnums=2)
  out = {}
  for train in (False, True):
    logits, upd = apply({'params': params['params'],
                         'batch_stats': variables['batch_stats']},
                        jnp.asarray(x), train)
    out[train] = (np.asarray(logits),
                  jax.tree.map(np.asarray, upd.get('batch_stats', {})))
  return dict(x=x, labels=labels, state=state, new_state=new_state,
              metrics=metrics, routing=routing, counts=counts,
              sparsities=dict(st.sparsities), logits=out,
              custom=st.custom_sparsity_map)


def _state_arrays(state):
  sp = state.sparse
  return {'params': jax.tree.map(np.asarray, state.params),
          'batch_stats': jax.tree.map(np.asarray, state.batch_stats),
          'momentum': jax.tree.map(np.asarray, state.opt_state[0].trace),
          'masks': {p: np.asarray(m) for p, m in sp.masks.items()},
          'step': int(sp.step), 'last_update_step': int(sp.last_update_step),
          'is_snipped': bool(sp.is_snipped), 'ema_grads': None,
          'initial_weights': None,
          'block_packs': jax.tree.map(np.asarray, sp.block_packs)}


def _port(jax_side):
  model = ResNet(50, num_classes=10, width=WIDTH, block=BLOCK, device='cpu')
  st = SparseTraining(
      functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                        nesterov=True),
      algorithms.RigL(schedule=UpdateSchedule(**SCHED)),
      default_sparsity=0.8, block=BLOCK, premask_params=True,
      block_routing=jax_side['routing'],
      custom_sparsity_map=model.first_last_layer_map(False, True))
  state = convert.train_state_from_jax(model, st,
                                       _state_arrays(jax_side['state']))
  return model, st, state


@pytest.mark.parametrize('train', [False, True])
def test_logits_and_batch_stats_match_jax(jax_side, train):
  """Logits in eval mode (running statistics) and in train mode (batch
  statistics), and the running averages train mode leaves: flax's
  momentum 0.9 and BIASED batch variance."""
  model, _, state = _port(jax_side)
  x = torch.as_tensor(jax_side['x'])
  with torch.no_grad():
    logits = model(x, train=train)
  want_logits, want_stats = jax_side['logits'][train]
  _close(logits, want_logits, msg='logits')
  if train:
    stats = convert._paths(want_stats)
    assert set(stats) == set(state.batch_stats)
    for p, t in state.batch_stats.items():
      _close(t, stats[p], msg=p)


def test_block_forward_equals_dense_forward(jax_side):
  """The v4-routed forward of the port equals its dense forward on the
  pre-masked weights (the routing changes how, not what)."""
  model, st, state = _port(jax_side)
  x = torch.as_tensor(jax_side['x'])
  entries = state.sparse.block_packs
  assert len(entries) == len(jax_side['routing'])
  with torch.no_grad(), common.frozen_batch_stats(model):
    dense = model(x, train=True)
    blocked = model(x, train=True, block_masks=entries)
  # As the logits: other summation orders, amplified by batch-statistic
  # normalization at batch 2.
  _close(blocked, dense.numpy())


def test_train_step_v4_route_matches_jax(jax_side):
  """One make_train_step step (RigL, no update: update_hint False) through
  the v4 route of every eligible 1x1 conv, from the same state: loss,
  parameters, momentum and batch statistics after the step."""
  model, st, state = _port(jax_side)
  for p, e in state.sparse.block_packs.items():
    assert set(e) == {'cols', 'rows'}, p
    assert int(e['cols'].shape[0]) - 1 == jax_side['counts'][p]
  fn = steps.make_train_step(model, st, weight_decay=1e-4,
                             label_smoothing=0.1, block=BLOCK,
                             update_hint=False)
  state, metrics = fn(state, {'image': torch.as_tensor(jax_side['x']),
                              'label': torch.as_tensor(jax_side['labels'])})
  jm = jax_side['metrics']
  assert metrics['update_hint_ok'] and not metrics['mask_updated']
  assert metrics['step'] == int(jm['step']) == 1
  np.testing.assert_allclose(float(metrics['loss']), float(jm['loss']),
                             rtol=1e-4)
  want = _state_arrays(jax_side['new_state'])
  jparams = convert._paths(want['params'])
  jtrace = convert._paths(want['momentum'])
  jstats = convert._paths(want['batch_stats'])
  for p, t in state.params.items():
    _close(t, jparams[p], 1e-3, msg=p)
    _close(state.optimizer.state[t]['momentum_buffer'], jtrace[p], 1e-3,
           msg=p)
  for p, t in state.batch_stats.items():
    _close(t, jstats[p], 1e-3, msg=p)
  for p, m in state.sparse.masks.items():   # pre-masked storage holds
    assert not bool((state.params[p].detach() * (1 - m)).any()), p
