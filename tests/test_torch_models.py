"""The port's model zoo (rigl_tpu_torch/models/registry.py and the modules
behind it) against the JAX package's, on the CPU.

Every registry name and preset is built in both packages at a small size
(narrow widths, small images; VGG at 224 px, where fc6's 7x7 VALID conv
needs a 7x7 map).  JAX's variable tree is traced with jax.eval_shape (no
init compile); the port's model, from a torch generator, gives the
values, with BatchNorm statistics off their initial values so that eval
mode tests them.  The values go to JAX by path and come back into a fresh
port model through convert.load_jax_variables, so the comparison also
runs the conversion.  Checked: the parameter and batch_stats paths and
shapes, the mask paths and shapes (the default rule) in JAX's order, and
the logits in eval mode and, where dropout is 0, in train mode, with the
train-mode batch statistics.  Tolerance: 1e-4 of the largest |value| of
each output (the same f32 convolutions, summed in another order through
up to 200 layers, each train-mode BatchNorm dividing by the batch's
standard deviation).

One dense-masked RigL train step (make_train_step, SGD 0.1 nesterov 0.9,
weight decay 1e-4, label smoothing 0.1, ERK 0.8 masks from JAX's init)
runs in both packages for WRN-10-1 and MobileNetV1 at width 0.25 (its
depthwise kernels left unmasked by a mask rule, as JAX's trainer does),
in float64 (JAX under enable_x64): at random init MobileNetV1's
train-mode gradients in float32 move by about 1e-2 of their largest
value when JAX alone evaluates them in another order, so float32 cannot
hold two packages together.  The loss (float32 in both, as their
cross-entropies compute it) within 1e-6 relative, and the updated
parameters, the momentum trace (after one step from zero, the masked
gradient) and the batch statistics within 1e-6 of each tensor's largest
value (the loss's float32 rounding carried through the backward).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.models import registry as jregistry
from rigl_tpu.sparsity import masks as jmasks
from rigl_tpu.sparsity.schedules import UpdateSchedule as JSchedule
from rigl_tpu.train import steps as jsteps
from rigl_tpu.train.train_state import TrainState as JTrainState
from rigl_tpu.transforms import algorithms as jalgorithms
from rigl_tpu.transforms.sparse_training import SparseTraining as JST
from rigl_tpu_torch import convert
from rigl_tpu_torch.models import registry
from rigl_tpu_torch.ops.block_mask import nest_entries
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import steps
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import SparseTraining
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-4
MNIST, CIFAR, IMAGENET = (8, 28, 28, 1), (2, 16, 16, 3), (1, 224, 224, 3)
SMALL_IMAGENET = (4, 32, 32, 3)
# 64 px: the last stage's 2x2 map gives train-mode BatchNorm 16 samples.
MOBILE = (4, 64, 64, 3)
SMALL_RESNET = dict(width=0.0625, num_classes=10)
# name -> (JAX kwargs, the port's extra kwargs, input shape, train-mode
# logits checked (no dropout))
CASES = {
    'mnist_mlp': ({}, {}, MNIST, True),
    'budget_mlp': (dict(param_count=20000, depth=3), {}, MNIST, True),
    'lenet5': (dict(use_batch_norm=True), {}, MNIST, True),
    'small_cnn': (dict(conv_features=(8, 16), dense_features=(32,)), {},
                  MNIST, True),
    'wide_resnet': (dict(depth=10, width=1), {}, CIFAR, True),
    'wrn_22_2': ({}, {}, CIFAR, True),
    'wrn_16_4': ({}, {}, CIFAR, True),
    'resnet': (dict(depth=34, **SMALL_RESNET), {}, SMALL_IMAGENET, True),
    'resnet18': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'resnet34': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'resnet50': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'resnet101': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'resnet152': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'resnet200': (SMALL_RESNET, {}, SMALL_IMAGENET, True),
    'mobilenet_v1': (dict(width=0.25, num_classes=10), {}, MOBILE, True),
    'mobilenet_v2': (dict(width=0.25, num_classes=10), {}, MOBILE, True),
    'vgg': (dict(variant='vgg_a', num_classes=10, dropout_rate=0.0), {},
            IMAGENET, True),
    'vgg_a': (dict(num_classes=10), {}, IMAGENET, False),
    'vgg_16': (dict(num_classes=10), {}, IMAGENET, False),
    'vgg_19': (dict(num_classes=10), {}, IMAGENET, False),
}


def _close(got, want, rtol=RTOL, msg=''):
  got = np.asarray(torch.as_tensor(got).detach().double())
  want = np.asarray(want, np.float64)
  scale = max(1e-6, float(np.abs(want).max()))
  np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                             err_msg=msg)


def _flat(tree):
  return {jmasks.path_str(p): leaf
          for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_model(name, seed):
  jkw, pkw, _, _ = CASES[name]
  return registry.create_model(
      name, device='cpu', generator=torch.Generator().manual_seed(seed),
      **jkw, **pkw)


def _variables(model, rs):
  """The port model's values as a flax variable tree of numpy arrays; the
  running statistics moved off their initial values."""
  params = {p: t.detach().numpy() for p, t in
            masks_lib.param_dict(model).items()}
  stats = {masks_lib.path_str(n): t.numpy() + rs.rand(*t.shape).astype(
      np.float32) for n, t in model.named_buffers()}
  out = {'params': nest_entries(params)}
  if stats:
    out['batch_stats'] = nest_entries(stats)
  return out


@pytest.fixture(scope='module')
def zoo():
  """Per name: JAX's traced shapes, the variables, the input and JAX's
  logits (eval, and train with the new statistics where checked)."""
  rs = np.random.RandomState(0)
  out = {}
  for name, (jkw, _, shape, train) in CASES.items():
    jmodel = jregistry.create_model(name, **jkw)
    x = rs.randn(*shape).astype(np.float32)
    traced = jax.eval_shape(
        lambda m=jmodel, s=shape: m.init(jax.random.key(0), jnp.zeros(s),
                                         train=False))
    variables = _variables(_port_model(name, 0), rs)

    def apply(v, x, m=jmodel, train=train):
      eval_logits = m.apply(v, x, train=False)
      if not train:
        return eval_logits, None, None
      train_logits, upd = m.apply(v, x, train=True, mutable=['batch_stats'])
      return eval_logits, train_logits, upd.get('batch_stats')

    # The ResNets run eagerly: their depths share every op shape, so JAX's
    # per-op compile cache serves them all, where jit compiles each whole.
    run = apply if name.startswith('resnet') else jax.jit(apply)
    res = run(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    out[name] = dict(
        traced={c: {p: tuple(s.shape) for p, s in _flat(t).items()}
                for c, t in traced.items()},
        masks=jmasks.mask_shapes(traced['params']), variables=variables,
        x=x, logits=jax.tree.map(np.asarray, res))
  return out


def test_registry_names_and_refusals_equal_jax():
  assert registry.available_models() == jregistry.available_models()
  assert set(CASES) == set(registry.available_models())
  for name, kw, err in (('nope', {}, 'Unknown model'),
                        ('wide_resnet', dict(depth=23), 'Depth'),
                        ('resnet', dict(depth=42), 'resnet_depth'),
                        ('vgg', dict(variant='vgg_x'), 'Unknown VGG')):
    with pytest.raises(ValueError, match=err):
      registry.create_model(name, device='cpu', **kw)
  m = registry.create_model('resnet50', device='meta')
  assert m.first_last_layer_map(False, False) == jregistry.create_model(
      'resnet50').first_last_layer_map(False, False)
  for name in ('mobilenet_v1', 'mobilenet_v2'):
    assert (registry.create_model(name, device='meta').dense_layer_paths()
            == jregistry.create_model(name).dense_layer_paths())
  mlp = registry.create_model('mnist_mlp', device='meta')
  assert mlp.custom_sparsity_map(0.9) == jregistry.create_model(
      'mnist_mlp').custom_sparsity_map(0.9)


@pytest.mark.parametrize('name', list(CASES))
def test_paths_shapes_and_logits_match_jax(zoo, name):
  ref = zoo[name]
  model = _port_model(name, 1)
  params = {p: tuple(t.shape) for p, t in
            masks_lib.param_dict(model).items()}
  stats = {masks_lib.path_str(n): tuple(t.shape)
           for n, t in model.named_buffers()}
  assert params == ref['traced']['params']
  assert stats == ref['traced'].get('batch_stats', {})
  shapes = masks_lib.mask_shapes(masks_lib.param_dict(model))
  assert list(shapes.items()) == list(ref['masks'].items())
  convert.load_jax_variables(model, ref['variables'])
  x = torch.as_tensor(ref['x'])
  want_eval, want_train, want_stats = ref['logits']
  with torch.no_grad():
    _close(model(x, train=False), want_eval, msg='eval logits')
    if want_train is None:
      return
    _close(model(x, train=True), want_train, msg='train logits')
  want_stats = convert._paths(want_stats or {})
  for n, t in model.named_buffers():
    _close(t, want_stats[masks_lib.path_str(n)], msg=n)


def test_dropout_draws_from_the_given_generator():
  """Train-mode dropout (VGG's fc6 / fc7 and WRN's droprate) is flax's
  keep-and-rescale, from the model's generator: the same generator state
  gives the same logits, another one other logits; eval mode has none."""
  x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))

  def logits(seed, train):
    m = registry.create_model(
        'wide_resnet', depth=10, width=1, droprate=0.5, device='cpu',
        generator=torch.Generator().manual_seed(0),
        dropout_rng=torch.Generator().manual_seed(seed))
    with torch.no_grad():
      return m(x, train=train)

  assert torch.equal(logits(1, True), logits(1, True))
  assert not torch.equal(logits(1, True), logits(2, True))
  assert torch.equal(logits(1, False), logits(2, False))


# ------------------------------------------------------ one train step ----
STEP_CASES = {
    'wrn': ('wide_resnet', dict(depth=10, width=1), (4, 16, 16, 3), False),
    'mbv1': ('mobilenet_v1', dict(width=0.25, num_classes=10),
             MOBILE, True),
}
SCHED = dict(begin_step=1, end_step=100, frequency=5, drop_fraction=0.3)


def _rule(dense_paths):
  def rule(path, leaf):
    return path not in dense_paths and masks_lib.default_mask_rule(path,
                                                                   leaf)
  return rule


@pytest.fixture(scope='module')
def step_side():
  """Per case: JAX's state before and after one train step, its metrics,
  the batch and the depthwise paths."""
  rs = np.random.RandomState(1)
  out = {}
  with jax.enable_x64(True):
    for case in STEP_CASES:
      out[case] = _jax_step(case, rs)
  return out


def _jax_step(case, rs):
  name, kw, shape, dense_dw = STEP_CASES[case]
  jmodel = jregistry.create_model(name, dtype=jnp.float64, **kw)
  dense = jmodel.dense_layer_paths() if dense_dw else []
  port = registry.create_model(name, device='cpu',
                               generator=torch.Generator().manual_seed(2),
                               **kw)
  variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           _variables(port, rs))
  st = JST(optax.sgd(0.1, momentum=0.9, nesterov=True),
           jalgorithms.RigL(schedule=JSchedule(**SCHED)),
           default_sparsity=0.8, mask_rule=_rule(dense))
  params = {'params': variables['params']}
  opt_state, sstate = st.init(jax.random.key(3), params)
  state = JTrainState(params=params,
                      batch_stats=variables['batch_stats'],
                      opt_state=opt_state, sparse=sstate,
                      rng=jax.random.key(4))
  batch = {'image': rs.randn(*shape),
           'label': rs.randint(0, 10, shape[0]).astype(np.int32)}
  fn = jax.jit(jsteps.make_train_step(jmodel, st, weight_decay=1e-4,
                                      label_smoothing=0.1,
                                      update_hint=False))
  new_state, metrics = fn(state, jax.tree.map(jnp.asarray, batch))
  return dict(state=_state_arrays(state),
              new_state=_state_arrays(new_state),
              metrics=jax.tree.map(np.asarray, metrics), batch=batch,
              dense=dense)


def _state_arrays(state):
  sp = state.sparse
  trace = state.opt_state[0].trace
  return {'params': jax.tree.map(np.asarray, state.params),
          'batch_stats': jax.tree.map(np.asarray, state.batch_stats),
          'momentum': jax.tree.map(np.asarray, trace),
          'masks': {p: np.asarray(m) for p, m in sp.masks.items()},
          'step': int(sp.step), 'last_update_step': int(sp.last_update_step),
          'is_snipped': bool(sp.is_snipped), 'ema_grads': None,
          'initial_weights': None, 'block_packs': None}


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_train_step_matches_jax(step_side, case):
  ref = step_side[case]
  name, kw, _, _ = STEP_CASES[case]
  model = registry.create_model(name, device='cpu', dtype=torch.float64,
                                **kw).double()
  st = SparseTraining(
      functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                        nesterov=True),
      algorithms.RigL(schedule=UpdateSchedule(**SCHED)),
      default_sparsity=0.8, mask_rule=_rule(ref['dense']))
  state = convert.train_state_from_jax(model, st, ref['state'])
  assert set(state.sparse.masks) == set(ref['state']['masks'])
  assert not set(ref['dense']) & set(state.sparse.masks)
  fn = steps.make_train_step(model, st, weight_decay=1e-4,
                             label_smoothing=0.1, update_hint=False)
  state, metrics = fn(state, {k: torch.as_tensor(v)
                              for k, v in ref['batch'].items()})
  jm = ref['metrics']
  assert metrics['update_hint_ok'] and not metrics['mask_updated']
  np.testing.assert_allclose(float(metrics['loss']), float(jm['loss']),
                             rtol=1e-6)
  want = ref['new_state']
  jparams = convert._paths(want['params'])
  jtrace = convert._paths(want['momentum'])
  jstats = convert._paths(want['batch_stats'])
  for p, t in state.params.items():
    _close(t, jparams[p], 1e-6, msg=p)
    _close(state.optimizer.state[t]['momentum_buffer'], jtrace[p], 1e-6,
           msg=p)
  for p, t in state.batch_stats.items():
    _close(t, jstats[p], 1e-6, msg=p)
  for p in ref['dense']:   # depthwise kernels: unmasked, trained densely
    assert bool((state.params[p] != 0).all()), p
