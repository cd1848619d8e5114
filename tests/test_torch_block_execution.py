"""Block-sparse execution in the port (rigl_tpu_torch/models/common.py,
ops/conv.py, train/steps.py, transforms/sparse_training.py), the twins of
tests/test_block_execution.py, and the port against the JAX package on
the same tiny conv net.

Also: ResNet's parameter and statistic paths at every depth equal flax's.

Contract, as in JAX: block execution changes HOW eligible convs compute
(inactive weight blocks skipped) but not WHAT they compute: outputs,
gradients at active blocks, masks and training trajectories equal
dense-times-mask execution.  Tolerances: 1e-5 on float32 outputs (the same
sums in another order), 1e-4 on gradients and on trajectories (sums of
products, then optimizer steps on top).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from rigl_tpu.models import common as jcommon
from rigl_tpu.models.resnet import ResNet as JResNet
from rigl_tpu.sparsity.schedules import UpdateSchedule as JSchedule
from rigl_tpu.train import steps as jsteps
from rigl_tpu.transforms import algorithms as jalgorithms
from rigl_tpu.transforms.sparse_training import SparseTraining as JST
from rigl_tpu_torch import convert
from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Dense
from rigl_tpu_torch.models.resnet import DEPTHS, ResNet
from rigl_tpu_torch.ops import block_mask as bm_lib
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import steps
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import SparseTraining
from torch_threads import one_thread  # noqa: F401


BLOCK = (8, 8)
BM = 8


def _conv_pair(kernel_size, stride, cin=8, cout=16, seed=0):
  gen = torch.Generator().manual_seed(seed)
  dense = common.ConvFixedPad(cin, cout, kernel_size, stride,
                              generator=gen, device='cpu')
  blocked = common.ConvFixedPad(cin, cout, kernel_size, stride, block=BLOCK,
                                block_bm=BM, device='cpu')
  blocked.load_state_dict(dense.state_dict())
  common.set_conv_paths(blocked)
  x = torch.randn(2, 8, 8, cin, generator=gen)
  return dense, blocked, x


def _mask(shape, seed):
  return bm_lib.random_block_mask(torch.Generator().manual_seed(seed),
                                  tuple(shape), 0.5, BLOCK)


def _masked(conv, mask):
  with torch.no_grad():
    conv.conv.kernel.mul_(mask)


@pytest.mark.parametrize('kernel_size', [1, 3])
@pytest.mark.parametrize('stride', [1, 2])
def test_block_execution_matches_dense(kernel_size, stride):
  """1x1 convs on the matmul kernels, spatial convs on the tap kernels
  (strided ones run stride-1 on the fixed-padded input, every s-th centre
  kept); semantics identical to the dense conv."""
  dense, blocked, x = _conv_pair(kernel_size, stride)
  mask = _mask(dense.conv.kernel.shape, 2)
  _masked(dense, mask)
  _masked(blocked, mask)
  entries = {'conv/kernel': bm_lib.block_entry(mask, BLOCK)}
  if kernel_size == 1:
    assert not isinstance(entries['conv/kernel'], dict)   # occupancy: v3
  else:
    assert 'taps' in entries['conv/kernel']
  want = dense(x)
  got = blocked(x, entries)
  np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                             rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kernel_size,form', [(1, 'occupancy'), (1, 'flat'),
                                              (3, 'tap')])
@pytest.mark.parametrize('stride', [1, 2])
def test_block_backward_matches_dense_at_active_blocks(kernel_size, form,
                                                       stride):
  dense, blocked, x = _conv_pair(kernel_size, stride, seed=1)
  mask = _mask(dense.conv.kernel.shape, 3)
  n_act = None
  if form == 'flat':
    n_act = int(bm_lib.pool_to_blocks(mask, BLOCK, 'max').sum())
  entries = {'conv/kernel': bm_lib.block_entry(mask, BLOCK, n_act)}

  def grads(conv, fn):
    xx = x.clone().requires_grad_()
    loss = (fn(conv, xx) ** 2).sum()
    return torch.autograd.grad(loss, (xx, conv.conv.kernel))

  def dense_fn(conv, xx):
    w = conv.conv.kernel
    return common.conv_nhwc(xx if stride == 1 else common.fixed_padding(
        xx, kernel_size), w * mask, stride, 'SAME' if stride == 1 else
        'VALID')

  gd = grads(dense, dense_fn)
  gb = grads(blocked, lambda c, xx: c(xx, entries))
  np.testing.assert_allclose(gb[0].numpy(), gd[0].numpy(), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose((gb[1] * mask).numpy(),
                             (gd[1] * mask).numpy(), rtol=1e-4, atol=1e-5)


def test_flat_packing_derives_its_lists_once():
  """A flat packing entry keeps the 1x1 conv's entry lists and occupancy
  after the first call; a second call reuses them and gives the same
  output and gradients."""
  from rigl_tpu_torch.ops.block_sparse_v4 import FlatPacking
  dense, blocked, x = _conv_pair(1, 1, seed=2)
  mask = _mask(dense.conv.kernel.shape, 4)
  n_act = int(bm_lib.pool_to_blocks(mask, BLOCK, 'max').sum())
  entry = bm_lib.block_entry(mask, BLOCK, n_act)
  assert isinstance(entry, FlatPacking) and set(entry) == {'cols', 'rows'}
  outs = []
  for _ in range(2):
    xx = x.clone().requires_grad_()
    y = blocked(xx, {'conv/kernel': entry})
    outs.append((y.detach(),) + torch.autograd.grad(
        (y ** 2).sum(), (xx, blocked.conv.kernel)))
    assert sorted(k[0] for k in entry._derived) == ['dx', 'fwd', 'occupancy']
  for a, b in zip(*outs):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_conv3x3_falls_back_to_dense_conv():
  dense, blocked, x = _conv_pair(3, 1)
  np.testing.assert_allclose(blocked(x).detach().numpy(),
                             dense(x).detach().numpy(), rtol=1e-5, atol=1e-5)


class TinyNet(nn.Module):
  """tests/test_block_execution.py's _TinyNet: 1x1, 3x3 and strided 1x1
  convs, all block-eligible under (8, 8), and a dense head."""

  def __init__(self, block=None, generator=None):
    super().__init__()
    conv = functools.partial(common.ConvFixedPad, block=block, block_bm=BM,
                             generator=generator, device='cpu')
    self.c1 = conv(8, 16, 1, 1)
    self.c3x3 = conv(16, 16, 3, 1)
    self.c2 = conv(16, 32, 1, 2)
    self.head = Dense(32, 10, generator=generator, device='cpu')
    common.set_conv_paths(self)

  def forward(self, x, train=False, block_masks=None):
    x = torch.relu(self.c1(x, block_masks))
    x = torch.relu(self.c3x3(x, block_masks))
    x = torch.relu(self.c2(x, block_masks))
    return self.head(x.mean(dim=(1, 2)))


def _sgd(lr=0.05, momentum=0.9):
  return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum)


SCHED = dict(begin_step=0, end_step=100, frequency=2, drop_fraction=0.5)


def _make(block_exec, algo_name, routing=None):
  model = TinyNet(block=BLOCK if block_exec else None,
                  generator=torch.Generator().manual_seed(0))
  st = SparseTraining(
      _sgd(), algorithms.get_algorithm(algo_name,
                                       schedule=UpdateSchedule(**SCHED)),
      distribution='uniform', default_sparsity=0.5, block=BLOCK, seed=3,
      block_routing=routing)
  state = steps.init_train_state(0, model, st, has_batch_stats=False)
  fn = steps.make_train_step(model, st, has_batch_stats=False,
                             block=BLOCK if block_exec else None,
                             block_conv3x3=block_exec)
  return fn, state


def _batches(n):
  rng = np.random.default_rng(0)
  return [{'image': rng.normal(size=(4, 8, 8, 8)).astype(np.float32),
           'label': rng.integers(0, 10, (4,)).astype(np.int32)}
          for _ in range(n)]


def _tb(batch):
  return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize('algo_name,routing', [
    ('rigl', None), ('set', None), ('static', None),
    ('rigl', {'c3x3/conv/kernel': 'dense', 'c1/conv/kernel': 'matmul'})])
def test_train_trajectory_block_vs_dense(algo_name, routing):
  """Steps spanning mask updates: identical masks, losses and params with
  block execution (default and measured routing) and without."""
  fn_b, state_b = _make(True, algo_name, routing)
  fn_d, state_d = _make(False, algo_name)
  for p in state_b.params:
    torch.testing.assert_close(state_b.params[p], state_d.params[p],
                               rtol=0, atol=0)
  updated = 0
  for batch in _batches(6):
    state_b, mb = fn_b(state_b, _tb(batch))
    state_d, md = fn_d(state_d, _tb(batch))
    updated += int(mb['mask_updated'])
    assert mb['mask_updated'] == md['mask_updated']
    np.testing.assert_allclose(float(mb['loss']), float(md['loss']),
                               rtol=1e-4, atol=1e-5)
  assert updated >= 2, 'test must cover mask-update iterations'
  for p, m in state_b.sparse.masks.items():
    np.testing.assert_array_equal(m.numpy(), state_d.sparse.masks[p].numpy(),
                                  p)
  for p in state_b.params:
    np.testing.assert_allclose(state_b.params[p].detach().numpy(),
                               state_d.params[p].detach().numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('algo_name', ['momentum', 'dnw'])
def test_block_execution_rejects_per_step_dense_grad_algos(algo_name):
  model = TinyNet(block=BLOCK)
  st = SparseTraining(_sgd(), algorithms.get_algorithm(
      algo_name, schedule=UpdateSchedule(**SCHED)), distribution='uniform',
                      default_sparsity=0.5, block=BLOCK)
  with pytest.raises(ValueError, match='block-sparse execution'):
    steps.make_train_step(model, st, has_batch_stats=False, block=BLOCK)


def test_block_mask_collection_matches_resnet_paths():
  """Collection entries nest at the exact parameter paths ResNet's 1x1
  convs read, and only 1x1-divisible layers are included."""
  model = ResNet(50, num_classes=10, width=0.25, block=(16, 16),
                 device='cpu')
  st = SparseTraining(_sgd(), algorithms.SET(schedule=UpdateSchedule(
      begin_step=0, end_step=10, frequency=5, drop_fraction=0.3)),
                      default_sparsity=0.8, block=(16, 16))
  params = masks_lib.param_dict(model)
  _, sstate = st.init(1, params)
  col = bm_lib.block_mask_collection(sstate.masks, (16, 16))
  flat = {}

  def walk(node, prefix):
    for k, v in node.items():
      if isinstance(v, dict):
        walk(v, prefix + (k,))
      else:
        flat['/'.join(prefix + (k,))] = v
  walk(col, ())
  assert flat
  convs = {m.path for m in model.modules()
           if isinstance(m, common._BlockConv)}
  for path, occ in flat.items():
    shape = tuple(params[path].shape)
    assert path in convs and len(shape) == 4 and shape[:2] == (1, 1)
    assert tuple(occ.shape) == (shape[2] // 16, shape[3] // 16)
    want = (bm_lib.pool_to_blocks(sstate.masks[path], (16, 16), 'max')
            > 0).to(torch.int32)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
  assert not any('conv2' in p for p in flat)
  assert 'final_dense/kernel' not in flat


def test_depths_param_paths_and_shapes_equal_jax():
  """Every depth of DEPTHS: the port's parameter and BatchNorm-statistic
  paths and shapes are flax's (jax.eval_shape, no compile), and each
  bottleneck's bn3 / residual block's bn2 scale starts at zero."""
  x = jnp.zeros((1, 32, 32, 3))
  for depth in DEPTHS:
    jm = JResNet(depth=depth, num_classes=10, width=0.125)
    shapes = jax.eval_shape(lambda k: jm.init(k, x, train=False),
                            jax.random.key(0))
    want, want_stats = (
        {'/'.join(k.key for k in path): tuple(leaf.shape) for path, leaf in
         jax.tree_util.tree_flatten_with_path(shapes[c])[0]}
        for c in ('params', 'batch_stats'))
    model = ResNet(depth, num_classes=10, width=0.125, device='meta')
    got = {masks_lib.path_str(n): tuple(t.shape)
           for n, t in model.named_parameters()}
    got_stats = {masks_lib.path_str(n): tuple(t.shape)
                 for n, t in model.named_buffers()}
    assert got == want, depth
    assert got_stats == want_stats, depth
  for depth in (18, 50):
    model = ResNet(depth, num_classes=10, width=0.125, device='cpu')
    last_bn = 'bn3' if DEPTHS[depth][0] else 'bn2'
    scales = {n: m.scale for n, m in model.named_modules()
              if n.endswith(last_bn)}
    assert scales and not any(bool(s.any()) for s in scales.values())
    assert bool(model.initial_bn.scale.all())
  assert ResNet(18, device='meta').first_last_layer_map(False, False) == {
      'initial_conv/conv/kernel': 0.0, 'final_dense/kernel': 0.0}


def test_block_routing_controls_pack_forms():
  """'dense' layers get no pack, 'matmul' 1x1s the flat v4 pack, unlisted
  layers keep the tap default."""
  routing = {'c3x3/conv/kernel': 'dense', 'c1/conv/kernel': 'matmul'}
  _, state = _make(True, 'set', routing)
  packs = state.sparse.block_packs
  assert 'c3x3/conv/kernel' not in packs
  assert set(packs['c1/conv/kernel']) == {'cols', 'rows'}
  assert set(packs['c2/conv/kernel']) == {'cols', 'rows', 'taps'}


# ------------------------------------------------------- port against JAX --
class _JTinyNet(fnn.Module):
  block: tuple = None

  @fnn.compact
  def __call__(self, x, train: bool = False):
    x = jcommon.ConvFixedPad(16, 1, 1, block=self.block, block_bm=BM,
                             name='c1')(x)
    x = fnn.relu(x)
    x = jcommon.ConvFixedPad(16, 3, 1, block=self.block, block_bm=BM,
                             name='c3x3')(x)
    x = fnn.relu(x)
    x = jcommon.ConvFixedPad(32, 1, 2, block=self.block, block_bm=BM,
                             name='c2')(x)
    x = fnn.relu(x)
    x = jnp.mean(x, axis=(1, 2))
    return fnn.Dense(10, name='head')(x)


def _jax_state_arrays(state):
  sp = state.sparse
  return {'params': jax.tree.map(np.asarray, state.params),
          'batch_stats': {},
          'momentum': jax.tree.map(np.asarray, state.opt_state[0].trace),
          'masks': {p: np.asarray(m) for p, m in sp.masks.items()},
          'step': int(sp.step), 'last_update_step': int(sp.last_update_step),
          'is_snipped': bool(sp.is_snipped), 'ema_grads': None,
          'initial_weights': None,
          'block_packs': jax.tree.map(np.asarray, sp.block_packs)}


@pytest.mark.parametrize('routing', [
    None, {'c1/conv/kernel': 'matmul', 'c2/conv/kernel': 'matmul'}])
def test_port_trajectory_matches_jax(routing):
  """The same _TinyNet, state carried over with convert.py, 6 RigL steps
  through two mask updates under block execution (the tap route by
  default; with routing, the v4 matmul route): masks equal at every step
  (JAX's drop noise passed in through the port's seam), losses and params
  within 1e-4."""
  jsched = JSchedule(begin_step=0, end_step=100, frequency=2,
                     drop_fraction=0.5)
  jmodel = _JTinyNet(block=BLOCK)
  jst = JST(optax.sgd(0.05, momentum=0.9), jalgorithms.RigL(schedule=jsched),
            distribution='uniform', default_sparsity=0.5, block=BLOCK,
            seed=3, block_routing=routing)
  jstate = jsteps.init_train_state(jax.random.key(0), jmodel, jst,
                                   (4, 8, 8, 8), has_batch_stats=False)
  jfn = jax.jit(jsteps.make_train_step(jmodel, jst, has_batch_stats=False,
                                       block=BLOCK, block_conv3x3=True))

  class Replay(SparseTraining):
    def _drop_noise(self, step, layer_idx, path, mask, w):
      return torch.tensor(np.array(jst._drop_noise(
          jnp.int32(step), layer_idx, path, jnp.asarray(mask.numpy()),
          None)))

  model = TinyNet(block=BLOCK)
  st = Replay(_sgd(), algorithms.RigL(schedule=UpdateSchedule(**SCHED)),
              distribution='uniform', default_sparsity=0.5, block=BLOCK,
              seed=3, block_routing=routing)
  state = convert.train_state_from_jax(model, st, _jax_state_arrays(jstate))
  fn = steps.make_train_step(model, st, has_batch_stats=False, block=BLOCK,
                             block_conv3x3=True)
  for p, e in state.sparse.block_packs.items():
    assert isinstance(e, dict) == isinstance(jstate.sparse.block_packs[p],
                                             dict)
  updates = 0
  for batch in _batches(6):
    jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = fn(state, _tb(batch))
    assert m['mask_updated'] == bool(jm['mask_updated'])
    updates += int(m['mask_updated'])
    assert m['step'] == int(jm['step'])
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']),
                               rtol=1e-4)
    for p, mk in state.sparse.masks.items():
      np.testing.assert_array_equal(mk.numpy(),
                                    np.asarray(jstate.sparse.masks[p]), p)
  assert updates == 2
  jparams = convert._paths(jax.tree.map(np.asarray, jstate.params))
  for p, t in state.params.items():
    np.testing.assert_allclose(t.detach().numpy(), jparams[p], rtol=1e-4,
                               atol=1e-5, err_msg=p)
