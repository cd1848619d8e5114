"""Port parity: the packed conv layers (rigl_tpu_torch/layers/packed_conv.py)
and every conv-net family (rigl_tpu_torch/models/packed_convnet.py) against
the JAX package's, on JAX's variables carried over by convert.py.

Layers: outputs and gradients of the packed kernel (packed, in JAX's slot
order) for PackedConv with both engines at strides 1 and 2 (stride 2 on
an even input pins XLA's SAME padding, (0, 1), which torch's padding=1
does not give), PackedConv1x1 and DenseConvTwin.  Families: logits at a
small size, within 1e-5 of the largest logit (f32; the convs and GroupNorm
sum in another order).  JAX's tap kernels run in interpret mode on the
CPU, as its own tests run them; the port runs its plain versions."""

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.layers import packed_conv as jpc
from rigl_tpu.models import packed_convnet as jm
from rigl_tpu_torch import convert
from rigl_tpu_torch.layers import packed_conv as tpc
from rigl_tpu_torch.models import packed_convnet as tm
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5


def _close(got, want, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  err = np.abs(got - want).max(initial=0.0)
  scale = np.abs(want).max(initial=0.0)
  assert scale > 0, f'{what}: all zeros, the comparison would be vacuous'
  assert err <= RTOL * scale, (what, err, scale)


def _layer_pair(kind, strides, engine):
  """(flax layer, port layer) of one kind, on a 16-channel input."""
  kw = dict(strides=strides)
  if kind == 'conv':
    return (jpc.PackedConv(32, (3, 3), sparsity=0.5, engine=engine, **kw),
            tpc.PackedConv(16, 32, (3, 3), sparsity=0.5, engine=engine,
                           device='cpu', **kw))
  if kind == 'conv1x1':
    return (jpc.PackedConv1x1(32, sparsity=0.5, block=(16, 16), bm=64, **kw),
            tpc.PackedConv1x1(16, 32, sparsity=0.5, block=(16, 16), bm=64,
                              device='cpu', **kw))
  return (jpc.DenseConvTwin(32, (3, 3), **kw),
          tpc.DenseConvTwin(16, 32, (3, 3), device='cpu', **kw))


@pytest.mark.parametrize('kind,strides,engine', [
    ('conv', (1, 1), 'tap'), ('conv', (2, 2), 'tap'),
    ('conv', (1, 1), 'xla'), ('conv', (2, 2), 'xla'),
    ('conv1x1', (1, 1), None), ('conv1x1', (2, 2), None),
    ('twin', (1, 1), None), ('twin', (2, 2), None)])
def test_layer_matches_jax(kind, strides, engine):
  """y and d(sum(y * r))/d kernel on a (2, 8, 8, 16) input."""
  rs = np.random.RandomState(sum(strides) + len(kind))
  x = rs.randn(2, 8, 8, 16).astype(np.float32)
  jlayer, tlayer = _layer_pair(kind, strides, engine)
  v = jlayer.init(jax.random.key(1), jnp.asarray(x))
  if kind == 'twin':
    v = {'params': {'d': {'kernel': jnp.asarray(
        rs.randn(9 * 16, 32).astype(np.float32) / 12)}}}
  y_j = np.asarray(jlayer.apply(v, jnp.asarray(x)))
  r = rs.randn(*y_j.shape).astype(np.float32)
  grads = jax.grad(lambda p: jnp.sum(jlayer.apply(
      dict(v, params=p), jnp.asarray(x)) * r))(v['params'])

  state, packs = convert.from_jax_variables(jax.tree.map(np.asarray, v))
  if packs:
    tlayer.set_packing(packs['kernel'])
  tlayer.load_state_dict({k: torch.tensor(a) for k, a in state.items()})
  if kind == 'conv':
    assert tlayer.uses_tap == (engine == 'tap' and strides == (1, 1))
  y = tlayer(torch.tensor(x))
  _close(y.detach(), y_j, 'y')
  (g,) = torch.autograd.grad((y * torch.tensor(r)).sum(),
                             [p for _, p in tlayer.named_parameters()])
  want = traverse.flatten_dict(grads)
  (key,) = want
  _close(g, want[key], 'kernel gradient')


def test_same_padding_is_xlas():
  """conv2d_same pads like lax SAME: (0, 1) for a 3x3 stride-2 conv on an
  even input, (2, 3) for a 7x7 stride-2 one, and max_pool pads with -inf."""
  assert tpc.same_pads(8, 3, 2) == (0, 1)
  assert tpc.same_pads(7, 3, 2) == (1, 1)
  assert tpc.same_pads(32, 7, 2) == (2, 3)
  assert tpc.same_pads(8, 3, 1) == (1, 1)
  rs = np.random.RandomState(0)
  x = rs.randn(2, 8, 6, 3).astype(np.float32)
  w = rs.randn(7, 7, 3, 4).astype(np.float32)
  want = jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(w), (2, 2), 'SAME',
      dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
  _close(tpc.conv2d_same(torch.tensor(x), torch.tensor(w), (2, 2)), want,
         'conv 7x7/2')
  import flax.linen as fnn
  xm = -np.abs(x)   # all negative: a zero pad would win the max
  _close(tm._max_pool_same(torch.tensor(xm)),
         fnn.max_pool(jnp.asarray(xm), (3, 3), (2, 2), 'SAME'), 'max pool')


FAMILIES = {
    'convnet': (lambda **k: jm.PackedConvNet(
        stem_width=16, stages=((32, 2), (32, 1)), sparsity=0.5, **k),
                lambda **k: tm.PackedConvNet(
        stem_width=16, stages=((32, 2), (32, 1)), sparsity=0.5, **k),
                (2, 8, 8, 3)),
    'convnet_twin': (lambda **k: jm.DenseConvNet(
        stem_width=16, stages=((32, 2), (32, 1)), **k),
                     lambda **k: tm.DenseConvNet(
        stem_width=16, stages=((32, 2), (32, 1)), **k), (2, 8, 8, 3)),
    'mbv1': (lambda **k: jm.PackedMobileNetV1(width_mult=0.25, sparsity=0.25,
                                              **k),
             lambda **k: tm.PackedMobileNetV1(width_mult=0.25, sparsity=0.25,
                                              **k), (2, 32, 32, 3)),
    'wrn_xla': (lambda **k: jm.PackedWideResNet(depth=10, width=1,
                                                sparsity=0.5, **k),
                lambda **k: tm.PackedWideResNet(depth=10, width=1,
                                                sparsity=0.5, **k),
                (2, 8, 8, 3)),
    'wrn_tap': (lambda **k: jm.PackedWideResNet(depth=10, width=1,
                                                sparsity=0.5, engine='tap',
                                                **k),
                lambda **k: tm.PackedWideResNet(depth=10, width=1,
                                                sparsity=0.5, engine='tap',
                                                **k), (2, 8, 8, 3)),
    'wrn_twin': (lambda **k: jm.DenseWideResNetTwin(depth=10, width=1, **k),
                 lambda **k: tm.DenseWideResNetTwin(depth=10, width=1, **k),
                 (2, 8, 8, 3)),
    'bottleneck_group': (lambda **k: jm.PackedBottleneckGroup(
        features=16, blocks=2, strides=(2, 2), sparsity=0.5, engine='tap',
        **k), lambda **k: tm.PackedBottleneckGroup(
            features=16, blocks=2, strides=(2, 2), sparsity=0.5, engine='tap',
            **k), (2, 8, 8, 3)),
    'resnet50': (lambda **k: jm.PackedResNet(depth=50, width_mult=0.25,
                                             sparsity=0.5, engine='tap', **k),
                 lambda **k: tm.PackedResNet(depth=50, width_mult=0.25,
                                             sparsity=0.5, engine='tap', **k),
                 (2, 32, 32, 3)),
}


@pytest.mark.parametrize('family', list(FAMILIES))
def test_family_logits_match_jax(family):
  make_j, make_t, shape = FAMILIES[family]
  x = np.random.RandomState(len(family)).randn(*shape).astype(np.float32)
  jmodel = make_j(num_classes=10)
  v = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(x))
  want = np.asarray(jax.jit(jmodel.apply)(v, jnp.asarray(x)))
  tmodel = make_t(num_classes=10, device='cpu')
  state, packs = convert.from_jax_variables(jax.tree.map(np.asarray, v))
  assert set(state) == set(dict(tmodel.named_parameters()))
  convert.load_converted(tmodel, state, packs)
  assert set(packs) == set(tm.packed_layers(tmodel))
  with torch.no_grad():
    got = tmodel(torch.tensor(x))
  _close(got, want, family)


@pytest.mark.parametrize('width', [0.25, 0.5, 1.0, 1.4])
def test_layer_shape_helpers_equal_jax(width):
  assert tm.mbv1_config(width) == jm.mbv1_config(width)
  assert tm.make_divisible(width * 37) == jm.make_divisible(width * 37)
  for block in ((16, 16), (32, 64), (128, 128)):
    assert tm.mbv1_layer_shapes(width, block) == jm.mbv1_layer_shapes(
        width, block)
    for depth in (50, 101):
      assert tm.resnet_layer_shapes(depth, width, block) == (
          jm.resnet_layer_shapes(depth, width, block))
  assert tm.wrn_layer_shapes(22, 2) == jm.wrn_layer_shapes(22, 2)
  assert tm.wrn_layer_shapes(10, 1) == jm.wrn_layer_shapes(10, 1)
  stages = ((64, 2), (128, 2), (128, 1))
  assert tm.convnet_layer_shapes(32, stages) == jm.convnet_layer_shapes(
      32, stages)
  with pytest.raises(ValueError):
    tm.wrn_layer_shapes(21, 2)


def test_module_paths_are_flax_paths():
  """Every packed kernel's name is its flax path joined with dots, and the
  models default to the card."""
  model = tm.PackedWideResNet(depth=22, width=2, device='meta')
  want = {p.replace('/', '.') for p in jm.wrn_layer_shapes(22, 2)}
  assert set(tm.packed_layers(model)) == want
  assert sum(layer.uses_tap for layer in tm.packed_layers(model).values()) == 0
  tap = tm.PackedWideResNet(depth=22, width=2, engine='tap', device='meta')
  strided = [n for n, layer in tm.packed_layers(tap).items()
             if not layer.uses_tap]
  assert strided == ['g1_b0.conv1.kernel', 'g2_b0.conv1.kernel']
  import inspect
  for family in (tm.PackedConvNet, tm.PackedMobileNetV1, tm.PackedWideResNet,
                 tm.PackedBottleneckGroup, tm.PackedResNet, tpc.PackedConv):
    assert inspect.signature(family).parameters['device'].default == 'cuda'
