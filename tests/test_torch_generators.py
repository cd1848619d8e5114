"""The port's mask generators, N:M structure, STR tables, sparse-aware
initializers and masked layers against the JAX package's, on the CPU.

Deterministic functions meet JAX's on the same numpy inputs: project_n_m,
propagate_masks and simple_mask bitwise; the STR sparsities exactly; the
masked layers' outputs within 1e-6 of the largest value (the same f32
products summed in another order).  Random generators and initializers
draw from torch generators where JAX draws from its keys, so they are
held to what they guarantee, against JAX's own draws where a count is
fixed: per-layer counts, per-neuron fan-ins, kept inputs, symmetry, the
N:M count of every group, zeros exactly at masked positions.  The scaled
initializers' variances are compared by replacing each package's sampler
with one that returns the standard deviation it was asked for: the
scales, computed from the masks' fans, must agree within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.layers import masked as jmasked
from rigl_tpu.models import init as jinit
from rigl_tpu.sparsity import distributions as jdist
from rigl_tpu.sparsity import generators as jgen
from rigl_tpu.sparsity import str_sparsities as jstr
from rigl_tpu.sparsity import structured as jstructured
from rigl_tpu_torch.layers import masked
from rigl_tpu_torch.models import init
from rigl_tpu_torch.sparsity import distributions
from rigl_tpu_torch.sparsity import generators
from rigl_tpu_torch.sparsity import str_sparsities
from rigl_tpu_torch.sparsity import structured
from torch_threads import one_thread  # noqa: F401


SHAPES = {'d1': (12, 8), 'd2': (8, 6), 'c1': (3, 3, 4, 8), 'tall': (64, 4)}
SPARSITIES = [0.0, 0.3, 0.5, 0.77, 0.9, 1.0]


def _gen(seed=0):
  return torch.Generator().manual_seed(seed)


def _np(d):
  return {p: np.asarray(m) for p, m in d.items()}


# ------------------------------------------------------------ structured --
@pytest.mark.parametrize('shape,n,m', [((8, 16, 32), 2, 4), ((8, 16, 32), 1, 4),
                                       ((8, 16, 32), 4, 8),
                                       ((3, 3, 8, 16), 2, 4),
                                       ((16, 8), 2, 4)])
def test_project_n_m_bitwise_equal_jax(shape, n, m):
  """Random scores, scores with ties (rounded to few values) and all-zero
  scores: the ranking breaks ties by position in both packages."""
  rs = np.random.RandomState(0)
  for scores in (rs.randn(*shape), np.round(rs.randn(*shape)),
                 np.zeros(shape)):
    scores = scores.astype(np.float32)
    want = np.asarray(jstructured.project_n_m(jnp.asarray(scores), n, m))
    got = structured.project_n_m(torch.as_tensor(scores), n, m).numpy()
    np.testing.assert_array_equal(got, want)
    g = got.reshape(-1, m, shape[-1])
    np.testing.assert_array_equal(g.sum(axis=1), n)


def test_project_n_m_errors_and_parse():
  for args in ((np.zeros((6, 8)), 2, 4), (np.zeros((8, 8)), 5, 4),
               (np.zeros((8, 8)), 0, 4)):
    with pytest.raises(ValueError) as want:
      jstructured.project_n_m(jnp.asarray(args[0]), *args[1:])
    with pytest.raises(ValueError) as got:
      structured.project_n_m(torch.as_tensor(args[0]), *args[1:])
    assert str(got.value) == str(want.value)
  for spec in ('nm_2_4', 'nm_1_8', 'shuffled', 'nm_2', 'per_neuron'):
    assert structured.parse_n_m(spec) == jstructured.parse_n_m(spec)


def test_n_m_generator_counts_and_implied_sparsity():
  shapes = {'a/kernel': (8, 16), 'c/kernel': (3, 3, 8, 16)}
  masks = generators.generate_mask('nm_2_4', _gen(), shapes, 0.5)
  jmasks = jgen.generate_mask('nm_2_4', jax.random.key(1), shapes, 0.5)
  assert list(masks) == list(jmasks)
  for p, shape in shapes.items():
    assert tuple(masks[p].shape) == shape
    g = masks[p].numpy().reshape(-1, 4, shape[-1])
    np.testing.assert_array_equal(g.sum(axis=1), 2)
  with pytest.raises(ValueError) as want:
    jgen.generate_mask('nm_2_4', jax.random.key(1), shapes, 0.8)
  with pytest.raises(ValueError) as got:
    generators.generate_mask('nm_2_4', _gen(), shapes, 0.8)
  assert str(got.value) == str(want.value)


# ------------------------------------------------------------ generators --
@pytest.mark.parametrize('sparsity', SPARSITIES)
def test_counting_generators_match_jax_counts(sparsity):
  """shuffled: the layer's count; symmetric: one shared column, JAX's
  count in it; per_neuron: JAX's count in every column, columns shuffled
  independently; no-input-ablation: every input keeps an edge, every
  column at least the per-neuron count."""
  key = jax.random.key(0)
  for name in ('shuffled', 'symmetric', 'per_neuron',
               'per_neuron_no_input_ablation'):
    want = _np(jgen.generate_mask(name, key, SHAPES, sparsity))
    got = _np(generators.generate_mask(name, _gen(), SHAPES, sparsity))
    assert list(got) == list(want)
    for p, shape in SHAPES.items():
      g, w = got[p], want[p]
      assert g.shape == shape and g.dtype == np.float32
      assert set(np.unique(g)) <= {0.0, 1.0}
      g2, w2 = g.reshape(-1, shape[-1]), w.reshape(-1, shape[-1])
      if name == 'shuffled':
        assert g.sum() == w.sum()
      elif name == 'symmetric':
        assert (g2 == g2[:, :1]).all()
        np.testing.assert_array_equal(g2.sum(0), w2.sum(0))
      elif name == 'per_neuron':
        np.testing.assert_array_equal(g2.sum(0), w2.sum(0))
        if 0 < g2.sum(0)[0] < g2.shape[0]:
          assert not (g2 == g2[:, :1]).all()
      else:
        assert (g2.sum(1) >= 1).all()
        base = w2.sum(0).min() if sparsity == 1.0 else 0
        assert (g2.sum(0) >= base).all()
        np.testing.assert_array_equal(g2.sum(1) >= 1, w2.sum(1) >= 1)


def test_bernoulli_simple_and_validation():
  big = {'big': (100, 100)}
  m = generators.bernoulli_mask(_gen(), big, 0.7)['big']
  assert float(m.mean()) == pytest.approx(0.3, abs=0.03)
  for fn in (np.ones, np.zeros, lambda s: np.arange(np.prod(s)).reshape(s)
             % 3):
    want = _np(jgen.simple_mask(SHAPES, fn))
    got = _np(generators.simple_mask(SHAPES, fn))
    for p in SHAPES:
      np.testing.assert_array_equal(got[p], want[p])
  with pytest.raises(ValueError) as want:
    jgen.shuffled_mask(jax.random.key(0), SHAPES, 1.5)
  with pytest.raises(ValueError) as got:
    generators.shuffled_mask(_gen(), SHAPES, 1.5)
  assert str(got.value) == str(want.value)
  with pytest.raises(ValueError) as want:
    jgen.generate_mask('nope', jax.random.key(0), SHAPES, 0.5)
  with pytest.raises(ValueError) as got:
    generators.generate_mask('nope', _gen(), SHAPES, 0.5)
  assert str(got.value) == str(want.value)
  assert set(generators.MASK_GENERATORS) == set(jgen.MASK_GENERATORS)


def test_propagate_masks_bitwise_equal_jax():
  rs = np.random.RandomState(1)
  m1 = np.ones((12, 8), np.float32)
  m1[:, 0] = 0
  c1 = np.ones((3, 3, 4, 8), np.float32)
  c1[..., 2] = 0
  chains = [
      {'d1': m1, 'd2': np.ones((8, 6), np.float32)},
      {'c1': c1, 'c2': np.ones((3, 3, 8, 6), np.float32)},
      {'c1': (rs.rand(3, 3, 4, 8) > 0.9).astype(np.float32),
       'c2': (rs.rand(3, 3, 8, 6) > 0.5).astype(np.float32),
       'c3': (rs.rand(1, 1, 6, 5) > 0.5).astype(np.float32)},
      {'d1': (rs.rand(12, 8) > 0.85).astype(np.float32),
       'd2': (rs.rand(8, 6) > 0.3).astype(np.float32),
       'd3': (rs.rand(6, 4) > 0.3).astype(np.float32)},
  ]
  for chain in chains:
    want = _np(jgen.propagate_masks({p: jnp.asarray(m)
                                     for p, m in chain.items()}))
    got = _np(generators.propagate_masks({p: torch.as_tensor(m)
                                          for p, m in chain.items()}))
    assert list(got) == list(want)
    for p in chain:
      assert got[p].dtype == want[p].dtype
      np.testing.assert_array_equal(got[p], want[p])
  bad = {'c1': np.ones((3, 3, 4, 8), np.float32),
         'd1': np.ones((8, 6), np.float32)}
  with pytest.raises(ValueError) as want:
    jgen.propagate_masks({p: jnp.asarray(m) for p, m in bad.items()})
  with pytest.raises(ValueError) as got:
    generators.propagate_masks({p: torch.as_tensor(m) for p, m in bad.items()})
  assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- STR --
def test_str_tables_and_sparsities_equal_jax():
  assert str_sparsities.overall_sparsities() == jstr.overall_sparsities()
  assert str_sparsities.read_all() == jstr.read_all()
  name_map = lambda k: 'x/' + k   # noqa: E731
  assert (str_sparsities.read_all(name_map=name_map)
          == jstr.read_all(name_map=name_map))
  layers = list(jstr.read_all()[str_sparsities.overall_sparsities()[0]])
  assert len(layers) == 54
  shapes = {name: (3, 3, 8, 8) for name in layers}
  for point in str_sparsities.overall_sparsities():
    assert (distributions.get_sparsities(shapes, 'str', point, {})
            == jdist.get_sparsities(shapes, 'str', point, {}))
  for shp, point in (({'conv1': (7, 7, 3, 64), 'not_a_layer': (3, 3, 8, 8)},
                      0.9023), ({'conv1': (7, 7, 3, 64)}, 0.1234)):
    with pytest.raises(ValueError) as want:
      jdist.get_sparsities(shp, 'str', point, {})
    with pytest.raises(ValueError) as got:
      distributions.get_sparsities(shp, 'str', point, {})
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- initializers --
def _mask(shape=(64, 32), sparsity=0.75, seed=0):
  rs = np.random.RandomState(seed)
  m = np.ones(int(np.prod(shape)), np.float32)
  m[:int(sparsity * m.size)] = 0
  rs.shuffle(m)
  return m.reshape(shape)


@pytest.fixture
def std_samplers(monkeypatch):
  """Both packages' samplers replaced by the standard deviation asked for,
  broadcast to the shape."""
  monkeypatch.setattr(jinit, '_sample', lambda key, shape, scale, dist,
                      dtype: jnp.broadcast_to(jnp.sqrt(scale),
                                              shape).astype(dtype))
  monkeypatch.setattr(init, '_sample', lambda gen, shape, scale, dist,
                      dtype: torch.broadcast_to(torch.sqrt(
                          torch.as_tensor(scale, dtype=torch.float32)),
                          tuple(shape)).to(dtype))


MASKS = [_mask(), _mask((64, 2), 0.5, 1), _mask((3, 3, 8, 16), 0.9, 2),
         np.zeros((8, 4), np.float32)]
MASKS[1][:60, 0] = 0


@pytest.mark.parametrize('method', ['fanin_normal', 'fanout_uniform',
                                    'fanavg_uniform'])
def test_scaled_initializers_give_jax_scales(std_samplers, method):
  for m in MASKS:
    jm, tm = jnp.asarray(m), torch.as_tensor(m)
    key, gen = jax.random.key(0), _gen()
    pairs = [
        (jinit.unit_scaled_init(key, jm, method, 1.5),
         init.unit_scaled_init(gen, tm, method, 1.5)),
        (jinit.layer_scaled_init(key, jm, method, 1.5),
         init.layer_scaled_init(gen, tm, method, 1.5)),
    ]
    for mode in ('fan_in', 'fan_out', 'fan_avg'):
      pairs.append((jinit.sparse_init(key, jm, 2.0, mode),
                    init.sparse_init(gen, tm, 2.0, mode)))
    pairs += [(jinit.xavier_sparse_normal(key, jm),
               init.xavier_sparse_normal(gen, tm)),
              (jinit.kaiming_sparse_normal(key, jm),
               init.kaiming_sparse_normal(gen, tm))]
    for want, got in pairs:
      np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                 atol=0)
  for sparsity in (0.0, 0.9):
    for mode in ('fan_in', 'fan_out', 'fan_avg'):
      want = jinit.sparse_variance_scaling(sparsity, 2.0, mode)(
          jax.random.key(0), (3, 3, 8, 16))
      got = init.sparse_variance_scaling(sparsity, 2.0, mode)(
          _gen(), (3, 3, 8, 16))
      np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_initializers_zero_at_masked_positions_and_counts():
  for m in MASKS:
    tm = torch.as_tensor(m)
    for w in (init.unit_scaled_init(_gen(), tm, 'fanin_uniform'),
              init.unit_scaled_init(_gen(), tm, 'fanavg_normal'),
              init.sparse_init(_gen(), tm),
              init.xavier_sparse_normal(_gen(), tm),
              init.kaiming_sparse_normal(_gen(), tm)):
      assert (w.numpy()[m == 0] == 0).all()
      assert bool(torch.isfinite(w).all())
  w = init.random_sparse_init(0.6)(_gen(), (50, 40))
  assert int((w == 0).sum()) == int(np.floor(0.6 * 2000))
  # The distributions: a column with 4 surviving inputs against one with
  # 400 (std ratio sqrt(100)); truncation keeps |w| within 2 corrected
  # sigmas; layer scaling by 1 / sqrt(density).
  m = np.ones((400, 2), np.float32)
  m[:396, 0] = 0
  w = init.unit_scaled_init(_gen(1), torch.as_tensor(m), 'fanin_normal')
  w = w.numpy()
  assert w[m[:, 0] == 1, 0].std() / w[:, 1].std() == pytest.approx(
      10.0, rel=0.5)
  w = init.sparse_variance_scaling(0.0)(_gen(), (256, 256))
  assert float(w.abs().max()) <= 2 * np.sqrt(2 / 256) / 0.87962566 + 1e-6
  assert float(w.std()) == pytest.approx(np.sqrt(2 / 256), rel=0.05)
  sparse = init.layer_scaled_init(_gen(), torch.as_tensor(_mask()))
  dense = init.layer_scaled_init(_gen(), torch.ones(64, 32))
  assert float(sparse.std() / dense.std()) == pytest.approx(2.0, rel=0.05)
  masks = {'a': torch.as_tensor(_mask()), 'b': torch.as_tensor(MASKS[1])}
  out = init.reinit_masked_params(_gen(), None, masks, 'sparse')
  assert list(out) == ['a', 'b']
  with pytest.raises(ValueError, match='Unknown sparse re-init'):
    init.reinit_masked_params(_gen(), None, masks, 'nope')


# ---------------------------------------------------------- masked layers --
def test_masked_layers_and_mask_dicts_match_jax():
  import flax.linen as fnn
  rs = np.random.RandomState(3)

  class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
      x = jmasked.MaskedConv(6, (3, 3), strides=2, name='c1')(x)
      x = jmasked.MaskedConv(6, (3, 3), padding='VALID',
                             feature_group_count=6, use_bias=False,
                             name='dw')(x)
      x = x.reshape(x.shape[0], -1)
      return jmasked.MaskedDense(5, name='d1')(x)

  class Net(torch.nn.Module):
    def __init__(self):
      super().__init__()
      self.c1 = masked.MaskedConv(3, 6, (3, 3), strides=2, device='cpu')
      self.dw = masked.MaskedConv(6, 6, (3, 3), padding='VALID',
                                  feature_group_count=6, use_bias=False,
                                  device='cpu')
      self.d1 = masked.MaskedDense(2 * 2 * 6, 5, device='cpu')

    def forward(self, x):
      x = self.dw(self.c1(x))
      return self.d1(x.reshape(x.shape[0], -1))

  x = rs.randn(2, 8, 8, 3).astype(np.float32)
  variables = jax.tree.map(np.asarray, JNet().init(jax.random.key(0), x))
  variables['params'] = jax.tree.map(
      lambda a: rs.randn(*a.shape).astype(np.float32), variables['params'])
  variables['masks'] = jax.tree.map(
      lambda a: (rs.rand(*a.shape) > 0.5).astype(np.float32),
      variables['masks'])
  net = Net()
  from rigl_tpu_torch import convert
  convert.load_jax_variables(net, variables)
  want = np.asarray(JNet().apply(variables, x))
  with torch.no_grad():
    got = net(torch.as_tensor(x)).numpy()
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=1e-6 * np.abs(want).max())
  jd = jmasked.masks_to_dict(variables)
  td = masked.masks_to_dict(net)
  assert list(td) == sorted(jd) == ['c1/kernel', 'd1/kernel', 'dw/kernel']
  for p in jd:
    np.testing.assert_array_equal(td[p].numpy(), np.asarray(jd[p]))
  masked.dict_to_masks(net, {'d1/kernel': torch.zeros(24, 5)})
  assert float(masked.masks_to_dict(net)['d1/kernel'].sum()) == 0.0
  with torch.no_grad():
    y = net(torch.as_tensor(x))
  np.testing.assert_array_equal(y.numpy(), np.broadcast_to(
      net.d1.bias.detach().numpy(), y.shape))


# --------------------------------------------- structured masks in training --
def test_n_m_masks_through_sparse_training_static():
  """N:M masks flow through SparseTraining's init as in JAX: every layer
  at 1 - n/m under the uniform distribution, every group exactly n."""
  from rigl_tpu.transforms import algorithms as jalgorithms
  from rigl_tpu.transforms.sparse_training import SparseTraining as JST
  from rigl_tpu_torch.transforms import algorithms
  from rigl_tpu_torch.transforms.sparse_training import SparseTraining
  shapes = {'d0/kernel': (8, 16), 'd1/kernel': (16, 4)}
  params = {p: torch.zeros(s) for p, s in shapes.items()}
  st = SparseTraining(lambda ps: torch.optim.SGD(ps, lr=0.1),
                      algorithms.Static(), default_sparsity=0.5,
                      distribution='uniform', mask_generator='nm_2_4')
  _, sstate = st.init(1, params)
  jst = JST(optax.sgd(0.1), jalgorithms.Static(), default_sparsity=0.5,
            distribution='uniform', mask_generator='nm_2_4')
  _, jstate = jst.init(jax.random.key(1), {
      p.split('/')[0]: {'kernel': jnp.zeros(s)} for p, s in shapes.items()})
  assert st.sparsities == jst.sparsities
  assert st.static_block_counts() == jst.static_block_counts() == {}
  for p, m in sstate.masks.items():
    g = m.numpy().reshape(-1, 4, m.shape[-1])
    np.testing.assert_array_equal(g.sum(axis=1), 2)
    assert m.sum() == float(np.asarray(jstate.masks[p]).sum())
