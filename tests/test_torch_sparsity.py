"""Port parity: rigl_tpu_torch.sparsity against rigl_tpu.sparsity.

Floor counts, the uniform / ER / ERK solvers and SparsityMap resolution
must give exactly the JAX package's values (both are host-side numpy
maths, so equality is exact)."""

import pytest

from rigl_tpu.sparsity import distributions as jd
from rigl_tpu.sparsity import layer_sparsity as jl
from rigl_tpu_torch.models.packed_transformer import transformer_layer_shapes
from rigl_tpu_torch.sparsity import distributions as td
from rigl_tpu_torch.sparsity import layer_sparsity as tl

SHAPE_SETS = {
    'transformer_2048': transformer_layer_shapes(2048, 8192),
    'transformer_32': transformer_layer_shapes(32, 64),
    'conv_mlp': {'conv1/kernel': (3, 3, 3, 64), 'conv2/kernel': (3, 3, 64, 128),
                 'fc1/kernel': (4096, 512), 'fc2/kernel': (512, 10)},
}


@pytest.mark.parametrize('size', [1, 7, 48, 64, 1000, 4096 * 4096])
@pytest.mark.parametrize('sparsity', [0.0, 0.5, 0.8, 0.9, 0.95, 1.0, 1 / 3])
def test_floor_counts_match(size, sparsity):
  assert td.get_n_zeros(size, sparsity) == jd.get_n_zeros(size, sparsity)
  assert td.get_n_ones(size, sparsity) == jd.get_n_ones(size, sparsity)


@pytest.mark.parametrize('shapes', sorted(SHAPE_SETS))
@pytest.mark.parametrize('method', ['uniform', 'random', 'erdos_renyi',
                                    'erdos_renyi_kernel'])
@pytest.mark.parametrize('sparsity', [0.5, 0.8, 0.95])
def test_get_sparsities_match(shapes, method, sparsity):
  shapes = SHAPE_SETS[shapes]
  got = td.get_sparsities(shapes, method, sparsity)
  want = jd.get_sparsities(shapes, method, sparsity)
  assert got == want


@pytest.mark.parametrize('method', ['uniform', 'erdos_renyi_kernel'])
def test_custom_map_and_erk_scale_match(method):
  shapes = SHAPE_SETS['conv_mlp']
  custom = {'fc2/kernel': 0.0}
  kw = dict(custom_sparsity_map=custom, erk_power_scale=0.5)
  assert (td.get_sparsities(shapes, method, 0.9, **kw)
          == jd.get_sparsities(shapes, method, 0.9, **kw))
  assert (tl.make_sparsity_map(shapes, method, 0.9, **kw).as_dict()
          == jl.make_sparsity_map(shapes, method, 0.9, **kw).as_dict())


def test_bad_inputs_raise_like_jax():
  shapes = SHAPE_SETS['conv_mlp']
  for mod in (td, jd):
    with pytest.raises(ValueError, match='No masks'):
      mod.get_sparsities(shapes, 'uniform', 0.5, {'nope/kernel': 0.1})
    with pytest.raises(ValueError, match='not a valid'):
      mod.get_sparsities(shapes, 'bogus', 0.5)
    with pytest.raises(ValueError, match='default_sparsity'):
      mod.get_sparsities(shapes, 'uniform', 1.5)
    # STR: 0.8 is not one of the table's operating points.
    with pytest.raises(ValueError, match='is not defined'):
      mod.get_sparsities(shapes, 'str', 0.8)


@pytest.mark.parametrize('path', [
    'block0/attn/qkv/kernel', 'block3/fc2/kernel', ('block1', 'attn', 'out'),
    ('fc1',), 'attn/out/kernel'])
def test_resolve_sparsity_suffix_lookup_matches(path):
  shapes = transformer_layer_shapes(32, 64)
  spec_t = tl.spec_for_model(shapes, 'erdos_renyi_kernel', 0.8)
  spec_j = jl.spec_for_model(shapes, 'erdos_renyi_kernel', 0.8)
  assert spec_t.as_dict() == spec_j.as_dict()
  assert tl.resolve_sparsity(spec_t, path) == jl.resolve_sparsity(spec_j,
                                                                  path)
  assert tl.resolve_sparsity(0.7, path) == jl.resolve_sparsity(0.7, path)
  assert (tl.spec_for_model(shapes, 'uniform', 0.8)
          == jl.spec_for_model(shapes, 'uniform', 0.8) == 0.8)


def test_resolve_sparsity_errors_match():
  table = {'attn/qkv/kernel': 0.5, 'block0/attn/qkv/kernel': 0.6,
           'qkv/kernel': 0.7}
  # Exact wins; a unique suffix resolves; two suffix hits are ambiguous.
  for mod in (tl, jl):
    assert mod.resolve_sparsity(table, 'block0/attn/qkv/kernel') == 0.6
    with pytest.raises(KeyError, match='ambiguous'):
      mod.resolve_sparsity(table, 'block1/attn/qkv/kernel')
    with pytest.raises(KeyError, match='no sparsity entry'):
      mod.resolve_sparsity(table, 'block1/fc1/kernel')
    with pytest.raises(ValueError, match=r'\[0, 1\]'):
      mod.SparsityMap({'a': 1.5})
  assert hash(tl.SparsityMap(table)) == hash(tl.SparsityMap(dict(table)))
  assert tl.SparsityMap(table) == tl.SparsityMap(dict(table))
