"""Per-layer sparsity specs for packed models: SparsityMap + resolution.

Counterpart of rigl_tpu/sparsity/layer_sparsity.py.  Every packed layer
takes a `sparsity` that is a plain float (uniform) or a SparsityMap keyed
by '/'-joined kernel paths ('block0/attn/qkv/kernel').  A layer resolves
its value by its own path: exact match first, then a UNIQUE suffix match
('attn/qkv/kernel' matches 'block3/attn/qkv/kernel'); an ambiguous or
missing path raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from rigl_tpu_torch.sparsity import distributions


class SparsityMap:
  """Frozen, hashable {layer_path: sparsity} table."""

  __slots__ = ('_items', '_lookup')

  def __init__(self, mapping: Mapping[str, float]):
    items = []
    for k, v in mapping.items():
      v = float(v)
      if not 0.0 <= v <= 1.0:
        raise ValueError(f'sparsity for {k!r} must be in [0, 1], got {v}')
      items.append((str(k), v))
    self._items = tuple(sorted(items))
    self._lookup = dict(self._items)

  def items(self):
    return self._items

  def as_dict(self) -> Dict[str, float]:
    return dict(self._items)

  def __hash__(self):
    return hash(self._items)

  def __eq__(self, other):
    return isinstance(other, SparsityMap) and self._items == other._items

  def __repr__(self):
    return f'SparsityMap({dict(self._items)!r})'

  def lookup(self, path: str) -> float:
    """Exact match, else unique suffix match, else KeyError."""
    if path in self._lookup:
      return self._lookup[path]
    hits = [k for k, _ in self._items if path.endswith('/' + k)]
    if len(hits) == 1:
      return self._lookup[hits[0]]
    if len(hits) > 1:
      raise KeyError(f'sparsity map is ambiguous for {path!r}: '
                     f'suffix-matches {hits}')
    raise KeyError(f'no sparsity entry for layer {path!r}; map keys: '
                   f'{[k for k, _ in self._items]}')


SparsitySpec = Union[float, int, SparsityMap, Mapping[str, float]]


def resolve_sparsity(spec: SparsitySpec,
                     path: Union[str, Sequence[str]]) -> float:
  """Resolve a layer's sparsity from a float-or-map spec.

  `path`: the layer's module path as a tuple of names, to which
  'kernel' is appended, or an already '/'-joined kernel path string.
  """
  if isinstance(spec, (float, int)):
    return float(spec)
  if not isinstance(path, str):
    path = '/'.join(tuple(path) + ('kernel',))
  if isinstance(spec, SparsityMap):
    return spec.lookup(path)
  return SparsityMap(spec).lookup(path)


def make_sparsity_map(
    shapes: Mapping[str, Tuple[int, ...]],
    method: str,
    default_sparsity: float,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
    erk_power_scale: float = distributions.DEFAULT_ERK_SCALE,
) -> SparsityMap:
  """Solve a per-layer distribution over a packed model's dense kernel
  shapes ({path: shape}, e.g. models.transformer_layer_shapes)."""
  return SparsityMap(distributions.get_sparsities(
      dict(shapes), method, default_sparsity,
      custom_sparsity_map=custom_sparsity_map,
      erk_power_scale=erk_power_scale))


def spec_for_model(
    shapes: Mapping[str, Tuple[int, ...]],
    method: str,
    default_sparsity: float,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
    erk_power_scale: float = distributions.DEFAULT_ERK_SCALE,
) -> SparsitySpec:
  """Like make_sparsity_map, but the plain float for uniform methods."""
  if method in ('uniform', 'random') and not custom_sparsity_map:
    return float(default_sparsity)
  return make_sparsity_map(shapes, method, default_sparsity,
                           custom_sparsity_map, erk_power_scale)

