"""Per-layer sparsity distributions: uniform, Erdos-Renyi(-Kernel) and the
published STR tables.

Counterpart of rigl_tpu/sparsity/distributions.py, which is numpy-only:
the maths runs once on the host at setup time, so the port keeps it in
numpy and the results are identical.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

DEFAULT_ERK_SCALE = 1.0

ShapeDict = Mapping[str, Tuple[int, ...]]


def get_n_zeros(size: int, sparsity: float) -> int:
  """Number of zeros for a layer of `size` params at `sparsity` (floor,
  so mask population counts are exact integers)."""
  return int(np.floor(sparsity * size))


def get_n_ones(size: int, sparsity: float) -> int:
  return size - get_n_zeros(size, sparsity)


def _validate_sparsity(sparsity: float, what: str = 'sparsity'):
  if not 0.0 <= sparsity <= 1.0:
    raise ValueError(f'{what} must be in [0, 1], got {sparsity}')


def _validate_custom_map(shapes: ShapeDict,
                         custom_sparsity_map: Mapping[str, float]):
  missing = set(custom_sparsity_map) - set(shapes)
  if missing:
    raise ValueError(
        'No masks are found for the following names: %s' % sorted(missing))
  for name, s in custom_sparsity_map.items():
    _validate_sparsity(s, f'custom sparsity for {name!r}')


def sparsities_uniform(
    shapes: ShapeDict,
    default_sparsity: float,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
) -> Dict[str, float]:
  """Every layer gets `default_sparsity` unless overridden."""
  _validate_sparsity(default_sparsity, 'default_sparsity')
  custom_sparsity_map = custom_sparsity_map or {}
  _validate_custom_map(shapes, custom_sparsity_map)
  return {
      name: custom_sparsity_map.get(name, default_sparsity) for name in shapes
  }


def sparsities_erdos_renyi(
    shapes: ShapeDict,
    default_sparsity: float,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
    include_kernel: bool = True,
    erk_power_scale: float = DEFAULT_ERK_SCALE,
) -> Dict[str, float]:
  """Erdos-Renyi(-Kernel) per-layer sparsities preserving the global budget.

  Solves for `eps` with eps * sum_i p_i * N_i (+ dense layers' N) equal to
  the uniform-sparsity survivor count; a layer whose scaled density would
  exceed 1 is made dense and the solve repeats without it.  ERK takes
  p = (sum(shape) / prod(shape)) ** erk_power_scale, ER takes
  (n_in + n_out) / (n_in * n_out) over the last two dims.  Layers in
  `custom_sparsity_map` keep their value and take no part in the solve.
  """
  _validate_sparsity(default_sparsity, 'default_sparsity')
  custom_sparsity_map = custom_sparsity_map or {}
  _validate_custom_map(shapes, custom_sparsity_map)

  dense_layers: set = set()
  while True:
    divisor = 0.0
    rhs = 0.0
    raw_probabilities: Dict[str, float] = {}
    for name, shape in shapes.items():
      n_param = int(np.prod(shape))
      n_zeros = get_n_zeros(n_param, default_sparsity)
      if name in dense_layers:
        rhs -= n_zeros
      elif name in custom_sparsity_map:
        continue
      else:
        rhs += n_param - n_zeros
        if include_kernel:
          prob = (np.sum(shape) / np.prod(shape)) ** erk_power_scale
        else:
          if len(shape) < 2:
            raise ValueError(
                f'ER (include_kernel=False) needs >=2D kernels; {name} has '
                f'shape {shape}')
          n_in, n_out = shape[-2], shape[-1]
          prob = (n_in + n_out) / (n_in * n_out)
        raw_probabilities[name] = prob
        divisor += prob * n_param
    if not raw_probabilities:
      break
    eps = rhs / divisor
    max_prob = max(raw_probabilities.values())
    if max_prob * eps > 1.0:
      for name, prob in raw_probabilities.items():
        if prob == max_prob:
          dense_layers.add(name)
    else:
      break

  sparsities: Dict[str, float] = {}
  for name, shape in shapes.items():
    if name in custom_sparsity_map:
      sparsities[name] = float(custom_sparsity_map[name])
    elif name in dense_layers:
      sparsities[name] = 0.0
    else:
      sparsities[name] = 1.0 - eps * raw_probabilities[name]
  return sparsities


def sparsities_str(shapes: ShapeDict,
                   default_sparsity: float) -> Dict[str, float]:
  """The published STR per-layer ResNet-50 sparsities (str_sparsities.py)
  at the operating point `default_sparsity`, keyed by the table's layer
  names, which `shapes` must use."""
  from rigl_tpu_torch.sparsity import str_sparsities
  tables = str_sparsities.read_all()
  if default_sparsity not in tables:
    raise ValueError('sparsity: %f is not defined' % default_sparsity)
  table = tables[default_sparsity]
  try:
    return {name: table[name] for name in shapes}
  except KeyError as e:
    raise ValueError(f'Layer {e} not present in STR table') from e


def get_sparsities(
    shapes: ShapeDict,
    method: str,
    default_sparsity: float,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
    erk_power_scale: float = DEFAULT_ERK_SCALE,
) -> Dict[str, float]:
  """method: 'random' / 'uniform', 'erdos_renyi', 'erdos_renyi_kernel'
  or 'str'."""
  custom_sparsity_map = custom_sparsity_map or {}
  if method in ('erdos_renyi', 'erdos_renyi_kernel'):
    return sparsities_erdos_renyi(
        shapes,
        default_sparsity,
        custom_sparsity_map,
        include_kernel=(method == 'erdos_renyi_kernel'),
        erk_power_scale=erk_power_scale)
  elif method in ('random', 'uniform'):
    return sparsities_uniform(shapes, default_sparsity, custom_sparsity_map)
  elif method == 'str':
    return sparsities_str(shapes, default_sparsity)
  raise ValueError(
      'Method: %s is not a valid mask initialization method' % method)

