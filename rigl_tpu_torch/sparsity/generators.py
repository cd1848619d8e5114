"""Structured mask generators and mask propagation, in PyTorch.

Counterpart of rigl_tpu/sparsity/generators.py, over the flat
``{path: mask}`` dicts of sparsity/masks.py:

  shuffled      -- exact-count random mask per layer
  bernoulli     -- iid Bernoulli(1 - sparsity) mask
  simple        -- mask from a numpy-style init fn (np.ones, np.zeros)
  symmetric     -- one shared input mask repeated for every output neuron
  per_neuron    -- every output neuron keeps the same number of inputs,
                   each neuron shuffled independently
  per_neuron_no_input_ablation -- per_neuron unioned with a wrapped
                   diagonal, so every input unit keeps an outgoing edge

plus `generate_mask` (the registry, 'nm_<n>_<m>' dispatching to
structured.py) and `propagate_masks` (a neuron with no surviving incoming
weight ablates its outgoing weights in the next layer; convs
channel-wise).

Random draws come from a torch.Generator, layer after layer in the dict's
order; SparseTraining.init seeds one per layer from (key, layer index), as
JAX folds the layer index into its key.  JAX's keys give other draws, so
the two packages agree on what each generator guarantees (counts,
fan-ins, structure), not on the positions.  The count of a fixed-count
vector is JAX's: zeros where index < sparsity * n, compared in float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

MaskDict = Dict[str, torch.Tensor]
ShapeDict = Mapping[str, Tuple[int, ...]]


def _check_sparsity(sparsity: float):
  if not 0.0 <= sparsity <= 1.0:
    raise ValueError(
        'Given sparsity, {}, is not in range [0, 1]'.format(sparsity))


def _gdev(generator: Optional[torch.Generator]):
  return generator.device if generator is not None else None


def _fixed_count_vector(n: int, sparsity: float, dtype=torch.float32,
                        device=None) -> torch.Tensor:
  """[0] * ceil(s * n) then ones: the reference's arange >= s * n, in
  float32 as JAX compares it."""
  idx = torch.arange(n, device=device).to(torch.float32)
  keep = idx >= torch.tensor(sparsity * n, dtype=torch.float32)
  return keep.to(dtype)


def shuffled_mask(generator, shapes: ShapeDict, sparsity: float,
                  dtype=torch.float32, device=None) -> MaskDict:
  """Exact-count random mask for every layer."""
  _check_sparsity(sparsity)
  out: MaskDict = {}
  for path, shape in shapes.items():
    n = int(np.prod(shape))
    vec = _fixed_count_vector(n, sparsity, dtype)
    perm = torch.randperm(n, generator=generator,
                          device=_gdev(generator)).cpu()
    out[path] = vec[perm].reshape(tuple(shape)).to(device)
  return out


def bernoulli_mask(generator, shapes: ShapeDict, mean_sparsity: float,
                   dtype=torch.float32, device=None) -> MaskDict:
  """iid Bernoulli(1 - mean_sparsity) masks (sparsity exact only in
  mean)."""
  _check_sparsity(mean_sparsity)
  out: MaskDict = {}
  for path, shape in shapes.items():
    u = torch.rand(tuple(shape), generator=generator, device=_gdev(generator))
    out[path] = (u < 1.0 - mean_sparsity).to(dtype=dtype, device=device)
  return out


def simple_mask(shapes: ShapeDict, init_fn: Callable = np.ones,
                dtype=torch.float32, device=None) -> MaskDict:
  """Masks from a numpy init function (e.g. np.ones, np.zeros)."""
  return {p: torch.as_tensor(np.asarray(init_fn(s))).to(dtype=dtype,
                                                        device=device)
          for p, s in shapes.items()}


def symmetric_mask(generator, shapes: ShapeDict, sparsity: float,
                   dtype=torch.float32, device=None) -> MaskDict:
  """One shared input mask repeated for every output neuron
  (structured)."""
  _check_sparsity(sparsity)
  out: MaskDict = {}
  for path, shape in shapes.items():
    n_in = int(np.prod(shape[:-1]))
    vec = _fixed_count_vector(n_in, sparsity, dtype)
    perm = torch.randperm(n_in, generator=generator,
                          device=_gdev(generator)).cpu()
    col = vec[perm]
    out[path] = col[:, None].repeat(1, shape[-1]).reshape(tuple(shape)).to(
        device)
  return out


def _column_permutations(generator, n_in: int, n_out: int) -> torch.Tensor:
  """(n_in, n_out) indices: an independent uniform permutation of
  range(n_in) in every column (the argsort of iid uniforms)."""
  u = torch.rand((n_in, n_out), generator=generator, device=_gdev(generator))
  return torch.argsort(u, dim=0).cpu()


def per_neuron_mask(generator, shapes: ShapeDict, sparsity: float,
                    dtype=torch.float32, device=None) -> MaskDict:
  """Every output neuron keeps the same input count, shuffled
  independently: no output neuron is fully ablated (for sparsity < 1)."""
  _check_sparsity(sparsity)
  out: MaskDict = {}
  for path, shape in shapes.items():
    n_in = int(np.prod(shape[:-1]))
    vec = _fixed_count_vector(n_in, sparsity, dtype)
    cols = vec[_column_permutations(generator, n_in, shape[-1])]
    out[path] = cols.reshape(tuple(shape)).to(device)
  return out


def _wrapped_diagonal(n_rows: int, n_cols: int, dtype=torch.float32):
  """Ones on the (wrapped) diagonal: every row gets a one even if tall."""
  rows = torch.arange(n_rows)
  out = torch.zeros((n_rows, n_cols), dtype=dtype)
  out[rows, rows % n_cols] = 1
  return out


def per_neuron_no_input_ablation_mask(generator, shapes: ShapeDict,
                                      sparsity: float, dtype=torch.float32,
                                      device=None) -> MaskDict:
  """Per-neuron mask unioned with a wrapped diagonal whose columns are
  shuffled, so every *input* unit keeps at least one outgoing
  connection."""
  _check_sparsity(sparsity)
  out: MaskDict = {}
  for path, shape in shapes.items():
    n_in = int(np.prod(shape[:-1]))
    base = per_neuron_mask(generator, {path: shape}, sparsity, dtype)[path]
    perm = torch.randperm(shape[-1], generator=generator,
                          device=_gdev(generator)).cpu()
    diag = _wrapped_diagonal(n_in, shape[-1], dtype)[:, perm]
    out[path] = torch.maximum(base.reshape(n_in, shape[-1]), diag).reshape(
        tuple(shape)).to(device)
  return out


MASK_GENERATORS = {
    'shuffled': shuffled_mask,
    'random': bernoulli_mask,
    'symmetric': symmetric_mask,
    'per_neuron': per_neuron_mask,
    'per_neuron_no_input_ablation': per_neuron_no_input_ablation_mask,
}


def generate_mask(mask_type: str, generator, shapes: ShapeDict,
                  sparsity: float, dtype=torch.float32,
                  device=None) -> MaskDict:
  """Registry dispatch; 'nm_<n>_<m>' dispatches to N:M structured masks
  (structured.py)."""
  from rigl_tpu_torch.sparsity import structured
  nm = structured.parse_n_m(mask_type)
  if nm is not None:
    return structured.make_n_m_generator(*nm)(generator, shapes, sparsity,
                                              dtype, device)
  if mask_type not in MASK_GENERATORS:
    raise ValueError(
        f'Unknown mask type {mask_type!r}; available: '
        f"{sorted(MASK_GENERATORS)} + 'nm_<n>_<m>'")
  return MASK_GENERATORS[mask_type](generator, shapes, sparsity, dtype,
                                    device)


def propagate_masks(masks: MaskDict) -> MaskDict:
  """Forward-propagates effective ablation through consecutive layers.

  The dict's order is the execution order.  An output unit of layer i
  with no surviving incoming weight ablates the corresponding input slice
  of layer i+1.  Convs are handled channel-wise: a channel is alive if any
  spatial weight survives, and the conv's mask becomes its (cin, cout)
  channel mask, gated by the alive inputs, tiled over the spatial dims.
  """
  paths = list(masks.keys())
  out = dict(masks)
  for i in range(1, len(paths)):
    prev, cur = out[paths[i - 1]], out[paths[i]]
    prev2d = prev.reshape(-1, prev.shape[-1])
    alive_in = (prev2d.sum(dim=0) != 0)
    if cur.dim() > 2:
      chan = cur.amax(dim=tuple(range(cur.dim() - 2)))   # (cin, cout)
      new2d = alive_in[:, None].to(chan.dtype) * chan
      new = new2d.repeat(tuple(cur.shape[:-2]) + (1, 1))
    else:
      if prev.dim() > 2:
        raise ValueError(
            'propagate_masks requires knowledge of the spatial dimensions '
            'of the previous layer; use an equivalent conv layer instead of '
            'dense after conv.')
      new = alive_in[:, None].to(cur.dtype) * cur
    out[paths[i]] = new.reshape(cur.shape).to(cur.dtype)
  return out
