"""Mask dicts over a model's parameters: creation, application and
accounting, in PyTorch.

Counterpart of rigl_tpu/sparsity/masks.py.  A mask set is a flat
``{path: tensor}`` dict keyed by flax-style paths: a torch parameter name
'group2_block0.conv1.conv.kernel' has the path
'group2_block0/conv1/conv/kernel' (`path_str`), so masks, sparsity maps,
routing tables and the weight-decay filter written for the JAX package
apply unchanged.  A parameter dict here is ``{path: tensor}`` too
(`param_dict`), ordered as JAX flattens a tree: by the path's parts,
sorted (`path_sorted`), which fixes each layer's index in the mask
updates.

Random masks keep the exact zero count floor(sparsity * size)
(rigl/sparse_utils.py:48-68).  `make_mask_dict` shuffles with numpy as JAX
does, from the same integers, so a caller passing the JAX key's data
(jax.random.key_data(key)) gets JAX's masks; `random_mask` draws a
permutation from a torch generator, which no JAX key reproduces.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rigl_tpu_torch.sparsity import distributions

MaskDict = Dict[str, torch.Tensor]
# Rule deciding which params get masks: (path, tensor) -> bool.
MaskRule = Callable[[str, torch.Tensor], bool]


def path_str(name: str) -> str:
  """A torch parameter name 'a.b.kernel' -> the flax path 'a/b/kernel';
  a leading 'params' collection name is stripped, as JAX's path_str
  does."""
  parts = str(name).replace('/', '.').split('.')
  if parts and parts[0] == 'params':
    parts = parts[1:]
  return '/'.join(parts)


def torch_name(path: str) -> str:
  """The inverse of path_str: 'a/b/kernel' -> 'a.b.kernel'."""
  return path.replace('/', '.')


def path_sorted(paths) -> list:
  """Paths in the order JAX flattens a nested dict: by parts, sorted."""
  return sorted(paths, key=lambda p: tuple(p.split('/')))


def param_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
  """{path: parameter} of a module, in JAX's flattening order."""
  named = {path_str(n): p for n, p in module.named_parameters()}
  return {p: named[p] for p in path_sorted(named)}


def default_mask_rule(path: str, leaf) -> bool:
  """Masks >= 2-D 'kernel' / 'w' / 'embedding' leaves: the matmul and conv
  weights.  Biases and normalization scales stay dense."""
  name = path.rsplit('/', 1)[-1]
  return name in ('kernel', 'w', 'embedding') and np.ndim(leaf) >= 2


def mask_shapes(params: Mapping[str, torch.Tensor],
                rule: MaskRule = default_mask_rule
                ) -> Dict[str, Tuple[int, ...]]:
  """{path: shape} of every maskable parameter, in JAX's path order."""
  return {p: tuple(params[p].shape) for p in path_sorted(params)
          if rule(p, params[p])}


def random_mask(generator: Optional[torch.Generator],
                shape: Tuple[int, ...], sparsity: float,
                dtype=torch.float32, device=None) -> torch.Tensor:
  """Random mask with an exact zero count of floor(sparsity * size): a
  uniform permutation from `generator` of n_zeros zeros and the rest ones."""
  size = int(np.prod(shape))
  n_zeros = distributions.get_n_zeros(size, sparsity)
  flat = torch.cat([torch.zeros(n_zeros, dtype=dtype),
                    torch.ones(size - n_zeros, dtype=dtype)])
  perm = torch.randperm(size, generator=generator)
  return flat[perm].reshape(shape).to(device)


def make_mask_dict(
    key: Union[int, Sequence[int]],
    params: Mapping[str, torch.Tensor],
    method: str = 'erdos_renyi_kernel',
    default_sparsity: float = 0.8,
    custom_sparsity_map: Optional[Mapping[str, float]] = None,
    rule: MaskRule = default_mask_rule,
    erk_power_scale: float = distributions.DEFAULT_ERK_SCALE,
    dtype=torch.float32,
) -> MaskDict:
  """The initial random mask dict of a parameter dict: layer i shuffles
  with numpy's generator of SeedSequence(key_ints + [i]), as JAX does with
  the integers of its key; masks land on each parameter's device."""
  shapes = mask_shapes(params, rule)
  sparsities = distributions.get_sparsities(
      shapes, method, default_sparsity, custom_sparsity_map,
      erk_power_scale=erk_power_scale)
  key_ints = [int(k) for k in np.asarray(key).reshape(-1)]
  masks: MaskDict = {}
  for i, (path, shape) in enumerate(shapes.items()):
    rs = np.random.default_rng(np.random.SeedSequence(key_ints + [i]))
    size = int(np.prod(shape))
    n_zeros = distributions.get_n_zeros(size, sparsities[path])
    flat = np.ones(size, np.float32)
    flat[:n_zeros] = 0.0
    rs.shuffle(flat)
    masks[path] = torch.as_tensor(flat.reshape(shape)).to(
        params[path].device, dtype)
  return masks


def apply_masks(params: Mapping[str, torch.Tensor],
                masks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """Effective params: masked entries multiplied, the others as they are
  (the same tensors)."""
  return {p: (w if p not in masks else w * masks[p].to(w.dtype))
          for p, w in params.items()}


def mask_grads(grads: Mapping[str, torch.Tensor],
               masks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """Projects dense gradients onto the active set."""
  return apply_masks(grads, masks)


def select_masked(tree: Mapping[str, torch.Tensor],
                  masks: Mapping[str, torch.Tensor]) -> MaskDict:
  """The masked entries of `tree`, keyed and ordered like `tree`."""
  return {p: v for p, v in tree.items() if p in masks}


def update_masked(tree: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
  """`tree` with the entries of `updates` written over it (a new dict)."""
  return {p: updates.get(p, v) for p, v in tree.items()}


def calculate_sparsity(masks: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """Global fraction of zeros across all masks (sparse_utils.py:39-45)."""
  total = sum(int(np.prod(m.shape)) for m in masks.values())
  ones = sum(m.to(torch.float32).sum().cpu() for m in masks.values())
  return 1.0 - ones / total


def per_layer_sparsity(masks: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
  return {p: 1.0 - m.to(torch.float32).mean() for p, m in masks.items()}
