"""FLOPs / model-size accounting for sparse models, in PyTorch.

Counterpart of rigl_tpu/utils/flops.py (which replaces the reference's
dependency on the MicroNet-challenge counting library,
sparse_utils.get_stats, sparse_utils.py:376-454).  JAX traces the
model's jaxpr and counts its `conv_general_dilated` / `dot_general`
equations with their shapes; here one forward pass runs under a
dispatch mode that records every convolution and matrix product the
model executes (aten convolution, mm, addmm, bmm) with its shapes, the
conv's weight read back to HWIO.  Each op is matched to a masked layer
by kernel shape, in the masks' definition order, as JAX does, and
scaled by that layer's density.

Conventions (matching the README tables the reference publishes):
  * FLOPs = multiplies + adds (2 * MACs), inference, batch 1.
  * sparse FLOPs scale linearly with layer density.
  * size bytes = nnz * param_bytes + total_params / 8 (bitmask overhead),
    reproducing e.g. 23.68MB for ResNet-50 @ 80% ERK.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rigl_tpu_torch.sparsity import masks as masks_lib

_MATMULS = ('mm', 'addmm', 'bmm')


class _ComputeOps(TorchDispatchMode):
  """Records (kind, lhs_shape, rhs_shape, out_shape) of every convolution
  and matrix product run inside it, in JAX's terms: a conv's rhs is its
  HWIO kernel, a product's rhs its right operand."""

  def __init__(self):
    super().__init__()
    self.ops: List[Tuple[str, tuple, tuple, tuple]] = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    name = func.overloadpacket.__name__
    if name == 'convolution':
      x, w = args[0], args[1]
      o, i, kh, kw = w.shape
      self.ops.append(('conv_general_dilated', tuple(x.shape),
                       (kh, kw, i, o), tuple(out.shape)))
    elif name in _MATMULS:
      lhs, rhs = (args[1], args[2]) if name == 'addmm' else args[:2]
      self.ops.append(('dot_general', tuple(lhs.shape), tuple(rhs.shape),
                       tuple(out.shape)))
    return out


def _macs(kind: str, lhs, rhs, res) -> int:
  if kind == 'conv_general_dilated':
    # output elements * (prod(kernel spatial) * cin_per_group), HWIO.
    kernel_volume = int(np.prod(rhs[:-1]))
    return int(np.prod(res)) * kernel_volume
  # dot_general: contracted dim = shared dim.
  m = int(np.prod(res))
  k = int(rhs[0]) if len(rhs) >= 1 else 1
  return m * k


def compute_ops(model, input_shape: Tuple[int, ...], train: bool = False):
  """The convolutions and products of one forward pass of `model` on
  zeros of `input_shape` (on the model's device), in execution order.
  BatchNorm statistics are left as they were."""
  from rigl_tpu_torch.models.common import frozen_batch_stats
  device = next(model.parameters()).device
  x = torch.zeros(input_shape, device=device)
  rec = _ComputeOps()
  with torch.no_grad(), frozen_batch_stats(model), rec:
    model(x, train=train)
  return rec.ops


def count_model(model, input_shape: Tuple[int, ...],
                sparsities: Optional[Mapping[str, float]] = None,
                param_bits: int = 32,
                train: bool = False) -> Dict[str, Any]:
  """Counts inference FLOPs + size of `model` under per-layer sparsities.

  Args:
    model: a module of the port's zoo, called as model(x, train=...).
    input_shape: including batch (use batch 1 for the README convention).
    sparsities: {param_path: sparsity} (e.g. from
      distributions.get_sparsities over mask_shapes); None = dense.
    param_bits: bits per stored parameter.

  Returns dict with dense_flops, sparse_flops, param_bytes, sparsity, and
  per-layer detail.
  """
  params = masks_lib.param_dict(model)
  ops = compute_ops(model, input_shape, train)

  # Maskable layers in definition order -- matches execution order for the
  # sequential models in the zoo; ops are matched greedily by kernel shape.
  shapes = masks_lib.mask_shapes(params)
  sparsities = dict(sparsities or {})
  remaining = list(shapes.items())

  dense_flops = 0
  sparse_flops = 0
  per_layer = []
  for kind, lhs, rhs, res in ops:
    macs = _macs(kind, lhs, rhs, res)
    flops = 2 * macs
    dense_flops += flops
    # Match this op to a masked layer by kernel shape.
    matched = None
    for i, (path, kshape) in enumerate(remaining):
      if tuple(kshape) == tuple(rhs):
        matched = (i, path)
        break
    if matched is not None:
      i, path = matched
      remaining.pop(i)
      s = float(sparsities.get(path, 0.0))
      sparse_flops += int(flops * (1.0 - s))
      per_layer.append({'path': path, 'kind': kind, 'dense_flops': flops,
                        'sparsity': s})
    else:
      sparse_flops += flops
      per_layer.append({'path': None, 'kind': kind, 'dense_flops': flops,
                        'sparsity': 0.0})

  total_params = sum(int(np.prod(tuple(p.shape))) for p in params.values())
  masked_params = sum(int(np.prod(s)) for s in shapes.values())
  nnz = total_params - sum(
      int(np.prod(shapes[p]) * sparsities.get(p, 0.0)) for p in shapes)
  param_bytes = nnz * param_bits // 8
  if sparsities:
    param_bytes += masked_params // 8  # 1-bit mask per maskable param
  return {
      'dense_flops': dense_flops,
      'sparse_flops': sparse_flops,
      'flops_ratio': sparse_flops / max(dense_flops, 1),
      'total_params': total_params,
      'nnz_params': nnz,
      'param_bytes': param_bytes,
      'sparsity': 1.0 - nnz / max(total_params, 1),
      'per_layer': per_layer,
  }


def get_stats(model, input_shape, method: str = 'erdos_renyi_kernel',
              default_sparsity: float = 0.8,
              custom_sparsities: Optional[Mapping[str, float]] = None,
              erk_power_scale: float = 1.0,
              param_bits: int = 32) -> Tuple[int, int, float]:
  """Reference-shaped API (sparse_utils.get_stats): returns
  (total_flops, total_param_bits, real_sparsity) for the given
  distribution."""
  from rigl_tpu_torch.sparsity import distributions
  shapes = masks_lib.mask_shapes(masks_lib.param_dict(model))
  sparsities = distributions.get_sparsities(
      shapes, method, default_sparsity, custom_sparsities or {},
      erk_power_scale=erk_power_scale)
  stats = count_model(model, input_shape, sparsities, param_bits)
  return stats['sparse_flops'], stats['param_bytes'] * 8, stats['sparsity']
