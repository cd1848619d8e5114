"""N:M structured sparsity, in PyTorch.

Counterpart of rigl_tpu/sparsity/structured.py: exactly n active weights
in every group of m consecutive elements along the flattened contraction
axis (all leading axes of a (..., cin, cout) kernel).  The projection
ranks with a stable sort, so ties break by position exactly as JAX's
`jnp.argsort(..., stable=True)` does, and the count per group is exact.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def project_n_m(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
  """Exact-count N:M mask from |scores|: in every group of m consecutive
  elements along the flattened contraction axis, keep the n largest
  (ties by position).  Requires prod(shape[:-1]) % m == 0."""
  if not 0 < n <= m:
    raise ValueError(f'need 0 < n <= m, got {n}:{m}')
  shape = tuple(scores.shape)
  cout = shape[-1]
  lead = 1
  for d in shape[:-1]:
    lead *= d
  if lead % m:
    raise ValueError(f'contraction dim {lead} not divisible by m={m} '
                     f'for shape {shape}')
  s = scores.abs().reshape(lead // m, m, cout)
  order = torch.argsort(-s, dim=1, stable=True)
  ranks = torch.argsort(order, dim=1, stable=True)
  return (ranks < n).to(scores.dtype).reshape(shape)


def n_m_mask_dict(generator: Optional[torch.Generator], shapes, n: int,
                  m: int, dtype=torch.float32, device=None
                  ) -> Dict[str, torch.Tensor]:
  """Random N:M masks for every entry of a {path: shape} dict (sparsity
  1 - n/m by construction): the projection of normal scores drawn from
  `generator`, path by path in sorted order."""
  gdev = generator.device if generator is not None else None
  out = {}
  for path, shape in sorted(shapes.items()):
    scores = torch.randn(tuple(shape), generator=generator, device=gdev)
    out[path] = project_n_m(scores, n, m).to(dtype=dtype, device=device)
  return out


def make_n_m_generator(n: int, m: int):
  """Adapter to the mask-generator signature (generator, shapes, sparsity,
  dtype, device); `sparsity` must equal 1 - n/m (or be 0 / None) to catch
  misconfigured presets."""
  def gen(generator, shapes, sparsity, dtype=torch.float32, device=None):
    implied = 1.0 - n / m
    if sparsity and abs(sparsity - implied) > 1e-6:
      raise ValueError(
          f'{n}:{m} implies sparsity {implied:.4f}, preset says {sparsity}')
    return n_m_mask_dict(generator, shapes, n, m, dtype, device)
  gen.__name__ = f'n_m_{n}_{m}_mask'
  return gen


def parse_n_m(mask_type: str):
  """'nm_2_4' -> (2, 4); None if not an N:M spec."""
  parts = mask_type.split('_')
  if len(parts) == 3 and parts[0] == 'nm':
    return int(parts[1]), int(parts[2])
  return None
