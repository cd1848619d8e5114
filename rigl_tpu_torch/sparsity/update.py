"""The drop/grow mask-update kernel as a plain PyTorch function.

Counterpart of rigl_tpu/sparsity/update.py (the reference's
rigl/sparse_optimizers_base.py:276-343 ``_get_update_op``):

  n_ones   = sum(mask)
  n_prune  = int(n_ones * drop_fraction)        # truncation, in float32
  n_keep   = n_ones - n_prune
  keep-mask  = top n_keep of score_drop over the whole flattened layer
  grow-mask  = top n_prune of score_grow with already-kept positions lifted
               to min(score_grow) - 1 so they can never be re-grown
  new connections start from `grow_tensor` (zeros by default).

Ranking: ``jax.lax.top_k`` orders floats by their total order (NaN above
+inf, +0 above -0, -NaN last) and breaks ties toward the lower index, as
TF's top_k does, which the reference relies on for reproducible mask
evolution.  ``torch.topk`` promises no tie order and ``torch.sort`` treats
-0 as +0, so `_rank` sorts integer keys of that total order with a stable
descending sort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rigl_tpu_torch.sparsity import distributions
from rigl_tpu_torch.sparsity.schedules import extract_number


class DropGrowResult(NamedTuple):
  mask: torch.Tensor             # updated binary mask, same shape/dtype
  weights: torch.Tensor          # weights with grown connections re-inited
  new_connections: torch.Tensor  # bool, True where a connection was grown


def _rank(flat: torch.Tensor) -> torch.Tensor:
  """Indices of `flat` in jax.lax.top_k's order: descending, floats by
  their total order, ties toward the lower index."""
  if flat.is_floating_point():
    bits = flat.to(torch.float32).view(torch.int32)
    # Sign-magnitude -> two's complement: negative floats' magnitudes run
    # backwards, so flip their 31 value bits.
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
  else:
    key = flat.to(torch.int64)
  return torch.sort(key, descending=True, stable=True).indices


def topk_mask_from_scores(scores: torch.Tensor, n_keep,
                          dtype=torch.float32) -> torch.Tensor:
  """Binary flat mask with ones at the top-`n_keep` positions of `scores`."""
  flat = scores.reshape(-1)
  n_total = flat.shape[0]
  order = _rank(flat)
  keep = (torch.arange(n_total, device=flat.device)
          < torch.as_tensor(n_keep, device=flat.device)).to(dtype)
  return torch.zeros(n_total, dtype=dtype, device=flat.device).index_put(
      (order,), keep)


def drop_grow_update(
    mask: torch.Tensor,
    weights: torch.Tensor,
    score_drop: torch.Tensor,
    score_grow: torch.Tensor,
    drop_fraction,
    grow_tensor: Optional[torch.Tensor] = None,
    reinit_when_same: bool = False,
) -> DropGrowResult:
  """One drop/grow step for a single layer.

  Args:
    mask: current binary mask (any float/int dtype).
    weights: raw (unmasked) weights, same shape.
    score_drop: magnitude score; highest `n_keep` survive.
    score_grow: grow score; highest `n_prune` of currently-inactive win.
    drop_fraction: scalar in [0, 1] (float or float32 tensor).
    grow_tensor: init values for grown connections (defaults to zeros).
    reinit_when_same: if True (Static algorithm, sparse_optimizers.py:109-123)
      re-initialize every grown connection even if it was already active.

  Returns:
    DropGrowResult(mask, weights, new_connections).
  """
  old_dtype = mask.dtype
  shape = mask.shape
  dev = mask.device
  mask_f = mask.to(torch.float32)

  n_ones = mask_f.sum().to(torch.int32)
  n_prune = (n_ones.to(torch.float32)
             * torch.as_tensor(drop_fraction, dtype=torch.float32,
                               device=dev)).to(torch.int32)
  n_keep = n_ones - n_prune

  # Keep-mask over drop scores.
  mask1 = topk_mask_from_scores(score_drop, n_keep)

  # Lift kept positions out of the grow competition.  nan_to_num is the
  # identity for finite scores; with NaN grow scores (a diverged run) the
  # lift's min - 1 would otherwise be NaN, NaNs rank first, kept positions
  # re-win grow, and the count drifts: fatal for packed storage, whose
  # n_active is a shape (rigl_tpu/sparsity/update.py:90-96).
  grow_flat = torch.nan_to_num(score_grow.reshape(-1).to(torch.float32))
  lifted = torch.where(mask1 == 1.0, grow_flat.min() - 1.0, grow_flat)
  mask2 = topk_mask_from_scores(lifted, n_prune)
  # mask1 and mask2 are disjoint by construction: mask2's candidates score
  # strictly below every non-lifted entry.

  mask2_r = mask2.reshape(shape)
  if reinit_when_same:
    new_connections = mask2_r == 1.0
  else:
    new_connections = (mask2_r == 1.0) & (mask_f == 0.0)

  if grow_tensor is None:
    grow_tensor = torch.zeros_like(weights)
  new_weights = torch.where(new_connections, grow_tensor.to(weights.dtype),
                            weights)
  new_mask = (mask1 + mask2).reshape(shape).to(old_dtype)
  return DropGrowResult(new_mask, new_weights, new_connections)


def prune_to_sparsity(score: torch.Tensor, sparsity: float,
                      dtype=torch.float32) -> torch.Tensor:
  """One-shot mask keeping the top (1-sparsity) of `score` (static count).

  Used by SNIP, DNW and magnitude pruning (sparse_optimizers.py:287-317,
  430-460).
  """
  n_total = score.numel()
  n_keep = n_total - distributions.get_n_zeros(n_total, float(sparsity))
  return topk_mask_from_scores(score, n_keep, dtype).reshape(score.shape)


def grow_init_tensor(
    method: str,
    generator: Optional[torch.Generator],
    weights: torch.Tensor,
    masked_grad: Optional[torch.Tensor] = None,
    initial_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Initialization values for newly grown connections.

  Methods (sparse_optimizers_base.py:355-400 and :540-553):
    'zeros'                     - zeros (default, the published RigL choice)
    'initial_dist[_d]'          - shuffled copy of the layer's initial
                                  weights, divided by d
    'random_normal[_d]'         - N(0, std(weights)) / d
    'random_uniform[_d]'        - U(-mean|w|, mean|w|) / d
    'grad_scale[_d]'            - dense gradient / d (RigL only)
    'grad_sign[_d]'             - sign(dense gradient) / d (RigL only)
  Random draws come from `generator`; they are not JAX's draws for any key.
  """
  if method == 'zeros':
    return torch.zeros_like(weights)
  divisor = extract_number(method)
  if method.startswith('initial_dist'):
    if initial_weights is None:
      raise ValueError('initial_dist grow init requires initial_weights')
    flat = initial_weights.reshape(-1)
    perm = torch.randperm(flat.numel(), generator=generator,
                          device=generator.device if generator else 'cpu')
    return flat[perm.to(flat.device)].reshape(weights.shape) / divisor
  if method.startswith('random_normal'):
    stddev = weights.std(correction=0)
    noise = torch.randn(weights.shape, generator=generator,
                        device=generator.device if generator else 'cpu',
                        dtype=weights.dtype).to(weights.device)
    return noise * stddev / divisor
  if method.startswith('random_uniform'):
    mean = weights.abs().mean()
    u = torch.rand(weights.shape, generator=generator,
                   device=generator.device if generator else 'cpu',
                   dtype=weights.dtype).to(weights.device)
    return (u * 2.0 - 1.0) * mean / divisor
  if method.startswith('grad_scale'):
    if masked_grad is None:
      raise ValueError('grad_scale grow init requires the dense gradient')
    return masked_grad / divisor
  if method.startswith('grad_sign'):
    if masked_grad is None:
      raise ValueError('grad_sign grow init requires the dense gradient')
    return torch.sign(masked_grad) / divisor
  raise ValueError('Grow-Init: %s is not a valid option.' % method)
