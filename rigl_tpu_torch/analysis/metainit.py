"""MetaInit: learning-free initialization tuning by gradient-quotient
descent, in PyTorch.

Counterpart of rigl_tpu/analysis/metainit.py (capability parity with
rigl_tf2/metainit.py:23-120, masked variant included): optimizes only the
*norms* of each weight tensor so that the gradient quotient

    GQ = mean(| Hg / (g + eps * sign(g)) - 1 |)

is minimized (Hg = the Hessian-vector product with the gradient itself, a
jvp of the gradient: no explicit Hessian).  Directions are frozen; each
step rescales every tensor toward the norm that lowers GQ, by signSGD
with momentum as in the original MetaInit algorithm.  The meta-gradient
is third order: torch.func's grad of a jvp of a grad.  Parameter sets are
{path: tensor} dicts, visited in JAX's leaf order (sorted paths).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.func import grad, grad_and_value, jvp

from rigl_tpu_torch.sparsity import masks as masks_lib


def gradient_quotient(loss_fn: Callable, params, eps: float = 1e-5
                      ) -> torch.Tensor:
  grad_fn = grad(loss_fn)
  g = grad_fn(params)
  hg = jvp(grad_fn, (params,), (g,))[1]
  total = 0.0
  count = 0
  for p in masks_lib.path_sorted(g):
    gl, hl = g[p], hg[p]
    denom = gl + eps * (2.0 * (gl >= 0).to(gl.dtype) - 1.0)
    q = torch.abs(hl / denom - 1.0)
    total = total + torch.sum(q)
    count += gl.numel()
  return total / count


def meta_init(loss_fn: Callable, params,
              masks: Optional[Mapping[str, torch.Tensor]] = None,
              lr: float = 0.1, momentum: float = 0.9, steps: int = 100,
              eps: float = 1e-5,
              ) -> Tuple[Dict, list]:
  """Tunes per-tensor norms of (optionally masked) params to minimize GQ.

  Returns (tuned params, gq history).  Only >=2D tensors are rescaled
  (biases / BN left alone), matching the reference's choice of trainable
  norms.
  """
  params = {p: t.detach() for p, t in params.items()}
  if masks is not None:
    params = masks_lib.apply_masks(params, masks)
  rescalable = [p for p in masks_lib.path_sorted(params)
                if params[p].dim() >= 2]
  device = next(iter(params.values())).device

  def with_scales(scales):
    new = dict(params)
    for j, p in enumerate(rescalable):
      new[p] = params[p] * scales[j]
    return new

  def gq_of_scales(scales):
    return gradient_quotient(loss_fn, with_scales(scales), eps)

  grad_gq = grad_and_value(gq_of_scales)
  scales = torch.ones(len(rescalable), device=device)
  vel = torch.zeros_like(scales)
  history = []
  for _ in range(steps):
    g, gq = grad_gq(scales)
    history.append(float(gq))
    vel = momentum * vel + torch.sign(g)    # signSGD w/ momentum (MetaInit)
    scales = torch.clamp(scales - lr * vel, min=1e-3)
  return with_scales(scales), history
