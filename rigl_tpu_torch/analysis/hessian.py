"""Sparse Hessian spectrum of the training loss, in PyTorch.

Counterpart of rigl_tpu/analysis/hessian.py (capability parity with
rigl_tf2/train.py:58-166, 'hessian' mode): the spectrum of the loss
Hessian restricted to the *active* (unmasked) parameters.

  * small models: the exact Hessian over the active-coordinate vector,
    column by column as Hessian-vector products (torch.func's jvp of
    grad), vmapped over chunks of basis vectors.  JAX's jax.hessian runs
    one forward per basis vector at once; at a large batch that does not
    fit, so the chunk is sized from the device's free memory and the
    memory one and two products take (measured first), and halved on an
    out-of-memory error (on the CPU, chunks of 32).  Eigenvalues by
    eigvalsh in float64 on the Hessian's device.
  * large models: stochastic Lanczos quadrature with Hessian-vector
    products on the device (only the tridiagonal matrix is formed on the
    host), from numpy's start vector of `seed`, with full
    reorthogonalisation, as in JAX.

Parameter sets and masks are {path: tensor} dicts; `loss_fn` maps a
parameter dict to a scalar.
"""

from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from rigl_tpu_torch.sparsity import masks as masks_lib

# Basis vectors per vmapped Hessian-vector product on the CPU.
_CPU_CHUNK = 32


def _active_coords(params, masks: Mapping[str, torch.Tensor]):
  """Flattens active (mask==1) masked-kernel entries into one vector, with
  functions to rebuild the full param dict."""
  sel = masks_lib.select_masked(params, masks)
  idx = {p: torch.nonzero(masks[p].reshape(-1) == 1).reshape(-1).to(
      params[p].device) for p in sel}

  def to_vec(tree):
    return torch.cat([tree[p].reshape(-1)[idx[p]] for p in sel])

  def from_vec(vec, base_tree):
    out = {}
    off = 0
    for p in sel:
      n = idx[p].numel()
      flat = base_tree[p].reshape(-1).index_put((idx[p],), vec[off:off + n])
      out[p] = flat.reshape(base_tree[p].shape)
      off += n
    return masks_lib.update_masked(base_tree, out)

  return to_vec, from_vec, sum(int(v.numel()) for v in idx.values())


def _hvp(loss_fn, params, masks):
  """(hvp, x0, n): v -> H v at the active-coordinate vector x0."""
  params = {p: t.detach() for p, t in params.items()}
  to_vec, from_vec, n = _active_coords(params, masks)

  def f(vec):
    return loss_fn(from_vec(vec, params))

  grad_f = grad(f)
  x0 = to_vec(params)

  def hvp(v):
    return jvp(grad_f, (x0,), (v,))[1]

  return hvp, x0, n


def _columns(hvp, x0, n, start, count):
  """H's columns start .. start + count - 1, as rows."""
  eye = torch.zeros((count, n), dtype=x0.dtype, device=x0.device)
  eye[torch.arange(count), start + torch.arange(count)] = 1.0
  return vmap(hvp)(eye)


def _chunk(hvp, x0, n) -> int:
  """Basis vectors per vmapped product: on a CUDA device, what fits in
  0.7 of the free memory, from the peaks of one and of two products (the
  primal pass is shared); on the CPU, _CPU_CHUNK."""
  if x0.device.type != 'cuda':
    return min(n, _CPU_CHUNK)
  peaks = []
  for count in (1, 2):
    torch.cuda.synchronize(x0.device)
    base = torch.cuda.memory_allocated(x0.device)
    torch.cuda.reset_peak_memory_stats(x0.device)
    _columns(hvp, x0, n, 0, min(count, n))
    peaks.append(torch.cuda.max_memory_allocated(x0.device) - base)
  per = max(peaks[1] - peaks[0], 1)
  free, _ = torch.cuda.mem_get_info(x0.device)
  return int(max(1, min(n, (0.7 * free - peaks[0]) // per + 1)))


def sparse_hessian(loss_fn: Callable, params, masks) -> torch.Tensor:
  """Exact Hessian over active coordinates (small models only)."""
  hvp, x0, n = _hvp(loss_fn, params, masks)
  chunk = _chunk(hvp, x0, n)
  cols = []
  start = 0
  while start < n:
    count = min(chunk, n - start)
    try:
      cols.append(_columns(hvp, x0, n, start, count))
    except torch.cuda.OutOfMemoryError:
      if chunk == 1:
        raise
      chunk = max(1, chunk // 2)
      torch.cuda.empty_cache()
      continue
    start += count
  # Row j of the stack is H e_j: column j, as jax.hessian lays it out.
  return torch.cat(cols).T


def sparse_hessian_spectrum(loss_fn: Callable, params, masks) -> np.ndarray:
  """Eigenvalues of the active-coordinate Hessian (ascending)."""
  h = sparse_hessian(loss_fn, params, masks).to(torch.float64)
  return torch.linalg.eigvalsh(h).cpu().numpy()


def lanczos_spectrum(loss_fn: Callable, params, masks, order: int = 32,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
  """Stochastic Lanczos estimate of the Hessian spectrum.

  Returns (ritz_values, ritz_weights) from `order` Lanczos steps with a
  random start vector; HVPs run on the parameters' device.
  """
  hvp, x0, n = _hvp(loss_fn, params, masks)

  def as_x(v):
    return torch.as_tensor(v, dtype=x0.dtype).to(x0.device)

  rng = np.random.default_rng(seed)
  v = rng.normal(size=n)
  v /= np.linalg.norm(v)
  vs = [np.asarray(as_x(v).cpu(), np.float64)]
  alphas, betas = [], []
  for i in range(order):
    w = hvp(as_x(vs[-1])).detach().cpu().numpy().astype(np.float64)
    alpha = float(np.dot(w, vs[-1]))
    w = w - alpha * vs[-1]
    if i > 0:
      w = w - betas[-1] * vs[-2]
    # Full reorthogonalization for numerical stability at small orders.
    for u in vs:
      w = w - np.dot(w, u) * u
    beta = float(np.linalg.norm(w))
    alphas.append(alpha)
    if beta < 1e-10 or i == order - 1:
      break
    betas.append(beta)
    vs.append(np.asarray(as_x(w / beta).cpu(), np.float64))

  t = np.diag(alphas)
  for i, b in enumerate(betas[:len(alphas) - 1]):
    t[i, i + 1] = t[i + 1, i] = b
  evals, evecs = np.linalg.eigh(t)
  weights = evecs[0, :] ** 2
  return evals, weights
