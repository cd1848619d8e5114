"""Training loop for PACKED block-sparse MLPs, in PyTorch.

Counterpart of rigl_tpu/train/packed_loop.py.  Weights, gradients and
momentum of every hidden matmul live as `(n_active, bk, bn)` packed blocks,
with RigL drop/grow running ON packed storage
(transforms/packed_training.py).  The classification head stays dense.
The semantics are the JAX trainer's: f32 parameters; SGD with momentum
(torch.optim.SGD with nesterov=False and dampening=0 has optax.sgd's
recurrence, trace = g + momentum * trace); the numpy-seeded batch sampler;
an update step consumes a batch without advancing `step`; the mask update
takes its grow scores from grads through the dense view.

Execution (`via`):
  * 'kernel'      - packed_matmul: the Hopper kernels (forward, dx, packed
                    dw) on a CUDA device, their plain versions on the CPU;
  * 'dense_view'  - unpack and matmul: the same semantics and storage;
  * 'auto'        - 'kernel' on a CUDA device, 'dense_view' on the CPU.
On a CUDA device the kernels take a block of whole 16-byte copies (a
multiple of 4 f32 values); another block raises unless the caller names
'dense_view'.
The kernels mask ragged rows, so unlike JAX's path no rows are padded.

Checkpoints (`save` / `restore`) use the JAX trainer's npz layout, so a
checkpoint written by either package restores into the other.

Used by drivers/packed_mlp.py and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rigl_tpu_torch.layers.packed_dense import random_occupancy
from rigl_tpu_torch.ops.block_sparse_packed import (make_packing,
                                                    packed_matmul,
                                                    unpack_dense)
from rigl_tpu_torch.sparsity.distributions import get_n_zeros
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.transforms import packed_training as pt


@dataclasses.dataclass
class PackedMLPConfig:
  in_features: int = 784
  widths: Tuple[int, ...] = (512, 256)
  num_classes: int = 10
  sparsity: float = 0.9
  block: Tuple[int, int] = (16, 16)
  via: str = 'auto'                     # kernel | dense_view | auto
  bm: int = 128
  learning_rate: float = 0.05
  momentum: float = 0.9
  train_steps: int = 2000
  batch_size: int = 100
  maskupdate_begin_step: int = 0
  maskupdate_end_step: int = 1500
  maskupdate_frequency: int = 100
  drop_fraction: float = 0.3
  drop_fraction_anneal: str = 'cosine'
  seed: int = 0

  def layer_names(self) -> List[str]:
    return [f'l{i + 1}' for i in range(len(self.widths))]

  def layer_dims(self) -> Dict[str, Tuple[int, int]]:
    dims, prev = {}, self.in_features
    for name, w in zip(self.layer_names(), self.widths):
      dims[name] = (prev, w)
      prev = w
    return dims

  def resolve_via(self, device) -> str:
    if self.via != 'auto':
      return self.via
    return 'kernel' if torch.device(device).type == 'cuda' else 'dense_view'


class PackedMLPTrainer:
  """Packed sparse-MLP training: init / step / update / eval / ckpt, on
  `device` (the card unless the caller names another)."""

  def __init__(self, cfg: PackedMLPConfig, device='cuda'):
    for name, (kin, kout) in cfg.layer_dims().items():
      if kin % cfg.block[0] or kout % cfg.block[1]:
        raise ValueError(
            f'{name}: ({kin}, {kout}) must divide block {cfg.block}')
    if cfg.via not in ('kernel', 'dense_view', 'auto'):
      raise ValueError(f'via must be kernel, dense_view or auto: {cfg.via!r}')
    self.cfg = cfg
    self.device = torch.device(device)
    self.via = cfg.resolve_via(self.device)
    vec = 16 // 4            # f32 values per 16-byte copy
    if (self.via == 'kernel' and self.device.type == 'cuda'
        and (cfg.block[0] % vec or cfg.block[1] % vec)):
      raise ValueError(f'the kernels take a block of multiples of {vec} f32 '
                       f'values, not {cfg.block}; name via=dense_view to '
                       'train this block by unpack and matmul')
    self.schedule = UpdateSchedule(
        cfg.maskupdate_begin_step, cfg.maskupdate_end_step,
        cfg.maskupdate_frequency, cfg.drop_fraction,
        cfg.drop_fraction_anneal)
    self.last_update_step = self.schedule.initial_last_update_step
    self.params: Dict[str, torch.Tensor] = {}
    self.packings: Dict[str, Any] = {}
    self.n_active: Dict[str, int] = {}
    self.optimizer: Optional[torch.optim.SGD] = None
    self.step = 0
    self.batches_seen = 0

  # ------------------------------------------------------------- state ----
  def init_state(self):
    """Random occupancy and weights from a torch generator seeded with
    cfg.seed (not JAX's draws: convert.py carries a JAX trainer's state)."""
    cfg = self.cfg
    gen = torch.Generator().manual_seed(cfg.seed)
    bk, bn = cfg.block
    self.params, self.packings, self.n_active = {}, {}, {}
    for name, (kin, kout) in cfg.layer_dims().items():
      nk, nn_ = kin // bk, kout // bn
      na = nk * nn_ - get_n_zeros(nk * nn_, cfg.sparsity)
      self.packings[name] = make_packing(
          random_occupancy(gen, nk, nn_, na), na)
      self.params[name] = torch.randn((na, bk, bn), generator=gen) / math.sqrt(
          kin)
      self.n_active[name] = na
    last = cfg.widths[-1] if cfg.widths else cfg.in_features
    self.params['head_w'] = (torch.randn((last, cfg.num_classes),
                                         generator=gen) / math.sqrt(last))
    self.params['head_b'] = torch.zeros(cfg.num_classes)
    self.params = {k: v.to(self.device, torch.float32).requires_grad_()
                   for k, v in self.params.items()}
    self.optimizer = torch.optim.SGD(list(self.params.values()),
                                     lr=cfg.learning_rate,
                                     momentum=cfg.momentum)
    self.step = 0
    self.batches_seen = 0
    self.last_update_step = self.schedule.initial_last_update_step

  def load_arrays(self, step: int, last_update_step: int, batches_seen: int,
                  occupancy: Dict[str, np.ndarray],
                  params: Dict[str, np.ndarray],
                  momentum: Dict[str, np.ndarray]):
    """Sets the whole training state from numpy arrays: counters, each
    packed layer's (nk, nn) occupancy (rebuilt as a packing), every
    parameter and its momentum trace (copied in place, so the optimizer's
    references stay valid)."""
    if self.optimizer is None:
      self.init_state()
    self.step, self.batches_seen = int(step), int(batches_seen)
    self.last_update_step = int(last_update_step)
    for name in self.packings:
      self.packings[name] = make_packing(
          torch.tensor(np.asarray(occupancy[name])), self.n_active[name])
    with torch.no_grad():
      for name, p in self.params.items():
        p.copy_(torch.tensor(np.asarray(params[name])))
        self.optimizer.state[p]['momentum_buffer'] = torch.tensor(
            np.asarray(momentum[name]), dtype=torch.float32,
            device=self.device)

  def momentum(self) -> Dict[str, torch.Tensor]:
    """{name: momentum trace}: zeros before the first step, as optax's."""
    return {name: self.optimizer.state.get(p, {}).get(
        'momentum_buffer', torch.zeros_like(p)).detach()
            for name, p in self.params.items()}

  # ----------------------------------------------------------- forward ----
  def logits(self, params, x, packings=None, dense_view=None):
    cfg = self.cfg
    packings = packings if packings is not None else self.packings
    h = x.reshape(x.shape[0], -1)
    for name in cfg.layer_names():
      if dense_view is not None:
        h = h @ dense_view[name]
      elif self.via == 'dense_view':
        h = h @ unpack_dense(params[name], packings[name], cfg.block)
      else:
        h = packed_matmul(h.contiguous(), params[name], packings[name],
                          cfg.block, cfg.bm)
      h = torch.relu(h)
    return h @ params['head_w'] + params['head_b']

  def _loss(self, params, x, y, packings=None, dense_view=None):
    lg = self.logits(params, x, packings, dense_view)
    logp = torch.log_softmax(lg, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()

  # -------------------------------------------------------------- steps ----
  def train_step(self, x, y) -> float:
    self.optimizer.zero_grad(set_to_none=True)
    loss = self._loss(self.params, x, y)
    loss.backward()
    self.optimizer.step()
    return float(loss.detach())

  def is_update_step(self, step: int) -> bool:
    return self.schedule.is_update_iter(step, self.last_update_step)

  def mask_update(self, x, y) -> Dict[str, np.ndarray]:
    """RigL update on packed storage: dense-view grads (inactive blocks
    included) -> pooled grow scores -> drop/grow + slot permutation, in
    place.  Returns the new occupancy grids."""
    cfg = self.cfg
    dv = pt.unpack_params({name: self.params[name].detach()
                           for name in self.packings}, self.packings,
                          cfg.block)
    dv = {name: d.requires_grad_() for name, d in dv.items()}
    loss = self._loss(self.params, x, y, dense_view=dv)
    grads = torch.autograd.grad(loss, list(dv.values()))
    grids = pt.rigl_grow_grids(dict(zip(dv, grads)), cfg.block)
    df = self.schedule.get_drop_fraction(self.step)
    out = pt.packed_rigl_update(self.params, self.packings, self.optimizer,
                                grids, df, self.n_active)
    self.packings = out.packings
    self.last_update_step = self.step
    return {name: o.numpy() for name, o in out.occupancy.items()}

  # --------------------------------------------------------------- eval ----
  def evaluate(self, x, y, batch: int = 500) -> float:
    correct = 0
    with torch.inference_mode():
      for i in range(0, len(x), batch):
        xb = torch.as_tensor(np.asarray(x[i:i + batch])).to(self.device)
        pred = self.logits(self.params, xb).argmax(-1).cpu().numpy()
        correct += int((pred == np.asarray(y[i:i + batch])).sum())
    return correct / len(x)

  # ---------------------------------------------------------------- loop ----
  def train(self, train_xy, eval_xy=None, progress_fn=None,
            log_every: int = 0) -> Dict[str, Any]:
    cfg = self.cfg
    if self.optimizer is None:
      self.init_state()
    xtr, ytr = train_xy
    n = len(xtr)
    n_updates = 0
    loss = float('nan')
    while self.step < cfg.train_steps:
      # Per-batch seeded sampling: resume from a checkpoint replays the
      # exact remaining batch sequence (batches_seen is checkpointed).
      rs = np.random.RandomState(
          (cfg.seed * 1000003 + self.batches_seen) % (2 ** 31))
      idx = rs.randint(0, n, size=cfg.batch_size)
      self.batches_seen += 1
      x = torch.as_tensor(np.asarray(xtr[idx])).to(self.device)
      y = torch.as_tensor(np.asarray(ytr[idx])).to(self.device)
      if self.is_update_step(self.step):
        # RigL consumes a batch without advancing the step counter
        # (reference skip-apply semantics, sparse_optimizers_base.py).
        self.mask_update(x, y)
        n_updates += 1
        continue
      loss = self.train_step(x, y)
      self.step += 1
      if log_every and self.step % log_every == 0 and progress_fn:
        progress_fn({'step': self.step, 'loss': loss})
    result = {'train_steps': self.step, 'mask_updates': n_updates,
              'batches': self.batches_seen, 'final_loss': loss,
              'sparsity': cfg.sparsity, 'via': self.via}
    if eval_xy is not None:
      result['eval_top_1'] = self.evaluate(*eval_xy)
    return result

  # ----------------------------------------------------------------- ckpt ----
  def save(self, path: str):
    """Checkpoint in the JAX trainer's layout: counters, occupancy grids
    (packings rebuild from them), params, and the momentum traces as
    `opt_{i}` in jax.tree.flatten's order of optax.sgd's state (the
    parameter names sorted)."""
    os.makedirs(path, exist_ok=True)
    flat = {'step': np.asarray(self.step),
            'last_update': np.asarray(self.last_update_step),
            'batches_seen': np.asarray(self.batches_seen)}
    for name, pk in self.packings.items():
      flat[f'occ_{name}'] = pt.occupancy_grid(pk).numpy()
    for name, p in self.params.items():
      flat[f'param_{name}'] = p.detach().cpu().numpy()
    mom = self.momentum()
    for i, name in enumerate(sorted(self.params)):
      flat[f'opt_{i}'] = mom[name].cpu().numpy()
    np.savez(os.path.join(path, 'packed_state.npz'), **flat)

  def restore(self, path: str) -> bool:
    f = os.path.join(path, 'packed_state.npz')
    if not os.path.exists(f):
      return False
    if self.optimizer is None:
      self.init_state()
    with np.load(f) as z:
      names = sorted(self.params)
      self.load_arrays(
          int(z['step']), int(z['last_update']), int(z['batches_seen']),
          {name: z[f'occ_{name}'] for name in self.packings},
          {name: z[f'param_{name}'] for name in self.params},
          {name: z[f'opt_{i}'] for i, name in enumerate(names)})
    return True
