"""Image-classification training on PACKED block-sparse storage, in PyTorch.

Counterpart of rigl_tpu/train/packed_classifier.py on one device.  A
classifier from models/packed_convnet.py (or any module whose sparse
kernels are PackedDense / PackedConv1x1 / PackedConv) trains with weights,
gradients and momentum in `(n_active, bk, bn)` packed blocks; drop/grow
runs on that storage (transforms/packed_training.py), with the grow score
taken lazily at update steps through the model's dense twin.

The semantics are the JAX trainer's:
  * SGD with nesterov momentum: torch.optim.SGD(nesterov=True,
    dampening=0) computes optax.sgd(lr, momentum, nesterov=True)'s
    trace = g + m * trace, update = g + m * trace.
  * RigL: a mask-update iteration consumes a batch and replaces the step
    (the step counter does not advance); grow scores are pooled |dense
    grads|.  SET (random grow) and SNFS (|EMA of pooled signed dense grads|,
    advanced at updates) apply the step, then update.  So for RigL
    `batches == steps + updates`.
  * The batch sampler is numpy RandomState((seed * 1000003 + batches_seen)
    % 2**31), so both packages see the same batches.
  * Checkpoints use JAX's packed_classifier_state.npz layout (`save`,
    `restore`); the momentum traces are `opt_{i}` in the order of optax's
    tree leaves (parameter paths sorted).

The model is built by the caller (its initial values come from the
generator it was given): `init_state` resets the optimizer, the counters
and SNFS's EMA, and convert.packed_classifier_trainer_from_jax installs a
JAX trainer's state.  The trainer runs on the model's device.  SET's grow
scores come from a torch generator seeded with (seed, step), not JAX's
fold_in bits.  n_data > 1 or n_model > 1 (JAX's mesh) raises
NotImplementedError.

Used by drivers/packed_conv.py and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from rigl_tpu_torch.models.packed_convnet import packed_layers
from rigl_tpu_torch.ops.block_sparse_packed import make_packing
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train.packed_lm import dense_twin_params
from rigl_tpu_torch.transforms import packed_training as pt


@dataclasses.dataclass
class PackedClassifierConfig:
  sparsity: float = 0.8
  block: Tuple[int, int] = (16, 16)
  learning_rate: float = 0.05
  momentum: float = 0.9
  train_steps: int = 1000
  batch_size: int = 100
  maskupdate_begin_step: int = 0
  maskupdate_end_step: int = 750
  maskupdate_frequency: int = 100
  drop_fraction: float = 0.3
  drop_fraction_anneal: str = 'cosine'
  seed: int = 0
  algo: str = 'rigl'                     # rigl | set | snfs
  snfs_momentum: float = 0.9
  # JAX's (data, model) mesh: single-device values only here.
  n_data: int = 1
  n_model: int = 1


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Mean cross-entropy of f32 logits (B, C) at integer labels y."""
  logp = torch.log_softmax(logits.float(), dim=-1)
  return -logp.gather(1, y.long()[:, None]).mean()


class PackedClassifierTrainer:
  """init / step / drop-grow update / eval / checkpoint for a (model,
  dense_twin) pair; every packed shape is static across the run.  The
  dense twin's structure is all that is used (it may live on 'meta')."""

  def __init__(self, model: torch.nn.Module, dense_twin: torch.nn.Module,
               cfg: PackedClassifierConfig, input_shape: Tuple[int, ...],
               model_sharded=None):
    if cfg.algo not in ('rigl', 'set', 'snfs'):
      raise ValueError(f'algo must be rigl/set/snfs, got {cfg.algo!r}')
    for name in ('n_data', 'n_model'):
      if getattr(cfg, name) != 1:
        raise NotImplementedError(f'{name}={getattr(cfg, name)}: only the '
                                  'single-device value 1 is ported')
    if model_sharded is not None:
      raise NotImplementedError('model_sharded (tensor parallelism) is not '
                                'ported yet')
    self.model = model
    self.dense_twin = dense_twin
    self.cfg = cfg
    self.input_shape = tuple(input_shape)
    self.device = next(model.parameters()).device
    self.schedule = UpdateSchedule(
        cfg.maskupdate_begin_step, cfg.maskupdate_end_step,
        cfg.maskupdate_frequency, cfg.drop_fraction,
        cfg.drop_fraction_anneal)
    self.last_update_step = self.schedule.initial_last_update_step
    self.optimizer: Optional[torch.optim.SGD] = None
    self.ema_grids = None
    self.step = 0
    self.batches_seen = 0

  # ------------------------------------------------------------- state ----
  def init_state(self):
    """Zero momentum, counters at 0, and (SNFS) zero EMA grids; the
    model's parameters are kept as they are."""
    cfg = self.cfg
    names = sorted(self.params, key=pt.path_key)
    self.optimizer = torch.optim.SGD([self.params[n] for n in names],
                                     lr=cfg.learning_rate,
                                     momentum=cfg.momentum, nesterov=True)
    self.ema_grids = (pt.init_snfs_ema_grids(self.packings, self.device)
                      if cfg.algo == 'snfs' else None)
    self.step = 0
    self.batches_seen = 0
    self.last_update_step = self.schedule.initial_last_update_step

  @property
  def params(self) -> Dict[str, torch.Tensor]:
    """{dotted name: parameter}: packed kernels and every dense leaf."""
    return dict(self.model.named_parameters())

  @property
  def packings(self):
    """{name of a packed kernel: its Packing}."""
    return {name: mod.packing
            for name, mod in packed_layers(self.model).items()}

  def _set_packings(self, packings):
    for name, mod in packed_layers(self.model).items():
      mod.set_packing(packings[name])

  def momentum(self) -> Dict[str, torch.Tensor]:
    """{name: momentum trace}: zeros before the first step, as optax's."""
    return {name: self.optimizer.state.get(p, {}).get(
        'momentum_buffer', torch.zeros_like(p)).detach()
            for name, p in self.params.items()}

  def load_arrays(self, step: int, last_update_step: int, batches_seen: int,
                  occupancy, params, momentum, ema=None):
    """Sets the whole training state from numpy arrays keyed by dotted
    names: counters, each packed kernel's occupancy (rebuilt as a packing),
    every parameter and its momentum trace (copied in place, so the
    optimizer's references stay valid) and (SNFS) the EMA grids."""
    if self.optimizer is None:
      self.init_state()
    self.step, self.batches_seen = int(step), int(batches_seen)
    self.last_update_step = int(last_update_step)
    cur = self.params
    self._set_packings({
        name: make_packing(torch.as_tensor(np.array(occupancy[name])),
                           int(cur[name].shape[0]))
        for name in self.packings})
    with torch.no_grad():
      for name, p in cur.items():
        p.copy_(torch.as_tensor(np.array(params[name])))
        self.optimizer.state[p]['momentum_buffer'] = torch.as_tensor(
            np.array(momentum[name]), dtype=torch.float32,
            device=self.device)
    if self.ema_grids is not None and ema is not None:
      self.ema_grids = {name: torch.as_tensor(np.array(ema[name]),
                                              dtype=torch.float32,
                                              device=self.device)
                        for name in self.ema_grids}

  # -------------------------------------------------------------- steps ----
  def _loss(self, x, y) -> torch.Tensor:
    return _xent(self.model(x), y)

  def train_step(self, x, y) -> float:
    self.optimizer.zero_grad(set_to_none=True)
    loss = self._loss(x, y)
    loss.backward()
    self.optimizer.step()
    return float(loss.detach())

  def is_update_step(self, step: int) -> bool:
    return bool(self.schedule.is_update_iter(step, self.last_update_step))

  def _dense_twin_grads(self, x, y) -> Dict[str, torch.Tensor]:
    """Dense gradients (inactive blocks included) of every packed kernel,
    through the dense twin holding dense views of the packed state: the
    grow-score input of RigL and SNFS."""
    params = {n: p.detach() for n, p in self.params.items()}
    packings = self.packings
    views = dense_twin_params(params, packings, self.cfg.block)
    leaves = {}
    for name in packings:
      key = f'{name.rsplit(".", 1)[0]}.d.kernel'
      views[key] = leaves[name] = views[key].requires_grad_()
    loss = _xent(functional_call(self.dense_twin, views, (x,)), y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))

  def mask_update(self, x, y) -> Dict[str, np.ndarray]:
    """Drop/grow on every packed kernel, in place (the momentum traces of
    survivors carried, of grown blocks zeroed).  Returns the new
    occupancy grids."""
    cfg = self.cfg
    df = self.schedule.get_drop_fraction(self.step)
    params, packings = self.params, self.packings
    if cfg.algo == 'set':
      gen = torch.Generator(device=self.device).manual_seed(
          cfg.seed * 1000003 + self.step)
      out = pt.flax_packed_drop_grow(
          params, packings, self.optimizer,
          pt.flax_set_grow_grids(packings, gen), df)
    elif cfg.algo == 'snfs':
      inst = pt.flax_snfs_inst_grids(self._dense_twin_grads(x, y), packings,
                                     cfg.block)
      self.ema_grids = pt.snfs_update_ema_grids(self.ema_grids, inst,
                                                cfg.snfs_momentum)
      out = pt.flax_packed_drop_grow(
          params, packings, self.optimizer,
          {n: v.abs() for n, v in self.ema_grids.items()}, df)
    else:
      out = pt.flax_packed_rigl_update(params, packings, self.optimizer,
                                       self._dense_twin_grads(x, y), df,
                                       cfg.block)
    self._set_packings(out.packings)
    self.last_update_step = self.step
    return {name: o.numpy() for name, o in out.occupancy.items()}

  # --------------------------------------------------------------- eval ----
  def evaluate(self, x: np.ndarray, y: np.ndarray) -> float:
    """Top-1 accuracy over (x, y) in batches of cfg.batch_size."""
    correct, bs = 0, self.cfg.batch_size
    with torch.no_grad():
      for i in range(0, len(x), bs):
        xb = torch.as_tensor(np.asarray(x[i:i + bs])).to(self.device)
        pred = self.model(xb).argmax(-1).cpu().numpy()
        correct += int(np.sum(pred == np.asarray(y[i:i + len(xb)])))
    return correct / len(x)

  # ---------------------------------------------------------------- loop ----
  def sample_batch(self, x: np.ndarray, y: np.ndarray):
    """Seeded random examples, replayable across resume (batches_seen is
    checkpointed); (x, y) on the trainer's device."""
    cfg = self.cfg
    rs = np.random.RandomState(
        (cfg.seed * 1000003 + self.batches_seen) % (2 ** 31))
    idx = rs.randint(0, len(x), size=cfg.batch_size)
    self.batches_seen += 1
    return (torch.as_tensor(np.asarray(x[idx])).to(self.device),
            torch.as_tensor(np.asarray(y[idx])).to(self.device))

  def train(self, train_xy, eval_xy: Optional[tuple] = None,
            progress_fn=None, log_every: int = 0) -> Dict[str, Any]:
    cfg = self.cfg
    if self.optimizer is None:
      self.init_state()
    xtr, ytr = train_xy
    n_updates = 0
    loss = float('nan')
    while self.step < cfg.train_steps:
      x, y = self.sample_batch(xtr, ytr)
      if cfg.algo == 'rigl' and self.is_update_step(self.step):
        self.mask_update(x, y)
        n_updates += 1
        continue
      loss = self.train_step(x, y)
      self.step += 1
      if cfg.algo != 'rigl' and self.is_update_step(self.step):
        self.mask_update(x, y)
        n_updates += 1
      if log_every and self.step % log_every == 0 and progress_fn:
        progress_fn({'step': self.step, 'loss': loss})
    params, packings = self.params, self.packings
    bk, bn = cfg.block
    result = {'train_steps': self.step, 'mask_updates': n_updates,
              'batches': self.batches_seen, 'final_loss': loss,
              'sparsity': cfg.sparsity,
              'n_params_packed': sum(params[n].numel() for n in packings),
              'n_params_dense_equiv': sum(
                  pk.shape[0] * pk.shape[1] * bk * bn
                  for pk in packings.values())}
    if eval_xy is not None:
      result['eval_top_1'] = self.evaluate(*eval_xy)
    return result

  # ----------------------------------------------------------------- ckpt ----
  def save(self, path: str):
    """JAX's packed_classifier_state.npz: counters, occupancy grids
    (packings rebuild from them), params, SNFS EMA grids, and the momentum
    traces as opt_{i} in sorted path order."""
    os.makedirs(path, exist_ok=True)
    flat = {'step': np.asarray(self.step),
            'last_update': np.asarray(self.last_update_step),
            'batches_seen': np.asarray(self.batches_seen)}
    slash = lambda name: name.replace('.', '/')   # noqa: E731
    for name, pk in self.packings.items():
      flat['occ_' + slash(name)] = pt.occupancy_grid(pk).numpy()
    for name, p in self.params.items():
      flat['param_' + slash(name)] = p.detach().cpu().numpy()
    if self.ema_grids is not None:
      for name, g in self.ema_grids.items():
        flat['ema_' + slash(name)] = g.cpu().numpy()
    mom = self.momentum()
    for i, name in enumerate(sorted(mom, key=pt.path_key)):
      flat[f'opt_{i}'] = mom[name].cpu().numpy()
    np.savez(os.path.join(path, 'packed_classifier_state.npz'), **flat)

  def restore(self, path: str) -> bool:
    f = os.path.join(path, 'packed_classifier_state.npz')
    if not os.path.exists(f):
      return False
    if self.optimizer is None:
      self.init_state()
    slash = lambda name: name.replace('.', '/')   # noqa: E731
    names = sorted(self.params, key=pt.path_key)
    with np.load(f) as z:
      self.load_arrays(
          int(z['step']), int(z['last_update']), int(z['batches_seen']),
          {name: z['occ_' + slash(name)] for name in self.packings},
          {name: z['param_' + slash(name)] for name in names},
          {name: z[f'opt_{i}'] for i, name in enumerate(names)},
          None if self.ema_grids is None else
          {name: z['ema_' + slash(name)] for name in self.ema_grids})
    return True
