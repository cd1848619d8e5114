"""Learning-rate schedules of the reference trainers, as step -> float
functions.

Counterpart of rigl_tpu/train/lr_schedules.py, with the same tables and
boundaries:
  * ImageNet piecewise with linear warmup over the first phase
    (imagenet_train_eval.py:280-330): per-architecture (multiplier,
    start_epoch) tables, scaled by batch/256; SGDR cosine restarts.
  * CIFAR piecewise /5 at 30k/60k/90k steps (resnet_train_eval.py:185-200).
  * `training_steps_multiplier` rescales every boundary
    (imagenet_train_eval.py:290-297).

Each function computes in numpy float32 scalars, in the order of the JAX
package's jnp expressions (every Python constant cast to float32 where
JAX's weak typing casts it), and returns a numpy float32.  The piecewise
and warmup schedules give JAX's bits; those through cos, log or pow (sgdr,
mnist) may differ from XLA's in the last place.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

Schedule = Callable[[int], np.float32]

_F = np.float32

# (multiplier, start_epoch) tables, imagenet_train_eval.py:283-288.
LR_SCHEDULES = {
    'resnet': [(1.0, 0), (0.1, 30), (0.01, 70), (0.001, 90), (0.0001, 120)],
    'vgg': [(1.0, 0), (0.1, 30), (0.01, 70), (0.001, 90), (0.0001, 120)],
    'mobilenet': [(1.0, 8), (0.1, 40), (0.01, 75), (0.001, 95),
                  (0.0003, 120)],
}


def _epoch(step, steps_per_epoch) -> np.float32:
  return _F(step) / _F(steps_per_epoch)


def imagenet_lr_schedule(
    base_learning_rate: float,
    batch_size: int,
    steps_per_epoch: float,
    schedule: Sequence[Tuple[float, float]] = None,
    training_steps_multiplier: float = 1.0,
) -> Schedule:
  """Piecewise-constant with a linear warmup from 0 to the scaled rate
  across the first phase's epochs when that phase starts after epoch 0
  (lr_schedule at imagenet_train_eval.py:317-330); multipliers apply
  afterwards."""
  table = [(m, e * training_steps_multiplier)
           for m, e in (schedule or LR_SCHEDULES['resnet'])]
  scaled_lr = base_learning_rate * (batch_size / 256.0)

  def fn(step):
    epoch = _epoch(step, steps_per_epoch)
    first_mult, first_epoch = table[0]
    if first_epoch > 0:
      lr = _F(scaled_lr * first_mult) * epoch / _F(first_epoch)
    else:
      lr = _F(scaled_lr * first_mult)
    for mult, start_epoch in table:
      lr = lr if epoch < _F(start_epoch) else _F(scaled_lr * mult)
    return _F(lr)

  return fn


def sgdr_schedule(base_learning_rate: float, batch_size: int,
                  steps_per_epoch: float, decay_epochs: float,
                  t_mul: float = 2.0, m_mul: float = 1.0) -> Schedule:
  """SGDR cosine decay with warm restarts (tf.train.cosine_decay_restarts
  semantics; imagenet_train_eval.py:320-323 use_sgdr path)."""
  scaled_lr = base_learning_rate * (batch_size / 256.0)

  def fn(step):
    epoch = _epoch(step, steps_per_epoch)
    frac = epoch / _F(decay_epochs)
    if t_mul == 1.0:
      i_restart = np.floor(frac)
      t = frac - i_restart
    else:
      # Number of completed restart periods.
      i_restart = np.floor(
          np.log(np.maximum(_F(1.0) - frac * _F(1.0 - t_mul), _F(1e-12)))
          / np.log(_F(t_mul)))
      sum_r = (_F(1.0) - _F(t_mul) ** i_restart) / _F(1.0 - t_mul)
      t = (frac - sum_r) / (_F(t_mul) ** i_restart)
    m_fac = _F(m_mul) ** i_restart
    cosine = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi)
                                         * np.clip(t, _F(0.0), _F(1.0))))
    return _F(_F(scaled_lr) * m_fac * cosine)

  return fn


def cifar_lr_schedule(training_steps_multiplier: float = 1.0) -> Schedule:
  """0.1 divided by 5 at 30k/60k/90k steps (resnet_train_eval.py:189-200)."""
  boundaries = [int(b * training_steps_multiplier)
                for b in (30000, 60000, 90000)]
  values = [0.1 / (5.0 ** i) for i in range(len(boundaries) + 1)]

  def fn(step):
    step = int(step)
    lr = _F(values[0])
    for b, v in zip(boundaries, values[1:]):
      lr = lr if step < b else _F(v)
    return lr

  return fn


def constant_lr(lr: float) -> Schedule:
  return lambda step: _F(lr)


def mnist_lr_schedule(lr: float = 0.2, decay_steps: int = 25000,
                      decay_rate: float = 0.1) -> Schedule:
  """Staircase exponential decay used by the MNIST trainer
  (mnist_train_eval.py optimizer block)."""

  def fn(step):
    k = np.floor(_F(step) / _F(decay_steps))
    return _F(_F(lr) * (_F(decay_rate) ** k))

  return fn
