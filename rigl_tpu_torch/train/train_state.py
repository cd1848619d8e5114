"""Train state for dense-masked sparse training: params, BatchNorm
statistics, the optimizer and the sparse state.

Counterpart of rigl_tpu/train/train_state.py.  `params` and `batch_stats`
are {path: tensor} views of the model's own parameters and buffers
(sparsity/masks.py paths), which the train step updates in place; the
optimizer holds the same parameters.  JAX's `rng` (dropout keys) has no
field: dropout, where a model has it, draws from torch's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from rigl_tpu_torch.transforms.sparse_training import SparseState


@dataclasses.dataclass
class TrainState:
  params: Dict[str, torch.Tensor]
  batch_stats: Dict[str, torch.Tensor]
  optimizer: torch.optim.Optimizer
  sparse: SparseState

  @property
  def step(self) -> int:
    return self.sparse.step

  def replace(self, **changes) -> 'TrainState':
    return dataclasses.replace(self, **changes)
