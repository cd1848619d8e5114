"""Train and eval steps of dense-masked sparse training, in PyTorch.

Counterpart of rigl_tpu/train/steps.py.  One train step: the forward and
backward with respect to the *effective* (masked) parameters, which gives
dense gradients at masked parameters in one backward pass, then
SparseTraining.step (gradient step and/or mask update).  The loss is
label-smoothed softmax cross-entropy plus L2 on the effective kernels and
biases, without normalization parameters (imagenet_train_eval.py:573-584).

`block` enables block-sparse execution: eligible layers run on the
block-skipping kernels, fed by the step's {path: entry} dict from
SparseState.block_packs (refreshed only when masks change).  The kernel
backward gives gradients at active blocks only, so RigL's grow scores are
recomputed with dense-times-mask execution on update steps only, and
algorithms that need dense gradients on every step (SNFS, DNW) are
rejected.  JAX's `update_hint` specialises a compiled program; here it is
the host branch SparseTraining.step takes.

Parameters and BatchNorm statistics change in place (the model's own
tensors, which the TrainState's dicts view); the returned state carries
the new SparseState.  The grow-score pass leaves the statistics as they
were (common.frozen_batch_stats), as JAX discards that pass's updates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from rigl_tpu_torch.models.common import frozen_batch_stats
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.train.train_state import TrainState
from rigl_tpu_torch.transforms.sparse_training import SparseTraining


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
  """Mean softmax CE with optional label smoothing; labels are int ids."""
  num_classes = logits.shape[-1]
  onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)
  if label_smoothing > 0:
    onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
  logp = torch.log_softmax(logits.to(torch.float32), -1)
  return -(onehot * logp).sum(-1).mean()


def l2_regularization(params: Dict[str, torch.Tensor],
                      weight_decay: float) -> torch.Tensor:
  """L2 on kernels and biases, without normalization parameters (the JAX
  package's filter on the same paths)."""
  if weight_decay == 0.0:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.float32, device=dev)
  total = None
  for p in masks_lib.path_sorted(params):
    name = p.rsplit('/', 1)[-1]
    parent = p.lower()
    if name in ('scale',) or 'bn' in parent.split('/')[-2:][0].lower():
      continue
    if name == 'bias' and ('bn' in parent or 'norm' in parent):
      continue
    term = params[p].to(torch.float32).square().sum()
    total = term if total is None else total + term
  if total is None:
    return torch.zeros((), dtype=torch.float32)
  return weight_decay * total


def _entries(state: TrainState, st: SparseTraining, block, block_conv3x3,
             block_min_sparsity):
  """The step's flat {path: entry} dict of block-executed layers, or
  None."""
  if block is None:
    return None
  from rigl_tpu_torch.ops import block_mask as bm_lib
  paths = bm_lib.block_executable_layers(state.sparse.masks, block,
                                         conv3x3=block_conv3x3)
  packs = state.sparse.block_packs or {}
  entries = {p: packs[p] for p in paths
             if p in packs and st.sparsities.get(p, 0.0) >= block_min_sparsity}
  return entries or None


def make_loss_fn(model, weight_decay: float = 0.0,
                 label_smoothing: float = 0.0):
  """loss(eff_params, batch, block_masks=None, train=True) -> (loss,
  logits): the model run with `eff_params` ({path: tensor}) in place of
  its parameters."""
  def loss_fn(eff, batch, block_masks=None, train=True):
    named = {masks_lib.torch_name(p): t for p, t in eff.items()}
    logits = functional_call(model, named, (batch['image'],),
                             {'train': train, 'block_masks': block_masks})
    loss = cross_entropy_loss(logits, batch['label'], label_smoothing)
    return loss + l2_regularization(eff, weight_decay), logits
  return loss_fn


def _effective(params, masks, premask: bool):
  """Leaf tensors of the effective parameters, requiring grad: the
  parameters themselves (pre-masked storage), or their masked copies."""
  if premask:
    return dict(params)
  return {p: ((t.detach() * masks[p].to(t.dtype)).requires_grad_()
              if p in masks else t) for p, t in params.items()}


def make_train_step(
    model,
    st: SparseTraining,
    weight_decay: float = 0.0,
    label_smoothing: float = 0.0,
    has_batch_stats: bool = True,
    has_dropout: bool = False,
    grow_batch: Optional[Dict[str, torch.Tensor]] = None,
    block: Optional[Tuple[int, int]] = None,
    block_conv3x3: bool = False,
    block_min_sparsity: float = 0.0,
    update_hint: Optional[bool] = None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, Any]]]:
  """The train step of `model` under sparse-training config `st`.

  `grow_batch`: a held-out batch whose dense gradients give the grow
  scores at mask-update steps.  `block`: block-sparse execution (module
  docstring); must equal st.block.  `update_hint`: the host's prediction
  of whether the steps this function runs are mask-update iterations
  (SparseTraining.predict_update_iters).  `has_batch_stats` and
  `has_dropout` are kept for the JAX signature: the model's BatchNorm
  layers keep their own statistics, and dropout draws from torch's
  generator."""
  del has_batch_stats, has_dropout
  if block is not None:
    block = tuple(block)
  if block is not None and st.algo.name in ('momentum', 'dnw'):
    raise ValueError(
        f'block-sparse execution cannot serve {st.algo.name}: it needs '
        'dense gradients every step, but the block kernel backward only '
        'covers active blocks')
  if block is not None and st.block != block:
    raise ValueError(
        f'block execution {block} requires SparseTraining(block={block}) '
        f'so masks are block-granular (got {st.block})')
  loss_fn = make_loss_fn(model, weight_decay, label_smoothing)

  def train_step(state: TrainState, batch):
    masks = state.sparse.masks
    eff = _effective(state.params, masks, st.premask_params)
    entries = _entries(state, st, block, block_conv3x3, block_min_sparsity)
    names = list(eff)
    loss, logits = loss_fn(eff, batch, entries)
    grads = torch.autograd.grad(loss, [eff[p] for p in names],
                                allow_unused=True)
    dense_grads = {p: (torch.zeros_like(eff[p]) if g is None else g)
                   for p, g in zip(names, grads)}
    grow_grads_fn = None
    # Gradient-scored regrowth under block execution needs dense
    # gradients: recomputed through dense-times-mask execution, in the
    # update branch only.
    need_dense_grow = (block is not None
                       and st.algo.name in ('rigl', 'rigl_inverted')
                       and update_hint is not False)
    if grow_batch is not None or need_dense_grow:
      def grow_grads_fn(params):
        b = grow_batch if grow_batch is not None else batch
        eff_p = _effective(params, masks, False)
        with frozen_batch_stats(model):
          g_loss, _ = loss_fn(eff_p, b)
        keys = list(eff_p)
        gs = torch.autograd.grad(g_loss, [eff_p[p] for p in keys],
                                 allow_unused=True)
        return {p: (torch.zeros_like(eff_p[p]) if g is None else g)
                for p, g in zip(keys, gs)}
    _, optimizer, sstate, st_metrics = st.step(
        state.params, state.optimizer, state.sparse, dense_grads,
        grow_grads_fn=grow_grads_fn, update_hint=update_hint)
    with torch.no_grad():
      acc = (logits.argmax(-1) == batch['label']).to(torch.float32).mean()
    metrics = {'loss': loss.detach(), 'accuracy': acc, 'step': sstate.step}
    metrics.update(st_metrics)
    return state.replace(optimizer=optimizer, sparse=sstate), metrics

  return train_step


def make_grad_norm_fn(model, weight_decay: float = 0.0,
                      label_smoothing: float = 0.0):
  """grad_norm(state, batch) -> the global L2 norm of the *masked*
  training gradients on a batch, in train mode with the statistics left
  as they were; logs the gradient-norm change a mask update produced
  (rigl_tf2/train.py:433-438)."""
  loss_fn = make_loss_fn(model, weight_decay, label_smoothing)

  def grad_norm(state: TrainState, batch):
    masks = state.sparse.masks
    eff = _effective(state.params, masks, False)
    keys = list(eff)
    with frozen_batch_stats(model):
      loss, _ = loss_fn(eff, batch)
    grads = torch.autograd.grad(loss, [eff[p] for p in keys],
                                allow_unused=True)
    grads = masks_lib.mask_grads(
        {p: (torch.zeros_like(eff[p]) if g is None else g)
         for p, g in zip(keys, grads)}, masks)
    sq = sum(g.to(torch.float32).square().sum() for g in grads.values())
    return torch.sqrt(sq).detach()

  return grad_norm


def make_eval_step(model, has_batch_stats: bool = True):
  """Top-1 / top-5 eval step on the masked parameters and the state's
  BatchNorm statistics (imagenet_train_eval.py:596-615)."""
  del has_batch_stats

  def eval_step(state: TrainState, batch):
    eff = masks_lib.apply_masks(state.params, state.sparse.masks)
    named = {masks_lib.torch_name(p): t
             for p, t in {**state.batch_stats, **eff}.items()}
    with torch.no_grad():
      logits = functional_call(model, named, (batch['image'],),
                               {'train': False}).to(torch.float32)
      labels = batch['label'].long()
      top1 = (logits.argmax(-1) == labels).to(torch.float32)
      k = min(5, logits.shape[-1])
      top5 = (logits.topk(k, -1).indices == labels[:, None]).any(-1).to(
          torch.float32)
      loss = cross_entropy_loss(logits, labels)
    return {'loss': loss, 'top_1': top1.mean(), 'top_5': top5.mean(),
            'count': torch.tensor(float(labels.shape[0]))}

  return eval_step


def init_train_state(
    key: int,
    model,
    st: SparseTraining,
    input_shape: Tuple[int, ...] = None,
    has_batch_stats: bool = True,
    premask: Optional[bool] = None,
) -> TrainState:
  """Masks and optimizer state for `model`, whose parameters (made at its
  construction, on its device, from its generator) are the train state's:
  JAX's model.init has no counterpart.  `key` seeds the masks.  With
  pre-masked storage (st.premask_params, or `premask`) the parameters are
  zeroed at inactive positions once, here.  `input_shape` and
  `has_batch_stats` are kept for the JAX signature."""
  del input_shape
  params = masks_lib.param_dict(model)
  optimizer, sstate = st.init(key, params)
  if st.premask_params if premask is None else premask:
    with torch.no_grad():
      for p, m in sstate.masks.items():
        params[p].mul_(m.to(params[p].dtype))
  stats = {}
  if has_batch_stats:
    stats = {masks_lib.path_str(n): b for n, b in model.named_buffers()}
  return TrainState(params=params, batch_stats=stats, optimizer=optimizer,
                    sparse=sstate)
