"""The Trainer: config -> model + data + sparse optimizer -> train loop.

Counterpart of rigl_tpu/train/trainer.py: the reference trainers'
responsibilities (mnist_train_eval.py, resnet_train_eval.py,
imagenet_train_eval.py) in one config-driven class: optimizer selection,
mask init and schedule wiring, learning-rate schedules, periodic eval with
top-1 / top-5, metrics, checkpointing and checkpoint surgery.
`TrainConfig` is JAX's, field for field, so one JSON preset loads into
both packages.

What changes in PyTorch:
  * the device is `Trainer(config, device='cuda')`, not a config field;
    asking for CUDA where there is none raises.  The Trainer runs on that
    one device: `n_model_shards > 1` (JAX's tensor-parallel mesh) is
    refused, and JAX's data-parallel mesh has no counterpart.
  * the learning rate: optax evaluates the schedule at its count of
    applied gradient steps, which equals state.sparse.step before every
    apply in every algorithm (a RigL / SNIP update iteration applies
    nothing and leaves the step where it was).  So before each iteration
    every param group's `lr` is set to lr_fn(state.sparse.step).
  * `static_update_steps` selects the train step made with update_hint
    False or True per batch, from predict_update_batches, where JAX
    compiles two programs.
  * checkpoints are the port's own (train/checkpoint.py), and a restored
    or surgically loaded state is copied into the model's own tensors
    (`_adopt`) before training goes on.
  * the model's initial weights come from a torch generator seeded with
    `seed`, so they are not JAX's (convert.trainer_state_from_jax carries
    a JAX Trainer's state over).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from rigl_tpu_torch.data import datasets as datasets_lib
from rigl_tpu_torch.data import pipeline
from rigl_tpu_torch.models import registry
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import lr_schedules, steps
from rigl_tpu_torch.train.train_state import TrainState
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import SparseTraining


@dataclasses.dataclass
class TrainConfig:
  """Resolved training configuration (the reference's ~80 absl flags
  collapsed into one dataclass; dump with `to_json`)."""
  # model / data
  model: str = 'mnist_mlp'
  model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
  dataset: str = 'mnist'
  data_dir: Optional[str] = None
  batch_size: int = 128
  eval_batch_size: int = 0

  # optimization
  optimizer: str = 'momentum'        # momentum | adam | sgd
  base_learning_rate: float = 0.1
  lr_schedule: str = 'constant'      # constant|imagenet|cifar|mnist|sgdr
  momentum: float = 0.9
  use_nesterov: bool = True
  weight_decay: float = 0.0
  label_smoothing: float = 0.0
  train_steps: int = 1000
  training_steps_multiplier: float = 1.0

  # sparse training
  training_method: str = 'rigl'      # rigl|set|static|momentum|snip|dnw|
                                     # prune|scratch|none|rigl_inverted
  sparsity: float = 0.8
  mask_init_method: str = 'erdos_renyi_kernel'
  erk_power_scale: float = 1.0
  custom_sparsity_map: Dict[str, float] = dataclasses.field(
      default_factory=dict)
  maskupdate_begin_step: int = 0
  maskupdate_end_step: int = 25000   # reference imagenet default; anneals
                                     # require a positive end_step
  maskupdate_frequency: int = 100
  drop_fraction: float = 0.3
  drop_fraction_anneal: str = 'constant'
  grow_init: str = 'zeros'
  initial_acc_scale: float = 0.0
  prune_initial_sparsity: float = 0.0
  # Block-granular masks (reference's reserved block_width/height flags):
  # 0 = element-granular.
  block_width: int = 0
  block_height: int = 0
  # Block-sparse *execution*: eligible convs run on the block-skipping
  # kernels instead of dense-times-mask.  Requires block_width/height and
  # a model taking `block` kwargs (resnet); conv3x3 extends it to the
  # spatial convs (ops/block_mask.py::block_executable_layers).
  block_execution: bool = False
  block_conv3x3: bool = False
  block_bm: int = 512
  # Row tile for the tap conv kernel; None = the kernels' default.
  block_tap_bm: Optional[int] = None
  # Only block-execute layers at least this sparse (0 = route every
  # eligible layer).
  block_min_sparsity: float = 0.0
  # Measured per-layer routing table {mask path: 'dense'|'tap'|'matmul'},
  # overriding the heuristics for listed layers; block_routing_file points
  # at a JSON of the same mapping and is merged under block_routing.
  block_routing: Dict[str, str] = dataclasses.field(default_factory=dict)
  block_routing_file: Optional[str] = None
  # Structured mask init ('per_neuron', 'symmetric', ...); None = random.
  mask_type: Optional[str] = None
  # Select the plain or the mask-update train step per batch from the
  # deterministic schedule (predict_update_batches); drop/grow family +
  # gradual pruning only.
  static_update_steps: bool = False
  # Store parameters pre-masked (inactive weights zeroed) so the forward
  # uses them directly.  Drop/grow family only
  # (see SparseTraining.premask_params).
  premask_params: bool = False
  # Runtime guards for the two representation tricks above, checked at
  # log/eval boundaries and at the end of training: (1) under
  # premask_params, params must equal params * masks; (2) under
  # static_update_steps, every step's update_hint must have matched the
  # schedule.  A wrong hint or a premask violation raises.
  debug_checks: bool = True

  # bookkeeping
  seed: int = 0
  log_every: int = 100
  eval_every: int = 0               # 0 = only at end
  checkpoint_dir: Optional[str] = None
  checkpoint_every: int = 0
  n_synthetic: int = 4096
  # Dump per-layer mask images every N batches (0 = off) to
  # checkpoint_dir/mask_images/ (imagenet_resnet/utils.py:83-90).
  mask_image_every: int = 0
  # Save pre/post snapshots around every mask update and log the grad-norm
  # change the update produced (rigl_tf2/train.py:418-438).
  snapshot_mask_updates: bool = False
  # Auto-resume from the latest checkpoint in checkpoint_dir
  # (rigl_tf2 train.py:304-313).
  auto_resume: bool = True
  # Cross-experiment surgery (imagenet_resnet/utils.py:93-125, flags
  # :256-261): initialize masks and/or params from another run's checkpoint.
  init_masks_from: Optional[str] = None
  init_params_from: Optional[str] = None
  # Shuffle loaded masks per layer, preserving sparsity
  # (rigl_tf2/utils.py:126-128).
  shuffle_loaded_masks: bool = False
  # Capture a profiler trace of steps [profile_start, profile_start+n).
  profile_dir: Optional[str] = None
  profile_start: int = 10
  profile_steps: int = 5

  # parallelism
  n_model_shards: int = 1

  def resolved(self) -> 'TrainConfig':
    """Applies training_steps_multiplier (imagenet_train_eval.py:290-297)."""
    if self.training_steps_multiplier == 1.0:
      return self
    m = self.training_steps_multiplier
    return dataclasses.replace(
        self,
        train_steps=int(self.train_steps * m),
        maskupdate_begin_step=int(self.maskupdate_begin_step * m),
        maskupdate_end_step=(int(self.maskupdate_end_step * m)
                             if self.maskupdate_end_step > 0
                             else self.maskupdate_end_step),
    )

  def to_json(self) -> str:
    return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def build_lr_fn(config: TrainConfig, steps_per_epoch: float):
  name = config.lr_schedule
  if name == 'constant':
    return lr_schedules.constant_lr(config.base_learning_rate)
  if name == 'mnist':
    return lr_schedules.mnist_lr_schedule(config.base_learning_rate)
  if name == 'cifar':
    return lr_schedules.cifar_lr_schedule(config.training_steps_multiplier)
  if name == 'imagenet':
    arch = ('mobilenet' if config.model.startswith('mobilenet') else
            'vgg' if config.model.startswith('vgg') else 'resnet')
    return lr_schedules.imagenet_lr_schedule(
        config.base_learning_rate, config.batch_size, steps_per_epoch,
        lr_schedules.LR_SCHEDULES[arch], config.training_steps_multiplier)
  if name == 'sgdr':
    return lr_schedules.sgdr_schedule(
        config.base_learning_rate, config.batch_size, steps_per_epoch,
        decay_epochs=10.0)
  raise ValueError(f'Unknown lr schedule {name!r}')


def build_optimizer(config: TrainConfig, lr_fn
                    ) -> Callable[[list], torch.optim.Optimizer]:
  """The inner optimizer (imagenet_train_eval.py:333-365), as the
  `tx` SparseTraining takes: a list of parameters -> a torch optimizer at
  lr_fn(0), whose `lr` the Trainer sets to lr_fn(step) before each step.
  'momentum' is SGD with dampening 0 (optax's trace), 'adam' Adam with
  optax's eps."""
  lr = float(lr_fn(0))
  if config.optimizer == 'momentum':
    return lambda params: torch.optim.SGD(
        params, lr=lr, momentum=config.momentum, dampening=0.0,
        nesterov=config.use_nesterov)
  if config.optimizer == 'sgd':
    return lambda params: torch.optim.SGD(params, lr=lr)
  if config.optimizer == 'adam':
    return lambda params: torch.optim.Adam(params, lr=lr, eps=1e-8)
  raise ValueError(f'Unknown optimizer {config.optimizer!r}')


def build_algorithm(config: TrainConfig,
                    lr_fn=None) -> algorithms.Algorithm:
  sched = UpdateSchedule(
      begin_step=config.maskupdate_begin_step,
      end_step=config.maskupdate_end_step,
      frequency=config.maskupdate_frequency,
      drop_fraction=config.drop_fraction,
      drop_fraction_anneal=config.drop_fraction_anneal,
      lr_fn=lr_fn,
  )
  name = config.training_method
  kwargs: Dict[str, Any] = {}
  if name in ('set', 'rigl', 'rigl_inverted', 'static', 'momentum', 'snfs'):
    kwargs = dict(schedule=sched, grow_init=config.grow_init)
    if name in ('rigl', 'rigl_inverted'):
      kwargs['initial_acc_scale'] = config.initial_acc_scale
    return algorithms.get_algorithm(name, **kwargs)
  if name == 'prune':
    return algorithms.GradualPruning(
        schedule=sched, initial_sparsity=config.prune_initial_sparsity)
  return algorithms.get_algorithm(name)


def predict_update_batches(algo: algorithms.Algorithm, n_batches: int,
                           start_step: int = 0,
                           start_last_update: Optional[int] = None):
  """Batch indices at which a mask update fires: the schedule is fully
  deterministic, so snapshots and step selection are arranged host-side."""
  sched = algo.schedule
  if sched is None:
    if algo.name == 'snip':
      return {0} if start_step == 0 else set()
    if algo.name == 'dnw':
      return set(range(n_batches))
    return set()
  out = set()
  step = start_step
  last = (sched.initial_last_update_step if start_last_update is None
          else start_last_update)
  for i in range(n_batches):
    if algo.skip_apply_on_update:
      if bool(sched.is_update_iter(step, last)):
        out.add(i)
        last = step
      else:
        step += 1
    else:
      step += 1
      if bool(sched.is_update_iter(step, last)):
        out.add(i)
        last = step
  return out


def simulate_step_sequence(algo: algorithms.Algorithm, total_steps: int,
                           start_step: int = 0,
                           start_last_update: Optional[int] = None) -> int:
  """Number of batches needed to reach `total_steps` optimizer steps.

  RigL/SNIP consume a batch without advancing the step counter on update
  iterations (the reference's skipped apply_gradients); the schedule is
  fully deterministic, so the batch count is precomputed host-side.
  `start_step`/`start_last_update` support resumption from a checkpoint
  mid-run.
  """
  if not (algo.skip_apply_on_update and algo.schedule is not None):
    extra = 1 if (algo.name == 'snip' and start_step == 0) else 0
    return max(total_steps - start_step, 0) + extra
  sched = algo.schedule
  step = start_step
  last = (sched.initial_last_update_step if start_last_update is None
          else start_last_update)
  batches = 0
  while step < total_steps:
    batches += 1
    if bool(sched.is_update_iter(step, last)):
      last = step
    else:
      step += 1
  return batches


class Trainer:
  """End-to-end sparse training driver."""

  def __init__(self, config: TrainConfig, device='cuda'):
    self.config = config.resolved()
    cfg = self.config
    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(f'Trainer: {self.device} requested but CUDA is not '
                         'available (pass device="cpu")')
    if cfg.n_model_shards > 1:
      raise NotImplementedError(
          f'n_model_shards={cfg.n_model_shards}: tensor-parallel meshes '
          'come with the parallel modules (Slice 10); the Trainer runs on '
          'one device')

    self.train_ds, self.eval_ds, self.data_info = datasets_lib.create_dataset(
        cfg.dataset, cfg.batch_size, cfg.eval_batch_size,
        data_dir=cfg.data_dir, seed=cfg.seed, n_synthetic=cfg.n_synthetic)
    steps_per_epoch = max(self.data_info['num_train'] / cfg.batch_size, 1.0)

    model_kwargs = dict(cfg.model_kwargs)
    model_kwargs.setdefault('num_classes', self.data_info['num_classes'])
    exec_block = None
    if cfg.block_execution:
      if not (cfg.block_width > 0 and cfg.block_height > 0):
        raise ValueError('block_execution requires block_width/block_height')
      exec_block = (cfg.block_height, cfg.block_width)
      model_kwargs['block'] = exec_block
      model_kwargs['block_bm'] = cfg.block_bm
      if cfg.block_tap_bm is not None:
        model_kwargs['block_tap_bm'] = cfg.block_tap_bm
    self._exec_block = exec_block
    self.model_kwargs = model_kwargs
    self.model = self._create_model()
    self._fresh = True

    self.lr_fn = build_lr_fn(cfg, steps_per_epoch)
    tx = build_optimizer(cfg, self.lr_fn)
    self.algo = build_algorithm(cfg, lr_fn=self.lr_fn)

    custom_map = dict(cfg.custom_sparsity_map)
    # Depthwise kernels (MobileNet) never carry masks: reference convention.
    dense_paths = []
    if hasattr(self.model, 'dense_layer_paths'):
      dense_paths = list(self.model.dense_layer_paths())

    def mask_rule(path, leaf):
      if path in dense_paths:
        return False
      return masks_lib.default_mask_rule(path, leaf)

    block = ((cfg.block_height, cfg.block_width)
             if cfg.block_width > 0 and cfg.block_height > 0 else None)
    routing = dict(cfg.block_routing)
    if cfg.block_routing_file:
      with open(cfg.block_routing_file) as f:
        file_routing = json.load(f)
      routing = {**file_routing, **routing}
    self.sparse_training = SparseTraining(
        tx, self.algo,
        distribution=cfg.mask_init_method,
        default_sparsity=cfg.sparsity,
        custom_sparsity_map=custom_map,
        erk_power_scale=cfg.erk_power_scale,
        mask_rule=mask_rule,
        seed=cfg.seed,
        block=block,
        mask_generator=cfg.mask_type,
        block_routing=routing,
        premask_params=cfg.premask_params)

    def _make_step(update_hint=None):
      return steps.make_train_step(
          self.model, self.sparse_training,
          weight_decay=cfg.weight_decay,
          label_smoothing=cfg.label_smoothing,
          block=self._exec_block,
          block_conv3x3=cfg.block_conv3x3,
          block_min_sparsity=cfg.block_min_sparsity,
          update_hint=update_hint)

    self._make_step = _make_step
    self._train_step = _make_step()
    self._eval_step = steps.make_eval_step(self.model)

    self.state: Optional[TrainState] = None
    self.metrics_history: List[Dict[str, float]] = []

  def _create_model(self):
    cfg = self.config
    return registry.create_model(
        cfg.model, data_shape=self.data_info['shape'], seed=cfg.seed,
        device=self.device, **self.model_kwargs)

  # ------------------------------------------------------------------------
  def init_state(self) -> TrainState:
    cfg = self.config
    if not self._fresh:
      # The model's tensors hold trained values: back to the seed's.
      with torch.no_grad():
        self.model.load_state_dict(self._create_model().state_dict())
    self._fresh = False
    has_surgery = bool(cfg.init_masks_from or cfg.init_params_from
                       or cfg.shuffle_loaded_masks)
    state = steps.init_train_state(
        cfg.seed, self.model, self.sparse_training,
        # Surgery swaps masks/params below; establish the pre-masked
        # invariant only once the FINAL masks are known, so latent init
        # values are not zeroed under the wrong mask.
        premask=False if has_surgery else None)
    if cfg.init_masks_from or cfg.init_params_from:
      from rigl_tpu_torch.train.checkpoint import (
          CheckpointManager, restore_masks_only, restore_params_only,
          shuffle_masks)
      for path, surgery in ((cfg.init_masks_from, restore_masks_only),
                            (cfg.init_params_from, restore_params_only)):
        if path:
          mgr = CheckpointManager(path)
          other = mgr.restore(state, sparse_training=self.sparse_training)
          mgr.close()
          state = surgery(state, other)
      if cfg.shuffle_loaded_masks and state.sparse.masks:
        masks = shuffle_masks(cfg.seed + 7, state.sparse.masks)
        state = state.replace(sparse=state.sparse.replace(
            masks=masks,
            block_packs=self.sparse_training._compute_packs(masks)))
      state = self._adopt(state)
    if has_surgery:
      state = self._enforce_premask(state)
    self.state = state
    return state

  def _adopt(self, state: TrainState) -> TrainState:
    """`state` on the model's own tensors: its params and statistics
    copied into the model's, its optimizer slots into an optimizer over
    them.  The identity where `state` already is the model's."""
    from rigl_tpu_torch.train.checkpoint import optimizer_slots
    own = masks_lib.param_dict(self.model)
    stats = {masks_lib.path_str(n): b for n, b in self.model.named_buffers()}
    if (all(state.params[p] is t for p, t in own.items())
        and all(state.batch_stats.get(p, b) is b for p, b in stats.items())):
      return state
    slots = optimizer_slots(state.optimizer, list(state.params))
    with torch.no_grad():
      for p, t in own.items():
        if state.params[p] is not t:
          t.copy_(state.params[p])
      for p, b in stats.items():
        src = state.batch_stats.get(p)
        if src is not None and src is not b:
          b.copy_(src)
      optimizer = self.sparse_training.tx(list(own.values()))
      for p, t in own.items():
        optimizer.state[t] = {k: (v.clone() if torch.is_tensor(v) else v)
                              for k, v in slots[p].items()}
    return state.replace(params=own, batch_stats=stats, optimizer=optimizer)

  def _enforce_premask(self, state: TrainState) -> TrainState:
    """Re-establishes the pre-masked invariant (params AND optimizer slots
    zero at inactive positions) under the state's CURRENT masks, in
    place; identity when the mode is off.

    Slots matter: a latent-mode checkpoint restored into a premask run
    carries momentum at inactive positions, and since masked grads are zero
    that stale momentum would walk 'premasked' weights off zero."""
    if not self.config.premask_params:
      return state
    from rigl_tpu_torch.train.checkpoint import optimizer_slots
    slots = optimizer_slots(state.optimizer, list(state.params))
    with torch.no_grad():
      for p, m in state.sparse.masks.items():
        w = state.params[p]
        inactive = m == 0
        for v in slots[p].values():
          if torch.is_tensor(v) and v.shape == w.shape:
            v.copy_(torch.where(inactive, torch.zeros_like(v), v))
        w.mul_(m.to(w.dtype))
    return state

  def _set_lr(self, state: TrainState):
    lr = float(self.lr_fn(state.sparse.step))
    for group in state.optimizer.param_groups:
      group['lr'] = lr

  # ------------------------------------------------------------------------
  def train(self, total_steps: Optional[int] = None,
            progress_fn: Optional[Callable[[Dict[str, Any]], None]] = None
            ) -> Dict[str, Any]:
    cfg = self.config
    total_steps = total_steps or cfg.train_steps
    if self.state is None:
      self.init_state()
    state = self.state

    ckpt_mgr0 = None
    if cfg.checkpoint_dir and cfg.auto_resume:
      from rigl_tpu_torch.train.checkpoint import CheckpointManager
      ckpt_mgr0 = CheckpointManager(cfg.checkpoint_dir)
      if ckpt_mgr0.latest_step() is not None:
        state = self._adopt(ckpt_mgr0.restore(
            state, sparse_training=self.sparse_training))
        # The checkpoint may come from a latent-mode run; re-establish the
        # pre-masked invariant (identity for premask-mode checkpoints).
        state = self._enforce_premask(state)
        self.state = state
    n_batches = simulate_step_sequence(
        self.algo, total_steps,
        start_step=int(state.sparse.step),
        start_last_update=int(state.sparse.last_update_step))

    hint_batches = None
    train_step = self._train_step
    if cfg.static_update_steps and self.algo.name in (
        'set', 'rigl', 'rigl_inverted', 'static', 'momentum', 'prune'):
      # The plain and the update step, selected by the host-side schedule
      # prediction.
      hint_batches = predict_update_batches(
          self.algo, n_batches, start_step=int(state.sparse.step),
          start_last_update=int(state.sparse.last_update_step))
      train_step_plain = self._make_step(False)
      train_step_upd = self._make_step(True)
    it = pipeline.prefetch_to_device(self.train_ds.repeat(), 2, self.device)

    writer = ckpt_mgr = None
    if cfg.checkpoint_dir:
      from rigl_tpu_torch.train.checkpoint import CheckpointManager
      from rigl_tpu_torch.utils.metrics import MetricsWriter
      writer = MetricsWriter(cfg.checkpoint_dir)
      ckpt_mgr = ckpt_mgr0 or CheckpointManager(cfg.checkpoint_dir)

    if not cfg.snapshot_mask_updates:
      update_batches = set()
    elif hint_batches is not None:
      update_batches = hint_batches  # same simulation, computed above
    else:
      update_batches = predict_update_batches(
          self.algo, n_batches, start_step=int(state.sparse.step),
          start_last_update=int(state.sparse.last_update_step))
    grad_norm_fn = None
    pre_mgr = post_mgr = None
    if update_batches:
      grad_norm_fn = steps.make_grad_norm_fn(
          self.model, cfg.weight_decay, cfg.label_smoothing)
      if cfg.checkpoint_dir:
        from rigl_tpu_torch.train.checkpoint import CheckpointManager
        pre_mgr = CheckpointManager(
            os.path.join(cfg.checkpoint_dir, 'pre_update'), max_to_keep=20)
        post_mgr = CheckpointManager(
            os.path.join(cfg.checkpoint_dir, 'post_update'), max_to_keep=20)

    # Runtime guards (debug_checks), read at boundaries: see
    # _run_debug_checks.
    hint_ok_buffer: List[Any] = []
    check_premask = cfg.debug_checks and cfg.premask_params

    def _run_debug_checks(state):
      if hint_ok_buffer:
        ok = all(bool(h) for h in hint_ok_buffer)
        hint_ok_buffer.clear()
        if not ok:
          raise RuntimeError(
              'static_update_steps hint mismatch: a step ran the wrong '
              'specialized program (host schedule prediction diverged from '
              'the device-evaluated schedule)')
      if check_premask and state.sparse.masks:
        with torch.no_grad():
          ok = all(bool((state.params[p][m == 0] == 0.0).all())
                   for p, m in state.sparse.masks.items())
        if not ok:
          raise RuntimeError(
              'premask invariant violated: params have nonzero values at '
              'mask-inactive positions (params != params * masks)')

    from rigl_tpu_torch.utils.metrics import profile_trace
    profiler = contextlib.ExitStack()
    t0 = time.time()
    last_log_t, last_log_i = t0, 0
    for i in range(n_batches):
      if cfg.profile_dir:
        if i == cfg.profile_start:
          profiler.enter_context(profile_trace(cfg.profile_dir))
        elif i == cfg.profile_start + cfg.profile_steps:
          profiler.close()
      batch = next(it)
      is_update_batch = i in update_batches
      if is_update_batch:
        pre_norm = grad_norm_fn(state, batch)
        if pre_mgr:
          pre_mgr.save(i, state)  # keyed by batch index: unique/monotone
      if hint_batches is not None:
        train_step = train_step_upd if i in hint_batches else train_step_plain
      self._set_lr(state)
      state, metrics = train_step(state, batch)
      # Keep self.state live: progress callbacks (e.g. mask recording)
      # read trainer.state.
      self.state = state
      if cfg.debug_checks and 'update_hint_ok' in metrics:
        hint_ok_buffer.append(metrics['update_hint_ok'])
      if is_update_batch:
        post_norm = grad_norm_fn(state, batch)
        if post_mgr:
          post_mgr.save(i, state)
        rec = {
            'mask_update_grad_norm_pre': float(pre_norm),
            'mask_update_grad_norm_post': float(post_norm),
            'mask_update_grad_norm_improvement':
                float(post_norm) - float(pre_norm),
            'step': float(state.sparse.step),
        }
        self.metrics_history.append(rec)
        if writer:
          writer.write(int(state.sparse.step), rec)
        if progress_fn:
          progress_fn(rec)
      if cfg.log_every and (i + 1) % cfg.log_every == 0:
        _run_debug_checks(state)
        m = {k: float(v) for k, v in metrics.items()}
        now = time.time()
        m['steps_per_sec'] = (i + 1 - last_log_i) / max(now - last_log_t,
                                                        1e-9)
        m['learning_rate'] = float(self.lr_fn(state.sparse.step))
        last_log_t, last_log_i = now, i + 1
        m['global_sparsity'] = (
            float(masks_lib.calculate_sparsity(state.sparse.masks))
            if state.sparse.masks else 0.0)
        self.metrics_history.append(m)
        if writer:
          writer.write(int(m['step']), m)
        if progress_fn:
          progress_fn(m)
      if (cfg.eval_every and (i + 1) % cfg.eval_every == 0):
        _run_debug_checks(state)
        em = self.evaluate(state)
        em['step'] = float(i + 1)
        self.metrics_history.append({'eval_' + k: v for k, v in em.items()})
        if writer:
          writer.write(int(em['step']), {'eval_' + k: v
                                         for k, v in em.items()})
        if progress_fn:
          progress_fn({'eval': em})
      if (ckpt_mgr and cfg.checkpoint_every
          and (i + 1) % cfg.checkpoint_every == 0):
        ckpt_mgr.save(int(state.sparse.step), state)
      if (cfg.mask_image_every and cfg.checkpoint_dir
          and (i + 1) % cfg.mask_image_every == 0 and state.sparse.masks):
        from rigl_tpu_torch.utils.metrics import write_mask_images
        write_mask_images(cfg.checkpoint_dir, int(state.sparse.step),
                          state.sparse.masks)

    profiler.close()
    if cfg.debug_checks:
      _run_debug_checks(state)
    self.state = state
    if ckpt_mgr:
      ckpt_mgr.save(int(state.sparse.step), state, force=True)
      ckpt_mgr.close()
    if writer:
      writer.close()
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
    wall = time.time() - t0
    final_eval = self.evaluate(state)
    result = {
        'train_steps': total_steps,
        'batches': n_batches,
        'wall_time_s': wall,
        'steps_per_sec': n_batches / max(wall, 1e-9),
        'final_loss': next(
            (float(m['loss']) for m in reversed(self.metrics_history)
             if 'loss' in m), None),
        **{f'eval_{k}': v for k, v in final_eval.items()},
    }
    if state.sparse.masks:
      result['global_sparsity'] = float(
          masks_lib.calculate_sparsity(state.sparse.masks))
    return result

  # ------------------------------------------------------------------------
  def evaluate(self, state: Optional[TrainState] = None) -> Dict[str, float]:
    state = state if state is not None else self.state
    totals: Dict[str, float] = {}
    count = 0.0
    for batch in self.eval_ds.epoch():
      m = self._eval_step(state, pipeline._to_device(batch, self.device))
      bs = float(m['count'])
      for k in ('loss', 'top_1', 'top_5'):
        totals[k] = totals.get(k, 0.0) + float(m[k]) * bs
      count += bs
    return {k: v / max(count, 1.0) for k, v in totals.items()}
