"""The sparse-training state machine over dense-masked parameters, in
PyTorch.

Counterpart of rigl_tpu/transforms/sparse_training.py: `SparseTraining`
couples an optimizer with one of the nine algorithms
(transforms/algorithms.py) and `SparseState` carries the masks, the step
accounting and the block-execution descriptors between steps.  The
trainer differentiates the loss with respect to the *effective* (masked)
parameters, so one backward pass gives dense gradients at masked
parameters; `step` masks them for the optimizer and feeds the dense ones
to the grow scores.

What changes in PyTorch:
  * parameters are a ``{path: tensor}`` dict (sparsity/masks.py) of the
    model's own parameters, and the optimizer is a torch.optim.Optimizer
    over them made by `tx(list_of_parameters)`, e.g.
    ``functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
    nesterov=True)``.  `step` updates both IN PLACE (the optimizer's
    references stay valid) and returns them with the new SparseState.
  * the step counters are host integers, so JAX's schedule `lax.cond`
    is a host branch; `update_hint` still selects the branch, and
    metrics['update_hint_ok'] reports whether it matched the schedule.
  * optax's `tree_map_params` reset of grown connections' slots is a
    `torch.where` on every parameter-shaped tensor of the optimizer's
    state for that parameter.  Where torch has no state yet, this module
    first creates what torch's first step would (SGD's momentum_buffer,
    Adam's step and moments): optax's slots start at zeros from `init`,
    and torch's first step would otherwise overwrite the reset.
  * random draws (drop-score noise, SET's grow scores, random grow inits,
    initial masks) come from torch generators seeded by (seed, step,
    layer, tag); JAX's keys give other numbers.  `_drop_noise` and
    `_grow_score` are the seams through which a replay injects recorded
    draws (tests/test_torch_golden_trajectories.py).

`mask_generator` names a structured initial mask (sparsity/generators.py:
'per_neuron', 'symmetric', 'nm_2_4', ...), drawn per layer at the
distribution's sparsity from the layer's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rigl_tpu_torch.sparsity import distributions
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity import update as update_lib
from rigl_tpu_torch.transforms import algorithms

MaskDict = Dict[str, torch.Tensor]
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class SparseState:
  """Dynamic sparse-training state carried through the train loop.

  `step` follows the reference's global_step: it advances only when a
  gradient step is applied (RigL / SNIP update iterations consume a batch
  without advancing it).  `block_packs`: per-layer block-execution
  descriptors ({'cols', 'rows'} flat packing, {'cols', 'rows', 'taps'} tap
  packing, or an occupancy), recomputed whenever the masks change."""
  masks: MaskDict
  step: int
  last_update_step: int
  is_snipped: bool
  ema_grads: Optional[MaskDict] = None
  initial_weights: Optional[MaskDict] = None
  block_packs: Optional[Dict[str, Any]] = None

  def replace(self, **changes) -> 'SparseState':
    return dataclasses.replace(self, **changes)


def _adam_state(t: torch.Tensor, group: Mapping[str, Any]) -> Dict[str, Any]:
  """The state torch.optim.Adam's first step creates for `t`
  (Adam._init_group): `step` a float32 scalar (float64 under a float64
  default dtype) on the CPU, or on t's device when `capturable` or
  `fused`; zero moments, and the amsgrad maximum when `amsgrad`."""
  fused = group.get('fused')
  if fused or group.get('capturable'):
    step = torch.zeros((), dtype=torch.float32 if fused else _scalar_dtype(),
                       device=t.device)
  else:
    step = torch.tensor(0.0, dtype=_scalar_dtype(), device='cpu')
  state = {'step': step, 'exp_avg': torch.zeros_like(t),
           'exp_avg_sq': torch.zeros_like(t)}
  if group.get('amsgrad'):
    state['max_exp_avg_sq'] = torch.zeros_like(t)
  return state


def _scalar_dtype():
  return (torch.float64 if torch.get_default_dtype() == torch.float64
          else torch.float32)


def _seed(*ints) -> int:
  """A 63-bit generator seed from a tuple of integers."""
  state = np.random.SeedSequence([int(i) & 0xFFFFFFFF for i in ints])
  return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


class SparseTraining:
  """Couples an optimizer with a sparse-training algorithm.

  Usage:
    st = SparseTraining(partial(torch.optim.SGD, lr=0.1, momentum=0.9),
                        algorithms.RigL(...))
    optimizer, sstate = st.init(seed, params)       # params: {path: tensor}
    eff = masks_lib.apply_masks(params, sstate.masks)
    ... dense_grads = grads of the loss w.r.t. eff ...
    params, optimizer, sstate, metrics = st.step(params, optimizer, sstate,
                                                 dense_grads)
  """

  def __init__(
      self,
      tx: Callable[[list], torch.optim.Optimizer],
      algo: algorithms.Algorithm,
      distribution: str = 'erdos_renyi_kernel',
      default_sparsity: float = 0.8,
      custom_sparsity_map: Optional[Mapping[str, float]] = None,
      erk_power_scale: float = distributions.DEFAULT_ERK_SCALE,
      mask_rule=masks_lib.default_mask_rule,
      seed: int = 0,
      mask_dtype=torch.float32,
      block: Optional[Tuple[int, int]] = None,
      mask_generator: Optional[str] = None,
      block_routing: Optional[Mapping[str, str]] = None,
      premask_params: bool = False,
  ):
    self.tx = tx
    self.algo = algo
    self.distribution = distribution
    self.default_sparsity = default_sparsity
    self.custom_sparsity_map = dict(custom_sparsity_map or {})
    self.erk_power_scale = erk_power_scale
    self.mask_rule = mask_rule
    self.seed = seed
    self.mask_dtype = mask_dtype
    # Block-granular masks over (block_rows x block_cols) cells of the 2D
    # matmul view (tap cells for spatial convs); layers the block does not
    # divide stay element-granular.
    self.block = None if block is None else tuple(block)
    self.mask_generator = mask_generator
    # Measured per-layer routing {mask path: 'dense' | 'tap' | 'matmul'}
    # overriding _compute_packs' default for the listed layers.
    self.block_routing = dict(block_routing or {})
    # Pre-masked storage: weights are zero at inactive positions from init
    # on, so the hot path uses the parameters directly (no per-step mask
    # multiply).  Valid for the drop/grow family (+ scratch) only.
    self.premask_params = premask_params
    if premask_params and algo.name in ('prune', 'dnw', 'snip'):
      raise ValueError(
          f'premask_params changes {algo.name} semantics: its re-masking '
          'scores frozen latent weights, which pre-masking zeroes')
    if premask_params and getattr(algo, 'grow_init', 'zeros').startswith(
        'random_'):
      raise ValueError(
          f'premask_params changes grow_init={algo.grow_init} semantics: '
          'its scale statistics (std/mean|w|) are taken over the full '
          'tensor, which pre-masking zeroes at inactive positions')
    # Per-layer sparsity targets + shapes, filled by init().
    self.sparsities: Dict[str, float] = {}
    self.layer_shapes: Dict[str, Tuple[int, ...]] = {}

  def _layer_block(self, shape) -> Optional[Tuple[int, int]]:
    if self.block is None:
      return None
    from rigl_tpu_torch.ops.block_mask import block_shape_for, is_tap_layer
    shape = tuple(shape)
    if len(shape) == 4 and shape[:2] != (1, 1):
      return self.block if is_tap_layer(shape, self.block) else None
    rows, cols = block_shape_for(shape, self.block)
    br, bc = self.block
    if rows % br == 0 and cols % bc == 0:
      return self.block
    return None

  def _n_blocks(self, shape) -> int:
    """Total block cells of a block-eligible layer."""
    from rigl_tpu_torch.ops.block_mask import block_shape_for, is_tap_layer
    br, bc = self.block
    shape = tuple(shape)
    if is_tap_layer(shape, self.block):
      kh, kw, cin, cout = shape
      return kh * kw * (cin // br) * (cout // bc)
    rows, cols = block_shape_for(shape, self.block)
    return (rows // br) * (cols // bc)

  def _generator(self, device, *ints) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(self.seed, *ints))
    return gen

  # ------------------------------------------------------------------ init --
  def init(self, key: int, params: Params
           ) -> Tuple[torch.optim.Optimizer, SparseState]:
    """Builds the optimizer over `params` and the initial mask set (on
    each parameter's device).  `key` seeds the masks: layer i draws from
    a generator of (key, i)."""
    algo = self.algo
    shapes = masks_lib.mask_shapes(params, self.mask_rule)
    self.layer_shapes = dict(shapes)
    mask_dict: MaskDict = {}
    if algo.name == 'none':
      self.sparsities = {}
    else:
      self.sparsities = distributions.get_sparsities(
          shapes, self.distribution, self.default_sparsity,
          self.custom_sparsity_map, erk_power_scale=self.erk_power_scale)
      for i, (p, s) in enumerate(shapes.items()):
        dev = params[p].device
        gen = torch.Generator().manual_seed(_seed(key, i))
        if algo.name == 'snip':
          # SNIP starts dense and prunes by saliency at step 0.
          mask_dict[p] = torch.ones(s, dtype=self.mask_dtype, device=dev)
        elif algo.name == 'prune':
          mask_dict[p] = masks_lib.random_mask(
              gen, s, algo.initial_sparsity, self.mask_dtype, dev)
        elif self.mask_generator is not None:
          from rigl_tpu_torch.sparsity import generators
          mask_dict[p] = generators.generate_mask(
              self.mask_generator, gen, {p: s}, self.sparsities[p],
              self.mask_dtype, dev)[p]
        elif self._layer_block(s) is not None:
          from rigl_tpu_torch.ops.block_mask import random_block_mask
          mask_dict[p] = random_block_mask(gen, s, self.sparsities[p],
                                           self.block, self.mask_dtype, dev)
        else:
          mask_dict[p] = masks_lib.random_mask(gen, s, self.sparsities[p],
                                               self.mask_dtype, dev)
    ema = None
    if algo.needs_ema:
      ema = {p: torch.zeros(s, dtype=torch.float32,
                            device=params[p].device)
             for p, s in shapes.items() if p in mask_dict}
    initial_weights = None
    if algo.grow_init.startswith('initial_dist'):
      initial_weights = {p: v.detach().clone() for p, v in
                         masks_lib.select_masked(params, mask_dict).items()}
    sstate = SparseState(
        masks=mask_dict, step=0,
        last_update_step=(algo.schedule.initial_last_update_step
                          if algo.schedule else 0),
        is_snipped=False, ema_grads=ema, initial_weights=initial_weights,
        block_packs=self._compute_packs(mask_dict))
    return self.tx(list(params.values())), sstate

  def _compute_packs(self, masks: MaskDict) -> Optional[Dict[str, Any]]:
    """Block-execution descriptors for every block-divisible layer; must
    be recomputed whenever masks change."""
    if self.block is None or not masks:
      return None
    from rigl_tpu_torch.ops.block_mask import block_entry
    counts = self.static_block_counts()
    packs: Dict[str, Any] = {}
    for p, m in masks.items():
      if self._layer_block(m.shape) is None:
        continue
      choice = self.block_routing.get(p)
      if choice == 'dense':
        continue   # measured loser: no pack -> dense conv on masked weights
      spatial = len(m.shape) == 4 and tuple(m.shape[:2]) != (1, 1)
      if len(m.shape) == 4 and p in counts and choice != 'matmul':
        # Conv layers (1x1 and spatial) with a static count execute on the
        # tap kernels; a 1x1 is the one-tap case.
        # The pack keeps the conv's TapIndex, built at its first call.
        from rigl_tpu_torch.ops.block_mask import pool_to_tap_blocks
        from rigl_tpu_torch.ops.block_sparse_conv import (TapPack,
                                                          pack_tap_active)
        occ3 = (pool_to_tap_blocks(m.to(torch.float32), self.block, 'max')
                > 0).to(torch.int32).cpu()
        packs[p] = TapPack(*pack_tap_active(occ3, counts[p]))
        continue
      if spatial:
        continue   # spatial conv routed 'matmul' / without a static count
      packs[p] = block_entry(m, self.block, counts.get(p))
    return packs or None

  def static_block_counts(self) -> Dict[str, int]:
    """Per-layer active-block counts invariant through training: drop/grow
    removes floor(drop_fraction * n_ones) blocks and grows as many, so
    block-granular masks of the drop/grow family keep their counts.  Empty
    where the invariant does not hold (element masks, count-changing
    algorithms)."""
    if self.block is None or self.mask_generator is not None:
      return {}
    if self.algo.name not in ('set', 'rigl', 'rigl_inverted', 'static',
                              'scratch'):
      return {}
    out: Dict[str, int] = {}
    for p, shape in self.layer_shapes.items():
      if self._layer_block(shape) is None:
        continue
      n_blocks = self._n_blocks(shape)
      n_zeros = distributions.get_n_zeros(n_blocks, self.sparsities[p])
      out[p] = n_blocks - n_zeros
    return out

  # ------------------------------------------------------------- internals --
  def _apply(self, grads: Params, params: Params,
             optimizer: torch.optim.Optimizer):
    """One optimizer step with `grads` as the parameters' gradients, in
    place."""
    for p, t in params.items():
      g = grads.get(p)
      t.grad = None if g is None else g.detach().to(t.dtype)
    optimizer.step()
    for t in params.values():
      t.grad = None
    return params, optimizer

  def _drop_noise(self, step: int, layer_idx: int, path: str, mask, w):
    """Tie-breaking noise added to the |mask*w| drop score
    (sparse_optimizers_base.py:264-270).  A seam: a replay overrides it
    (and _grow_score) to inject recorded draws."""
    gen = self._generator(mask.device, step, layer_idx, 0)
    return (torch.randn(mask.shape, generator=gen, device=mask.device)
            * self.algo.noise_std)

  def _grow_score(self, algo: algorithms.Algorithm, path: str, mask,
                  weights, dense_grad, ema_grad,
                  generator: torch.Generator) -> torch.Tensor:
    name = algo.name
    if name == 'set':
      return torch.rand(mask.shape, generator=generator, device=mask.device)
    if name == 'rigl':
      return dense_grad.abs()
    if name == 'rigl_inverted':
      return -dense_grad.abs()
    if name == 'static':
      return mask.to(torch.float32)
    if name == 'momentum':
      return ema_grad.abs()
    raise ValueError(f'{name} has no drop/grow update')

  def _reset_slots(self, optimizer: torch.optim.Optimizer, params: Params,
                   conn: MaskDict, vals: MaskDict):
    """Every parameter-shaped optimizer slot of a masked parameter takes
    `vals` where `conn` (optax's tree_map_params reset).  Slots that optax
    holds from `init` but torch creates at the first step are created here
    first, as that step would: SGD's momentum buffer, Adam's state.  SGD
    without momentum has no slot, in either package, and is left alone."""
    for path, c in conn.items():
      t = params[path]
      state = optimizer.state[t]
      if not state:
        group = next(g for g in optimizer.param_groups
                     if any(q is t for q in g['params']))
        if isinstance(optimizer, torch.optim.SGD) and group['momentum']:
          state['momentum_buffer'] = torch.zeros_like(t)
        elif isinstance(optimizer, torch.optim.Adam):
          state.update(_adam_state(t, group))
        elif self.algo.initial_acc_scale and not isinstance(
            optimizer, torch.optim.SGD):
          raise NotImplementedError(
              'initial_acc_scale needs the optimizer state of '
              f'{type(optimizer).__name__} before its first step')
      for key, slot in state.items():
        if torch.is_tensor(slot) and slot.shape == t.shape:
          slot.copy_(torch.where(c, vals[path].to(slot.dtype), slot))

  def _drop_grow_all(self, params: Params, optimizer, sstate: SparseState,
                     dense_grads: Params, drop_fraction,
                     ema: Optional[MaskDict]) -> MaskDict:
    """Runs the drop/grow update on every masked layer, writes the new
    weights into `params` and resets the grown slots; returns the masks."""
    algo = self.algo
    masks = sstate.masks
    step = sstate.step
    new_masks: MaskDict = {}
    new_conn: MaskDict = {}
    reset_vals: MaskDict = {}
    with torch.no_grad():
      for i, path in enumerate(masks):
        mask, w, g = masks[path], params[path].detach(), dense_grads[path]
        noise = self._drop_noise(step, i, path, mask, w)
        score_drop = (mask.to(w.dtype) * w).abs() + noise
        score_grow = self._grow_score(
            algo, path, mask, w, g, None if ema is None else ema[path],
            self._generator(mask.device, step, i, 1))
        grow_tensor = update_lib.grow_init_tensor(
            algo.grow_init, self._generator(mask.device, step, i, 2), w,
            masked_grad=g,
            initial_weights=(None if sstate.initial_weights is None
                             else sstate.initial_weights[path]))
        blk = self._layer_block(mask.shape)
        if blk is not None:
          from rigl_tpu_torch.ops.block_mask import blockwise_drop_grow
          res = blockwise_drop_grow(
              mask, w, score_drop, score_grow, drop_fraction, blk,
              grow_tensor=grow_tensor,
              reinit_when_same=algo.reinit_when_same)
        else:
          res = update_lib.drop_grow_update(
              mask, w, score_drop, score_grow, drop_fraction,
              grow_tensor=grow_tensor,
              reinit_when_same=algo.reinit_when_same)
        new_masks[path] = res.mask
        if self.premask_params:
          # Pre-masked storage: zero dropped connections' weights and
          # slots (stale momentum would walk them off zero).
          dropped = (mask > 0) & (res.mask == 0)
          new_w = res.weights * res.mask.to(res.weights.dtype)
          new_conn[path] = res.new_connections | dropped
          reset_vals[path] = torch.where(
              dropped, torch.zeros_like(g), g * algo.initial_acc_scale)
        else:
          new_w = res.weights
          new_conn[path] = res.new_connections
          reset_vals[path] = g * algo.initial_acc_scale
        params[path].copy_(new_w)
      self._reset_slots(optimizer, params, new_conn, reset_vals)
    return new_masks

  def _remask_by_score(self, scores: MaskDict) -> MaskDict:
    """Per-layer top-k remask at the configured sparsity targets."""
    return {path: update_lib.prune_to_sparsity(score, self.sparsities[path],
                                               self.mask_dtype)
            for path, score in scores.items()}

  def one_shot_prune(self, params: Params, sstate: SparseState,
                     pruning_rate=None) -> SparseState:
    """Magnitude-prunes masks to the target rate in one shot: per layer,
    keep the largest |mask * w|; `pruning_rate` is a float for all layers
    or a {path: rate} dict; defaults to the per-layer sparsities."""
    new_masks: MaskDict = {}
    for path, mask in sstate.masks.items():
      if pruning_rate is None:
        rate = self.sparsities[path]
      elif isinstance(pruning_rate, dict):
        rate = pruning_rate.get(path, 0.0)
      else:
        rate = float(pruning_rate)
      score = (mask.to(torch.float32) * params[path].detach()).abs()
      new_masks[path] = update_lib.prune_to_sparsity(score, rate,
                                                     self.mask_dtype)
    return sstate.replace(masks=new_masks)

  # ------------------------------------------------------------------ step --
  def predict_update_iters(self, n_steps: int, start_step: int = 0,
                           start_last: Optional[int] = None):
    """Which of the next `n_steps` iterations are mask-update iterations:
    the schedule is deterministic in (step, last_update_step).  Mirrors
    step()'s gating; returns a list of bools."""
    algo = self.algo
    sched = getattr(algo, 'schedule', None)
    if algo.name == 'snip':
      return [start_step == 0] + [False] * (n_steps - 1)
    if sched is None or algo.name in ('none', 'scratch', 'dnw'):
      return [algo.name == 'dnw'] * n_steps
    step = start_step
    last = (start_last if start_last is not None
            else int(sched.initial_last_update_step))
    out = []
    for _ in range(n_steps):
      if algo.name == 'prune' or not algo.skip_apply_on_update:
        step += 1
        upd = sched.is_update_iter(step, last)
        if upd:
          last = step
      else:
        upd = sched.is_update_iter(step, last)
        if upd:
          last = step
        else:
          step += 1
      out.append(upd)
    return out

  @staticmethod
  def _branch(truth: bool, update_hint: Optional[bool], metrics) -> bool:
    """The branch to take: the hint where given (recording whether it
    matched the schedule), else the schedule's value."""
    if update_hint is None:
      return truth
    metrics['update_hint_ok'] = truth == bool(update_hint)
    return bool(update_hint)

  def step(self, params: Params, optimizer: torch.optim.Optimizer,
           sstate: SparseState, dense_grads: Params,
           grow_grads_fn=None, update_hint: Optional[bool] = None
           ) -> Tuple[Params, torch.optim.Optimizer, SparseState,
                      Dict[str, Any]]:
    """One training iteration: gradient application and/or mask update.

    `dense_grads`: gradients of the loss w.r.t. the effective (masked)
    parameters, dense at masked entries.  `grow_grads_fn` (optional):
    params -> dense grads used for grow scores only, called in the
    mask-update branch.  `update_hint` (optional): the caller's prediction
    (predict_update_iters) of whether this is an update iteration; it
    picks the branch, and metrics['update_hint_ok'] says whether it was
    right.  `params` and `optimizer` are updated in place."""
    algo = self.algo
    masks = sstate.masks
    train_grads = (dense_grads if algo.dense_gradients
                   else masks_lib.mask_grads(dense_grads, masks))
    # SNFS: the EMA of dense gradients advances every step, before apply.
    ema = sstate.ema_grads
    if algo.needs_ema:
      m = algo.momentum
      ema = {p: m * ema[p] + (1.0 - m) * dense_grads[p].to(torch.float32)
             for p in ema}
    metrics: Dict[str, Any] = {}

    if algo.name in ('none', 'scratch'):
      self._apply(train_grads, params, optimizer)
      metrics['mask_updated'] = False
      return params, optimizer, sstate.replace(step=sstate.step + 1), metrics

    if algo.name == 'snip':
      do_snip = sstate.step == 0 and not sstate.is_snipped
      metrics['mask_updated'] = do_snip
      if self._branch(do_snip, update_hint, metrics):
        saliency = {p: (dense_grads[p] * params[p].detach()).abs()
                    for p in masks}
        new_masks = self._remask_by_score(saliency)
        new = sstate.replace(masks=new_masks, is_snipped=True,
                             block_packs=self._compute_packs(new_masks))
      else:
        self._apply(train_grads, params, optimizer)
        new = sstate.replace(step=sstate.step + 1)
      return params, optimizer, new, metrics

    if algo.name == 'dnw':
      # Dense gradient step, then re-mask by |w| every iteration.
      self._apply(train_grads, params, optimizer)
      new_masks = self._remask_by_score(
          {p: params[p].detach().abs() for p in masks})
      metrics['mask_updated'] = True
      return params, optimizer, sstate.replace(
          masks=new_masks, step=sstate.step + 1,
          block_packs=self._compute_packs(new_masks)), metrics

    if algo.name == 'prune':
      # Gradient step always; magnitude prune on the polynomial schedule.
      sched = algo.schedule
      self._apply(train_grads, params, optimizer)
      step_after = sstate.step + 1
      is_update = sched.is_update_iter(step_after, sstate.last_update_step)
      metrics['mask_updated'] = is_update
      new = sstate.replace(step=step_after)
      if self._branch(is_update, update_hint, metrics):
        t = torch.clamp(
            torch.tensor(step_after - sched.begin_step, dtype=torch.float32)
            / max(sched.end_step - sched.begin_step, 1), 0.0, 1.0)
        out: MaskDict = {}
        for path in masks:
          w = params[path].detach()
          final_s = self.sparsities[path]
          s_t = final_s + (algo.initial_sparsity - final_s) * (
              (1.0 - t) ** algo.power)
          n_keep = int(torch.round((1.0 - s_t) * w.numel()))
          out[path] = update_lib.topk_mask_from_scores(
              w.abs(), n_keep, self.mask_dtype).reshape(w.shape)
        new = new.replace(masks=out, last_update_step=step_after,
                          block_packs=self._compute_packs(out))
      return params, optimizer, new, metrics

    # --- drop/grow family: SET / RigL / RigLInverted / Static / SNFS -------
    sched = algo.schedule
    if algo.skip_apply_on_update:
      # RigL: the mask update replaces the gradient step and the step
      # counter does not advance.
      is_update = sched.is_update_iter(sstate.step, sstate.last_update_step)
      drop_fraction = sched.get_drop_fraction(sstate.step)
      if self._branch(is_update, update_hint, metrics):
        score_grads = (grow_grads_fn(params) if grow_grads_fn is not None
                       else dense_grads)
        new_masks = self._drop_grow_all(params, optimizer, sstate,
                                        score_grads, drop_fraction, ema)
        new = sstate.replace(masks=new_masks, last_update_step=sstate.step,
                             block_packs=self._compute_packs(new_masks))
      else:
        self._apply(train_grads, params, optimizer)
        new = sstate.replace(step=sstate.step + 1)
    else:
      # SET family: the gradient step always applies; the mask update
      # fires afterwards, gated on the post-increment step.
      self._apply(train_grads, params, optimizer)
      new_step = sstate.step + 1
      is_update = sched.is_update_iter(new_step, sstate.last_update_step)
      drop_fraction = sched.get_drop_fraction(new_step)
      new = sstate.replace(step=new_step)
      if self._branch(is_update, update_hint, metrics):
        score_grads = (grow_grads_fn(params) if grow_grads_fn is not None
                       else dense_grads)
        new_masks = self._drop_grow_all(params, optimizer, new, score_grads,
                                        drop_fraction, ema)
        new = new.replace(masks=new_masks, last_update_step=new_step,
                          block_packs=self._compute_packs(new_masks))
    metrics['mask_updated'] = is_update
    metrics['drop_fraction'] = drop_fraction
    return params, optimizer, new.replace(ema_grads=ema), metrics
