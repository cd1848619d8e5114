"""Causal-LM training on PACKED block-sparse transformer storage, in PyTorch.

Counterpart of rigl_tpu/train/packed_lm.py on one device.  Every parameter
matmul of the model (fused QKV, attention out-projection, both FFN
matmuls) keeps its float32 master weights, gradients and Adam slots as
`(n_active, bk, bn)` packed blocks; drop/grow runs on that storage
(transforms/packed_training.py).  Embedding, LayerNorms and the untied head
stay dense.  The model computes in `dtype` (bfloat16 on the card, through
the packed kernels) from float32 parameters, as the JAX trainer does.

The semantics are the JAX trainer's:
  * Adam with a linear warmup from 0 (optax.adam(linear_schedule(0, lr,
    warmup))): the schedule is read at the optimizer's count BEFORE it
    advances, so the first step has learning rate 0.  torch.optim.Adam and
    optax agree on bias correction and eps outside the sqrt.
  * RigL: a mask-update iteration consumes a batch, applies no gradient and
    advances neither the step nor the optimizer's count; grow scores are
    pooled |dense grads| through the dense twin.  SET (random grow) and
    SNFS (|EMA of pooled signed dense grads|, advanced at updates) apply
    the gradient step, then update.
  * The batch sampler is numpy RandomState((seed * 1000003 + batches_seen)
    % 2**31), so both packages see the same batches.
  * Checkpoints use JAX's packed_lm_state.npz layout (`save`, `restore`).

With n_experts > 0 every block's FFN is a Switch top-1 MoE whose expert
kernels are expert-stacked packed storage (models/packed_moe.py): the loss
adds aux_loss_weight times the sum of every layer's load-balance aux, the
drop/grow runs per expert, checkpoints hold (E, nk, nn) occupancy grids,
and generation routes drop-free.  As in JAX, the dense-twin grads that
score RigL's and SNFS's growth are those of the cross-entropy alone.

Random initialisation draws from a torch generator, not JAX's keys: to
start from a JAX trainer's state use convert.packed_lm_trainer_from_jax.
SET's grow scores come from a torch generator seeded with (seed, step), not
JAX's fold_in bits.  Parallel fields of the config (n_data, n_model,
n_pipe, n_seq, n_expert) raise NotImplementedError unless at their
single-device values; n_experts > 0 with n_model, n_pipe or n_seq above 1
raises ValueError, as in JAX.

Used by drivers/packed_lm.py and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from rigl_tpu_torch.layers.packed_dense import PackedDense
from rigl_tpu_torch.models.packed_moe import (DenseMoETransformer,
                                              PackedMoETransformer,
                                              _PackedExperts,
                                              moe_layer_shapes)
from rigl_tpu_torch.models.packed_transformer import (DenseTransformer,
                                                      PackedTransformer,
                                                      transformer_layer_shapes)
from rigl_tpu_torch.ops.block_sparse_packed import make_packing, unpack_dense
from rigl_tpu_torch.parallel import packed_ep as ep
from rigl_tpu_torch.serve.decode import decode_twin, make_generate_fn
from rigl_tpu_torch.sparsity.layer_sparsity import spec_for_model
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.transforms import packed_training as pt

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass
class PackedLMConfig:
  vocab_size: int = 256                  # byte-level by default
  num_layers: int = 2
  d_model: int = 256
  d_ff: int = 1024
  num_heads: int = 8
  seq_len: int = 128
  sparsity: float = 0.8
  sparsity_distribution: str = 'uniform'
  erk_power_scale: float = 1.0
  block: Tuple[int, int] = (16, 16)
  bm: int = 128
  dtype: str = 'float32'                 # 'bfloat16' on the card
  learning_rate: float = 1e-3
  warmup_steps: int = 50
  train_steps: int = 1000
  batch_size: int = 8
  maskupdate_begin_step: int = 0
  maskupdate_end_step: int = 750
  maskupdate_frequency: int = 100
  drop_fraction: float = 0.3
  drop_fraction_anneal: str = 'cosine'
  seed: int = 0
  algo: str = 'rigl'                     # rigl | set | snfs
  snfs_momentum: float = 0.9
  # Parallel layouts of the JAX trainer: single-device values only here.
  # n_experts > 0: every block's FFN is a top-1 MoE of that many experts.
  n_data: int = 1
  n_model: int = 1
  n_pipe: int = 1
  n_micro: int = 0
  n_seq: int = 1
  n_experts: int = 0
  capacity_factor: float = 2.0
  aux_loss_weight: float = 0.01
  n_expert: int = 1

  def model_kwargs(self) -> Dict[str, Any]:
    kw = dict(num_layers=self.num_layers, d_model=self.d_model,
              d_ff=self.d_ff, num_heads=self.num_heads,
              vocab_size=self.vocab_size, dtype=_DTYPES[self.dtype])
    if self.n_experts > 0:
      kw.update(num_experts=self.n_experts,
                capacity_factor=self.capacity_factor)
    return kw


def dense_twin_params(params: Dict[str, torch.Tensor], packings,
                      block: Tuple[int, int]) -> Dict[str, torch.Tensor]:
  """Packed state {name: tensor} -> the dense twin's state: each packed
  kernel '<layer>.kernel' unpacked to its dense (in, out) matrix, or an
  expert stack to its (E, in, out) matrices (zeros at inactive blocks), at
  '<layer>.d.kernel'; other entries shared."""
  out = {}
  for name, value in params.items():
    if name in packings:
      layer = name.rsplit('.', 1)[0]
      unpack = (ep.unpack_dense_experts
                if ep.is_expert_stacked(packings[name]) else unpack_dense)
      out[f'{layer}.d.kernel'] = unpack(value, packings[name], block)
    else:
      out[name] = value
  return out


def _lm_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Mean next-token cross-entropy of f32 logits (B, S, V) at labels y."""
  logp = torch.log_softmax(logits.float(), dim=-1)
  return -logp.gather(-1, y.long()[..., None]).mean()


class PackedLMTrainer:
  """Packed-transformer causal-LM training: init / step / update / eval /
  generate / checkpoint, on `device` (the card unless the caller names
  another)."""

  def __init__(self, cfg: PackedLMConfig, device='cuda'):
    if (cfg.d_model % cfg.block[0] or cfg.d_model % cfg.block[1]
        or cfg.d_ff % cfg.block[0] or cfg.d_ff % cfg.block[1]):
      raise ValueError(f'd_model={cfg.d_model} and d_ff={cfg.d_ff} must '
                       f'divide block {cfg.block}')
    if cfg.algo not in ('rigl', 'set', 'snfs'):
      raise ValueError(f'algo must be rigl/set/snfs, got {cfg.algo!r}')
    if cfg.dtype not in _DTYPES:
      raise ValueError(f'dtype must be float32 or bfloat16: {cfg.dtype!r}')
    if cfg.n_experts > 0 and (cfg.n_model > 1 or cfg.n_pipe > 1
                              or cfg.n_seq > 1):
      raise ValueError('n_experts>0 composes with n_data/n_expert only')
    for name in ('n_data', 'n_model', 'n_pipe', 'n_seq', 'n_expert'):
      if getattr(cfg, name) != 1:
        raise NotImplementedError(f'{name}={getattr(cfg, name)}: only the '
                                  'single-device value 1 is ported')
    self.cfg = cfg
    self.device = torch.device(device)
    shapes = (moe_layer_shapes(cfg.d_model, cfg.d_ff, cfg.n_experts)
              if cfg.n_experts > 0
              else transformer_layer_shapes(cfg.d_model, cfg.d_ff))
    self.sparsity_spec = spec_for_model(
        shapes, cfg.sparsity_distribution, cfg.sparsity,
        erk_power_scale=cfg.erk_power_scale)
    self.schedule = UpdateSchedule(
        cfg.maskupdate_begin_step, cfg.maskupdate_end_step,
        cfg.maskupdate_frequency, cfg.drop_fraction,
        cfg.drop_fraction_anneal)
    self.last_update_step = self.schedule.initial_last_update_step
    self.model: Optional[PackedTransformer] = None
    self.dense_twin: Optional[DenseTransformer] = None
    self.optimizer: Optional[torch.optim.Adam] = None
    self.opt_count = 0          # optax's count: optimizer steps taken
    self.ema_grids = None
    self.step = 0
    self.batches_seen = 0

  # ------------------------------------------------------------- state ----
  def init_state(self):
    """A fresh model (occupancy and weights from a torch generator seeded
    with cfg.seed), zero Adam slots at count 0, counters at 0."""
    cfg = self.cfg
    gen = torch.Generator().manual_seed(cfg.seed)
    moe = cfg.n_experts > 0
    packed = PackedMoETransformer if moe else PackedTransformer
    self.model = packed(sparsity=self.sparsity_spec, block=cfg.block,
                        bm=cfg.bm, generator=gen, device=self.device,
                        **cfg.model_kwargs())
    # Only its structure is used: the dense-view grads run it through
    # functional_call on dense views of the packed state.
    dense = DenseMoETransformer if moe else DenseTransformer
    self.dense_twin = dense(device='meta', **cfg.model_kwargs())
    names = sorted(self.params, key=pt.path_key)
    self.optimizer = torch.optim.Adam([self.params[n] for n in names],
                                      lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    for p in self.optimizer.param_groups[0]['params']:
      self.optimizer.state[p].update(
          step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
          exp_avg_sq=torch.zeros_like(p))
    self.opt_count = 0
    self.ema_grids = (pt.init_snfs_ema_grids(self.packings, self.device)
                      if cfg.algo == 'snfs' else None)
    self.step = 0
    self.batches_seen = 0
    self.last_update_step = self.schedule.initial_last_update_step

  @property
  def params(self) -> Dict[str, torch.Tensor]:
    """{dotted name: parameter}: packed kernels and every dense leaf."""
    return dict(self.model.named_parameters())

  def _packed_layers(self) -> Dict[str, PackedDense]:
    return {f'{name}.kernel': mod for name, mod in self.model.named_modules()
            if isinstance(mod, (PackedDense, _PackedExperts))}

  @property
  def packings(self):
    """{name of a packed kernel: its Packing (an ExpertPacking for an
    expert stack)}."""
    return {name: mod.packing for name, mod in self._packed_layers().items()}

  def _set_packings(self, packings):
    for name, mod in self._packed_layers().items():
      mod.set_packing(packings[name])

  def adam_slots(self) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """({name: exp_avg}, {name: exp_avg_sq}): optax's mu and nu."""
    st = self.optimizer.state
    params = self.params
    return ({n: st[p]['exp_avg'] for n, p in params.items()},
            {n: st[p]['exp_avg_sq'] for n, p in params.items()})

  def load_arrays(self, step: int, last_update_step: int, batches_seen: int,
                  occupancy, params, mu, nu, count: int, ema=None):
    """Sets the whole training state from numpy arrays keyed by dotted
    names: counters, each packed kernel's (nk, nn) occupancy, or an expert
    stack's (E, nk, nn) (rebuilt as a packing), every parameter, Adam's
    mu / nu and count, and (SNFS) the EMA grids.  Parameters and slots are
    copied in place."""
    if self.optimizer is None:
      self.init_state()
    self.step, self.batches_seen = int(step), int(batches_seen)
    self.last_update_step = int(last_update_step)
    self.opt_count = int(count)
    cur = self.params

    def packing(name, old):
      occ = torch.as_tensor(np.array(occupancy[name]))
      if ep.is_expert_stacked(old):
        return ep.expert_packing_from_occ(occ, int(cur[name].shape[1]))
      return make_packing(occ, int(cur[name].shape[0]))

    self._set_packings({name: packing(name, old)
                        for name, old in self.packings.items()})
    with torch.no_grad():
      for name, p in cur.items():
        p.copy_(torch.as_tensor(np.array(params[name])))
        st = self.optimizer.state[p]
        st['exp_avg'].copy_(torch.as_tensor(np.array(mu[name])))
        st['exp_avg_sq'].copy_(torch.as_tensor(np.array(nu[name])))
        st['step'] = torch.tensor(float(self.opt_count))
    if self.ema_grids is not None and ema is not None:
      self.ema_grids = {name: torch.as_tensor(np.array(ema[name]),
                                              dtype=torch.float32,
                                              device=self.device)
                        for name in self.ema_grids}

  # -------------------------------------------------------------- steps ----
  def learning_rate(self, count: int) -> float:
    """optax.linear_schedule(0, lr, max(warmup, 1)) at `count`, in f32."""
    w = max(self.cfg.warmup_steps, 1)
    frac = np.float32(1.0) - np.float32(min(max(count, 0), w)) / np.float32(w)
    lr = np.float32(self.cfg.learning_rate)
    return float(np.float32(-lr) * frac + lr)

  def _loss(self, x, y) -> torch.Tensor:
    """Mean cross-entropy, plus aux_loss_weight times the summed
    load-balance aux of the MoE layers."""
    if self.cfg.n_experts > 0:
      logits, aux = self.model(x, with_aux=True)
      return _lm_loss(logits, y) + self.cfg.aux_loss_weight * aux
    return _lm_loss(self.model(x), y)

  def train_step(self, x, y) -> float:
    """One Adam step on (x, y); the learning rate is the schedule's value
    at the count before this step."""
    lr = self.learning_rate(self.opt_count)
    for group in self.optimizer.param_groups:
      group['lr'] = lr
    self.optimizer.zero_grad(set_to_none=True)
    loss = self._loss(x, y)
    loss.backward()
    self.optimizer.step()
    self.opt_count += 1
    return float(loss.detach())

  def train_chunk(self, xs, ys) -> float:
    """xs / ys: (k, batch, seq): k consecutive train_steps (JAX runs them
    as one lax.scan); returns the last loss.  Counters advance in train()."""
    loss = float('nan')
    for x, y in zip(xs, ys):
      loss = self.train_step(x, y)
    return loss

  def is_update_step(self, step: int) -> bool:
    return bool(self.schedule.is_update_iter(step, self.last_update_step))

  def _dense_twin_grads(self, x, y) -> Dict[str, torch.Tensor]:
    """Dense gradients (inactive blocks included) of every packed kernel,
    through the dense twin holding dense views of the packed state: the
    grow-score input of RigL and SNFS.  The loss is the cross-entropy
    alone, without the MoE aux, as JAX's _dense_twin_grads takes it."""
    params = {n: p.detach() for n, p in self.params.items()}
    packings = self.packings
    views = dense_twin_params(params, packings, self.cfg.block)
    leaves = {}
    for name in packings:
      key = f'{name.rsplit(".", 1)[0]}.d.kernel'
      views[key] = leaves[name] = views[key].requires_grad_()
    loss = _lm_loss(functional_call(self.dense_twin, views, (x,)), y)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))

  def _set_generator(self) -> torch.Generator:
    """SET's per-update generator: stateless in (seed, step), like JAX's
    fold_in(key(seed), step)."""
    gen = torch.Generator(device=self.device)
    return gen.manual_seed(self.cfg.seed * 1000003 + self.step)

  def mask_update(self, x, y) -> Dict[str, np.ndarray]:
    """Drop/grow on every packed kernel, in place.  Drop scores are the
    packed block |w| sums; grow scores are RigL's pooled |dense grad|,
    SET's uniform random draws, or SNFS's |EMA of pooled dense grads| (the
    EMA advanced here).  Returns the new occupancy grids."""
    cfg = self.cfg
    df = self.schedule.get_drop_fraction(self.step)
    params, packings = self.params, self.packings
    if cfg.algo == 'set':
      out = pt.flax_packed_drop_grow(
          params, packings, self.optimizer,
          pt.flax_set_grow_grids(packings, self._set_generator()), df)
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
  def evaluate(self, tokens: np.ndarray, max_windows: int = 64) -> float:
    """Mean next-token cross-entropy (nats/token) over non-overlapping
    seq_len+1 windows of the eval stream."""
    cfg = self.cfg
    w = cfg.seq_len + 1
    n = min(len(tokens) // w, max_windows)
    if n == 0:
      return float('nan')
    wins = np.asarray(tokens[:n * w], np.int32).reshape(n, w)
    total, count = 0.0, 0
    with torch.no_grad():
      for i in range(0, n, cfg.batch_size):
        chunk = torch.as_tensor(wins[i:i + cfg.batch_size]).to(self.device)
        x, y = chunk[:, :-1], chunk[:, 1:]
        total += float(self._loss(x, y)) * x.shape[0]
        count += int(x.shape[0])
    return total / count

  def generate(self, prompt_tokens, steps: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, prompt_lens=None,
               seed: int = 0, max_len: int = 0,
               kv_chunk: int = 0) -> np.ndarray:
    """Autoregressive generation from the current packed weights through
    serve/decode.py (KV cache; the decode twin shares this trainer's
    modules).  prompt_tokens: (P,) or (B, P) ints; returns (B, steps)
    int32.  With kv_chunk the cache length rounds up to a multiple of the
    chunk.  Sampling draws from a torch generator seeded with `seed`."""
    if self.optimizer is None:
      self.init_state()
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int32))
    if prompt.dim() == 1:
      prompt = prompt[None]
    L = max_len or (int(prompt.shape[1]) + steps)
    if kv_chunk > 0:
      L = -(-L // kv_chunk) * kv_chunk
    fn = make_generate_fn(decode_twin(self.model, L, kv_chunk), steps,
                          temperature, top_k, top_p)
    gen = torch.Generator(device=self.device).manual_seed(seed)
    lens = (None if prompt_lens is None
            else torch.as_tensor(np.asarray(prompt_lens, np.int32)))
    out = fn(prompt.to(self.device), gen, lens)
    return out.cpu().numpy()

  # ---------------------------------------------------------------- loop ----
  def sample_batch(self, tokens: np.ndarray):
    """Seeded random windows, replayable across resume (batches_seen is
    checkpointed); int32 (x, y) on the trainer's device."""
    cfg = self.cfg
    rs = np.random.RandomState(
        (cfg.seed * 1000003 + self.batches_seen) % (2 ** 31))
    starts = rs.randint(0, len(tokens) - cfg.seq_len - 1,
                        size=cfg.batch_size)
    self.batches_seen += 1
    wins = np.stack([tokens[s:s + cfg.seq_len + 1] for s in starts]
                    ).astype(np.int32)
    wins = torch.as_tensor(wins).to(self.device)
    return wins[:, :-1], wins[:, 1:]

  def train(self, train_tokens: np.ndarray, eval_tokens=None,
            progress_fn=None, log_every: int = 0, steps_per_loop: int = 1,
            eval_windows: int = 64) -> Dict[str, Any]:
    """The JAX trainer's loop: RigL updates replace a step, SET / SNFS
    updates follow one; steps_per_loop > 1 runs runs of plain steps through
    train_chunk, broken at update iterations, with the same batches."""
    cfg = self.cfg
    if self.optimizer is None:
      self.init_state()
    n_updates = 0
    loss = float('nan')
    while self.step < cfg.train_steps:
      if cfg.algo == 'rigl' and self.is_update_step(self.step):
        x, y = self.sample_batch(train_tokens)
        self.mask_update(x, y)
        n_updates += 1
        continue
      k = 1
      while (steps_per_loop > 1 and k < steps_per_loop
             and self.step + k < cfg.train_steps
             and not self.schedule.is_update_iter(self.step + k,
                                                  self.last_update_step)):
        k += 1
      batches = [self.sample_batch(train_tokens) for _ in range(k)]
      loss = self.train_chunk([b[0] for b in batches],
                              [b[1] for b in batches])
      x, y = batches[-1]
      crossed = (self.step + k) // log_every - self.step // log_every \
          if log_every else 0
      self.step += k
      if cfg.algo != 'rigl' and self.is_update_step(self.step):
        self.mask_update(x, y)
        n_updates += 1
      if crossed and progress_fn:
        progress_fn({'step': self.step, 'loss': loss})
    params, packings = self.params, self.packings
    result = {'train_steps': self.step, 'mask_updates': n_updates,
              'batches': self.batches_seen, 'final_loss': loss,
              'sparsity': cfg.sparsity,
              'n_params_packed': sum(params[n].numel() for n in packings),
              'n_params_dense_equiv': sum(
                  pk.shape[0] * pk.shape[1] * cfg.block[0] * cfg.block[1]
                  for pk in packings.values())}
    if eval_tokens is not None:
      ce = self.evaluate(np.asarray(eval_tokens), max_windows=eval_windows)
      result['eval_ce_nats'] = ce
      result['eval_ppl'] = float(np.exp(min(ce, 30.0)))
    return result

  # ----------------------------------------------------------------- ckpt ----
  def _opt_leaves(self):
    """optax's adam + schedule state in jax.tree.flatten order: the adam
    count, mu and nu (each in path order), the schedule count."""
    mu, nu = self.adam_slots()
    names = sorted(mu, key=pt.path_key)
    count = np.asarray(self.opt_count, np.int32)
    return ([count] + [mu[n] for n in names] + [nu[n] for n in names]
            + [count]), names

  def save(self, path: str):
    """JAX's packed_lm_state.npz: counters, occupancy grids ((E, nk, nn)
    for an expert stack; packings rebuild from them), params, SNFS EMA
    grids, optimizer leaves."""
    os.makedirs(path, exist_ok=True)
    flat = {'step': np.asarray(self.step),
            'last_update': np.asarray(self.last_update_step),
            'batches_seen': np.asarray(self.batches_seen)}
    slash = lambda name: name.replace('.', '/')   # noqa: E731
    for name, pk in self.packings.items():
      occ = (ep.expert_occupancy_grid(pk) if ep.is_expert_stacked(pk)
             else pt.occupancy_grid(pk))
      flat['occ_' + slash(name)] = occ.numpy()
    for name, p in self.params.items():
      flat['param_' + slash(name)] = p.detach().cpu().numpy()
    if self.ema_grids is not None:
      for name, g in self.ema_grids.items():
        flat['ema_' + slash(name)] = g.cpu().numpy()
    leaves, _ = self._opt_leaves()
    for i, leaf in enumerate(leaves):
      flat[f'opt_{i}'] = (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                          else leaf)
    np.savez(os.path.join(path, 'packed_lm_state.npz'), **flat)

  def restore(self, path: str) -> bool:
    f = os.path.join(path, 'packed_lm_state.npz')
    if not os.path.exists(f):
      return False
    if self.optimizer is None:
      self.init_state()
    slash = lambda name: name.replace('.', '/')   # noqa: E731
    _, names = self._opt_leaves()
    n = len(names)
    with np.load(f) as z:
      self.load_arrays(
          int(z['step']), int(z['last_update']), int(z['batches_seen']),
          {name: z['occ_' + slash(name)] for name in self.packings},
          {name: z['param_' + slash(name)] for name in self.params},
          {name: z[f'opt_{1 + i}'] for i, name in enumerate(names)},
          {name: z[f'opt_{1 + n + i}'] for i, name in enumerate(names)},
          int(z['opt_0']),
          None if self.ema_grids is None else
          {name: z['ema_' + slash(name)] for name in self.ema_grids})
    return True
