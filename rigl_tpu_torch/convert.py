"""From the JAX package's variables to the port's modules.

`from_jax_variables(tree)` takes the flax variable tree of a model of
models/packed_transformer.py, models/packed_moe.py or
models/packed_convnet.py ({'params': ...,
'packing': ...}, with its arrays mapped to numpy) and returns the port's
state dict plus its packings.  Module names in the port follow the flax
paths, so a parameter's key is its flax path joined with dots.  The port
keeps flax's layouts, so no array is transposed: Dense kernels (in, out)
(`x @ kernel`), conv kernels HWIO (a depthwise kernel (3, 3, 1, C)),
GroupNorm's and LayerNorm's scale and bias (C,); the conv modules permute
to torch's OIHW on each call.  Packed kernels are taken as they are: both
packages store (n_active, bk, bn) in the same column-major slot order.

Packing leaves are duck-typed through p['fwd'], p['bwd'] and p['shape'],
so this module needs nothing from the JAX package.  Lists with a leading
axis are an MoE layer's expert stack (JAX's ExpertPacking; its tensor-
parallel stacking is not ported) and become the port's ExpertPacking.

`packed_mlp_trainer_from_jax(config, state)` builds the port's
PackedMLPTrainer from a JAX PackedMLPTrainer's state passed as numpy
arrays (params, occupancy grids, momentum traces, counters);
`packed_lm_trainer_from_jax` does the same for PackedLMTrainer (params,
occupancy grids, (E, nk, nn) for the MoE's expert stacks, Adam's slots and
counts, counters, SNFS's EMA grids), and
`packed_classifier_trainer_from_jax` for PackedClassifierTrainer (params,
occupancy grids, momentum traces, counters, SNFS's EMA grids).

`load_jax_variables(model, variables)` copies the variables of a model of
the JAX zoo (models/registry.py: params, batch_stats and the masked
layers' masks, as numpy) into the port's model of the same name, by path.

`train_state_from_jax(model, st, state)` turns a JAX dense-masked
TrainState (rigl_tpu/train/train_state.py: params, batch_stats, the optax
momentum trace or Adam's slots and the SparseState with its block_packs,
as numpy) into the port's, so both packages can run from one state;
`trainer_state_from_jax(trainer, state)` loads a JAX Trainer's TrainState
into the port's Trainer (train/trainer.py).

`dqn_state_from_jax(agent, state)`, `ppo_state_from_jax` and
`sac_state_from_jax` carry a JAX RL agent's state (rigl_tpu/rl: params,
target params and masks, Adam's slots, the SparseState, the replay's
contents, cursor and size, the env's obs, done and t, the counters) into
the port's agent of the same config (rigl_tpu_torch/rl).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

from rigl_tpu_torch.ops.block_sparse_packed import Packing, unpack_dense
from rigl_tpu_torch.parallel import packed_ep as ep


def _packing_leaf(node):
  if isinstance(node, Mapping) and set(node.keys()) != {'fwd', 'bwd',
                                                        'shape'}:
    return None
  try:
    fwd, bwd, shape = node['fwd'], node['bwd'], node['shape']
  except (KeyError, TypeError, IndexError):
    return None
  as_t = lambda lists: tuple(torch.tensor(np.asarray(a, np.int32))
                             for a in lists)
  fwd, bwd, shape = as_t(fwd), as_t(bwd), tuple(int(s) for s in shape)
  if fwd[0].dim() == 2:                  # an expert stack
    return ep.ExpertPacking(fwd, bwd, shape)
  return Packing(fwd, bwd, shape)


def _flatten(node, prefix, out, leaf):
  for key, value in node.items():
    path = prefix + (str(key),)
    converted = leaf(value)
    if converted is not None:
      out['.'.join(path)] = converted
    elif isinstance(value, Mapping):
      _flatten(value, path, out, leaf)
    else:
      raise TypeError(f'unexpected leaf at {"/".join(path)}: {type(value)}')
  return out


def from_jax_variables(tree) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, Packing]]:
  """(state, packings): state maps 'block0.attn.qkv.kernel'-style keys to
  numpy arrays; packings maps the same packed-kernel keys to Packings."""
  def array_leaf(value):
    return None if isinstance(value, Mapping) else np.asarray(value)

  state = _flatten(tree['params'], (), {}, array_leaf)
  packings = _flatten(tree.get('packing', {}), (), {}, _packing_leaf)
  return state, packings


def load_converted(model: torch.nn.Module, state: Dict[str, np.ndarray],
                   packings: Dict[str, Packing]) -> torch.nn.Module:
  """Installs converted packings, then the state (cast to each
  parameter's dtype and device; every key must match)."""
  for key, packing in packings.items():
    model.get_submodule(key.rsplit('.', 1)[0]).set_packing(packing)
  model.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in state.items()}, strict=True)
  return model


def dense_twin_state(model) -> Dict[str, torch.Tensor]:
  """State dict of the dense twin that computes exactly what the packed
  transformer `model` (PackedTransformer, PackedMoETransformer) does: each
  packed kernel unpacked to its dense (in, out) matrix (zeros at inactive
  blocks), at '<layer>.d.kernel', in the layer's compute dtype (the twin
  stores its projections so); an expert stack to its (E, in, out) float32
  matrices (the twin's expert kernels are float32 master weights)."""
  out = {}
  for key, value in model.state_dict().items():
    layer = key.rsplit('.', 1)[0]
    sub = model.get_submodule(layer) if key.endswith('.kernel') else None
    if sub is not None and ep.is_expert_stacked(getattr(sub, 'packing',
                                                        None)):
      out[f'{layer}.d.kernel'] = ep.unpack_dense_experts(value, sub.packing,
                                                         sub.block)
    elif sub is not None and hasattr(sub, 'packing'):
      out[f'{layer}.d.kernel'] = unpack_dense(value, sub.packing,
                                              sub.block).to(sub.dtype)
    else:
      out[key] = value
  return out


def packed_mlp_trainer_from_jax(config, state, device='cuda'):
  """The port's PackedMLPTrainer holding a JAX PackedMLPTrainer's state.

  `config`: the port's PackedMLPConfig, or a mapping of the JAX config's
  fields (dataclasses.asdict of it).  `state`: numpy arrays and ints,
    'params'           {name: array}   every parameter, packed or dense;
    'occupancy'        {name: (nk, nn)} each packed layer's grid (rebuilt
                                        as a packing by make_packing);
    'momentum'         {name: array}   optax's momentum trace per parameter
                                        (opt_state[0].trace);
    'step', 'last_update_step', 'batches_seen'.
  """
  from rigl_tpu_torch.train.packed_loop import (PackedMLPConfig,
                                                PackedMLPTrainer)
  if isinstance(config, Mapping):
    config = PackedMLPConfig(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in config.items()})
  trainer = PackedMLPTrainer(config, device=device)
  trainer.init_state()
  trainer.load_arrays(state['step'], state['last_update_step'],
                      state['batches_seen'], state['occupancy'],
                      state['params'], state['momentum'])
  return trainer


def packed_lm_trainer_from_jax(config, state, device='cuda'):
  """The port's PackedLMTrainer holding a JAX PackedLMTrainer's state.

  `config`: the port's PackedLMConfig, or a mapping of the JAX config's
  fields (dataclasses.asdict of it).  `state`: numpy arrays and ints, keyed
  by dotted parameter names ('block0.attn.qkv.kernel'),
    'params'            {name: array}    every parameter, packed or dense
                                         (an expert stack (E, cap, bk, bn));
    'occupancy'         {name: (nk, nn)} each packed kernel's grid ((E, nk,
                                         nn) for an expert stack);
    'mu', 'nu'          {name: array}    Adam's slots (opt_state[0].mu / nu);
    'count'             int              Adam's count (opt_state[0].count);
    'schedule_count'    int              the schedule's (opt_state[1].count),
                                         which JAX advances with Adam's;
    'step', 'last_update_step', 'batches_seen';
    'ema'               {name: (nk, nn)} SNFS's EMA grids (algo 'snfs';
                                         (E, nk, nn) for an expert stack).
  """
  from rigl_tpu_torch.train.packed_lm import PackedLMConfig, PackedLMTrainer
  if isinstance(config, Mapping):
    config = PackedLMConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in config.items()})
  count = int(state['count'])
  if int(state.get('schedule_count', count)) != count:
    raise ValueError(f'Adam count {count} and schedule count '
                     f'{state["schedule_count"]} differ: the port keeps one')
  if config.algo == 'snfs' and 'ema' not in state:
    raise ValueError("algo 'snfs' needs the EMA grids under 'ema'")
  trainer = PackedLMTrainer(config, device=device)
  trainer.init_state()
  trainer.load_arrays(state['step'], state['last_update_step'],
                      state['batches_seen'], state['occupancy'],
                      state['params'], state['mu'], state['nu'], count,
                      state.get('ema'))
  return trainer


def packed_classifier_trainer_from_jax(config, state, model, dense_twin,
                                       input_shape):
  """The port's PackedClassifierTrainer on (model, dense_twin), holding a
  JAX PackedClassifierTrainer's state; it runs on the model's device.

  `config`: the port's PackedClassifierConfig, or a mapping of the JAX
  config's fields (dataclasses.asdict of it).  `state`: numpy arrays and
  ints, keyed by dotted parameter names ('g0_b0.conv1.kernel'),
    'params'           {name: array}    every parameter, packed or dense;
    'occupancy'        {name: (nk, nn)} each packed kernel's grid;
    'momentum'         {name: array}    optax's nesterov trace per parameter
                                        (opt_state[0].trace);
    'step', 'last_update_step', 'batches_seen';
    'ema'              {name: (nk, nn)} SNFS's EMA grids (algo 'snfs').
  """
  from rigl_tpu_torch.train.packed_classifier import (
      PackedClassifierConfig, PackedClassifierTrainer)
  if isinstance(config, Mapping):
    config = PackedClassifierConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in config.items()})
  if config.algo == 'snfs' and 'ema' not in state:
    raise ValueError("algo 'snfs' needs the EMA grids under 'ema'")
  trainer = PackedClassifierTrainer(model, dense_twin, config, input_shape)
  trainer.init_state()
  trainer.load_arrays(state['step'], state['last_update_step'],
                      state['batches_seen'], state['occupancy'],
                      state['params'], state['momentum'], state.get('ema'))
  return trainer


def _paths(tree) -> Dict[str, np.ndarray]:
  """A nested mapping of arrays -> {'a/b/kernel': array}; a top-level
  'params' wrapper is dropped, as JAX's path_str drops it."""
  if set(tree) == {'params'}:
    tree = tree['params']
  flat = _flatten(tree, (), {}, lambda v: None if isinstance(v, Mapping)
                  else np.asarray(v))
  return {k.replace('.', '/'): v for k, v in flat.items()}


def _pack_entry(entry, device):
  from rigl_tpu_torch.ops.block_sparse_conv import TapPack
  from rigl_tpu_torch.ops.block_sparse_v4 import FlatPacking
  if isinstance(entry, Mapping):
    # Tap packings stay on the host, where their kernel index is built.
    dev = 'cpu' if 'taps' in entry else device
    out = {k: torch.from_numpy(np.array(v, np.int32)).to(dev)
           for k, v in entry.items()}
    if 'taps' in out:
      return TapPack(**out)
    return FlatPacking(**out) if set(out) == {'cols', 'rows'} else out
  return torch.from_numpy(np.array(entry, np.int32)).to(device)


def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
  """Copies a flax model's variables into the port's `model`, by path:
  'params' into its parameters, 'batch_stats' into its BatchNorm buffers
  and 'masks' (the masked layers of layers/masked.py) into its
  `kernel_mask` buffers.  `variables`: {'params': tree, 'batch_stats':
  tree, 'masks': tree} of numpy arrays (jax.tree.map(np.asarray, ...));
  a missing collection counts as empty.  Every path must match."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  params = {masks_lib.path_str(n): t for n, t in model.named_parameters()}
  buffers = {masks_lib.path_str(n): t for n, t in model.named_buffers()}
  src_params = _paths(variables.get('params') or {})
  src_buffers = _paths(variables.get('batch_stats') or {})
  src_buffers.update({p + '_mask': v for p, v in
                      _paths(variables.get('masks') or {}).items()})
  if set(src_params) != set(params) or set(src_buffers) != set(buffers):
    raise ValueError(
        f'JAX paths do not match the model: params '
        f'{sorted(set(src_params) ^ set(params))[:6]}, buffers '
        f'{sorted(set(src_buffers) ^ set(buffers))[:6]}')
  with torch.no_grad():
    for p, t in params.items():
      t.copy_(torch.from_numpy(np.array(src_params[p])))
    for p, t in buffers.items():
      t.copy_(torch.from_numpy(np.array(src_buffers[p])))
  return model


def train_state_from_jax(model: torch.nn.Module, st, state):
  """The port's dense-masked TrainState (train/train_state.py) for `model`
  under `st` (transforms/sparse_training.py), holding a JAX TrainState's
  values; on the model's device.

  `state`: numpy arrays and ints (jax.tree.map(np.asarray, ...)),
    'params'          the flax params tree ({'params': ...} or its inside);
    'batch_stats'     the batch_stats tree ({} without BatchNorm);
    'momentum'        optax's momentum trace, a tree like 'params'
                      (opt_state[0].trace), or None (SGD without
                      momentum has no slot in either package);
    'mu', 'nu', 'count'  Adam's slots, trees like 'params'
                      (opt_state[0].mu / nu), and its count, for an
                      optimizer built as torch.optim.Adam (absent
                      otherwise);
    'masks'           {path: array};
    'step', 'last_update_step', 'is_snipped';
    'ema_grads', 'initial_weights'   {path: array} or None;
    'block_packs'     {path: occupancy | {'cols', 'rows'[, 'taps']}} or
                      None.
  The parameters and statistics are copied into the model's tensors;
  st.init builds the optimizer and the per-layer sparsities (its random
  masks are replaced by `state`'s)."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.train.train_state import TrainState
  device = next(model.parameters()).device
  load_jax_variables(model, {'params': state['params'],
                             'batch_stats': state.get('batch_stats')})
  params = masks_lib.param_dict(model)
  stats = {masks_lib.path_str(n): b for n, b in model.named_buffers()}
  optimizer, sstate = st.init(0, params)
  if state.get('momentum') is not None:
    trace = _paths(state['momentum'])
    for p, t in params.items():
      optimizer.state[t]['momentum_buffer'] = torch.from_numpy(
          np.array(trace[p])).to(device, t.dtype)
  if state.get('mu') is not None:
    from rigl_tpu_torch.transforms.sparse_training import _adam_state
    mu, nu = _paths(state['mu']), _paths(state['nu'])
    group = optimizer.param_groups[0]
    for p, t in params.items():
      slots = _adam_state(t, group)
      slots['step'].fill_(float(state['count']))
      slots['exp_avg'].copy_(torch.from_numpy(np.array(mu[p])))
      slots['exp_avg_sq'].copy_(torch.from_numpy(np.array(nu[p])))
      optimizer.state[t] = slots

  def dev_dict(d, dtype=None):
    if d is None:
      return None
    return {p: torch.from_numpy(np.array(v)).to(device, dtype)
            for p, v in d.items()}

  packs = state.get('block_packs')
  sstate = sstate.replace(
      masks=dev_dict(state['masks'], st.mask_dtype),
      step=int(state['step']),
      last_update_step=int(state['last_update_step']),
      is_snipped=bool(state['is_snipped']),
      ema_grads=dev_dict(state.get('ema_grads'), torch.float32),
      initial_weights=dev_dict(state.get('initial_weights'), torch.float32),
      block_packs=(None if packs is None else
                   {p: _pack_entry(e, device) for p, e in packs.items()}))
  return TrainState(params=params, batch_stats=stats, optimizer=optimizer,
                    sparse=sstate)


def _jax_state_arrays(state) -> Dict:
  """The arrays of a JAX dense-masked TrainState (as numpy) in
  train_state_from_jax's form.  `state` is the flax struct itself
  (jax.tree.map(np.asarray, trainer.state)), read by attribute: the
  optimizer slots by the optax states that hold them (a trace, Adam's
  mu / nu / count)."""
  sp = state.sparse
  out = {'params': state.params, 'batch_stats': state.batch_stats,
         'masks': dict(sp.masks), 'step': int(sp.step),
         'last_update_step': int(sp.last_update_step),
         'is_snipped': bool(sp.is_snipped),
         'ema_grads': None if sp.ema_grads is None else dict(sp.ema_grads),
         'initial_weights': (None if sp.initial_weights is None
                             else dict(sp.initial_weights))}

  def walk(node):
    fields = getattr(node, '_fields', ())
    if 'trace' in fields:
      out['momentum'] = node.trace
    elif 'mu' in fields and 'nu' in fields:
      out.update(mu=node.mu, nu=node.nu, count=int(node.count))
    elif isinstance(node, (tuple, list)):
      for child in node:
        walk(child)
  walk(state.opt_state)
  return out


def trainer_state_from_jax(trainer, state):
  """Loads a JAX Trainer's TrainState (rigl_tpu/train/trainer.py, as
  numpy: jax.tree.map(np.asarray, jax_trainer.state)) into the port's
  Trainer `trainer` (train/trainer.py), which then continues from it:
  params and batch_stats into its model's tensors, the masks, the step
  counters, SNFS's EMA and the initial weights into its SparseState, the
  optimizer's slots (SGD's momentum trace, Adam's mu, nu and count) into
  its optimizer, and the block packs rebuilt from the masks.  Returns the
  trainer's new state."""
  if trainer.state is None:
    trainer.init_state()
  arrays = _jax_state_arrays(state)
  st = trainer.sparse_training
  new = train_state_from_jax(trainer.model, st, arrays)
  trainer.state = new.replace(sparse=new.sparse.replace(
      block_packs=st._compute_packs(new.sparse.masks)))
  return trainer.state


# ------------------------------------------------------------- RL agents --
def _sparse_arrays(params, opt_state, sparse) -> Dict:
  """train_state_from_jax's arrays of one network of a JAX agent: its
  params tree, Adam's slots found in `opt_state` and its SparseState."""
  out = {'params': params, 'batch_stats': None, 'masks': dict(sparse.masks),
         'step': int(sparse.step),
         'last_update_step': int(sparse.last_update_step),
         'is_snipped': bool(sparse.is_snipped),
         'ema_grads': (None if sparse.ema_grads is None
                       else dict(sparse.ema_grads)),
         'initial_weights': (None if sparse.initial_weights is None
                             else dict(sparse.initial_weights))}
  _adam_slots(opt_state, out)
  return out


def _adam_slots(opt_state, out):
  """Adam's mu, nu and count from an optax state, into `out`."""
  fields = getattr(opt_state, '_fields', ())
  if 'mu' in fields and 'nu' in fields:
    out.update(mu=opt_state.mu, nu=opt_state.nu, count=int(opt_state.count))
  elif isinstance(opt_state, (tuple, list)):
    for child in opt_state:
      _adam_slots(child, out)
  return out


def _network(model, st, params, opt_state, sparse):
  """(params, optimizer, SparseState) of one network: the JAX values in
  `model`'s own tensors, under `st`."""
  ts = train_state_from_jax(model, st, _sparse_arrays(params, opt_state,
                                                       sparse))
  return ts.params, ts.optimizer, ts.sparse


def _tensors(tree, device, dtype=None) -> Dict[str, torch.Tensor]:
  """{path: tensor} of a params tree or a flat {path: array} dict, in
  JAX's path order."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  flat = _paths(tree)
  return {p: torch.from_numpy(np.array(flat[p])).to(device, dtype)
          for p in masks_lib.path_sorted(flat)}


def _scalar(value, device, dtype):
  return torch.tensor(np.asarray(value), dtype=dtype, device=device)


def _common_rl(agent, state, base):
  """The fields every agent state shares: the env's obs, done and t, the
  env-step count and the returns bookkeeping."""
  from rigl_tpu_torch.rl.envs import EnvState
  dev = agent.device
  env = state.env_state
  out = dict(
      env_state=EnvState(obs=torch.from_numpy(np.array(env.obs)).to(dev),
                         done=_scalar(env.done, dev, torch.bool),
                         t=_scalar(env.t, dev, torch.int32),
                         gen=base.env_state.gen),
      env_steps=int(state.env_steps),
      episode_return=_scalar(state.episode_return, dev, torch.float32),
      completed_returns_sum=_scalar(state.completed_returns_sum, dev,
                                    torch.float32),
      completed_episodes=_scalar(state.completed_episodes, dev, torch.int32))
  if hasattr(state, 'buffer'):
    from rigl_tpu_torch.rl.replay import ReplayBuffer
    b = state.buffer
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    out['buffer'] = ReplayBuffer(obs=t(b.obs), action=t(b.action),
                                 reward=t(b.reward), next_obs=t(b.next_obs),
                                 done=t(b.done), ptr=int(b.ptr),
                                 size=int(b.size))
  return out


def dqn_state_from_jax(agent, state, seed: int = 0):
  """The port's DQNState for `agent` (rl/dqn.py SparseDQN, the JAX
  agent's config), holding a JAX DQNState's values, on the agent's device.
  `state`: the JAX struct with its arrays as numpy (its key left out:
  the port's generators come from agent.init(seed))."""
  base = agent.init(seed)
  params, optimizer, sparse = _network(agent.net, agent.st, state.params,
                                       state.opt_state, state.sparse)
  dev = agent.device
  return base.replace(
      params=params, optimizer=optimizer, sparse=sparse,
      target_params=_tensors(state.target_params, dev),
      target_masks=_tensors(state.target_masks, dev, agent.st.mask_dtype),
      **_common_rl(agent, state, base))


def ppo_state_from_jax(agent, state, seed: int = 0):
  """The port's PPOTrainState for `agent` (rl/ppo.py SparsePPO), holding a
  JAX PPOTrainState's values (numpy, key left out)."""
  base = agent.init(seed)
  params, optimizer, sparse = _network(agent.net, agent.st, state.params,
                                       state.opt_state, state.sparse)
  return base.replace(params=params, optimizer=optimizer, sparse=sparse,
                      **_common_rl(agent, state, base))


def sac_state_from_jax(agent, state, seed: int = 0):
  """The port's SACState for `agent` (rl/sac.py SparseSAC), holding a JAX
  SACState's values (numpy, key left out): both networks, the target
  critic, log alpha and its Adam."""
  from rigl_tpu_torch.transforms.sparse_training import _adam_state
  base = agent.init(seed)
  a_params, a_opt, a_sparse = _network(agent.actor, agent.actor_st,
                                       state.actor_params, state.actor_opt,
                                       state.actor_sparse)
  c_params, c_opt, c_sparse = _network(agent.critic, agent.critic_st,
                                       state.critic_params, state.critic_opt,
                                       state.critic_sparse)
  dev = agent.device
  log_alpha = base.log_alpha
  with torch.no_grad():
    log_alpha.fill_(float(np.asarray(state.log_alpha)))
  slots = _adam_slots(state.alpha_opt, {})
  alpha_opt = agent.alpha_tx([log_alpha])
  adam = _adam_state(log_alpha, alpha_opt.param_groups[0])
  adam['step'].fill_(float(slots['count']))
  adam['exp_avg'].fill_(float(np.asarray(slots['mu'])))
  adam['exp_avg_sq'].fill_(float(np.asarray(slots['nu'])))
  alpha_opt.state[log_alpha] = adam
  return base.replace(
      actor_params=a_params, actor_opt=a_opt, actor_sparse=a_sparse,
      critic_params=c_params, critic_opt=c_opt, critic_sparse=c_sparse,
      target_critic_params=_tensors(state.target_critic_params, dev),
      target_critic_masks=_tensors(state.target_critic_masks, dev,
                                   agent.critic_st.mask_dtype),
      log_alpha=log_alpha, alpha_opt=alpha_opt,
      **_common_rl(agent, state, base))
