"""From the JAX package's variables to the port's modules.

`from_jax_variables(tree)` takes the flax variable tree of a model of
models/packed_transformer.py or models/packed_convnet.py ({'params': ...,
'packing': ...}, with its arrays mapped to numpy) and returns the port's
state dict plus its packings.  Module names in the port follow the flax
paths, so a parameter's key is its flax path joined with dots.  The port
keeps flax's layouts, so no array is transposed: Dense kernels (in, out)
(`x @ kernel`), conv kernels HWIO (a depthwise kernel (3, 3, 1, C)),
GroupNorm's and LayerNorm's scale and bias (C,); the conv modules permute
to torch's OIHW on each call.  Packed kernels are taken as they are: both
packages store (n_active, bk, bn) in the same column-major slot order.

Packing leaves are duck-typed through p['fwd'], p['bwd'] and p['shape'],
so this module needs nothing from the JAX package.

`packed_mlp_trainer_from_jax(config, state)` builds the port's
PackedMLPTrainer from a JAX PackedMLPTrainer's state passed as numpy
arrays (params, occupancy grids, momentum traces, counters);
`packed_lm_trainer_from_jax` does the same for PackedLMTrainer (params,
occupancy grids, Adam's slots and counts, counters, SNFS's EMA grids), and
`packed_classifier_trainer_from_jax` for PackedClassifierTrainer (params,
occupancy grids, momentum traces, counters, SNFS's EMA grids).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

from rigl_tpu_torch.ops.block_sparse_packed import Packing, unpack_dense


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
  return Packing(as_t(fwd), as_t(bwd), tuple(int(s) for s in shape))


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
  """State dict of the DenseTransformer that computes exactly what the
  PackedTransformer `model` does: each packed kernel unpacked to its
  dense (in, out) matrix (zeros at inactive blocks), at '<layer>.d.kernel',
  in the layer's compute dtype (the twin stores its projections so)."""
  out = {}
  for key, value in model.state_dict().items():
    layer = key.rsplit('.', 1)[0]
    sub = model.get_submodule(layer) if key.endswith('.kernel') else None
    if sub is not None and hasattr(sub, 'packing'):
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
    'params'            {name: array}    every parameter, packed or dense;
    'occupancy'         {name: (nk, nn)} each packed kernel's grid;
    'mu', 'nu'          {name: array}    Adam's slots (opt_state[0].mu / nu);
    'count'             int              Adam's count (opt_state[0].count);
    'schedule_count'    int              the schedule's (opt_state[1].count),
                                         which JAX advances with Adam's;
    'step', 'last_update_step', 'batches_seen';
    'ema'               {name: (nk, nn)} SNFS's EMA grids (algo 'snfs').
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
