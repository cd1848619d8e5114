"""Drop/grow sparse training ON packed block storage, in PyTorch.

Counterpart of rigl_tpu/transforms/packed_training.py.  The drop/grow
kernel (sparsity/update.py:drop_grow_update) runs on the block-pooled
occupancy grid:

  * drop score  = sum |w| over each block (inactive blocks do not exist in
    packed storage, so they score zero);
  * grow score  = block-pooled |dense grads|, computed by the caller at
    update steps only (rigl_grow_grids);
  * repack      = permutation gather on the packed axis; grown slots start
    at zeros (RigL's grow_init default) and their optimizer slots reset.

The active count is invariant under drop/grow, so every packed shape is
constant across a run.  Where JAX returns new arrays, `packed_rigl_update`
updates a torch.optim.Optimizer's parameters and state IN PLACE, so the
optimizer's references stay valid.

The JAX module's nested-tree (`flax_*`) functions work on flax trees keyed
by path tuples; here they take flat `{name: tensor}` dicts keyed by the
port's dotted parameter names ('block0.attn.qkv.kernel'), and the
optimizer is a torch.optim.Optimizer (Adam's exp_avg / exp_avg_sq are
carried or reset, its step passes through as optax's count does).  An
expert-stacked kernel (an ExpertPacking, parallel/packed_ep.py) has
(E, nk, nn) grids and drops and grows per expert; its optimizer slots are
carried within each expert.  They are for one device: the TP
(tensor-stacked) variant is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from rigl_tpu_torch.ops.block_mask import pool_to_blocks
from rigl_tpu_torch.ops.block_sparse_packed import (Packing, make_packing,
                                                    repack_permutation,
                                                    unpack_dense)
from rigl_tpu_torch.parallel import packed_ep as ep
from rigl_tpu_torch.sparsity import update as update_lib


def occupancy_grid(packing: Packing) -> torch.Tensor:
  """(nk, nn) int32 occupancy reconstructed from the fwd entry list."""
  nk, nn_ = packing.shape
  cols, rows, _, valid = (t.long() for t in packing.to('cpu').fwd)
  return torch.zeros(nk * nn_, dtype=torch.int64).scatter_reduce(
      0, rows * nn_ + cols, valid, 'amax', include_self=True
  ).reshape(nk, nn_).to(torch.int32)


def block_drop_scores(packed: torch.Tensor, packing: Packing) -> torch.Tensor:
  """sum |w| per block scattered onto the (nk, nn) grid (zeros at inactive
  blocks, so they never win the keep competition); on packed's device."""
  nk, nn_ = packing.shape
  cols, rows, slots, valid = (t.long() for t in packing.to(packed.device).fwd)
  per_slot = packed.to(torch.float32).abs().sum(dim=(1, 2))
  vals = torch.where(valid == 1, per_slot[slots], 0.0)
  return torch.zeros(nk * nn_, dtype=torch.float32,
                     device=packed.device).index_add_(
                         0, rows * nn_ + cols, vals).reshape(nk, nn_)


class PackedUpdateResult(NamedTuple):
  packed: torch.Tensor       # new packed weights (grown slots zeroed)
  packing: Packing           # new packing
  grown: torch.Tensor        # (n_active,) bool, slots that are NEW
  occupancy: torch.Tensor    # new (nk, nn) int32 grid
  perm: torch.Tensor         # (n_active,) gather indices, -1 where grown


def packed_drop_grow(packed: torch.Tensor, packing: Packing,
                     grow_scores_grid: torch.Tensor, drop_fraction,
                     n_active: int) -> PackedUpdateResult:
  """One drop/grow update on packed storage.

  grow_scores_grid: (nk, nn) block-pooled grow scores (sum |dense grad| per
  block, pool_to_blocks(..., 'sum')).  n_active: the active-block count,
  invariant under drop/grow.  The result lies on packed's device; the
  packing and occupancy on the CPU.
  """
  dev = packed.device
  occ = occupancy_grid(packing).to(dev, torch.float32)
  bd = block_drop_scores(packed, packing)
  res = update_lib.drop_grow_update(
      occ, torch.zeros_like(occ), bd,
      torch.as_tensor(grow_scores_grid, dtype=torch.float32, device=dev),
      drop_fraction, grow_tensor=torch.zeros_like(occ))
  new_occ = res.mask.to(torch.int32).cpu()
  new_packing = make_packing(new_occ, n_active)
  perm = repack_permutation(packing, new_packing).long().to(dev)
  grown = perm < 0
  new_packed = torch.where(grown[:, None, None], torch.zeros_like(packed),
                           packed[perm.clamp(min=0)])
  return PackedUpdateResult(new_packed, new_packing, grown, new_occ, perm)


def unpack_params(params: Dict[str, torch.Tensor],
                  packings: Dict[str, Packing],
                  block: Tuple[int, int]) -> Dict[str, torch.Tensor]:
  """{name: packed} -> {name: dense (K, N)} (zeros at inactive blocks), for
  the dense-view backward of update steps (RigL's grow score is |dense
  grad|, sparse_optimizers_base.py:328-334)."""
  return {name: unpack_dense(params[name], packings[name], block)
          for name in params}


def rigl_grow_grids(dense_grads: Dict[str, torch.Tensor],
                    block: Tuple[int, int]) -> Dict[str, torch.Tensor]:
  """{name: dense grad} -> {name: (nk, nn) pooled |grad| grow scores}."""
  return {name: pool_to_blocks(g.to(torch.float32).abs(), block, 'sum')
          for name, g in dense_grads.items()}


def _carry_slots(tree, perm: torch.Tensor, grown: torch.Tensor):
  """Gathers the survivors of every tensor in `tree` (nested dicts, lists
  and tuples) whose leading axes are the packed axes of `grown` into their
  new slots and zeroes the grown ones; scalars and counters pass through.
  `grown` is (n_active,), or (E, cap) for an expert stack, whose slots are
  gathered within each expert (along axis 1).  Returns a new tree."""
  if isinstance(tree, dict):
    return {k: _carry_slots(v, perm, grown) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    items = [_carry_slots(v, perm, grown) for v in tree]
    return type(tree)(*items) if hasattr(tree, '_fields') else type(tree)(
        items)
  lead = grown.dim()
  if not (torch.is_tensor(tree) and tree.dim() >= lead
          and tree.shape[:lead] == grown.shape):
    return tree
  pad = (1,) * (tree.dim() - lead)
  index = perm.clamp(min=0).to(tree.device, torch.long)
  if lead == 1:
    src = tree[index]
  else:
    src = torch.take_along_dim(tree, index.reshape(grown.shape + pad), 1)
  return torch.where(grown.to(tree.device).reshape(grown.shape + pad),
                     torch.zeros_like(src), src)


class PackedRigLResult(NamedTuple):
  params: dict                 # {name: packed}, the same tensors, updated
  packings: dict               # {name: Packing}
  optimizer: torch.optim.Optimizer   # its state carried and reset in place
  occupancy: dict              # {name: (nk, nn)} new grids


def packed_rigl_update(params: Dict[str, torch.Tensor],
                       packings: Dict[str, Packing],
                       optimizer: torch.optim.Optimizer,
                       grow_grids: Dict[str, torch.Tensor], drop_fraction,
                       n_active: Dict[str, int]) -> PackedRigLResult:
  """One RigL mask update across a dict of packed layers, in place.

  For each packed layer: drop by packed block |w| sums, grow by the
  caller's pooled grids (rigl_grow_grids), copy the repacked weights into
  the parameter (grown blocks zeroed; an expert stack per expert, by
  packed_ep.expert_drop_grow), and in every per-parameter state tensor of
  `optimizer` whose leading axis is the packed axis, or whose leading two
  are an expert stack's (momentum_buffer, exp_avg, exp_avg_sq), gather the
  survivors and zero the grown slots (sparse_optimizers_base.py:336-343;
  JAX's `fix` at rigl_tpu/transforms/packed_training.py:350-368).  An
  expert stack's n_active entry is unused.  Entries of `params`
  without a packing (a dense head) pass through.  State the optimizer has
  not created yet (torch makes momentum_buffer at the first step) needs no
  permuting: it equals optax's zero trace.
  """
  new_packings, occ = dict(packings), {}
  for name, param in params.items():
    if name not in packings:
      continue
    if ep.is_expert_stacked(packings[name]):
      out = ep.expert_drop_grow(param.detach(), packings[name],
                                grow_grids[name], drop_fraction)
    else:
      out = packed_drop_grow(param.detach(), packings[name],
                             grow_grids[name], drop_fraction, n_active[name])
    with torch.no_grad():
      param.copy_(out.packed)
      if param in optimizer.state:
        optimizer.state[param].update(_carry_slots(
            dict(optimizer.state[param]), out.perm, out.grown))
    new_packings[name] = out.packing
    occ[name] = out.occupancy
  return PackedRigLResult(params, new_packings, optimizer, occ)


def permute_opt_state(tree, packing_old: Packing, packing_new: Packing,
                      grown: torch.Tensor):
  """Carry optimizer slots through a repack: gather surviving blocks' slots
  into their new positions, zero the grown ones (see _carry_slots).
  Returns a new tree."""
  return _carry_slots(tree, repack_permutation(packing_old, packing_new),
                      grown)


# ------------------------------------------------ tree functions (flax_*) --
def path_key(name: str) -> Tuple[str, ...]:
  """The flax path tuple of a dotted parameter name: the order in which
  JAX sorts (and so flattens and enumerates) a tree's leaves."""
  return tuple(name.split('.'))


def _pooled_grids(dense_grads: Dict[str, torch.Tensor],
                  packings: Dict[str, Packing], block: Tuple[int, int],
                  absolute: bool) -> Dict[str, torch.Tensor]:
  """{name: (nk, nn)} block-pooled grids of the dense grads of each packed
  kernel ((E, nk, nn) stacks for an expert stack): pooled |grad| (RigL) or
  the SIGNED grads (SNFS's EMA input)."""
  def pool(g):
    g = g.to(torch.float32)
    return pool_to_blocks(g.abs() if absolute else g, block, 'sum')

  grids = {}
  for name, pk in packings.items():
    g = dense_grads[name]
    grids[name] = (torch.stack([pool(ge) for ge in g])
                   if ep.is_expert_stacked(pk) else pool(g))
  return grids


def flax_rigl_grow_grids(dense_grads, packings, block: Tuple[int, int]):
  """RigL grow grids: block-pooled |dense grad|."""
  return _pooled_grids(dense_grads, packings, block, absolute=True)


def flax_snfs_inst_grids(dense_grads, packings, block: Tuple[int, int]):
  """SNFS EMA input: block-pooled SIGNED dense grads (abs is applied after
  the EMA, at scoring time, so sign-oscillating gradients rank low)."""
  return _pooled_grids(dense_grads, packings, block, absolute=False)


def grow_grid_shapes(packings: Dict[str, Packing]) -> Dict[str, tuple]:
  """{name: (nk, nn)} for each packed kernel, (E, nk, nn) for an expert
  stack: the shapes of its grow grid and of its SNFS EMA state."""
  return {name: ((ep.n_experts_of(pk),) if ep.is_expert_stacked(pk) else ())
          + tuple(pk.shape) for name, pk in packings.items()}


def flax_set_grow_grids(packings: Dict[str, Packing],
                        generator: Optional[torch.Generator] = None):
  """SET grow grids: per-layer uniform [0, 1) scores over the block grid,
  drawn from `generator` layer by layer in JAX's path order.  JAX folds a
  key per layer; torch cannot give its bits, so a caller after JAX's exact
  grids passes them to flax_packed_drop_grow itself."""
  shapes = grow_grid_shapes(packings)
  dev = generator.device if generator is not None else None
  return {name: torch.rand(shapes[name], generator=generator, device=dev,
                           dtype=torch.float32)
          for name in sorted(shapes, key=path_key)}


def init_snfs_ema_grids(packings: Dict[str, Packing], device=None):
  """Zero SNFS gradient-EMA state, one (nk, nn) f32 grid per kernel."""
  return {name: torch.zeros(shape, dtype=torch.float32, device=device)
          for name, shape in grow_grid_shapes(packings).items()}


def snfs_update_ema_grids(ema_grids, inst_grids, momentum: float):
  """ema <- momentum * ema + (1 - momentum) * inst (the signed pooled
  grads); advanced at mask-update steps only, as in JAX."""
  return {name: momentum * ema_grids[name] + (1.0 - momentum)
          * inst_grids[name] for name in ema_grids}


def flax_packed_drop_grow(params: Dict[str, torch.Tensor],
                          packings: Dict[str, Packing],
                          optimizer: torch.optim.Optimizer, grow_grids,
                          drop_fraction) -> PackedRigLResult:
  """Score-agnostic drop/grow over every packed kernel of `params` (RigL,
  SET and SNFS differ only in grow_grids); each kernel's active count is
  its packed leading dim (an expert stack's, the axis after the experts).
  Entries without a packing pass through.  In place, as
  packed_rigl_update."""
  n_active = {name: int(params[name].shape[int(ep.is_expert_stacked(pk))])
              for name, pk in packings.items()}
  return packed_rigl_update(params, packings, optimizer, grow_grids,
                            drop_fraction, n_active)


def flax_packed_rigl_update(params, packings, optimizer, dense_grads,
                            drop_fraction, block: Tuple[int, int]):
  """flax_packed_drop_grow with RigL's grow scores (pooled |dense grad|)."""
  return flax_packed_drop_grow(
      params, packings, optimizer,
      flax_rigl_grow_grids(dense_grads, packings, block), drop_fraction)
