"""Expert-stacked packed storage and top-1 routing for PACKED block-sparse
Mixture-of-Experts layers, in PyTorch: the single-device half of
rigl_tpu/parallel/packed_ep.py.

An MoE FFN stores its E experts' packed kernels stacked on a leading expert
axis `(E, cap, bk, bn)`; `ExpertPacking` (a Packing subclass whose lists
carry the same leading axis) marks the stacking, so the RigL update, the
dense-twin unpack and the checkpoints tell it apart by type.  It also
holds its E per-expert Packings, made once with it: the kernels read each
expert's CSR indices from its Packing's cache (Packing.column_index), so
they are built once per mask update, not once per call.

Routing is Switch-Transformer top-1 with a static per-expert capacity:
argmax of the f32 softmax (the first index wins a tie), slots first come
first served in token order, tokens past an expert's capacity dropped (the
residual carries them), and the load-balance aux loss E * sum_e(frac_e *
mean_prob_e).  `top1_gather_dispatch` gives it as integer gather indices,
which models/packed_moe.py runs; `top1_dispatch` as the one-hot (T, E, C)
tensors, the oracle the gather form is tested against.

RigL per expert: `expert_drop_grow` runs the packed drop/grow
(transforms/packed_training.py) independently on each expert, so each
expert's active count is invariant.

Not ported yet, and raising NotImplementedError: the token axes of a
sharded token set (`token_axes`); the all_to_all half (dispatch_to_experts,
return_from_experts) and ep_spec_trees are absent.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from rigl_tpu_torch.ops.block_sparse_packed import (Packing, make_packing,
                                                    pack_dense, unpack_dense)


# ------------------------------------------------------------- packing ----
class ExpertPacking(Packing):
  """A Packing whose fwd / bwd lists carry a leading EXPERT axis (E,
  n_entries); `shape` is each expert's (nk, nn) grid and `n_active` each
  expert's active count.  `experts` holds expert e's lists as an ordinary
  Packing (row e of the stacked lists), made once with this object."""

  def __init__(self, fwd, bwd, shape, experts: Sequence[Packing] = None):
    super().__init__(fwd, bwd, shape)
    if experts is None:
      experts = [Packing(tuple(a[e] for a in self.fwd),
                         tuple(a[e] for a in self.bwd), self.shape)
                 for e in range(int(self.fwd[0].shape[0]))]
    self.experts = tuple(experts)

  @property
  def n_active(self) -> int:
    return int(self.fwd[0].shape[1]) - self.shape[1]

  def to(self, device) -> 'ExpertPacking':
    """This packing, and each expert's, with the lists on `device`
    (cached)."""
    device = torch.device(device)
    if self.fwd[0].device == device:
      return self
    key = ('to', str(device))
    if key not in self._cache:
      self._cache[key] = ExpertPacking(
          tuple(t.to(device) for t in self.fwd),
          tuple(t.to(device) for t in self.bwd), self.shape,
          [pk.to(device) for pk in self.experts])
    return self._cache[key]


def stack_expert_packings(pks: List[Packing]) -> ExpertPacking:
  """Per-expert packings (equal grids and active counts) -> the stacked
  ExpertPacking, which keeps them as its `experts`."""
  if len({(pk.shape, pk.n_active) for pk in pks}) != 1:
    raise ValueError('expert packings must share their grid and active '
                     'count')
  fwd = tuple(torch.stack([pk.fwd[i] for pk in pks]) for i in range(4))
  bwd = tuple(torch.stack([pk.bwd[i] for pk in pks]) for i in range(4))
  return ExpertPacking(fwd, bwd, pks[0].shape, pks)


def is_expert_stacked(pk) -> bool:
  return isinstance(pk, ExpertPacking)


def local_expert_packing(pk: ExpertPacking, e: int) -> Packing:
  """Expert e's Packing (for packed_matmul); the same object on every
  call, so its kernel indices are cached."""
  return pk.experts[e]


def n_experts_of(pk: ExpertPacking) -> int:
  return len(pk.experts)


def cap_of(pk: ExpertPacking) -> int:
  """Each expert's active-block count."""
  return pk.n_active


def expert_occupancy_grid(pk: ExpertPacking) -> torch.Tensor:
  """(E, nk, nn) int32 occupancy from the stacked packing, on the CPU."""
  from rigl_tpu_torch.transforms import packed_training as pt
  return torch.stack([pt.occupancy_grid(p) for p in pk.experts])


def expert_packing_from_occ(occ, cap: int) -> ExpertPacking:
  """(E, nk, nn) occupancy, exactly `cap` active per expert -> the stacked
  ExpertPacking."""
  occ = torch.as_tensor(occ).cpu()
  return stack_expert_packings([make_packing(occ[e], cap)
                                for e in range(occ.shape[0])])


def pack_dense_experts(w: torch.Tensor, pk: ExpertPacking,
                       block: Tuple[int, int]) -> torch.Tensor:
  """Dense (E, K, N) -> stacked packed (E, cap, bk, bn)."""
  return torch.stack([pack_dense(w[e], p, block)
                      for e, p in enumerate(pk.experts)])


def unpack_dense_experts(packed: torch.Tensor, pk: ExpertPacking,
                         block: Tuple[int, int], dtype=None) -> torch.Tensor:
  """Stacked packed (E, cap, bk, bn) -> dense (E, K, N), zeros at inactive
  blocks."""
  return torch.stack([unpack_dense(packed[e], p, block, dtype)
                      for e, p in enumerate(pk.experts)])


# ------------------------------------------------------------- routing ----
def _route(logits: torch.Tensor, token_axes: Tuple[str, ...]):
  """(choice, pos, gate, aux) of top-1 routing: each token's expert (the
  first of equal maxima of the f32 softmax), its place in that expert's
  queue in token order (an integer cumsum: exact where JAX's f32 cumsum
  of the one-hots is), the router probability of its expert, and the
  load-balance aux loss."""
  if token_axes:
    raise NotImplementedError('token_axes (a sharded token set) is not '
                              'ported yet')
  _, E = logits.shape
  probs = torch.softmax(logits.float(), dim=-1)
  choice = torch.argmax(probs, dim=-1)
  # (E, T): the running counts scan along the contiguous token axis (on
  # the card a scan down the T rows of (T, E) ran E sequential columns).
  onehot = F.one_hot(choice, E).T.contiguous()
  pos = torch.cumsum(onehot, 1).gather(0, choice[None])[0] - 1
  gate = probs.gather(1, choice[:, None])[:, 0]
  frac = onehot.float().mean(1)
  aux = E * torch.sum(frac * probs.mean(0))
  return choice, pos, gate, aux


def top1_dispatch(logits: torch.Tensor, capacity: int,
                  token_axes: Tuple[str, ...] = ()):
  """Switch top-1 routing as one-hot tensors (the oracle of
  top1_gather_dispatch).

  Returns (dispatch, combine, aux): dispatch (T, E, C) f32, 1 where token t
  holds slot c of expert e (a dropped token's row is all zero); combine,
  dispatch times the token's gate; aux = E * sum_e(frac_e * mean_prob_e),
  1 at perfect balance."""
  _, E = logits.shape
  choice, pos, gate, aux = _route(logits, token_axes)
  slot = F.one_hot(pos.clamp(max=capacity), capacity + 1)[:, :capacity]
  dispatch = (F.one_hot(choice, E)[:, :, None] * slot[:, None, :]).float()
  return dispatch, dispatch * gate[:, None, None], aux


def top1_gather_dispatch(logits: torch.Tensor, capacity: int,
                         token_axes: Tuple[str, ...] = ()):
  """top1_dispatch's routing as integer gather indices.

  Returns (src, flat_ec, kept, gate, aux):
    src: (E*C,) int64, the token filling each expert slot, T (one past the
      last token: callers gather from a zero-padded x) for an empty slot;
    flat_ec: (T,) int64, each token's slot in the flattened expert-major
      (E*C,) layout (clipped for a dropped token: mask it with kept);
    kept: (T,) bool, the token was routed within capacity;
    gate: (T,) f32, the router probability of the chosen expert;
    aux: the load-balance loss, as top1_dispatch's."""
  T, E = logits.shape
  choice, pos, gate, aux = _route(logits, token_axes)
  kept = pos < capacity
  flat_ec = choice * capacity + pos.clamp(max=capacity - 1)
  src = torch.full((E * capacity + 1,), T, dtype=torch.int64,
                   device=logits.device)
  src.scatter_(0, torch.where(kept, flat_ec, E * capacity),
               torch.arange(T, device=logits.device))
  return src[:E * capacity], flat_ec, kept, gate, aux


# ----------------------------------------------------------- drop/grow ----
class EPUpdateResult(NamedTuple):
  packed: torch.Tensor         # (E, cap, bk, bn), grown slots zeroed
  packing: ExpertPacking       # the new stacked packing
  grown: torch.Tensor          # (E, cap) bool, slots that are NEW
  perm: torch.Tensor           # (E, cap) within-expert gather, -1 where grown
  occupancy: torch.Tensor      # the new (E, nk, nn) grids


def expert_drop_grow(packed: torch.Tensor, pk: ExpertPacking, grow_grids,
                     drop_fraction) -> EPUpdateResult:
  """One RigL drop/grow on expert-stacked storage, independently per
  expert: drop by each expert's packed block |w| sums, grow by its (nk, nn)
  grid of `grow_grids` (E, nk, nn).  The result lies on packed's device;
  the packing and occupancy on the CPU."""
  from rigl_tpu_torch.transforms import packed_training as pt
  cap = cap_of(pk)
  outs = [pt.packed_drop_grow(packed[e], p, grow_grids[e], drop_fraction,
                              cap) for e, p in enumerate(pk.experts)]
  return EPUpdateResult(
      torch.stack([o.packed for o in outs]),
      stack_expert_packings([o.packing for o in outs]),
      torch.stack([o.grown for o in outs]),
      torch.stack([o.perm for o in outs]),
      torch.stack([o.occupancy for o in outs]))
