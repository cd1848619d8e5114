"""Mixture-of-Experts transformer on PACKED block-sparse expert storage, in
PyTorch.

Counterpart of rigl_tpu/models/packed_moe.py on one device.  Every block's
FFN is a Switch-Transformer top-1 MoE whose E experts store their fc1 /
fc2 kernels as stacked packed blocks `(E, cap, bk, bn)` (an
ExpertPacking, parallel/packed_ep.py), one packed matmul per expert; the
attention projections are PackedDense, the attention core unfused (as in
JAX), and the router and LayerNorms dense.  `DenseMoETransformer` is the
equal-architecture dense twin: the same routing, the expert kernels dense
(E, K, N) float32 master weights.

Routing (parallel/packed_ep.top1_gather_dispatch) is one gather each way
(index_select, whose backward is an index_add): the tokens routed to each
expert slot are gathered from a zero-padded x (empty slots read the pad
row, the only row read twice), and each token reads back its slot's
output times its gate, in f32, cast once to `dtype`; a token past its
expert's capacity gets zero (the residual carries it, and the zero its
clipped slot's gradient).  The gradient reaches the router through the
gate only.  The expert rows are not padded to `bm`: the kernels mask
ragged rows.

`forward(x, cache=None, with_aux=False)`: with_aux also returns the sum of
every layer's load-balance aux loss (JAX sows it into 'intermediates').
Decoding (serve/decode.py: a decode twin and its cache) routes DROP-FREE,
capacity = the step's token count: the stack passes decode mode to every
MoE FFN in forward, since a decode twin shares its modules with the
train-mode model.

Not ported yet, and raising NotImplementedError: expert parallelism
(`ep_axis`) and a sharded token set (`token_axes`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.layers.packed_dense import (MasterWeight, PackedDense,
                                                random_occupancy)
from rigl_tpu_torch.models.packed_transformer import (Embed, LayerNorm,
                                                      Linear, _Attention,
                                                      _Dense2D, _Stack)
from rigl_tpu_torch.ops.block_sparse_packed import make_packing, packed_matmul
from rigl_tpu_torch.parallel import packed_ep as ep
from rigl_tpu_torch.sparsity.distributions import get_n_zeros
from rigl_tpu_torch.sparsity.layer_sparsity import resolve_sparsity


def moe_layer_shapes(d_model: int, d_ff: int, num_experts: int):
  """Dense kernel shapes of one MoE block's packed matmuls, keyed by the
  canonical layer paths; expert stacks enter the ERK solve as the rank-3
  (E, K, N) tensors they are."""
  return {
      'attn/qkv/kernel': (d_model, 3 * d_model),
      'attn/out/kernel': (d_model, d_model),
      'moe/fc1/kernel': (num_experts, d_model, d_ff),
      'moe/fc2/kernel': (num_experts, d_ff, d_model),
  }


class _PackedExperts(MasterWeight, nn.Module):
  """E experts' kernels as stacked packed storage: forward maps (E, C,
  in_features) to (E, C, features), one packed_matmul per expert.  All
  experts share the layer's sparsity (resolved by `path`); each draws its
  own occupancy.  The float32 kernel is cast to `dtype` on each call."""

  def __init__(self, in_features: int, features: int, num_experts: int, *,
               sparsity=0.8, block: Tuple[int, int] = (16, 16),
               bm: int = 128, dtype: torch.dtype = torch.float32,
               path=(), generator: Optional[torch.Generator] = None,
               device='cuda'):
    super().__init__()
    bk, bn = block
    if in_features % bk or features % bn:
      raise ValueError(f'({in_features}, {features}) must divide '
                       f'block {block}')
    self.in_features, self.features = in_features, features
    self.num_experts = num_experts
    self.block, self.bm, self.dtype = tuple(block), bm, dtype
    nk, nn_ = in_features // bk, features // bn
    n_total = nk * nn_
    n_active = n_total - get_n_zeros(
        n_total, resolve_sparsity(sparsity, tuple(path)))
    self.packing = ep.stack_expert_packings([
        make_packing(random_occupancy(generator, nk, nn_, n_active),
                     n_active) for _ in range(num_experts)])
    gdev = generator.device if generator else None
    kernel = torch.randn((num_experts, n_active, bk, bn),
                         generator=generator, device=gdev)
    self.kernel = nn.Parameter(
        (kernel / math.sqrt(in_features)).to(device=device,
                                             dtype=torch.float32))

  def set_packing(self, packing: ep.ExpertPacking):
    """Swap in other occupancies with the same grid and counts."""
    nk, nn_ = self.in_features // self.block[0], self.features // self.block[1]
    if not (ep.is_expert_stacked(packing) and packing.shape == (nk, nn_)
            and ep.n_experts_of(packing) == self.num_experts
            and packing.n_active == self.kernel.shape[1]):
      raise ValueError(f'packing {type(packing).__name__} {packing.shape} '
                       f'does not fit {self.num_experts} experts of '
                       f'{(nk, nn_)} with {self.kernel.shape[1]} actives')
    self.packing = packing

  def forward(self, xe: torch.Tensor) -> torch.Tensor:
    if xe.shape[0] != self.num_experts or xe.shape[-1] != self.in_features:
      raise ValueError(f'expected ({self.num_experts}, C, '
                       f'{self.in_features}), got {tuple(xe.shape)}')
    ys = [packed_matmul(x.contiguous(), w, pk, self.block, self.bm)
          for x, w, pk in zip(xe.to(self.dtype).unbind(0),
                              self.compute_weight().unbind(0),
                              self.packing.experts)]
    return torch.stack(ys)


class _ExpertKernel(MasterWeight, nn.Module):
  """Dense (E, in, out) float32 expert kernels, used in `dtype`: a batched
  matmul."""

  def __init__(self, in_features: int, features: int, num_experts: int,
               dtype: torch.dtype, generator=None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    shape = (num_experts, in_features, features)
    if torch.device(device).type == 'meta':      # a structure-only twin
      kernel = torch.empty(shape, device='meta')
    else:
      gdev = generator.device if generator else None
      kernel = torch.randn(shape, generator=generator,
                           device=gdev) / math.sqrt(in_features)
    self.kernel = nn.Parameter(kernel.to(device=device, dtype=torch.float32))

  def forward(self, xe):
    return torch.bmm(xe.to(self.dtype), self.compute_weight())


class _DenseExperts(nn.Module):
  """Dense twin of _PackedExperts, its kernel one level deeper ('d'), as
  _Dense2D's, so '<layer>.kernel' maps to '<layer>.d.kernel'."""

  def __init__(self, in_features, features, num_experts, dtype,
               generator=None, device='cuda'):
    super().__init__()
    self.d = _ExpertKernel(in_features, features, num_experts, dtype,
                           generator, device)

  def forward(self, xe):
    return self.d(xe)


class _MoEFFN(nn.Module):
  """Switch top-1 MoE FFN, shared by the packed model and its dense twin
  through `make_experts`.  forward(x, decode) -> (y, aux); decode routes
  drop-free (capacity = the step's token count)."""

  def __init__(self, d_model: int, d_ff: int, num_experts: int,
               make_experts: Callable, capacity_factor: float,
               dtype: torch.dtype, generator=None, device='cuda'):
    super().__init__()
    self.num_experts, self.capacity_factor = num_experts, capacity_factor
    self.dtype = dtype
    self.router = Linear(d_model, num_experts, torch.float32, generator,
                         device)
    self.fc1 = make_experts(d_model, d_ff, ('moe', 'fc1'))
    self.fc2 = make_experts(d_ff, d_model, ('moe', 'fc2'))

  def forward(self, x, decode: bool = False):
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d).float()
    E = self.num_experts
    cap = t if decode else max(int(math.ceil(t / E * self.capacity_factor)),
                               1)
    src, flat_ec, kept, gate, aux = ep.top1_gather_dispatch(self.router(x2d),
                                                            cap)
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))])
    xe = x_pad.index_select(0, src).reshape(E, cap, d).to(self.dtype)
    ye = self.fc2(F.gelu(self.fc1(xe), approximate='tanh'))
    y_tok = ye.float().reshape(E * cap, d).index_select(0, flat_ec)
    y2d = torch.where(kept, gate, 0.0)[:, None] * y_tok
    return y2d.to(self.dtype).reshape(b, s, d), aux


class _MoEBlock(nn.Module):

  def __init__(self, d_model: int, num_heads: int, d_ff: int,
               num_experts: int, make_proj: Callable, make_experts: Callable,
               capacity_factor: float, dtype: torch.dtype, generator=None,
               device='cuda'):
    super().__init__()
    self.ln1 = LayerNorm(d_model, dtype, device=device)
    self.attn = _Attention(d_model, num_heads, make_proj)
    self.ln2 = LayerNorm(d_model, dtype, device=device)
    self.moe = _MoEFFN(d_model, d_ff, num_experts, make_experts,
                       capacity_factor, dtype, generator, device)

  def forward(self, x, cache: Optional[dict] = None, kv_chunk: int = 0):
    x = x + self.attn(self.ln1(x), cache, kv_chunk)
    y, aux = self.moe(self.ln2(x), decode=cache is not None)
    return x + y, aux


class _MoEStack(_Stack):
  """Embedding -> MoE blocks -> final LayerNorm -> head, shared by both
  twins; decode twins and caches as _Stack's."""

  def _build_moe(self, num_layers, d_model, d_ff, num_heads, vocab_size,
                 num_experts, capacity_factor, dtype, make_proj,
                 make_experts, generator, device, kv_chunk):
    self.num_layers, self.d_model, self.d_ff = num_layers, d_model, d_ff
    self.num_heads, self.vocab_size, self.dtype = num_heads, vocab_size, dtype
    self.num_experts, self.capacity_factor = num_experts, capacity_factor
    self.fused_attention, self.kv_chunk = False, kv_chunk
    self.decode, self.max_decode_len = False, 0
    if vocab_size:
      self.embed = Embed(vocab_size, d_model, dtype, generator, device)

    def in_block(make, i):
      return lambda n_in, n_out, path: make(n_in, n_out, (f'block{i}', *path))

    for i in range(num_layers):
      self.add_module(f'block{i}', _MoEBlock(
          d_model, num_heads, d_ff, num_experts, in_block(make_proj, i),
          in_block(make_experts, i), capacity_factor, dtype, generator,
          device))
    self.ln_f = LayerNorm(d_model, dtype, device=device)
    if vocab_size:
      self.head = Linear(d_model, vocab_size, dtype, generator, device)

  def forward(self, x, cache: Optional[List[dict]] = None,
              with_aux: bool = False):
    if self.decode != (cache is not None):
      raise ValueError('a decode twin takes a cache (serve.init_cache); '
                       'the train-mode model takes none')
    if self.vocab_size:
      x = self.embed(x)
    aux = 0.0
    for i, block in enumerate(self.blocks):
      x, a = block(x, None if cache is None else cache[i], self.kv_chunk)
      aux = aux + a
    x = self.ln_f(x)
    if self.vocab_size:
      x = self.head(x)
    return (x, aux) if with_aux else x


class PackedMoETransformer(_MoEStack):
  """Decoder stack: packed attention projections and packed MoE FFNs.

  `sparsity`: float or SparsityMap over moe_layer_shapes' paths.
  Occupancies and weights are drawn from `generator` (torch's default
  generator when None)."""

  def __init__(self, num_layers: int = 2, d_model: int = 256,
               d_ff: int = 1024, num_heads: int = 8, vocab_size: int = 0,
               num_experts: int = 8, capacity_factor: float = 2.0,
               sparsity=0.8, block: Tuple[int, int] = (16, 16),
               bm: int = 128, dtype: torch.dtype = torch.float32,
               ep_axis: Optional[str] = None,
               token_axes: Tuple[str, ...] = (), kv_chunk: int = 0,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if ep_axis is not None or token_axes:
      raise NotImplementedError('expert parallelism (ep_axis, token_axes) '
                                'is not ported yet')
    self.sparsity, self.block, self.bm = sparsity, tuple(block), bm

    def proj(n_in, n_out, path):
      return PackedDense(n_in, n_out, sparsity=sparsity, block=block, bm=bm,
                         use_bias=False, dtype=dtype, path=path,
                         generator=generator, device=device)

    def experts(n_in, n_out, path):
      return _PackedExperts(n_in, n_out, num_experts, sparsity=sparsity,
                            block=block, bm=bm, dtype=dtype, path=path,
                            generator=generator, device=device)

    self._build_moe(num_layers, d_model, d_ff, num_heads, vocab_size,
                    num_experts, capacity_factor, dtype, proj, experts,
                    generator, device, kv_chunk)


class DenseMoETransformer(_MoEStack):
  """Equal-architecture dense twin: the same routing; the projections'
  kernels stored in `dtype`, the experts' (E, K, N) in float32."""

  def __init__(self, num_layers: int = 2, d_model: int = 256,
               d_ff: int = 1024, num_heads: int = 8, vocab_size: int = 0,
               num_experts: int = 8, capacity_factor: float = 2.0,
               dtype: torch.dtype = torch.float32, kv_chunk: int = 0,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def proj(n_in, n_out, path):
      del path
      return _Dense2D(n_in, n_out, dtype, generator, device)

    def experts(n_in, n_out, path):
      del path
      return _DenseExperts(n_in, n_out, num_experts, dtype, generator,
                           device)

    self._build_moe(num_layers, d_model, d_ff, num_heads, vocab_size,
                    num_experts, capacity_factor, dtype, proj, experts,
                    generator, device, kv_chunk)
