"""Transformer blocks on PACKED block-sparse storage, in PyTorch.

Counterpart of rigl_tpu/models/packed_transformer.py.  Every parameter
matmul (fused QKV, attention output, both FFN matmuls) is a PackedDense;
attention, LayerNorm, GELU, the embedding and the head stay dense.  The
family has no positional encoding.  `DenseTransformer` is the
equal-architecture dense twin, whose projections are plain
`torch.matmul` with (in, out) kernels.

Parameters follow flax's dtypes: the packed kernels, the embedding, the
head and the LayerNorms are float32 master weights cast to `dtype` on
each call (layers/packed_dense.MasterWeight); only the dense twin's
projections are stored in `dtype` (flax `param_dtype=dtype` there).

Module and parameter names follow the flax paths ('block0.attn.qkv.kernel'
for 'block0/attn/qkv/kernel'), so convert.py maps a JAX variable tree by
joining its path with dots.

`fused_attention=True` runs the causal softmax(QKᵀ)V core through
ops/flash_attention.py (the Hopper flash kernels on the card, their plain
versions on the CPU), where JAX calls its TPU flash kernel.

Decoding: `forward(x, cache)` with the per-layer cache of
rigl_tpu_torch/serve/decode.py runs the KV-cache branch; the cache is
updated in place (the JAX model returns a new cache collection).  With
`kv_chunk` set on the decode twin, cache attention visits the cache in
kv_chunk pieces combined by online softmax and skips, with a Python `if`,
the pieces past the live prefix (JAX skips them with lax.cond).

Not ported yet, and raising NotImplementedError: sequence parallelism
(`seq_axis`) and tensor parallelism (`tp_shards > 1`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.layers.packed_dense import MasterWeight, PackedDense
from rigl_tpu_torch.ops.flash_attention import flash_attention

_NEG = torch.finfo(torch.float32).min


def transformer_layer_shapes(d_model: int, d_ff: int):
  """Dense kernel shapes of one block's packed matmuls, keyed by the
  canonical (blockless) layer paths that resolve_sparsity's suffix lookup
  matches from any block."""
  return {
      'attn/qkv/kernel': (d_model, 3 * d_model),
      'attn/out/kernel': (d_model, d_model),
      'fc1/kernel': (d_model, d_ff),
      'fc2/kernel': (d_ff, d_model),
  }


def _not_ported(seq_axis=None, tp_shards=1):
  for name, on in (('seq_axis', seq_axis is not None),
                   ('tp_shards > 1', tp_shards > 1)):
    if on:
      raise NotImplementedError(f'{name} is not ported yet')


class LayerNorm(nn.Module):
  """flax.linen.LayerNorm: f32 statistics with Var = E[x^2] - E[x]^2,
  epsilon 1e-6, f32 scale and bias, result in `dtype`."""

  def __init__(self, d: int, dtype: torch.dtype, eps: float = 1e-6,
               device='cuda'):
    super().__init__()
    self.dtype, self.eps = dtype, eps
    self.scale = nn.Parameter(torch.ones(d, device=device))
    self.bias = nn.Parameter(torch.zeros(d, device=device))

  def forward(self, x):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
    mul = torch.rsqrt(var + self.eps) * self.scale
    return ((xf - mean) * mul + self.bias).to(self.dtype)


class Linear(MasterWeight, nn.Module):
  """x @ kernel with an (in, out) kernel and no bias (flax nn.Dense): the
  kernel is stored in `param_dtype` and used in `dtype`."""

  def __init__(self, in_features: int, features: int, dtype: torch.dtype,
               generator: Optional[torch.Generator] = None, device='cuda',
               param_dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    gdev = generator.device if generator else None
    kernel = torch.randn((in_features, features), generator=generator,
                         device=gdev) / math.sqrt(in_features)
    self.kernel = nn.Parameter(kernel.to(device=device, dtype=param_dtype))

  def forward(self, x):
    return x.to(self.dtype) @ self.compute_weight()


class _Dense2D(nn.Module):
  """The dense twin's projection (flax path '<name>/d/kernel'), stored in
  `dtype` as JAX's `_Dense2D` stores it."""

  def __init__(self, in_features, features, dtype, generator=None,
               device='cuda'):
    super().__init__()
    self.d = Linear(in_features, features, dtype, generator, device,
                    param_dtype=dtype)

  def forward(self, x):
    return self.d(x)


class Embed(MasterWeight, nn.Module):
  """Token embedding (flax nn.Embed): an f32 (vocab, d) table, looked up
  in `dtype`."""

  weight_name = 'embedding'

  def __init__(self, vocab: int, d: int, dtype: torch.dtype,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    gdev = generator.device if generator else None
    table = torch.randn((vocab, d), generator=generator, device=gdev)
    self.embedding = nn.Parameter(
        (table / math.sqrt(d)).to(device=device, dtype=torch.float32))

  def forward(self, tokens):
    return F.embedding(tokens, self.compute_weight())


class _Attention(nn.Module):
  """Causal multi-head self-attention with projections from `make_proj`.

  `fused`: the softmax(QKᵀ)V core runs through flash_attention (the decode
  branch ignores it, as JAX's does).  With a cache (decode): the s_in new
  k/v are written at the cache's running index, q attends to the whole
  cache under a global-position causal mask, and the per-row 'pad_len'
  masks left-pad positions out; `kv_chunk` > 0 takes the chunked path."""

  def __init__(self, d_model: int, num_heads: int, make_proj: Callable,
               fused: bool = False):
    super().__init__()
    self.num_heads, self.fused = num_heads, fused
    self.qkv = make_proj(d_model, 3 * d_model, ('attn', 'qkv'))
    self.out = make_proj(d_model, d_model, ('attn', 'out'))

  def forward(self, x, cache: Optional[dict] = None, kv_chunk: int = 0):
    b, s, d = x.shape
    h = self.num_heads
    hd = d // h
    qkv = self.qkv(x.reshape(b * s, d))
    q, k, v = qkv.reshape(b, s, 3 * d).split(d, dim=-1)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, h, hd).transpose(1, 2)
    v = v.reshape(b, s, h, hd).transpose(1, 2)
    if cache is not None:
      start = self._cache_write(k, v, cache, s)
      q_pos = start + torch.arange(s, device=x.device)
      if kv_chunk:
        o = _chunked_cache_attend(q, cache['cached_key'],
                                  cache['cached_value'], q_pos,
                                  cache['pad_len'], kv_chunk)
      else:
        k_pos = torch.arange(cache['cached_key'].shape[2], device=x.device)
        mask = ((k_pos[None, :] <= q_pos[:, None])[None, None]
                & (k_pos[None, :] >= cache['pad_len'][:, None])
                [:, None, None, :])
        o = _attend(q, cache['cached_key'], cache['cached_value'], mask)
    elif self.fused:
      o = flash_attention(q, k, v, 1.0 / math.sqrt(hd))
    else:
      pos = torch.arange(s, device=x.device)
      o = _attend(q, k, v, (pos[None, :] <= pos[:, None])[None, None])
    o = o.transpose(1, 2).reshape(b * s, d)
    return self.out(o).reshape(b, s, d)

  @staticmethod
  def _cache_write(k, v, cache, s) -> int:
    """Writes k/v at the running index (in place), advances it, and
    returns the position of the first new token."""
    ck, cv = cache['cached_key'], cache['cached_value']
    L = ck.shape[2]
    start = cache['index']
    if start + s > L:
      raise ValueError(f'cache overflow: {start} + {s} > max_decode_len {L}')
    ck[:, :, start:start + s] = k
    cv[:, :, start:start + s] = v
    cache['index'] = start + s
    return start


def _attend(q, k, v, mask):
  """softmax(q kᵀ / sqrt(hd), masked) v with f32 softmax statistics.  A
  fully masked (left-pad) query row gets a uniform, finite softmax that is
  never read."""
  logits = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(
      q.shape[-1])
  logits = logits.masked_fill(~mask, _NEG)
  probs = torch.softmax(logits, -1).to(v.dtype)
  return torch.matmul(probs, v)


def _chunked_cache_attend(q, ck, cv, q_pos, pad, chunk: int):
  """Online-softmax cache attention over kv_chunk pieces in f32 (JAX's
  `_chunked_cache_attend`); pieces at or past the live end (the last query
  position + 1) are never read.  A query with no visible key (a left-pad
  row) gets zeros, finite and never read."""
  L = ck.shape[2]
  if L % chunk:
    raise ValueError(f'kv_chunk={chunk} must divide max_decode_len={L}')
  b, h, s, hd = q.shape
  qf = q.float()
  scale = 1.0 / math.sqrt(hd)
  live_end = int(q_pos[-1]) + 1
  m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
  l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
  acc = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
  for lo in range(0, L, chunk):
    if live_end <= lo:          # this piece and every later one: not live
      break
    kpos = lo + torch.arange(chunk, device=q.device)
    lg = torch.matmul(qf, ck[:, :, lo:lo + chunk].float().transpose(-1, -2)
                      ) * scale
    mask = ((kpos[None, :] <= q_pos[:, None])[None, None]
            & (kpos[None, :] >= pad[:, None])[:, None, None, :])
    lg = torch.where(mask, lg, _NEG)
    mc = torch.maximum(m, lg.amax(-1))
    p = torch.where(mask, torch.exp(lg - mc[..., None]), 0.0)
    corr = torch.exp(m - mc)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.matmul(
        p, cv[:, :, lo:lo + chunk].float())
    m = mc
  return (acc / l.clamp(min=1e-30)[..., None]).to(cv.dtype)


class _Block(nn.Module):

  def __init__(self, d_model: int, num_heads: int, d_ff: int,
               make_proj: Callable, dtype: torch.dtype, device='cuda',
               fused: bool = False):
    super().__init__()
    self.ln1 = LayerNorm(d_model, dtype, device=device)
    self.attn = _Attention(d_model, num_heads, make_proj, fused)
    self.ln2 = LayerNorm(d_model, dtype, device=device)
    self.fc1 = make_proj(d_model, d_ff, ('fc1',))
    self.fc2 = make_proj(d_ff, d_model, ('fc2',))

  def forward(self, x, cache: Optional[dict] = None, kv_chunk: int = 0):
    b, s, d = x.shape
    x = x + self.attn(self.ln1(x), cache, kv_chunk)
    h = self.fc1(self.ln2(x).reshape(b * s, d))
    h = self.fc2(F.gelu(h, approximate='tanh'))
    return x + h.reshape(b, s, d)


class _Stack(nn.Module):
  """Embedding -> blocks -> final LayerNorm -> head, shared by both twins.

  vocab_size == 0: pre-embedded (B, S, d_model) inputs and outputs.
  decode (set by serve.decode_twin): forward(tokens, cache) is required
  to carry a cache from serve.init_cache; kv_chunk applies to it only."""

  def _build(self, num_layers, d_model, d_ff, num_heads, vocab_size, dtype,
             make_proj, generator, device, fused_attention, kv_chunk):
    self.num_layers, self.d_model, self.d_ff = num_layers, d_model, d_ff
    self.num_heads, self.vocab_size, self.dtype = num_heads, vocab_size, dtype
    self.fused_attention, self.kv_chunk = fused_attention, kv_chunk
    self.decode, self.max_decode_len = False, 0
    if vocab_size:
      self.embed = Embed(vocab_size, d_model, dtype, generator, device)
    for i in range(num_layers):
      self.add_module(f'block{i}', _Block(
          d_model, num_heads, d_ff,
          lambda n_in, n_out, path, i=i: make_proj(n_in, n_out,
                                                   (f'block{i}', *path)),
          dtype, device, fused_attention))
    self.ln_f = LayerNorm(d_model, dtype, device=device)
    if vocab_size:
      self.head = Linear(d_model, vocab_size, dtype, generator, device)

  @property
  def blocks(self) -> List[_Block]:
    return [getattr(self, f'block{i}') for i in range(self.num_layers)]

  def forward(self, x, cache: Optional[List[dict]] = None):
    if self.decode != (cache is not None):
      raise ValueError('a decode twin takes a cache (serve.init_cache); '
                       'the train-mode model takes none')
    if self.vocab_size:
      x = self.embed(x)
    for i, block in enumerate(self.blocks):
      if cache is None:
        x = block(x)
      else:
        x = block(x, cache[i], self.kv_chunk)
    x = self.ln_f(x)
    if self.vocab_size:
      x = self.head(x)
    return x


class PackedTransformer(_Stack):
  """Decoder stack whose parameter matmuls are packed block-sparse.

  `sparsity`: float (uniform) or SparsityMap over the canonical layer
  paths (transformer_layer_shapes).  Occupancies and initial weights are
  drawn from `generator` (torch's default generator when None).
  """

  def __init__(self, num_layers: int = 2, d_model: int = 512,
               d_ff: int = 2048, num_heads: int = 8, vocab_size: int = 0,
               sparsity=0.8, block: Tuple[int, int] = (128, 128),
               bm: int = 512, dtype: torch.dtype = torch.float32,
               tp_shards: int = 1, seq_axis: Optional[str] = None,
               fused_attention: bool = False, kv_chunk: int = 0,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    _not_ported(seq_axis, tp_shards)
    self.sparsity, self.block, self.bm = sparsity, tuple(block), bm

    def proj(n_in, n_out, path):
      return PackedDense(n_in, n_out, sparsity=sparsity, block=block, bm=bm,
                         use_bias=False, dtype=dtype, path=path,
                         generator=generator, device=device)

    self._build(num_layers, d_model, d_ff, num_heads, vocab_size, dtype,
                proj, generator, device, fused_attention, kv_chunk)


class DenseTransformer(_Stack):
  """Equal-architecture dense twin; its projections' kernels are stored in
  `dtype`, the embedding, head and LayerNorms in float32."""

  def __init__(self, num_layers: int = 2, d_model: int = 512,
               d_ff: int = 2048, num_heads: int = 8, vocab_size: int = 0,
               dtype: torch.dtype = torch.float32,
               fused_attention: bool = False, kv_chunk: int = 0,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def proj(n_in, n_out, path):
      del path
      return _Dense2D(n_in, n_out, dtype, generator, device)

    self._build(num_layers, d_model, d_ff, num_heads, vocab_size, dtype,
                proj, generator, device, fused_attention, kv_chunk)
