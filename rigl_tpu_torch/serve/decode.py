"""Autoregressive decoding on the packed/dense transformer family.

Counterpart of rigl_tpu/serve/decode.py.  `decode_twin(model, L)` is the
decode-mode twin of a train-mode model (the same modules and parameters);
`generate` prefills the prompt, samples the first token from the last
prompt logit, then runs `steps - 1` single-token steps against the
per-layer KV cache of `init_cache`.  JAX's jit + lax.scan program is an
eager Python loop here, run under torch.inference_mode(); the cache is
written in place.

Shapes: prompt (B, P) int32 or int64, generated tokens (B, steps) int32.
Variable-length batches: LEFT-pad each row to the common length and pass
`prompt_lens`; pad positions are masked out of every attention (the
family has no positional encoding, so a left-shifted row decodes as it
would alone).  Sampling draws from an explicit torch.Generator (on the
logits' device) where JAX took a key.  A request reads each float32
master weight cast to the compute dtype once (layers/packed_dense.
cached_casts), not once per step.  `kv_chunk` > 0 (decode_twin) visits
the cache in kv_chunk pieces and never reads the pieces past the live
prefix.  The MoE family (models/packed_moe.py) decodes DROP-FREE: its
stack runs every MoE FFN in decode mode whenever it is given a cache
(capacity = the step's token count, B * P at prefill and B a step), so
with no drops each token's output is its own and incremental decoding
equals the full causal forward at a capacity that drops nothing.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import torch

from rigl_tpu_torch.layers.packed_dense import cached_casts

_NEG = torch.finfo(torch.float32).min


def decode_twin(model, max_decode_len: int, kv_chunk: int = 0):
  """The decode-mode twin of a train-mode PackedTransformer /
  DenseTransformer / PackedMoETransformer / DenseMoETransformer: a
  shallow copy that shares every submodule and
  parameter, with an L-token KV cache.  kv_chunk > 0: chunked cache
  attention, with per-step KV reads that scale with the live prefix (it
  must divide L; models/packed_transformer._chunked_cache_attend)."""
  if not getattr(model, 'vocab_size', 0):
    raise ValueError('decoding requires vocab_size > 0 (token inputs)')
  if max_decode_len < 1:
    raise ValueError('decoding requires max_decode_len >= 1')
  if kv_chunk < 0 or (kv_chunk and max_decode_len % kv_chunk):
    raise ValueError(f'kv_chunk={kv_chunk} must divide '
                     f'max_decode_len={max_decode_len}')
  twin = copy.copy(model)
  twin.decode = True
  twin.max_decode_len = max_decode_len
  twin.kv_chunk = kv_chunk
  return twin


def init_cache(model, batch: int) -> List[dict]:
  """Zeroed per-layer cache for `batch` sequences of a decode twin:
  cached_key / cached_value (batch, heads, L, head_dim) in the model's
  dtype, the running `index` and the per-row left-pad count `pad_len`."""
  if not getattr(model, 'decode', False):
    raise ValueError('init_cache takes a decode twin (decode_twin)')
  device = next(model.parameters()).device
  h = model.num_heads
  shape = (batch, h, model.max_decode_len, model.d_model // h)
  return [dict(cached_key=torch.zeros(shape, dtype=model.dtype,
                                      device=device),
               cached_value=torch.zeros(shape, dtype=model.dtype,
                                        device=device),
               index=0,
               pad_len=torch.zeros(batch, dtype=torch.int32, device=device))
          for _ in range(model.num_layers)]


def _set_pad_lens(cache: List[dict], pad) -> List[dict]:
  """Stamp the per-row left-pad count into every layer's 'pad_len'."""
  for layer in cache:
    layer['pad_len'] = torch.as_tensor(
        pad, dtype=torch.int32, device=layer['pad_len'].device
    ).expand_as(layer['pad_len']).clone()
  return cache


def _filter_logits(logits, temperature: float, top_k: int = 0,
                   top_p: float = 1.0):
  """Temperature, then top-k (ties with the k-th kept), then top-p (the
  smallest sorted prefix whose mass reaches top_p, crossing token and the
  top token always kept); filtered-out logits become float32 min."""
  logits = logits.float() / temperature
  if top_k and top_k < logits.shape[-1]:
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    logits = torch.where(logits >= kth, logits, _NEG)
  if top_p < 1.0:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p
    keep[..., 0] = True
    min_kept = torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)
    logits = torch.where(logits >= min_kept, logits, _NEG)
  return logits


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: int = 0, top_p: float = 1.0):
  """Greedy (temperature 0: argmax, first maximum) or a categorical draw
  from the filtered logits by the Gumbel-max rule, as jax.random does."""
  if temperature == 0.0:
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
  logits = _filter_logits(logits, temperature, top_k, top_p)
  u = torch.rand(logits.shape, generator=generator, device=logits.device)
  tiny = torch.finfo(torch.float32).tiny
  gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
  return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def make_generate_fn(model, steps: int, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0):
  """(prompt, generator=None, prompt_lens=None) -> (B, steps) tokens, for
  a decode twin `model`."""
  if steps < 1:
    raise ValueError('steps must be >= 1')

  def run(prompt: torch.Tensor, generator: Optional[torch.Generator] = None,
          prompt_lens=None) -> torch.Tensor:
    b, p = prompt.shape
    if p + steps > model.max_decode_len:
      raise ValueError(f'prompt {p} + steps {steps} exceeds '
                       f'max_decode_len {model.max_decode_len}')
    with torch.inference_mode(), cached_casts(model):
      cache = init_cache(model, b)
      if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, dtype=torch.int32,
                               device=prompt.device)
        _set_pad_lens(cache, p - lens)
      logits = model(prompt, cache)
      tok = _sample(logits[:, -1], generator, temperature, top_k, top_p)
      toks = [tok]
      for _ in range(steps - 1):
        logits = model(tok[:, None], cache)
        tok = _sample(logits[:, 0], generator, temperature, top_k, top_p)
        toks.append(tok)
      return torch.stack(toks, dim=1)

  return run


def generate(model, prompt: torch.Tensor, steps: int, *,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
             prompt_lens=None) -> torch.Tensor:
  """Convenience wrapper over make_generate_fn."""
  fn = make_generate_fn(model, steps, temperature, top_k, top_p)
  return fn(prompt, generator, prompt_lens)
