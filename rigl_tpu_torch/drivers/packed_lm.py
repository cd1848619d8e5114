"""Packed block-sparse transformer LM driver: causal language modelling
where every parameter matmul's weights, gradients and Adam slots live as
`(n_active, bk, bn)` packed blocks (train/packed_lm.py), with RigL, SET or
SNFS drop/grow ON packed storage.

Counterpart of rigl_tpu/drivers/packed_lm.py, with the flags its `main`
reads and their defaults, on argparse, plus --device (default cuda).
--n_experts=E > 0 trains the packed Switch-MoE transformer (E experts a
block, --capacity_factor, --aux_loss_weight).  The parallel flags
(n_data, n_model, n_pipe, n_seq, n_expert) are accepted at their
single-device values only.

  python -m rigl_tpu_torch.drivers.packed_lm --train_steps=2000 \\
      --end_sparsity=0.8 --data_file=/path/to/corpus.txt --lm_dtype=bfloat16
  python -m rigl_tpu_torch.drivers.packed_lm --n_experts=8 --lm_dtype=bfloat16
  # a deterministic synthetic byte stream when --data_file is unset;
  # --device=cpu runs the plain versions of the kernels

Data: `--data_file` is any local file, read byte-level (vocab 256) with a
90/10 train/eval split.  It prints progress lines and a JSON result; with
--output_dir it resumes from and writes a checkpoint (the JAX trainer's
packed_lm_state.npz layout) and result.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def synthetic_stream(n: int = 200_000, seed: int = 0) -> np.ndarray:
  """Deterministic learnable byte stream: a noisy order-2 Markov walk over
  a 64-symbol alphabet (the JAX driver's, value for value)."""
  rs = np.random.RandomState(seed)
  table = rs.randint(0, 64, size=(64, 64))
  out = np.empty(n, np.int64)
  out[0], out[1] = 1, 2
  noise = rs.rand(n)
  rand_sym = rs.randint(0, 64, size=n)
  for i in range(2, n):
    out[i] = rand_sym[i] if noise[i] < 0.1 else \
        table[out[i - 2], out[i - 1]]
  return out.astype(np.int32)


def load_tokens(data_file: Optional[str], seq_len: int, seed: int):
  """(tokens, vocab, source): the file's bytes, or the synthetic stream."""
  if data_file:
    raw = np.fromfile(data_file, dtype=np.uint8)
    if len(raw) < 10 * (seq_len + 1):
      raise ValueError(f'--data_file too small: {len(raw)} bytes')
    return raw.astype(np.int32), 256, 'file:' + os.path.basename(data_file)
  return synthetic_stream(seed=seed), 64, 'synthetic'


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--training_method', default='rigl',
                 help='rigl | set | momentum (SNFS) | static')
  p.add_argument('--end_sparsity', type=float, default=0.8)
  p.add_argument('--mask_init_method', default='erdos_renyi_kernel',
                 help='random | erdos_renyi | erdos_renyi_kernel')
  p.add_argument('--erk_power_scale', type=float, default=1.0)
  p.add_argument('--maskupdate_begin_step', type=int, default=0)
  p.add_argument('--maskupdate_end_step', type=int, default=750)
  p.add_argument('--maskupdate_frequency', type=int, default=100)
  p.add_argument('--drop_fraction', type=float, default=0.3)
  p.add_argument('--drop_fraction_anneal', default='cosine',
                 help='constant|cosine|exponential_<p>')
  p.add_argument('--train_steps', type=int, default=1000)
  p.add_argument('--training_steps_multiplier', type=float, default=1.0)
  p.add_argument('--batch_size', type=int, default=8)
  p.add_argument('--learning_rate', type=float, default=1e-3)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--output_dir', default=None, help='checkpoint + result')
  p.add_argument('--log_every', type=int, default=100)
  p.add_argument('--data_file', default=None,
                 help='any local file, read as a byte stream (synthetic '
                 'stream if unset)')
  p.add_argument('--num_layers', type=int, default=2)
  p.add_argument('--d_model', type=int, default=256)
  p.add_argument('--d_ff', type=int, default=1024)
  p.add_argument('--num_heads', type=int, default=8)
  p.add_argument('--seq_len', type=int, default=128)
  p.add_argument('--packed_block', default='16,16',
                 help='block (bk,bn) of packed storage')
  p.add_argument('--packed_bm', type=int, default=128)
  p.add_argument('--lm_dtype', default='float32', help='float32|bfloat16')
  p.add_argument('--warmup_steps', type=int, default=50)
  p.add_argument('--snfs_momentum', type=float, default=0.9)
  for name in ('n_data', 'n_model', 'n_pipe', 'n_seq', 'n_expert'):
    p.add_argument(f'--{name}', type=int, default=1,
                   help='single-device value only')
  p.add_argument('--n_micro', type=int, default=0)
  p.add_argument('--n_experts', type=int, default=0,
                 help='>0: Switch top-1 MoE FFN with this many experts')
  p.add_argument('--capacity_factor', type=float, default=2.0)
  p.add_argument('--aux_loss_weight', type=float, default=0.01)
  p.add_argument('--generate_steps', type=int, default=0,
                 help='after training, sample this many tokens through '
                 'the serving decode path')
  p.add_argument('--generate_prompt', default='',
                 help='prompt text (byte-level; defaults to the first '
                 'training window)')
  p.add_argument('--generate_temperature', type=float, default=0.8)
  p.add_argument('--generate_top_k', type=int, default=0)
  p.add_argument('--generate_top_p', type=float, default=1.0)
  p.add_argument('--generate_kv_chunk', type=int, default=0,
                 help='chunked KV-cache attention (0 = off)')
  p.add_argument('--device', default='cuda', help='torch device')
  return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
  from rigl_tpu_torch.train.packed_lm import PackedLMConfig, PackedLMTrainer

  args = parse_args(argv)
  if args.training_method not in ('rigl', 'set', 'momentum', 'static'):
    raise ValueError('packed LM driver supports rigl / set / momentum '
                     '(SNFS) drop/grow or static (frozen topology), got '
                     f'{args.training_method!r}')
  # 'momentum' is the reference's name for SNFS; static freezes the
  # topology through end_step=0 and rides the rigl code path.
  algo = {'rigl': 'rigl', 'static': 'rigl', 'set': 'set',
          'momentum': 'snfs'}[args.training_method]
  static = args.training_method == 'static'

  tokens, vocab, source = load_tokens(args.data_file, args.seq_len,
                                      args.seed)
  split = int(len(tokens) * 0.9)
  train_tokens, eval_tokens = tokens[:split], tokens[split:]

  cfg = PackedLMConfig(
      vocab_size=vocab, num_layers=args.num_layers, d_model=args.d_model,
      d_ff=args.d_ff, num_heads=args.num_heads, seq_len=args.seq_len,
      sparsity=args.end_sparsity,
      sparsity_distribution=args.mask_init_method,
      erk_power_scale=args.erk_power_scale,
      block=tuple(int(b) for b in args.packed_block.split(',')),
      bm=args.packed_bm, dtype=args.lm_dtype,
      learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
      train_steps=int(args.train_steps * args.training_steps_multiplier),
      batch_size=args.batch_size,
      maskupdate_begin_step=args.maskupdate_begin_step,
      maskupdate_end_step=0 if static else args.maskupdate_end_step,
      maskupdate_frequency=args.maskupdate_frequency,
      drop_fraction=args.drop_fraction,
      drop_fraction_anneal='constant' if static else args.drop_fraction_anneal,
      seed=args.seed, algo=algo, snfs_momentum=args.snfs_momentum,
      n_data=args.n_data, n_model=args.n_model, n_pipe=args.n_pipe,
      n_micro=args.n_micro, n_seq=args.n_seq, n_experts=args.n_experts,
      capacity_factor=args.capacity_factor,
      aux_loss_weight=args.aux_loss_weight, n_expert=args.n_expert)

  trainer = PackedLMTrainer(cfg, device=args.device)
  if args.output_dir and trainer.restore(args.output_dir):
    print(f'# resumed at step {trainer.step}')

  result = trainer.train(train_tokens, eval_tokens=eval_tokens,
                         progress_fn=print, log_every=args.log_every)
  result.update(data_source=source, vocab_size=vocab,
                sparsity_distribution=args.mask_init_method,
                device=str(trainer.device))

  if args.output_dir:
    trainer.save(args.output_dir)
    with open(os.path.join(args.output_dir, 'result.json'), 'w') as f:
      json.dump(result, f, indent=2)

  if args.generate_steps:
    if args.generate_prompt:
      prompt = np.frombuffer(args.generate_prompt.encode('utf-8'),
                             np.uint8).astype(np.int32) % vocab
    else:
      prompt = np.asarray(train_tokens[:32], np.int32)
    out = trainer.generate(prompt, args.generate_steps,
                           temperature=args.generate_temperature,
                           top_k=args.generate_top_k,
                           top_p=args.generate_top_p,
                           kv_chunk=args.generate_kv_chunk, seed=args.seed)
    result['generated_tokens'] = out[0].tolist()
    if vocab == 256:
      result['generated_text'] = bytes(out[0].tolist()).decode(
          'utf-8', errors='replace')

  print(json.dumps(result, indent=2))
  return result


if __name__ == '__main__':
  main()
