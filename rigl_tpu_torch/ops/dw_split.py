"""How the two weight-gradient kernels split their reduction over thread
blocks: the plan that `packed_dw_kernel` (csrc/packed_mm.cu, packed and
dense storage) and `tap_dw_kernel` (csrc/tap_conv.cu) both take.

A dw kernel owns output tiles and sums, for each, over a long axis: the m
rows of x and gy, or the N*H*W pixels of a conv.  When the tiles alone
leave the card idle (a few large blocks over 401408 rows, or a handful of
tap groups over a whole batch of images), the sum is cut into S slices of
whole chunks, one thread block per (tile, slice).  Each slice writes its
f32 partial tile into a workspace, and a second small kernel adds the S
partials in slice order and casts once into dw: no atomics, so two calls
on the same inputs give the same bits.  With S = 1 there is no workspace
and no second kernel.

S is chosen by a model of the time, in units of one chunk's work on one
thread block: the thread blocks run in rounds of `slots` (the SMs times
the blocks an SM holds), each round as long as a slice; with S > 1 every
thread block also writes a partial tile and the second kernel reads them
all (`partial`, a partial tile's bytes over a chunk's bytes).  A split
must save MIN_GAIN of the unsplit time, for what the model leaves out
(the workspace, the second launch).  A grid that fills the card in full
rounds keeps S = 1; a short grid, or one whose last round is mostly
empty, splits, within MAX_WAVES rounds of the card.
"""

from __future__ import annotations

import functools

import torch

MAX_WAVES = 4    # tiles x S stays within this many rounds of the card
MIN_GAIN = 0.1   # the least share of the unsplit time a split must save


@functools.lru_cache(maxsize=4096)
def split_plan(tiles: int, length: int, chunk: int, slots: int,
               partial: float = 2.0) -> int:
  """S, the number of slices of `length` (each whole chunks of `chunk`)
  for `tiles` output tiles on a card that runs `slots` thread blocks at
  once: the S of least modelled time (module docstring), the smallest of
  equals, with tiles x S <= MAX_WAVES x slots unless S = 1; S = 1 unless
  that saves MIN_GAIN, and where the sum is shorter than two chunks."""
  if tiles <= 0 or length < 2 * chunk:
    return 1
  chunks = -(-length // chunk)

  def cost(s):
    rounds = -(-tiles * s // slots)
    extra = partial if s > 1 else 0.0
    return rounds * (-(-chunks // s) + extra) + extra * tiles * s / slots

  most = min(chunks, max(1, MAX_WAVES * slots // tiles))
  best = min(range(1, most + 1), key=lambda s: (cost(s), s))
  if cost(best) > (1 - MIN_GAIN) * cost(1):
    return 1
  return fit(length, chunk, best)


def fit(length: int, chunk: int, slices: int) -> int:
  """`slices` brought within 1 .. the chunks of `length`, with no slice
  empty (what split_plan returns for the same count)."""
  chunks = max(1, -(-length // chunk))
  per = -(-chunks // max(1, min(slices, chunks)))
  return -(-chunks // per)


def slice_rows(length: int, chunk: int, slices: int) -> int:
  """The rows (pixels) of each slice but the last: whole chunks, so that
  slice s covers [s * rows, min(length, (s + 1) * rows))."""
  chunks = -(-length // chunk)
  return -(-chunks // slices) * chunk


@functools.cache
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
  """The SM count of a CUDA device, read once per device."""
  device = torch.device(device)
  return _sm_count(device.index if device.index is not None
                   else torch.cuda.current_device())
