"""How the decode branch of the forward / dx kernels splits each output
tile's contraction over a thread-block cluster: the plan that
`packed_mm_decode_kernel` (csrc/packed_mm.cu) takes.

At decode (m <= 32 rows) the forward and dx are bound by the bytes of the
weights, and an output tile -- an m-tile of 8, 16 or 32 rows (`tile_rows`)
times TILE columns of one output block-column -- has a long contraction
(its column's actives, `seg` deep each) and few siblings: serving's fc2
(4 block-columns of 512) has 32 tiles for the 132 SMs of an H100.  So the
tile's contraction, cut into chunks of 128 bytes of a row (CHUNK), is cut
again into S contiguous ranges of whole chunks, one thread block a range.
The S blocks form a cluster and add their f32 partial tiles in rank order
through distributed shared memory: one launch, no workspace, the same
bits on every call.

S is the largest of 1, 2, 4, 8 (the portable cluster sizes) that keeps
tiles x S within BLOCKS_PER_SM blocks an SM and gives each rank of the
longest column at least one chunk; S = 1 once the tiles alone fill the
card.  A block at decode takes 42-67 KB of shared memory, so that many
are resident at once and every block's loads are in flight from the
start: a larger S shortens the longest column's chain of chunks, which
bounds the call, and costs a cluster reduction and more blocks to launch
(on an H100, S = 4 beat S = 2 at serving's qkv and fc1 and S = 8 beat S
= 4 at its out and fc2: chip_smoke.py phase 3a times every S).  Uncapped,
tiles x S lies between 2 and 4 blocks an SM.  The plan is computed on the
host from shapes and the packing's longest column (cached per Packing),
so a call waits for nothing on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

TILE = 64            # output columns of a tile: wgmma's M, one warpgroup
STAGES = 4           # the ring's depth
STAGE_W_BYTES = 8192   # W a stage: TILE columns x 128 bytes of contraction
MAX_SLICES = 8       # the portable cluster size
BLOCKS_PER_SM = 4    # tiles x S stays within this many blocks an SM
SMEM_PER_SM = 228 * 1024   # shared memory of an SM (H100: 228 KB)
# Contraction a chunk: 128 bytes of a row (the TMA boxes' inner width).
CHUNK = {torch.bfloat16: 64, torch.float32: 32}


class DecodePlan(NamedTuple):
  """One decode call's split: `slices` (S) blocks a cluster, m-tiles of
  `rows` rows, the grid (S x column tiles, m-tiles), the output `tiles`,
  the longest column's contraction in `chunks`, and the bytes of a ring
  stage (`stage_bytes`: W and x) and of a block's shared memory
  (`smem_bytes`, as csrc/packed_mm.cu DecLayout lays it out)."""
  slices: int
  rows: int
  grid: Tuple[int, int]
  tiles: int
  chunks: int
  stage_bytes: int
  smem_bytes: int

  def bytes_in_flight_per_sm(self, sm_count: int) -> int:
    """The ring bytes an SM holds in flight: its blocks (the grid spread
    over the SMs, within what their shared memory allows) times the
    stages a block fills (at most the chunks of its range) times a
    stage's bytes."""
    blocks = self.grid[0] * self.grid[1]
    per_sm = min(-(-blocks // sm_count), SMEM_PER_SM // self.smem_bytes)
    stages = min(STAGES, -(-self.chunks // self.slices))
    return per_sm * stages * self.stage_bytes


def tile_rows(m: int) -> int:
  """The m-tile of a call of m rows: wgmma's N, 8, 16 or 32."""
  return 8 if m <= 8 else 16 if m <= 16 else 32


@functools.lru_cache(maxsize=4096)
def decode_plan(m: int, out_w: int, ngroups: int, seg: int, longest: int,
                dtype, sm_count: int,
                slices: Optional[int] = None) -> DecodePlan:
  """The plan of one decode call: m rows, `ngroups` output block-columns
  `out_w` wide (bn forward, bk dx), a contraction of `seg` per active (bk
  forward, bn dx), at most `longest` actives in a column, in `dtype`, on
  a card of sm_count SMs; `slices` forces S (1, 2, 4 or 8) where given."""
  rows = tile_rows(m)
  m_tiles = -(-m // rows)
  col_tiles = ngroups * -(-out_w // TILE)
  tiles = m_tiles * col_tiles
  chunks = longest * -(-seg // CHUNK[dtype])
  if slices is None:
    slices = 1
    if tiles < sm_count:
      while (2 * slices <= MAX_SLICES and 2 * slices <= chunks
             and tiles * 2 * slices <= BLOCKS_PER_SM * sm_count):
        slices *= 2
  stage = STAGE_W_BYTES + rows * 128
  partials = rows * (TILE + 4) * 4 + rows * TILE * 4   # its own, received
  return DecodePlan(slices, rows, (slices * col_tiles, m_tiles), tiles,
                    chunks, stage,
                    1024 + STAGES * stage + partials + 16 * STAGES + 8)
