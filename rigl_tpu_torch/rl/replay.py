"""Device-resident circular replay buffer, in PyTorch.

Counterpart of rigl_tpu/rl/replay.py (which replaces the reference's
Dopamine OutOfGraphReplayBuffer, host numpy): the transitions live on the
device, so adds and samples never copy to the host.  The write cursor
and the valid size are host integers (they follow the env-step count,
which the host knows), so `add` writes at a Python index and `sample`
draws below a Python bound: neither syncs.  `add` writes in place.
`sample` draws its indices from a generator and `gather` reads them, so
a test can hand JAX's indices to `gather`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass
class ReplayBuffer:
  obs: torch.Tensor        # (cap, *obs_shape)
  action: torch.Tensor     # (cap,) int32, or (cap, action_dim) float32
  reward: torch.Tensor     # (cap,)
  next_obs: torch.Tensor   # (cap, *obs_shape)
  done: torch.Tensor       # (cap,) bool
  ptr: int                 # write cursor
  size: int                # valid entries

  @property
  def capacity(self) -> int:
    return self.obs.shape[0]


def create(capacity: int, obs_shape: Tuple[int, ...],
           action_shape: Tuple[int, ...] = (), device='cuda') -> ReplayBuffer:
  """Discrete actions by default; pass action_shape=(action_dim,) for
  continuous control (float actions)."""
  action = (torch.zeros((capacity,), dtype=torch.int32, device=device)
            if tuple(action_shape) == () else
            torch.zeros((capacity,) + tuple(action_shape), device=device))
  return ReplayBuffer(
      obs=torch.zeros((capacity,) + tuple(obs_shape), device=device),
      action=action,
      reward=torch.zeros((capacity,), device=device),
      next_obs=torch.zeros((capacity,) + tuple(obs_shape), device=device),
      done=torch.zeros((capacity,), dtype=torch.bool, device=device),
      ptr=0, size=0)


def add(buf: ReplayBuffer, obs, action, reward, next_obs, done
        ) -> ReplayBuffer:
  """Writes one transition at the cursor, in place; returns `buf`."""
  i = buf.ptr
  buf.obs[i] = obs
  buf.action[i] = action
  buf.reward[i] = reward
  buf.next_obs[i] = next_obs
  buf.done[i] = done
  buf.ptr = (i + 1) % buf.capacity
  buf.size = min(buf.size + 1, buf.capacity)
  return buf


def gather(buf: ReplayBuffer, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
  """The transitions at `idx` (a 1-D index tensor on the buffer's
  device)."""
  return {'obs': buf.obs[idx], 'action': buf.action[idx],
          'reward': buf.reward[idx], 'next_obs': buf.next_obs[idx],
          'done': buf.done[idx]}


def sample_indices(buf: ReplayBuffer, gen: torch.Generator,
                   batch_size: int) -> torch.Tensor:
  """Uniform indices over the valid prefix (with replacement)."""
  return torch.randint(0, max(buf.size, 1), (batch_size,), generator=gen,
                       device=buf.obs.device)


def sample(buf: ReplayBuffer, gen: torch.Generator, batch_size: int
           ) -> Dict[str, torch.Tensor]:
  """Uniform sample over the valid prefix (with replacement)."""
  return gather(buf, sample_indices(buf, gen, batch_size))
