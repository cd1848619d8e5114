"""Environments of the RL workload as device tensors, in PyTorch.

Counterpart of rigl_tpu/rl/envs.py: CartPole (discrete, DQN / PPO),
Pendulum (continuous, SAC) and the MinAtar-style Breakout, Freeway,
Asterix and SpaceInvaders, whose 10x10 image observations drive the
NatureDQN / Impala conv nets.  Every env is unbatched and fully
observable: the observation channels carry the whole state, so
`EnvState` is the shared (obs, done, t, gen) tuple, and the state lives
on the env's device, where the Q-network reads the observation with no
copy.

What changes in PyTorch:
  * the state's key is a torch.Generator on the env's device
    (`EnvState.gen`).  A step draws everything it may need at once
    (`step_draws`: one uniform vector, from which the named draws are
    derived), then runs its deterministic transition
    (`transition(obs, t, action, draws)`); a test hands both packages
    the same draws through `transition`.  The draws are the reset
    observation (every env resets in the step that ends an episode),
    Asterix's fresh golds and nothing else: JAX's Space Invaders splits
    a shot key it never reads.
  * a step makes no host sync: cells are written by comparing index
    grids, positions read by argmax (the first maximum, as JAX's), and
    every branch is a torch.where.  `t` is an int32 tensor, `done` a
    bool tensor, the reward a float32 tensor.
  * JAX's out-of-range scatters are dropped; the grids' comparisons match
    no cell there, which is the same.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

Draws = Dict[str, torch.Tensor]


class EnvState(NamedTuple):
  obs: torch.Tensor     # the full state, as observed
  done: torch.Tensor    # bool: the step that made this state ended an episode
  t: torch.Tensor       # int32 step count within the episode
  gen: torch.Generator  # the env's draws, on its device


def env_device(device) -> torch.device:
  """`device` as a torch.device; CUDA asked for where there is none
  raises (no fallback to the CPU)."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'{device} requested but CUDA is not available '
                       '(pass device="cpu")')
  return device


def _randint(u: torch.Tensor, n: int) -> torch.Tensor:
  """Integers uniform in [0, n) from uniforms in [0, 1)."""
  return torch.clamp((u * n).floor().to(torch.int64), max=n - 1)


class _Env:
  """Shared reset / step over the subclass's draws and transition."""

  N_DRAWS = 0

  def __init__(self, device='cuda'):
    self.device = env_device(device)

  def _uniforms(self, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(self.N_DRAWS, generator=gen, device=self.device)

  def reset(self, gen: torch.Generator) -> EnvState:
    obs = self._reset_obs(self.step_draws(gen))
    return EnvState(obs=obs,
                    done=torch.zeros((), dtype=torch.bool, device=self.device),
                    t=torch.zeros((), dtype=torch.int32, device=self.device),
                    gen=gen)

  def step(self, state: EnvState, action: torch.Tensor, draws=None
           ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """Returns (next_state, reward, done); auto-resets when done.  `draws`
    (the form step_draws gives) stands in for the state's generator."""
    if draws is None:
      draws = self.step_draws(state.gen)
    obs, t, reward, done = self.transition(state.obs, state.t, action, draws)
    return EnvState(obs=obs, done=done, t=t, gen=state.gen), reward, done

  def _finish(self, obs, t, done, draws):
    next_obs = torch.where(done, self._reset_obs(draws), obs)
    next_t = torch.where(done, torch.zeros_like(t), t)
    return next_obs, next_t


class _GridEnv(_Env):
  SIZE = 10

  def __init__(self, device='cuda'):
    super().__init__(device)
    ar = torch.arange(self.SIZE, device=self.device)
    self._rows, self._cols = ar[:, None], ar[None, :]
    self._ar = ar
    self._lanes = torch.arange(1, 9, device=self.device)
    # Column of the lane's entity per row: rows 0 and 9 hold none.
    self._no_lane = torch.full((1,), -1, dtype=torch.int64,
                               device=self.device)

  def _cell(self, r, c) -> torch.Tensor:
    """(SIZE, SIZE) bool: the one cell (r, c), or none off the grid."""
    return (self._rows == r) & (self._cols == c)

  def _lane_cells(self, cols) -> torch.Tensor:
    """(SIZE, SIZE) bool: lane l (rows 1..8) at column cols[l - 1]."""
    per_row = torch.cat([self._no_lane, cols.to(torch.int64),
                         self._no_lane])
    return self._cols == per_row[:, None]

  def _argmax2(self, plane) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) of the first maximum of a (SIZE, SIZE) plane."""
    flat = torch.argmax(plane.reshape(-1))
    return flat // self.SIZE, flat % self.SIZE


class Breakout(_GridEnv):
  """MinAtar-style Breakout on a 10x10 grid: the conv-net workload.

  Observation (10, 10, 4) float32 channels: 0=paddle (bottom row), 1=ball,
  2=direction code at the ball cell (k/4, k in 1..4 for the four diagonal
  velocities), 3=bricks (three rows).  Actions: 0=noop, 1=left, 2=right.
  Reward +1 per brick; the episode ends when the ball passes the paddle
  or at `max_steps`; bricks replenish when cleared.

  Draws: 'reset_col' (int, the ball's column at reset) and 'reset_right'
  (bool, its horizontal direction)."""

  num_actions: int = 3
  obs_shape: Tuple[int, ...] = (10, 10, 4)
  max_steps: int = 1000
  BRICK_ROWS = (1, 2, 3)
  N_DRAWS = 2

  def __init__(self, device='cuda'):
    super().__init__(device)
    rows = torch.tensor(self.BRICK_ROWS, device=self.device)
    self._bricks_full = (self._rows == rows[:, None, None]).any(0).expand(
        self.SIZE, self.SIZE).to(torch.float32).contiguous()

  def step_draws(self, gen) -> Draws:
    u = self._uniforms(gen)
    return {'reset_col': _randint(u[0], self.SIZE), 'reset_right': u[1] < 0.5}

  def _pack(self, paddle_x, ball_r, ball_c, dy, dx, bricks):
    code = ((dy > 0).to(torch.int64) * 2 + (dx > 0).to(torch.int64)
            + 1).to(torch.float32) / 4.0
    ball = self._cell(ball_r, ball_c).to(torch.float32)
    paddle = self._cell(self.SIZE - 1, paddle_x).to(torch.float32)
    return torch.stack([paddle, ball, ball * code, bricks], dim=-1)

  def _unpack(self, obs):
    paddle_x = torch.argmax(obs[self.SIZE - 1, :, 0])
    ball_r, ball_c = self._argmax2(obs[:, :, 1])
    k = torch.round(obs[:, :, 2].max() * 4.0).to(torch.int64)
    dy = torch.where(k >= 3, 1, -1)
    dx = torch.where(k % 2 == 0, 1, -1)
    return paddle_x, ball_r, ball_c, dy, dx, obs[:, :, 3]

  def _reset_obs(self, draws):
    col = draws['reset_col'].to(torch.int64)
    dx = torch.where(draws['reset_right'], 1, -1)
    one = torch.ones((), dtype=torch.int64, device=self.device)
    return self._pack(one * (self.SIZE // 2), one * 4, col, one, dx,
                      self._bricks_full)

  def transition(self, obs, t, action, draws):
    size = self.SIZE
    paddle_x, r, c, dy, dx, bricks = self._unpack(obs)
    paddle_x = torch.clamp(paddle_x + (action == 2).to(torch.int64)
                           - (action == 1).to(torch.int64), 0, size - 1)
    # Wall bounces (sides + top), then advance one cell.
    dx = torch.where((c + dx < 0) | (c + dx > size - 1), -dx, dx)
    dy = torch.where(r + dy < 0, -dy, dy)
    nr, nc = r + dy, c + dx
    # Brick hit: clear it, score, bounce vertically.
    cell = self._cell(nr, nc)
    hit = (bricks * cell).amax() > 0
    reward = hit.to(torch.float32)
    bricks = torch.where(cell & hit, torch.zeros_like(bricks), bricks)
    bricks = torch.where(bricks.sum() == 0, self._bricks_full, bricks)
    dy_after = torch.where(hit, -dy, dy)
    # Bottom row: a paddle catch bounces, a miss ends the episode.
    at_bottom = nr == size - 1
    caught = at_bottom & (nc == paddle_x)
    missed = at_bottom & ~caught
    dy_after = torch.where(caught, -1, dy_after)
    t = t + 1
    done = missed | (t >= self.max_steps)
    obs = self._pack(paddle_x, nr, nc, dy_after, dx, bricks)
    next_obs, next_t = self._finish(obs, t, done, draws)
    return next_obs, next_t, reward, done


class Freeway(_GridEnv):
  """MinAtar-style Freeway: the player climbs from the bottom row to the
  top through 8 lanes of crossing cars.

  Observation (10, 10, 2): 0=player (fixed column 4), 1=cars (one per
  lane, rows 1..8; lane direction alternates, lane speed is the period
  table).  Actions: 0=noop, 1=up, 2=down.  Reward +1 on reaching row 0
  (the player returns to the bottom); a collision sends the player back
  to the bottom without ending the episode; `max_steps` bounds it.

  Draws: 'reset_cols' (8 ints, the cars' columns at reset)."""

  num_actions: int = 3
  obs_shape: Tuple[int, ...] = (10, 10, 2)
  max_steps: int = 500
  COL = 4
  PERIODS = (1, 2, 3, 4, 4, 3, 2, 1)
  N_DRAWS = 8

  def __init__(self, device='cuda'):
    super().__init__(device)
    self._periods = torch.tensor(self.PERIODS, dtype=torch.int32,
                                 device=self.device)
    self._dirs = torch.where(torch.arange(8, device=self.device) % 2 == 0,
                             1, -1)

  def step_draws(self, gen) -> Draws:
    return {'reset_cols': _randint(self._uniforms(gen), self.SIZE)}

  def _pack(self, player_row, car_cols):
    player = self._cell(player_row, self.COL).to(torch.float32)
    return torch.stack([player, self._lane_cells(car_cols).to(torch.float32)],
                       dim=-1)

  def _unpack(self, obs):
    player_row = torch.argmax(obs[:, self.COL, 0])
    car_cols = torch.argmax(obs[1:9, :, 1], dim=1)
    return player_row, car_cols

  def _reset_obs(self, draws):
    one = torch.ones((), dtype=torch.int64, device=self.device)
    return self._pack(one * (self.SIZE - 1), draws['reset_cols'])

  def transition(self, obs, t, action, draws):
    player_row, car_cols = self._unpack(obs)
    t = t + 1
    player_row = torch.clamp(player_row - (action == 1).to(torch.int64)
                             + (action == 2).to(torch.int64), 0,
                             self.SIZE - 1)
    moves = (t % self._periods == 0).to(torch.int64)
    car_cols = torch.remainder(car_cols + self._dirs * moves, self.SIZE)
    # Collision: a car occupies (lane, COL) while the player is in it.
    hit = ((car_cols == self.COL) & (self._lanes == player_row)).any()
    scored = player_row == 0
    reward = scored.to(torch.float32)
    player_row = torch.where(hit | scored, self.SIZE - 1, player_row)
    done = t >= self.max_steps
    obs = self._pack(player_row, car_cols)
    next_obs, next_t = self._finish(obs, t, done, draws)
    return next_obs, next_t, reward, done


class Asterix(_GridEnv):
  """MinAtar-style Asterix: collect gold, dodge enemies, 4-way movement.

  Observation (10, 10, 3): 0=player, 1=entities (one per lane, rows 1..8,
  direction alternating by lane), 2=gold flag at the entity cell (1=gold,
  0=enemy).  Actions: 0=noop, 1=left, 2=right, 3=up, 4=down.  Touching
  gold: +1 and the entity respawns at its lane edge; touching an enemy
  ends the episode.

  Draws: 'fresh' (8 bools, the type of an entity that wraps this step),
  'reset_cols' (8 ints) and 'reset_golds' (8 bools)."""

  num_actions: int = 5
  obs_shape: Tuple[int, ...] = (10, 10, 3)
  max_steps: int = 500
  N_DRAWS = 24

  def __init__(self, device='cuda'):
    super().__init__(device)
    self._dirs = torch.where(torch.arange(8, device=self.device) % 2 == 0,
                             1, -1)

  def step_draws(self, gen) -> Draws:
    u = self._uniforms(gen)
    return {'fresh': u[:8] < 0.5, 'reset_cols': _randint(u[8:16], self.SIZE),
            'reset_golds': u[16:] < 0.5}

  def _pack(self, pr, pc, cols, golds):
    player = self._cell(pr, pc).to(torch.float32)
    lanes = self._lane_cells(cols).to(torch.float32)
    gold_rows = torch.cat([torch.zeros(1, device=self.device),
                           golds.to(torch.float32),
                           torch.zeros(1, device=self.device)])
    return torch.stack([player, lanes, lanes * gold_rows[:, None]], dim=-1)

  def _unpack(self, obs):
    pr, pc = self._argmax2(obs[:, :, 0])
    cols = torch.argmax(obs[1:9, :, 1], dim=1)
    golds = obs[1:9, :, 2].gather(1, cols[:, None])[:, 0] > 0.5
    return pr, pc, cols, golds

  def _reset_obs(self, draws):
    half = torch.full((), self.SIZE // 2, dtype=torch.int64,
                      device=self.device)
    return self._pack(half, half, draws['reset_cols'], draws['reset_golds'])

  def transition(self, obs, t, action, draws):
    pr, pc, cols, golds = self._unpack(obs)
    t = t + 1
    dr = (action == 4).to(torch.int64) - (action == 3).to(torch.int64)
    dc = (action == 2).to(torch.int64) - (action == 1).to(torch.int64)
    pr = torch.clamp(pr + dr, 0, self.SIZE - 1)
    pc = torch.clamp(pc + dc, 0, self.SIZE - 1)
    cols = torch.remainder(cols + self._dirs, self.SIZE)
    # Re-roll the type when an entity wraps around (a fresh spawn).
    wrapped = torch.where(self._dirs > 0, cols == 0, cols == self.SIZE - 1)
    golds = torch.where(wrapped, draws['fresh'], golds)
    touching = (self._lanes == pr) & (cols == pc)
    got_gold = (touching & golds).any()
    hit_enemy = (touching & ~golds).any()
    reward = got_gold.to(torch.float32)
    # Collected gold turns into an enemy-free respawn at the lane edge.
    edge = torch.where(self._dirs > 0, 0, self.SIZE - 1)
    cols = torch.where(touching & golds, edge, cols)
    done = hit_enemy | (t >= self.max_steps)
    obs = self._pack(pr, pc, cols, golds)
    next_obs, next_t = self._finish(obs, t, done, draws)
    return next_obs, next_t, reward, done


class SpaceInvaders(_GridEnv):
  """MinAtar-style Space Invaders: a descending alien block, one friendly
  bullet, one enemy bullet.

  Observation (10, 10, 4): 0=player cannon (bottom row), 1=aliens bitmap,
  2=friendly bullet (moving up), 3=enemy bullet (moving down); the alien
  march direction rides channel 2's corner cell (0, 0) as a code (0.25
  right, 0.75 left).  Actions: 0=noop, 1=left, 2=right, 3=fire.  Reward
  +1 per alien destroyed; aliens reaching the bottom or an enemy bullet
  hitting the player ends the episode; a cleared wave respawns.

  Draws: 'reset_col' (int, the cannon's column at reset)."""

  num_actions: int = 4
  obs_shape: Tuple[int, ...] = (10, 10, 4)
  max_steps: int = 1000
  MARCH_EVERY = 4   # aliens advance every 4th step
  SHOOT_EVERY = 8   # enemy bullet respawns every 8th step when absent
  N_DRAWS = 1

  def __init__(self, device='cuda'):
    super().__init__(device)
    self._aliens_full = ((self._rows >= 1) & (self._rows < 5)
                         & (self._cols >= 2) & (self._cols < 8)).to(
                             torch.float32)
    self._corner = self._cell(0, 0)
    self._absent = torch.tensor([-1, 0], dtype=torch.int64,
                                device=self.device)

  def step_draws(self, gen) -> Draws:
    return {'reset_col': _randint(self._uniforms(gen)[0], self.SIZE)}

  def _pack(self, player_x, aliens, fb, eb, adir):
    cannon = self._cell(self.SIZE - 1, player_x).to(torch.float32)
    # fb / eb are (row, col) with row < 0 meaning "absent": no cell.
    ch2 = self._cell(fb[0], fb[1]).to(torch.float32)
    ch2 = torch.where(self._corner, torch.where(adir > 0, 0.25, 0.75), ch2)
    ch3 = self._cell(eb[0], eb[1]).to(torch.float32)
    return torch.stack([cannon, aliens, ch2, ch3], dim=-1)

  def _bullet(self, plane):
    has = plane.max() > 0.5
    r, c = self._argmax2(plane)
    return torch.where(has, torch.stack([r, c]), self._absent)

  def _unpack(self, obs):
    player_x = torch.argmax(obs[self.SIZE - 1, :, 0])
    aliens = obs[:, :, 1]
    adir = torch.where(obs[0, 0, 2] < 0.5, 1, -1)
    ch2 = torch.where(self._corner, 0.0, obs[:, :, 2])
    return player_x, aliens, self._bullet(ch2), self._bullet(obs[:, :, 3]), \
        adir

  def _reset_obs(self, draws):
    one = torch.ones((), dtype=torch.int64, device=self.device)
    return self._pack(draws['reset_col'], self._aliens_full, self._absent,
                      self._absent, one)

  def transition(self, obs, t, action, draws):
    size = self.SIZE
    player_x, aliens, fb, eb, adir = self._unpack(obs)
    t = t + 1
    player_x = torch.clamp(player_x + (action == 2).to(torch.int64)
                           - (action == 1).to(torch.int64), 0, size - 1)
    # Fire: one friendly bullet at a time, spawned just above the cannon.
    can_fire = (action == 3) & (fb[0] < 0)
    fb = torch.where(can_fire, torch.stack([player_x * 0 + size - 2,
                                            player_x]), fb)
    # The friendly bullet moves up and despawns above row 1.
    up = torch.tensor([1, 0], device=self.device)
    fb = torch.where(fb[0] >= 0, fb - up, fb)
    fb = torch.where(fb[0] < 1, self._absent, fb)
    fb_cell = self._cell(fb[0], fb[1])
    hit = (fb[0] >= 0) & ((aliens * fb_cell).amax() > 0)
    reward = hit.to(torch.float32)
    aliens = torch.where(fb_cell & hit, 0.0, aliens)
    fb = torch.where(hit, self._absent, fb)
    # Alien march every MARCH_EVERY steps: drop + reverse at the walls.
    occupied = (aliens != 0).any(0)
    turn = (occupied[0] & (adir < 0)) | (occupied[size - 1] & (adir > 0))
    shifted = torch.where(adir > 0, torch.roll(aliens, 1, 1),
                          torch.roll(aliens, -1, 1))
    marched = torch.where(turn, torch.roll(aliens, 1, 0), shifted)
    march = t % self.MARCH_EVERY == 0
    aliens = torch.where(march, marched, aliens)
    adir = torch.where(march & turn, -adir, adir)
    # Enemy bullet: spawns under the lowest alien of the occupied column
    # nearest the player every SHOOT_EVERY steps; moves down 1 a step.
    eb = torch.where(eb[0] >= 0, eb + up, eb)
    eb = torch.where(eb[0] > size - 1, self._absent, eb)
    occupied_cols = (aliens > 0).any(0)
    dist = torch.where(occupied_cols, (self._ar - player_x).abs(), size + 1)
    shoot_col = torch.argmin(dist)
    column = aliens.gather(1, shoot_col.expand(size, 1))[:, 0]
    lowest = size - 1 - torch.argmax(torch.flip(column, [0]))
    any_alien = (aliens > 0).any()
    spawn = (t % self.SHOOT_EVERY == 0) & (eb[0] < 0) & any_alien
    eb = torch.where(spawn, torch.stack([lowest + 1, shoot_col]), eb)
    player_hit = (eb[0] == size - 1) & (eb[1] == player_x)
    aliens_landed = (aliens[size - 1] > 0).any()
    # A cleared wave respawns.
    aliens = torch.where(any_alien, aliens, self._aliens_full)
    done = player_hit | aliens_landed | (t >= self.max_steps)
    obs = self._pack(player_x, aliens, fb, eb, adir)
    next_obs, next_t = self._finish(obs, t, done, draws)
    return next_obs, next_t, reward, done


class Pendulum(_Env):
  """Pendulum-v1: continuous torque control, the standard SAC benchmark.

  obs = [cos(theta), sin(theta), theta_dot]; action = torque in [-2, 2];
  reward = -(angle^2 + 0.1*theta_dot^2 + 0.001*u^2); 200-step episodes.

  Draws: 'reset_theta' (uniform in [-pi, pi)) and 'reset_dot' (uniform in
  [-1, 1))."""

  action_dim: int = 1
  max_action: float = 2.0
  obs_shape: Tuple[int, ...] = (3,)
  max_steps: int = 200
  GRAVITY = 10.0
  MASS = 1.0
  LENGTH = 1.0
  DT = 0.05
  MAX_SPEED = 8.0
  N_DRAWS = 2

  def step_draws(self, gen) -> Draws:
    u = self._uniforms(gen)
    return {'reset_theta': u[0] * (2 * math.pi) - math.pi,
            'reset_dot': u[1] * 2.0 - 1.0}

  def _obs(self, theta, theta_dot):
    return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot])

  def _reset_obs(self, draws):
    return self._obs(draws['reset_theta'], draws['reset_dot'])

  def transition(self, obs, t, action, draws):
    cos_t, sin_t, theta_dot = obs[0], obs[1], obs[2]
    theta = torch.atan2(sin_t, cos_t)
    u = torch.clamp(action.reshape(()), -self.max_action, self.max_action)
    cost = theta ** 2 + 0.1 * theta_dot ** 2 + 0.001 * u ** 2
    theta_dot = theta_dot + self.DT * (
        3.0 * self.GRAVITY / (2.0 * self.LENGTH) * torch.sin(theta)
        + 3.0 / (self.MASS * self.LENGTH ** 2) * u)
    theta_dot = torch.clamp(theta_dot, -self.MAX_SPEED, self.MAX_SPEED)
    theta = theta + self.DT * theta_dot
    t = t + 1
    done = t >= self.max_steps
    next_obs, next_t = self._finish(self._obs(theta, theta_dot), t, done,
                                    draws)
    return next_obs, next_t, -cost, done


class CartPole(_Env):
  """CartPole-v1: force +-10N, dt 0.02, fail at |x|>2.4 or |theta|>12deg,
  500-step limit, reward 1 per step.

  Draws: 'reset_obs' (4 uniforms in [-0.05, 0.05))."""

  num_actions: int = 2
  obs_shape: Tuple[int, ...] = (4,)
  max_steps: int = 500
  GRAVITY = 9.8
  CART_MASS = 1.0
  POLE_MASS = 0.1
  TOTAL_MASS = CART_MASS + POLE_MASS
  LENGTH = 0.5
  POLEMASS_LENGTH = POLE_MASS * LENGTH
  FORCE_MAG = 10.0
  DT = 0.02
  X_LIMIT = 2.4
  THETA_LIMIT = 12 * 2 * math.pi / 360
  N_DRAWS = 4

  def step_draws(self, gen) -> Draws:
    return {'reset_obs': self._uniforms(gen) * 0.1 - 0.05}

  def _reset_obs(self, draws):
    return draws['reset_obs']

  def transition(self, obs, t, action, draws):
    x, x_dot, theta, theta_dot = obs[0], obs[1], obs[2], obs[3]
    force = torch.where(action == 1, self.FORCE_MAG, -self.FORCE_MAG)
    costheta, sintheta = torch.cos(theta), torch.sin(theta)
    temp = (force + self.POLEMASS_LENGTH * theta_dot ** 2 * sintheta
            ) / self.TOTAL_MASS
    theta_acc = (self.GRAVITY * sintheta - costheta * temp) / (
        self.LENGTH * (4.0 / 3.0 - self.POLE_MASS * costheta ** 2
                       / self.TOTAL_MASS))
    x_acc = temp - self.POLEMASS_LENGTH * theta_acc * costheta \
        / self.TOTAL_MASS
    x = x + self.DT * x_dot
    x_dot = x_dot + self.DT * x_acc
    theta = theta + self.DT * theta_dot
    theta_dot = theta_dot + self.DT * theta_acc
    obs = torch.stack([x, x_dot, theta, theta_dot])
    t = t + 1
    done = ((x.abs() > self.X_LIMIT) | (theta.abs() > self.THETA_LIMIT)
            | (t >= self.max_steps))
    reward = torch.ones((), device=self.device)
    next_obs, next_t = self._finish(obs, t, done, draws)
    return next_obs, next_t, reward, done


ENVS = {'cartpole': CartPole, 'breakout': Breakout, 'freeway': Freeway,
        'asterix': Asterix, 'space_invaders': SpaceInvaders,
        'pendulum': Pendulum}
