"""Experiment runner for RL, in PyTorch.

Counterpart of rigl_tpu/rl/runner.py (parity with
rigl/rl/run_experiment.py:54-203, a Dopamine Runner subclass):
fixed-size phases of environment steps, per-phase average returns, and a
final score defined as the average return over the last 10% of
training.  The agent's device metrics are read once a phase.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class PhaseRunner:
  """Runs an agent in fixed-length phases and aggregates phase metrics.

  Works with any agent exposing `init(seed)` and a
  `collect_and_learn(state) -> (state, metrics)` step (SparseDQN,
  SparseSAC) or `train_iteration` (SparsePPO).
  """

  def __init__(self, agent, num_phases: int = 10,
               steps_per_phase: int = 2000,
               final_fraction: float = 0.1):
    self.agent = agent
    self.num_phases = num_phases
    self.steps_per_phase = steps_per_phase
    self.final_fraction = final_fraction

  def run(self, seed: int = 0,
          progress_fn: Optional[Callable[[Dict[str, Any]], None]] = None
          ) -> Dict[str, Any]:
    agent = self.agent
    state = agent.init(seed)
    step_fn = getattr(agent, 'collect_and_learn', None)
    if step_fn is None:
      step_fn = agent.train_iteration
      chunk = agent.config.rollout_length
    else:
      chunk = agent.config.learn_every

    phase_results: List[Dict[str, float]] = []
    prev_sum, prev_count = 0.0, 0
    for phase in range(self.num_phases):
      n_chunks = max(self.steps_per_phase // chunk, 1)
      metrics = {}
      for _ in range(n_chunks):
        state, metrics = step_fn(state)
      total_sum = float(metrics.get('avg_return', 0.0)) * max(
          float(metrics.get('episodes', 0)), 1.0)
      episodes = int(metrics.get('episodes', 0))
      phase_eps = episodes - prev_count
      phase_avg = ((total_sum - prev_sum) / phase_eps
                   if phase_eps > 0 else float('nan'))
      prev_sum, prev_count = total_sum, episodes
      rec = {'phase': phase, 'phase_avg_return': phase_avg,
             'episodes': episodes,
             'env_steps': float(metrics.get('env_steps', 0))}
      phase_results.append(rec)
      if progress_fn:
        progress_fn(rec)

    n_final = max(int(self.num_phases * self.final_fraction), 1)
    finals = [r['phase_avg_return'] for r in phase_results[-n_final:]
              if r['phase_avg_return'] == r['phase_avg_return']]
    final_score = sum(finals) / len(finals) if finals else float('nan')
    self.state = state
    return {
        'final_score': final_score,
        'phases': phase_results,
        'total_episodes': phase_results[-1]['episodes'],
    }
