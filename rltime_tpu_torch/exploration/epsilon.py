"""Exploration: epsilon-greedy schedules + the Ape-X per-actor ladder.

SURVEY.md §1 L7 / §2 "Exploration": linear annealing for single-actor
DQN; fixed per-env ladder eps_i = eps^(1 + alpha*i/(E-1)) for
distributed acting (arxiv 1803.00933 §4). Epsilons are computed
host-side per chunk (cheap scalars) and consumed on device by the
jitted act step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rltime_tpu_torch.config.registry import register


def epsilon_ladder(num_envs: int, base_eps: float = 0.4,
                   alpha: float = 7.0) -> np.ndarray:
    """Ape-X ladder: env i acts with eps^(1 + alpha * i / (E-1))."""
    if num_envs == 1:
        return np.array([base_eps], np.float32)
    i = np.arange(num_envs, dtype=np.float32)
    return (base_eps ** (1.0 + alpha * i / (num_envs - 1))).astype(
        np.float32)


@register("epsilon_greedy")
@dataclasses.dataclass
class EpsilonGreedy:
    """Annealed or ladder epsilon-greedy.

    mode="anneal": eps goes eps_start -> eps_end linearly over
      anneal_steps env steps (all envs share it).
    mode="ladder": fixed Ape-X per-env ladder (ignores step).
    """
    mode: str = "anneal"
    eps_start: float = 1.0
    eps_end: float = 0.05
    anneal_steps: int = 100_000
    base_eps: float = 0.4
    alpha: float = 7.0
    eval_eps: float = 0.001

    def epsilons(self, num_envs: int, env_step: int) -> np.ndarray:
        if self.mode == "ladder":
            return epsilon_ladder(num_envs, self.base_eps, self.alpha)
        frac = min(max(env_step / max(self.anneal_steps, 1), 0.0), 1.0)
        eps = self.eps_start + frac * (self.eps_end - self.eps_start)
        return np.full((num_envs,), eps, np.float32)
