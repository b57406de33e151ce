"""Deterministic counting env for reproducible integration tests
(SURVEY.md §4 item 2): obs is a pure function of (env_id, episode,
step), episodes end on a fixed schedule, rewards encode the step index
— full actor->replay->learner loops become exactly checkable without
any real environment.
"""
from __future__ import annotations

import numpy as np

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import VecEnv, EnvSpec


@register("counting_env")
class CountingVecEnv(VecEnv):
    def __init__(self, num_envs: int, episode_len: int = 10,
                 obs_dim: int = 4, num_actions: int = 3,
                 image_obs: bool = False, seed: int = 0):
        self.num_envs = num_envs
        self.episode_len = episode_len
        self.image_obs = image_obs
        if image_obs:
            self.spec = EnvSpec((84, 84), np.uint8, num_actions)
        else:
            self.spec = EnvSpec((obs_dim,), np.float32, num_actions)
        self._step = np.zeros((num_envs,), np.int64)
        self._episode = np.zeros((num_envs,), np.int64)

    def _obs(self):
        e = np.arange(self.num_envs)
        if self.image_obs:
            val = (e[:, None, None] * 7 + self._episode[:, None, None] * 3
                   + self._step[:, None, None]) % 256
            return np.broadcast_to(
                val, (self.num_envs, 84, 84)).astype(np.uint8)
        base = np.stack([e, self._episode, self._step,
                         e * 0 + 1], axis=1).astype(np.float32)
        return base

    def reset(self, seed: int = 0) -> np.ndarray:
        self._step[:] = 0
        self._episode[:] = 0
        return self._obs()

    def step(self, actions: np.ndarray):
        self._step += 1
        reward = self._step.astype(np.float32).copy()
        terminated = self._step >= self.episode_len
        truncated = np.zeros_like(terminated)
        done = terminated
        self._episode[done] += 1
        self._step[done] = 0
        return self._obs(), reward, terminated, truncated
