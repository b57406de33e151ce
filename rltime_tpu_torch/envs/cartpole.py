"""Vectorized CartPole-v1 on the host: pure-numpy lockstep physics.

A copy of `rltime_tpu/envs/cartpole.py` (numpy only). The whole batch
advances as a handful of numpy vector ops. Dynamics and reward match
gymnasium's CartPole-v1 (Euler integration, same constants, 500-step
time limit), so config #1's bar (reward >= 475) is measured on the same
task. `envs/device.py:DeviceCartPole` is the same dynamics on the
training device.
"""
from __future__ import annotations

import numpy as np

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import VecEnv, EnvSpec

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5  # half pole length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * np.pi / 360
X_THRESHOLD = 2.4
TIME_LIMIT = 500


@register("cartpole")
class CartPoleVecEnv(VecEnv):
    def __init__(self, num_envs: int, seed: int = 0,
                 time_limit: int = TIME_LIMIT):
        self.num_envs = num_envs
        self.time_limit = time_limit
        self.spec = EnvSpec(obs_shape=(4,), obs_dtype=np.float32,
                            num_actions=2)
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros((num_envs,), np.int64)

    def _sample_init(self, n):
        return self._rng.uniform(-0.05, 0.05, size=(n, 4))

    def reset(self, seed: int = 0) -> np.ndarray:
        self._rng = np.random.default_rng(seed)
        self._state = self._sample_init(self.num_envs)
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, th, th_dot = self._state.T
        force = np.where(actions == 1, FORCE_MAG, -FORCE_MAG)
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + POLEMASS_LENGTH * th_dot ** 2 * sin) / TOTAL_MASS
        th_acc = (GRAVITY * sin - cos * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * cos ** 2 / TOTAL_MASS))
        x_acc = temp - POLEMASS_LENGTH * th_acc * cos / TOTAL_MASS
        # Euler (gymnasium kinematics_integrator="euler")
        x = x + TAU * x_dot
        x_dot = x_dot + TAU * x_acc
        th = th + TAU * th_dot
        th_dot = th_dot + TAU * th_acc
        self._state = np.stack([x, x_dot, th, th_dot], axis=1)
        self._steps += 1

        terminated = ((np.abs(x) > X_THRESHOLD)
                      | (np.abs(th) > THETA_THRESHOLD))
        truncated = (~terminated) & (self._steps >= self.time_limit)
        reward = np.ones((self.num_envs,), np.float32)

        done = terminated | truncated
        if np.any(done):
            n = int(done.sum())
            self._state[done] = self._sample_init(n)
            self._steps[done] = 0
        return (self._state.astype(np.float32), reward,
                terminated, truncated)
