"""Lockstep wrapper over gymnasium envs (port of `rltime_tpu/envs/gym_vec.py`).

The generic engine for envs without a vectorized one of their own: an
in-process Python loop, fine for cheap classic-control envs. An env that
ends is reset inside `step` (seeded from its first reset onwards by
gymnasium itself). Without `gymnasium` construction raises ImportError.
"""
from __future__ import annotations

import numpy as np

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import EnvSpec, VecEnv


@register("gym")
class GymVecEnv(VecEnv):
    def __init__(self, num_envs: int, env_id: str = "CartPole-v1",
                 seed: int = 0, **make_kwargs):
        try:
            import gymnasium
        except ImportError:
            raise ImportError("gymnasium is not installed") from None
        self.num_envs = num_envs
        self._envs = [gymnasium.make(env_id, **make_kwargs)
                      for _ in range(num_envs)]
        obs_space = self._envs[0].observation_space
        act_space = self._envs[0].action_space
        if not hasattr(act_space, "n"):
            raise ValueError("only discrete action spaces are supported")
        self.spec = EnvSpec(tuple(obs_space.shape),
                            obs_space.dtype.type, int(act_space.n))
        self._seed = seed

    def reset(self, seed: int = 0) -> np.ndarray:
        self._seed = seed
        obs = [e.reset(seed=seed + i)[0] for i, e in enumerate(self._envs)]
        return np.stack(obs).astype(self.spec.obs_dtype)

    def step(self, actions: np.ndarray):
        obs = np.empty((self.num_envs,) + self.spec.obs_shape,
                       self.spec.obs_dtype)
        rew = np.empty((self.num_envs,), np.float32)
        term = np.empty((self.num_envs,), bool)
        trunc = np.empty((self.num_envs,), bool)
        for i, e in enumerate(self._envs):
            o, r, tm, tr, _ = e.step(int(actions[i]))
            if tm or tr:
                o, _ = e.reset()
            obs[i], rew[i], term[i], trunc[i] = o, r, tm, tr
        return obs, rew, term, trunc

    def close(self):
        for e in self._envs:
            e.close()
