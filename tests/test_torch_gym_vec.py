"""The port's `GymVecEnv` against the JAX package's (gymnasium CartPole).

200 random steps of the same seed and actions give equal observations,
rewards and flags (tolerance 0: the same gymnasium envs underneath).
"""
import numpy as np
import pytest

pytest.importorskip("gymnasium")

from rltime_tpu.envs.gym_vec import GymVecEnv as JaxGymVecEnv  # noqa: E402
from rltime_tpu_torch.envs.gym_vec import GymVecEnv  # noqa: E402


def test_gym_vec_matches_jax():
    E, S = 4, 200
    acts = np.random.default_rng(0).integers(0, 2, (S, E))
    recs = []
    for cls in (GymVecEnv, JaxGymVecEnv):
        env = cls(E, "CartPole-v1", seed=3)
        assert env.spec.num_actions == 2 and env.spec.obs_shape == (4,)
        rec = [env.reset(seed=3)]
        for a in acts:
            rec.extend(env.step(a))
        env.close()
        recs.append(rec)
    dones = sum(int(x.sum()) for x in recs[0][3::4])
    assert dones > 0                        # episodes ended and reset
    for t, j in zip(*recs):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_gym_registry_builds():
    import rltime_tpu_torch.envs  # noqa: F401  (registers)
    from rltime_tpu_torch.config.config import build
    env = build({"type": "gym", "num_envs": 2, "env_id": "CartPole-v1"})
    assert env.reset(0).shape == (2, 4)
    env.close()
