"""Host environments carried from `rltime_tpu/envs` (numpy only).

Only the deterministic `counting_env` is ported so far; CartPole, gym,
Atari, the native C++ lanes and the device envs are ROADMAP.md items.
"""
from rltime_tpu_torch.envs.base import VecEnv, EnvSpec  # noqa: F401
from rltime_tpu_torch.envs.fake import CountingVecEnv  # noqa: F401
