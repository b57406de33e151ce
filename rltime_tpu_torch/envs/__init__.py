"""Environments carried from `rltime_tpu/envs`.

Host side (numpy only): the deterministic `counting_env` and the
vectorized `cartpole`. Device side (tensor ops on the training device,
`envs/device.py` contract): `cartpole_device` and the five
`minatar_<game>` envs. gym, Atari and the native C++ lanes are
ROADMAP.md items.
"""
from rltime_tpu_torch.envs.base import VecEnv, EnvSpec  # noqa: F401
from rltime_tpu_torch.envs.fake import CountingVecEnv  # noqa: F401
from rltime_tpu_torch.envs.cartpole import CartPoleVecEnv  # noqa: F401
from rltime_tpu_torch.envs import device, minatar  # noqa: F401  (register)
