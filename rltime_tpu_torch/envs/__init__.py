"""Environments carried from `rltime_tpu/envs`.

Host side (numpy only): the deterministic `counting_env`, the
vectorized `cartpole`, `gym` (gymnasium envs in lockstep), `atari` (the
DeepMind stack over `ale_py`) and the C++ lane pool's `cartpole_native`
and `atari_native` (compiled by g++ when the first one is built; nothing
is built at import). Device side (tensor ops on the training device,
`envs/device.py` contract): `cartpole_device` and the five
`minatar_<game>` envs.
"""
from rltime_tpu_torch.envs.base import VecEnv, EnvSpec  # noqa: F401
from rltime_tpu_torch.envs.fake import CountingVecEnv  # noqa: F401
from rltime_tpu_torch.envs.cartpole import CartPoleVecEnv  # noqa: F401
from rltime_tpu_torch.envs import (  # noqa: F401  (register)
    atari, device, gym_vec, minatar, native,
)
