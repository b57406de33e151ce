"""The C++ lane pool: `cartpole_native` and `atari_native` (built at first use)."""
from rltime_tpu_torch.envs.native.bindings import (  # noqa: F401
    NativeAtariVecEnv, NativeCartPoleVecEnv, atari_backend, build_library,
    library_path,
)
