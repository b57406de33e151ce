from rltime_tpu_torch.config.registry import register, lookup, registered_names  # noqa: F401
from rltime_tpu_torch.config.config import load_config, apply_overrides, build  # noqa: F401
