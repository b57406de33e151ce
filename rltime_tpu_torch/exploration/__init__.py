from rltime_tpu_torch.exploration.epsilon import (  # noqa: F401
    EpsilonGreedy, epsilon_ladder,
)
