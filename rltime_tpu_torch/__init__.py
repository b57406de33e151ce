"""rltime_tpu_torch — the PyTorch + CUDA port of `rltime_tpu`.

The JAX package `rltime_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports torch
and numpy only (never jax, flax, optax, orbax or rltime_tpu), because
the GPU machine it targets has none of them.

Ported so far (ROADMAP.md): the default host `Trainer` for the
feed-forward DQN path — dense PER replay with the frame-stack union
gather (a hand-written CUDA kernel, `csrc/union_gather.cu`), the MLP
and Nature-CNN torsos with linear or dueling heads, n-step double-Q
Huber loss, Adam with optax's global-norm clip, and checkpoints.
Options not ported yet raise `NotImplementedError` via `not_ported`.
"""

__version__ = "0.1.0"


def not_ported(option: str, roadmap_item: str) -> NotImplementedError:
    """The error for a configuration option this port does not run yet.

    `roadmap_item` names the ROADMAP.md entry that will port it."""
    return NotImplementedError(
        f"{option} is not ported to rltime_tpu_torch yet "
        f"(ROADMAP.md: {roadmap_item})")
