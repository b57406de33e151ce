"""rltime_tpu_torch — the PyTorch + CUDA port of `rltime_tpu`.

The JAX package `rltime_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports torch
and numpy only (never jax, flax, optax, orbax or rltime_tpu), because
the GPU machine it targets has none of them.

Ported so far (ROADMAP.md): the default host `Trainer` for the
feed-forward DQN path and the R2D2 path — dense PER replay with the
window gathers as hand-written CUDA kernels (`csrc/window_gather.cu`
for every strip, stack done window and the R2D2 frame sequence,
`csrc/union_gather.cu`
for the FF frame-stack union), the MLP and Nature-CNN torsos with
linear or dueling heads and an optional LSTM, n-step double-Q Huber
loss, R2D2 burn-in from the stored carry with n-step or lambda targets
through value rescaling, Adam with optax's global-norm clip, and
checkpoints.
Options not ported yet raise `NotImplementedError` via `not_ported`.
"""

__version__ = "0.1.0"


def not_ported(option: str, roadmap_item: str) -> NotImplementedError:
    """The error for a configuration option this port does not run yet.

    `roadmap_item` names the ROADMAP.md entry that will port it."""
    return NotImplementedError(
        f"{option} is not ported to rltime_tpu_torch yet "
        f"(ROADMAP.md: {roadmap_item})")
