"""rltime_tpu_torch — the PyTorch + CUDA port of `rltime_tpu`.

The JAX package `rltime_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports torch
and numpy only (never jax, flax, optax, orbax or rltime_tpu), because
the GPU machine it targets has none of them.

Ported so far (ROADMAP.md): everything one device can run.
  * the default host `Trainer` for the feed-forward DQN/IQN path and the
    R2D2 path: PER replay (dense two-level sampler or binary sum tree)
    or uniform replay, with the window gathers as hand-written
    CUDA kernels (`csrc/window_gather.cu`: every strip, single column
    and the R2D2 frame sequence of one update in one launch;
    `csrc/union_gather.cu`: both FF frame stacks with their done-mask
    validity in one launch), the MLP, Nature-CNN and MinAtar-CNN torsos
    with linear, dueling or IQN heads and an optional LSTM, n-step
    double-Q Huber, feed-forward Q(lambda) and IQN quantile-Huber
    losses, R2D2 burn-in from the stored carry with n-step or lambda
    targets through value rescaling, Adam or centered RMSProp with
    optax's global-norm clip, the NHWC / space-to-depth Nature CNN,
    actor-side initial priorities, transcripts, and checkpoints; host
    envs `cartpole` (config #1) and `counting_env`;
  * the fused on-device path (`train.trainer="fused"`, every
    `configs/minatar_*.json` preset): device-resident envs
    (`envs/device.py` CartPole, `envs/minatar*.py` Breakout, Asterix,
    Freeway, Space Invaders, Seaquest), the on-device rollout
    (`acting/device_actor.py`) and `parallel/fused.py:FusedApexTrainer`
    on one device, with no host sync inside a dispatch, chunked or
    with `train.interleave_updates`;
  * `python -m rltime_tpu_torch.eval <result_dir> [--best]`.

    python -m rltime_tpu_torch.train minatar_breakout_dqn   # on the card
    python -m rltime_tpu_torch.train minatar_breakout_dqn --device cpu \
        --env.num_envs=8 --algo.batch_size=8 --train.total_env_steps=3000 \
        --train.warmup_env_steps=1000 --train.updates_per_chunk=2

Options not ported yet (the multi-device split: `train.trainer="apex"`,
`train.async_acting`, a fused mesh; and `train.profile_dir`) raise
`NotImplementedError` via `not_ported`.
"""

__version__ = "0.1.0"


def not_ported(option: str, roadmap_item: str) -> NotImplementedError:
    """The error for a configuration option this port does not run yet.

    `roadmap_item` names the ROADMAP.md entry that will port it."""
    return NotImplementedError(
        f"{option} is not ported to rltime_tpu_torch yet "
        f"(ROADMAP.md: {roadmap_item})")
