"""rltime_tpu_torch — the PyTorch + CUDA port of `rltime_tpu`.

The JAX package `rltime_tpu` stays the reference; this package mirrors
its module paths so each counterpart is easy to find. It imports torch
and numpy only (never jax, flax, optax, orbax or rltime_tpu), because
the GPU machine it targets has none of them.

Ported so far (ROADMAP.md): everything of one device, and the
distribution layer over `torch.distributed`.
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
    actor-side initial priorities, async acting (`acting/pool.py`),
    transcripts, and checkpoints; host envs `cartpole` (config #1),
    `counting_env`, `gym`, `atari` (the DeepMind stack over `ale_py`)
    and the C++ lane pool's `cartpole_native` and `atari_native`
    (`envs/native/`), with the true game scores in the log;
    `train.profile_dir` and `train.profile_port` (torch.profiler traces,
    on-demand captures);
  * the fused on-device path (`train.trainer="fused"`, every
    `configs/minatar_*.json` preset): device-resident envs
    (`envs/device.py` CartPole, `envs/minatar*.py` Breakout, Asterix,
    Freeway, Space Invaders, Seaquest), the on-device rollout
    (`acting/device_actor.py`) and `parallel/fused.py:FusedApexTrainer`,
    with no host sync inside a dispatch, chunked or with
    `train.interleave_updates`;
  * distribution (`parallel/mesh.py`: one rank per process and device,
    NCCL on cards, gloo on the CPU): the Ape-X `ApexTrainer`
    (`train.trainer="apex"`, config #5 as `apex_multihost_counting`) and
    the fused trainer over d ranks, sharded replay, one gradient
    all-reduce per update, per-rank checkpoint sidecars, and the count
    of collectives (`parallel/census.py`);
  * `python -m rltime_tpu_torch.eval <result_dir> [--best]`,
    `python -m rltime_tpu_torch.train_distributed` (N ranks) and
    `python -m rltime_tpu_torch.dryrun` (every training leg once, at
    tiny shapes, on d ranks).
On the card every trainer runs its step as one CUDA-graph replay
(`utils/graphs.py`, the counterpart of a jitted XLA program): the fused
superstep, and the host trainers' insert + K updates of a chunk, with
the replay cursor and the update count on the device.

    python -m rltime_tpu_torch.train minatar_breakout_dqn   # on the card
    python -m rltime_tpu_torch.train minatar_breakout_dqn --device cpu \
        --env.num_envs=8 --algo.batch_size=8 --train.total_env_steps=3000 \
        --train.warmup_env_steps=1000 --train.updates_per_chunk=2

Every option of the reference's configs runs.
"""

__version__ = "0.1.0"
