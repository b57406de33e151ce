"""Fused on-device superstep: the whole training iteration with the host
only dispatching.

Port of `rltime_tpu/parallel/fused.py` at d=1 (one device). For
device-resident envs (`envs/device.py`, `envs/minatar*.py`) nothing in
the train loop needs the host, so one superstep is, all on the device:

  1. `chunk_len` env+policy steps over all lanes (the ONE rollout core
     of `acting/device_actor.py`),
  2. the chunk's insert into the replay ring,
  3. K learner updates (DQN/IQN feed-forward or R2D2 sequence).

The host enqueues these and reads nothing back: epsilon goes down once
per dispatch, the PER exponent beta is a host float per superstep, and
the metrics stay device scalars until the trainer logs. That is what
will let a later change capture the superstep in a CUDA graph; here it
runs eagerly. `supersteps_per_dispatch` S is a plain loop of S
supersteps with a per-superstep beta, so its numbers equal S sequential
dispatches.

This is the training path of every `configs/minatar_*.json` preset
(`{"train": {"trainer": "fused"}}`, `train.py`). It composes the same
building blocks as `Trainer` + `DeviceActor` and draws its random
numbers from the same generators in the same order, so at d=1 the two
paths agree bit for bit (tests/test_torch_fused.py). The JAX version's
`shard_map`, `pmean`/`pmax` and per-shard state views are the identity
at d=1 and are not carried over: the actor state is
`device_actor.DeviceActorState` itself, the act phase is
`make_rollout_core` itself, and a mesh is refused (ROADMAP.md).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import rltime_tpu_torch.envs  # noqa: F401  (registers env types)
import rltime_tpu_torch.exploration  # noqa: F401  (registers exploration)
from rltime_tpu_torch import not_ported
from rltime_tpu_torch.acting.device_actor import (
    eps_schedule, init_device_actor_state, make_rollout_core,
    pop_episode_stats,
)
from rltime_tpu_torch.config.config import build
from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.history.replay import (
    ReplayConfig, replay_init, replay_insert,
)
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_insert_and_update_step, make_train_state,
    make_update_step,
)
from rltime_tpu_torch.training.r2d2 import (
    make_r2d2_update_step, r2d2_horizon,
)
from rltime_tpu_torch.training.trainer import (
    TrainLoopConfig, _mk_model_cfg, replay_fields,
)
from rltime_tpu_torch.utils.loggers import RunLogger
from rltime_tpu_torch.utils.prng import fold_in_str


def make_superstep(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                   replay_cfg: ReplayConfig, chunk_len: int,
                   num_updates: int, frame_stack: int = 1,
                   flatten: bool = True):
    """Build superstep(tstate, astate, rstate, eps (L, E), beta,
    draws=None) -> (tstate, astate, rstate, metrics): act L steps,
    insert the chunk, run `num_updates` learner updates. All three
    states are updated in place. `draws` = {"act": [L rollout-step
    draws], "update": [K update draws]} injects the random numbers
    (tests)."""
    if algo_cfg.algo == "r2d2":
        update = make_r2d2_update_step(model_cfg, algo_cfg, replay_cfg,
                                       frame_stack, flatten)
    else:
        update = make_update_step(algo_cfg, replay_cfg, frame_stack, flatten)
    act = make_rollout_core(env, model_cfg, chunk_len)
    insert_update = make_insert_and_update_step(replay_cfg, update,
                                                num_updates)

    def superstep(tstate, astate, rstate, eps, beta, draws=None):
        draws = draws or {}
        astate, chunk = act(tstate.model, astate, eps, draws.get("act"))
        tstate, rstate, metrics = insert_update(tstate, rstate, chunk, beta,
                                                draws.get("update"))
        return tstate, astate, rstate, metrics

    return superstep


def make_warm_superstep(env, model_cfg: ModelConfig,
                        replay_cfg: ReplayConfig, chunk_len: int):
    """Warmup program: act + insert, NO learner updates (the learner's
    generator is untouched), as `Trainer`'s warmup chunks."""
    act = make_rollout_core(env, model_cfg, chunk_len)

    def warm(model, astate, rstate, eps, draws=None):
        astate, chunk = act(model, astate, eps, (draws or {}).get("act"))
        return astate, replay_insert(replay_cfg, rstate, chunk)

    return warm


class FusedApexTrainer:
    """Runs the fused superstep loop (device envs only, one device).

    The config is the `Trainer`'s ("env": {"type": "minatar_breakout" |
    "cartpole_device" | ..., "num_envs": lanes}); select it with
    {"train": {"trainer": "fused"}} from the CLI. Supports warmup, image
    observations (uint8 replay rings), DQN/IQN/R2D2 updates, checkpoints
    and resume."""

    def __init__(self, config: Dict[str, Any], result_dir: str,
                 device: str | torch.device = "cuda", mesh=None,
                 logger: Optional[RunLogger] = None):
        if mesh is not None:
            raise not_ported("a device mesh (d > 1) for the fused trainer",
                             "mesh, apex, pool")
        self.device = resolve_device(device)
        self.config = config
        self.result_dir = result_dir
        seed = int(config.get("seed", 0))

        handle = build(config["env"], seed=seed)
        if not getattr(handle, "is_device", False):
            raise ValueError(
                "FusedApexTrainer requires a device-resident env (got "
                f"{config['env']['type']!r}); use the default Trainer for "
                "host envs")
        self.env = handle.inner
        spec = handle.spec
        self.num_envs = E = int(config["env"]["num_envs"])
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        r2d2 = self.algo_cfg.algo == "r2d2"
        self.replay_cfg = ReplayConfig(
            num_envs=E,
            horizon=r2d2_horizon(self.algo_cfg) if r2d2
            else self.algo_cfg.n_step,
            chunk_len=self.loop_cfg.chunk_len,
            **config.get("replay", {}))
        self.flatten = len(spec.obs_shape) == 1
        self.replay_state = replay_init(
            self.replay_cfg, replay_fields(spec, self.model_cfg), self.device)
        self.actor_state = init_device_actor_state(
            self.env, self.model_cfg, E, fold_in_str(seed, "actor"),
            self.device)
        in_shape = ((int(np.prod(spec.obs_shape)),) if self.flatten
                    else (1,) + tuple(spec.obs_shape))
        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg, in_shape,
            fold_in_str(seed, "learner"), self.device)
        self.supersteps = max(1, int(self.loop_cfg.supersteps_per_dispatch))
        L = self.loop_cfg.chunk_len
        self._super = make_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg, L,
            self.loop_cfg.updates_per_chunk, frame_stack=1,
            flatten=self.flatten)
        self._warm_super = make_warm_superstep(
            self.env, self.model_cfg, self.replay_cfg, L)
        self.exploration = build(config.get(
            "exploration", {"type": "epsilon_greedy"}))
        self.logger = logger or RunLogger(result_dir, config)
        self.env_steps = 0
        self.updates_done = 0
        self.last_metrics: Dict[str, torch.Tensor] = {}
        self._stats_popped = 0
        self._best_score = float("-inf")
        self._protected_steps: set = set()
        if self.loop_cfg.resume:
            self._try_resume()

    def _beta_at(self, env_steps: int) -> float:
        a = self.algo_cfg
        frac = min(env_steps / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return a.per_beta_start + frac * (a.per_beta_end - a.per_beta_start)

    def superstep(self, draws=None):
        """One dispatch: S full supersteps, or one warmup act+insert.

        As `Trainer.train_chunk`, a chunk trains iff the post-chunk
        env-step counter has reached `warmup_env_steps`. `draws`: a list
        of S injected draw sets (one dict for a warmup dispatch). Returns
        the last superstep's metrics as device scalars ({} in warmup)."""
        L, S, E = self.loop_cfg.chunk_len, self.supersteps, self.num_envs
        per_chunk = L * E
        if self.env_steps + per_chunk < self.loop_cfg.warmup_env_steps:
            eps = eps_schedule(self.exploration, E, self.env_steps, L,
                               self.device)
            self.actor_state, self.replay_state = self._warm_super(
                self.train_state.model, self.actor_state, self.replay_state,
                eps, draws)
            self.env_steps += per_chunk
            return {}
        eps = eps_schedule(self.exploration, E, self.env_steps, S * L,
                           self.device)
        metrics = {}
        for i in range(S):
            # beta annealed on the POST-chunk step counter (the point
            # Trainer samples it), one value per superstep
            beta = self._beta_at(self.env_steps + per_chunk)
            (self.train_state, self.actor_state, self.replay_state,
             metrics) = self._super(
                self.train_state, self.actor_state, self.replay_state,
                eps[i * L:(i + 1) * L], beta, draws[i] if draws else None)
            self.env_steps += per_chunk
        self.updates_done += S * self.loop_cfg.updates_per_chunk
        self.last_metrics = metrics
        return metrics

    def episode_stats(self):
        """Fresh completed returns, oldest first (reads the device)."""
        rets, _, self._stats_popped = pop_episode_stats(
            self.actor_state, self._stats_popped)
        return rets

    # ----- checkpointing -----
    def _host_state(self):
        return dict(env_steps=self.env_steps, updates=self.updates_done,
                    stats_popped=self._stats_popped)

    def save_checkpoint(self, protect: bool = True):
        """Learner state, the whole actor state (env state, carry, stat
        rings, both generators) and, with `checkpoint_replay`, the
        replay: a resumed run continues bit-identically."""
        rp = self.replay_state if self.loop_cfg.checkpoint_replay else None
        path = ckpt_lib.save(
            self.result_dir, self.env_steps, self.train_state,
            self._host_state(), rp,
            extra={"actor_state": self.actor_state.state_dict()})
        if protect:
            self._protected_steps.add(self.env_steps)
        return path

    def _try_resume(self):
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return
        best = ckpt_lib.best_step(self.result_dir)
        if best is not None:
            # a resumed run must not mark a worse mean as 'best'
            self._best_score = float(best["score"])
        restored = ckpt_lib.restore(self.result_dir, step)
        ckpt_lib.load_train_state(self.train_state, restored)
        hs = restored["host_state"]
        self.env_steps = int(hs["env_steps"])
        self.updates_done = int(hs["updates"])
        self._stats_popped = int(hs["stats_popped"])
        self.actor_state.load_state_dict(restored["actor_state"])
        if self.loop_cfg.checkpoint_replay and "replay_state" in restored:
            ckpt_lib.load_replay_state(self.replay_state,
                                       restored["replay_state"])
        print(f"fused: resumed from checkpoint at env step {step}")

    # ----- training -----
    def train(self):
        cfg = self.loop_cfg
        next_log = self.env_steps + cfg.log_interval
        next_ckpt = self.env_steps + cfg.checkpoint_interval
        t_last, s_last = time.time(), self.env_steps
        while self.env_steps < cfg.total_env_steps:
            m = self.superstep()
            if self.env_steps >= next_log:
                next_log = self.env_steps + cfg.log_interval
                rets = self.episode_stats()
                if rets and cfg.track_best:
                    self._best_score = ckpt_lib.maybe_record_best(
                        self.result_dir, self._best_score,
                        float(np.mean(rets)), len(rets),
                        cfg.best_min_episodes, self.env_steps,
                        lambda: self.save_checkpoint(protect=False),
                        self._protected_steps)
                now = time.time()
                scalars = dict(
                    env_steps=self.env_steps, updates=self.updates_done,
                    steps_per_s=(self.env_steps - s_last)
                    / max(now - t_last, 1e-9))
                t_last, s_last = now, self.env_steps
                if rets:
                    scalars["episode_return_mean"] = float(np.mean(rets))
                    scalars["episode_return_median"] = float(
                        np.median(rets))
                for k, v in m.items():
                    if not k.startswith("debug_"):
                        scalars[f"train/{k}"] = float(v)
                self.logger.log_scalars(self.env_steps, scalars)
                self.logger.summary(self.env_steps, scalars)
            if self.env_steps >= next_ckpt:
                next_ckpt = self.env_steps + cfg.checkpoint_interval
                self.save_checkpoint()
        self.save_checkpoint()
        self.logger.close()
        return self
