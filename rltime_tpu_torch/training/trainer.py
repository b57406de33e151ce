"""Trainer: the host loop gluing acting, replay and the learner.

Port of the default `rltime_tpu/training/trainer.py:Trainer`. The loop
alternates {device acting over all lanes, chunk insert, K update
steps}; the update path never reads back to the host except to log.
A host env is stepped by `acting/actor.py:Actor`; a device-resident env
(a handle with `is_device`) by `acting/device_actor.py:DeviceActor`,
the two-dispatch path that `parallel/fused.py` is held against.
`algo.algo` picks the FF DQN/IQN update (`training/learner.py`) or the
R2D2 one (`training/r2d2.py`, whose replay also stores the actor's
LSTM carry as `rnn_c`/`rnn_h`). `train.async_acting` moves the rollout
to a background thread (`acting/pool.py`) that acts with a copy of the
weights published every `train.publish_interval` chunks.
`train.record_transcript` records every
chunk's actions, sampled leaves and |TD| digests (`utils/transcript.py`)
and writes `transcript.jsonl` beside the checkpoints.
`train.profile_dir` traces the whole train loop with torch.profiler;
`train.profile_port` serves on-demand captures of chunks
(`utils/profiling.py`). The log carries the true game scores of an env
that keeps them (`episode_score_*`, Atari envs).
Built from the same JSON config dict as the JAX trainer, plus an
explicit `device` ("cuda" raises when no card is present).

The actors capture too (`Actor` and `DeviceActor`, `capture=`): on the
card an act step (host envs) or a whole chunk's rollout (device envs) is
a CUDA-graph replay, as the JAX package jits its act step and rollout.
Where the JAX trainer jits {chunk insert + K updates} into one program
per chunk, the port captures that step into a CUDA graph on the card
(`utils/graphs.py:GraphedStep`): the first two trained chunks run it op
by op, the third captures it, and every later chunk is one replay, after
copying the chunk's fields (host arrays from the host, device tensors
device to device) and its beta into the graph's static buffers. What
the jitted step carries is state on the device, updated in place: the
replay's write cursor (`ReplayState.cursor`; the warmup inserts go
through it too), the update count (`TrainState.counter`, which also
drives the target sync and the lr schedule), the tree and the rings;
Adam is `capturable` and the learner's generator is registered with the
graph. The host mirrors (`replay_state.t`, `train_state.updates`,
`updates_done`) are bumped after each chunk. The CPU runs the same body
op by op, as does `capture=False` on the card (a constructor argument,
not a config key: the eager rate, injected draws; the actor then acts op
by op too) and the transcript route (`debug_outputs`, its actor too);
nothing falls back to it otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import rltime_tpu_torch.envs  # noqa: F401  (registers env types)
import rltime_tpu_torch.exploration  # noqa: F401  (registers exploration types)
from rltime_tpu_torch.acting.actor import Actor
from rltime_tpu_torch.acting.device_actor import DeviceActor
from rltime_tpu_torch.acting.pool import AsyncActorPool
from rltime_tpu_torch.config.config import build
from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.history.replay import (
    ReplayConfig, replay_in_place, replay_init, replay_insert_at_cursor,
)
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_insert_and_update_step, make_train_state,
    make_update_step, use_device_counter,
)
from rltime_tpu_torch.training.r2d2 import (
    make_r2d2_update_step, r2d2_horizon,
)
from rltime_tpu_torch.utils.graphs import GraphedStep
from rltime_tpu_torch.utils.loggers import RunLogger
from rltime_tpu_torch.utils.prng import fold_in_str, make_generator
from rltime_tpu_torch.utils.profiling import PhaseTimers, start_server, trace
from rltime_tpu_torch.utils.transcript import Transcript


@dataclasses.dataclass
class TrainLoopConfig:
    total_env_steps: int = 100_000
    warmup_env_steps: int = 1_000
    chunk_len: int = 16
    updates_per_chunk: int = 1
    log_interval: int = 2_000        # env steps
    checkpoint_interval: int = 50_000
    checkpoint_replay: bool = False
    resume: bool = False
    track_best: bool = True
    best_min_episodes: int = 5
    record_transcript: bool = False
    profile_dir: str = ""
    profile_port: int = 0
    async_acting: bool = False
    publish_interval: int = 1
    trainer: str = "default"
    supersteps_per_dispatch: int = 1
    interleave_updates: bool = False

    def __post_init__(self):
        if self.trainer not in ("default", "fused", "apex"):
            raise ValueError(f"unknown trainer {self.trainer!r}")


def score_scalars(env) -> Dict[str, float]:
    """The true game scores of the games an env finished since the last
    call (`pop_completed_scores`, Atari envs), as log scalars."""
    scores = (env.pop_completed_scores()
              if hasattr(env, "pop_completed_scores") else [])
    if not scores:
        return {}
    return {"episode_score_mean": float(np.mean(scores)),
            "episode_score_median": float(np.median(scores))}


def _mk_model_cfg(model: Dict[str, Any], num_actions: int) -> ModelConfig:
    m = dict(model)
    for k in ("mlp_hidden", "cnn_channels"):
        if k in m:
            m[k] = tuple(m[k])
    return ModelConfig(num_actions=num_actions, **m)


def replay_fields(spec, model_cfg: ModelConfig,
                  inserted_priorities: bool = False) -> Dict[str, Any]:
    """The replay ring's fields for an env spec and a model: name ->
    (per-step shape, dtype). A recurrent model also stores the actor's
    LSTM carry; `inserted_priorities` adds the actor's raw |TD|."""
    obs_dt = torch.uint8 if spec.obs_dtype == np.uint8 else torch.float32
    fields = {
        "obs": (spec.obs_shape, obs_dt),
        "action": ((), torch.int32),
        "reward": ((), torch.float32),
        "terminated": ((), torch.bool),
        "done": ((), torch.bool),
    }
    if model_cfg.recurrent:
        H = model_cfg.lstm_size
        fields["rnn_c"] = ((H,), torch.float32)
        fields["rnn_h"] = ((H,), torch.float32)
    if inserted_priorities:
        fields["priority"] = ((), torch.float32)
    return fields


def model_in_shape(spec, frame_stack: int, model_cfg: ModelConfig):
    """One sample's model input for an env's obs spec: the flattened
    stack for vector obs, (F, ...) frames for images (device envs have
    F = 1), frames last with `channels_last`."""
    if len(spec.obs_shape) == 1:
        return (int(np.prod(spec.obs_shape)) * frame_stack,)
    if model_cfg.channels_last:
        return tuple(spec.obs_shape) + (frame_stack,)
    return (frame_stack,) + tuple(spec.obs_shape)


class ChunkStep:
    """The post-warmup step of the host trainers (`Trainer`, and
    `parallel/apex.py:ApexTrainer`): {chunk insert + K updates} at the
    device cursor and counter, one CUDA-graph replay a chunk on the card.

    The trainer sets `device`, `replay_cfg`, `loop_cfg`, `train_state`
    (with its device counter), `replay_state` (with its device cursor),
    `updates_done`, `_beta()` (a 0-d float32 tensor on the host),
    `_insert(rstate, chunk)` (its insert at the cursor) and
    `_insert_update` (`learner.make_insert_and_update_step` over that
    insert) and, where a thread acts beside it, `pool` (paused while
    the graph is captured), then calls `_make_graph`."""

    def _make_graph(self, graphed: bool) -> None:
        """`self.graph`: the step captured on the card (static buffers:
        beta, then one (E, L, ...) buffer per ring field), or None (the
        CPU, `capture=False`, transcripts)."""
        self._fields = list(self.replay_state.storage)
        self._graph_states = None
        self.graph = None
        if graphed:
            E, L = self.replay_cfg.num_envs, self.replay_cfg.chunk_len
            self.graph = GraphedStep(
                self._body,
                [torch.empty((), dtype=torch.float32, device=self.device)]
                + [torch.empty((E, L) + tuple(ring.shape[2:]),
                               dtype=ring.dtype, device=self.device)
                   for ring in self.replay_state.storage.values()],
                generators=[self.train_state.generator])

    def eager_step(self, tstate, rstate, chunk: Dict[str, Any], beta,
                   draws=None) -> Dict[str, torch.Tensor]:
        """The post-warmup {insert + K updates} op by op on any states of
        this trainer's shapes, in place (what the graph captures, and
        what a replay is held against). Returns the last update's
        metrics; the host counts are the caller's."""
        with replay_in_place(rstate):
            _, _, metrics = self._insert_update(tstate, rstate, chunk, beta,
                                                draws)
        return metrics

    def _body(self, beta: torch.Tensor, *fields: torch.Tensor):
        """One chunk's step on the trainer's own states: what the graph
        captures."""
        return self.eager_step(self.train_state, self.replay_state,
                               dict(zip(self._fields, fields)), beta)

    def learn(self, chunk: Dict[str, Any], draws=None):
        """A post-warmup chunk's insert + K updates (a graph replay on the
        card), then the host counts. Returns the last update's metrics.
        `draws` (tests) needs the eager body."""
        beta = self._beta()
        if self.device.type == "cuda":
            beta = beta.pin_memory().to(self.device, non_blocking=True)
        if self.graph is None:
            metrics = self.eager_step(self.train_state, self.replay_state,
                                      chunk, beta, draws)
        else:
            if draws:
                raise ValueError("injected draws need the eager body: build "
                                 "the trainer with capture=False")
            states = (self.train_state, self.replay_state)
            if self._graph_states is not None and any(
                    a is not b for a, b in zip(states, self._graph_states)):
                raise RuntimeError("the graph holds the states it captured; "
                                   "this trainer's were replaced since")
            pool = getattr(self, "pool", None)
            metrics = self.graph(beta, *[chunk[n] for n in self._fields],
                                 quiet=pool.paused() if pool else None)
            if self.graph.graph is not None:
                self._graph_states = states
            # the next replay overwrites them
            metrics = {k: v.clone() for k, v in metrics.items()}
        k = self.loop_cfg.updates_per_chunk
        self.replay_state.t += self.replay_cfg.chunk_len
        self.train_state.updates += k
        self.updates_done += k
        self.last_metrics = metrics
        return metrics

    def warm_insert(self, chunk: Dict[str, Any]) -> None:
        """A warmup chunk's insert at the device cursor (op by op), then
        the host cursor."""
        with replay_in_place(self.replay_state):
            self._insert(self.replay_state, chunk)
        self.replay_state.t += self.replay_cfg.chunk_len


class Trainer(ChunkStep):
    """The host training loop (see the module doc). On a card each
    post-warmup chunk's insert + K updates is a replay of the CUDA graph
    `self.graph`, but for the transcript route's; `capture=False` runs
    the same body op by op instead."""

    def __init__(self, config: Dict[str, Any], result_dir: str,
                 logger: Optional[RunLogger] = None,
                 device: str | torch.device = "cuda",
                 capture: bool = True):
        self.device = resolve_device(device)
        self.config = config
        self.result_dir = result_dir
        seed = int(config.get("seed", 0))

        self.env = build(config["env"], seed=seed)
        spec = self.env.spec
        self.frame_stack = int(config.get("frame_stack", 1))
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        self.transcript = None
        if self.loop_cfg.record_transcript:
            self.algo_cfg = dataclasses.replace(self.algo_cfg,
                                                debug_outputs=True)
            self.transcript = Transcript()
        r2d2 = self.algo_cfg.algo == "r2d2"
        if self.model_cfg.recurrent and not r2d2:
            raise ValueError("a recurrent model (lstm_size > 0) trains with "
                             "algo='r2d2'")
        self.replay_cfg = ReplayConfig(
            num_envs=self.env.num_envs,
            horizon=(r2d2_horizon(self.algo_cfg) if r2d2
                     else self.algo_cfg.n_step),
            chunk_len=self.loop_cfg.chunk_len,
            lookback=self.frame_stack - 1,
            **config.get("replay", {}))

        prio = self.replay_cfg.use_inserted_priorities
        self.replay_state = replay_init(
            self.replay_cfg, replay_fields(spec, self.model_cfg, prio),
            self.device)
        self.replay_state.cursor = torch.zeros((), dtype=torch.int64,
                                               device=self.device)

        graphed = (capture and self.device.type == "cuda"
                   and not self.algo_cfg.debug_outputs)
        exploration = build(config.get(
            "exploration", {"type": "epsilon_greedy"}))
        if getattr(self.env, "is_device", False):
            if self.frame_stack != 1:
                raise ValueError("device envs feed raw obs straight to "
                                 "the model; frame_stack must be 1")
            self.actor = DeviceActor(
                self.env.inner, self.env.num_envs, self.model_cfg,
                exploration, fold_in_str(seed, "actor"),
                self.loop_cfg.chunk_len, self.device,
                compute_priorities=prio, gamma=self.algo_cfg.gamma,
                capture=graphed)
        else:
            self.actor = Actor(
                self.env, self.model_cfg, self.frame_stack, exploration,
                make_generator(seed, "actor", self.device),
                self.loop_cfg.chunk_len, self.device,
                compute_priorities=prio, gamma=self.algo_cfg.gamma,
                capture=graphed)
        self.flatten = len(spec.obs_shape) == 1

        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg,
            model_in_shape(spec, self.frame_stack, self.model_cfg),
            fold_in_str(seed, "learner"), self.device, capturable=graphed)
        use_device_counter(self.train_state, self.algo_cfg)
        if r2d2:
            upd = make_r2d2_update_step(self.model_cfg, self.algo_cfg,
                                        self.replay_cfg, self.frame_stack,
                                        self.flatten)
        else:
            upd = make_update_step(self.algo_cfg, self.replay_cfg,
                                   self.frame_stack, self.flatten,
                                   self.model_cfg.channels_last)
        self._insert = functools.partial(replay_insert_at_cursor,
                                         self.replay_cfg)
        self._insert_update = make_insert_and_update_step(
            self.replay_cfg, upd, self.loop_cfg.updates_per_chunk,
            insert=self._insert)
        self._make_graph(graphed)

        self.pool = None
        if self.loop_cfg.async_acting:
            self.pool = AsyncActorPool(self.actor, self.train_state.model)
        self._chunks_trained = 0

        self.timers = PhaseTimers()
        self.profile_server = (
            start_server(self.loop_cfg.profile_port, result_dir)
            if self.loop_cfg.profile_port > 0 else None)
        self.logger = logger or RunLogger(result_dir, config)
        self.last_metrics: Dict[str, torch.Tensor] = {}
        self.updates_done = 0
        self._t_start = time.time()
        self._steps_at_last_log = 0
        self._time_at_last_log = self._t_start
        self._best_score = float("-inf")
        self._protected_steps: set = set()

        if self.loop_cfg.resume:
            self._try_resume()

    # ----- checkpointing -----
    def _host_state(self):
        return dict(env_steps=self.actor.env_steps,
                    updates=self.updates_done)

    def save_checkpoint(self, protect: bool = True):
        """`protect=True` (interval/final saves) marks the step as never
        garbage-collectable by best-checkpoint cleanup."""
        rp = (self.replay_state if self.loop_cfg.checkpoint_replay
              else None)
        path = ckpt_lib.save(self.result_dir, self.actor.env_steps,
                             self.train_state, self._host_state(), rp)
        if protect:
            self._protected_steps.add(self.actor.env_steps)
        return path

    def _maybe_save_best(self, mean_return: float, n_episodes: int):
        if not self.loop_cfg.track_best:
            return
        self._best_score = ckpt_lib.maybe_record_best(
            self.result_dir, self._best_score, mean_return, n_episodes,
            self.loop_cfg.best_min_episodes, self.actor.env_steps,
            lambda: self.save_checkpoint(protect=False),
            self._protected_steps)

    def _try_resume(self):
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return
        best = ckpt_lib.best_step(self.result_dir)
        if best is not None:
            self._best_score = float(best["score"])
        restored = ckpt_lib.restore(self.result_dir, step)
        ckpt_lib.load_train_state(self.train_state, restored)
        self.actor.env_steps = int(restored["host_state"]["env_steps"])
        self.updates_done = int(restored["host_state"]["updates"])
        if self.loop_cfg.checkpoint_replay and "replay_state" in restored:
            ckpt_lib.load_replay_state(self.replay_state,
                                       restored["replay_state"])
        print(f"resumed from checkpoint at env step {step}")

    # ----- training -----
    def _beta(self) -> torch.Tensor:
        """The PER exponent at the actor's step count, as a 0-d float32
        tensor on the host: the fused trainer's betas are float32
        tensors, and a power takes another path for a float exponent
        than for a tensor one (the last bit of a weight may differ)."""
        a = self.algo_cfg
        frac = min(self.actor.env_steps
                   / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return torch.tensor(a.per_beta_start + frac * (a.per_beta_end
                                                       - a.per_beta_start),
                            dtype=torch.float32)

    def train_chunk(self, draws=None):
        """One acting chunk + its learner updates. Returns metrics.
        `draws` is for tests only, as the fused `superstep(draws)` is:
        the chunk's K update draws replayed from the JAX key chain (see
        `learner.make_insert_and_update_step`). Training never passes it
        and draws from the train state's generator."""
        with (self.profile_server.chunk() if self.profile_server
              else contextlib.nullcontext()):
            return self._train_chunk(draws)

    def _train_chunk(self, draws):
        with self.timers.phase("act"):
            if self.pool is not None:
                chunk, act_info = self.pool.get_chunk()
            else:
                chunk, act_info = self.actor.rollout(self.train_state.model)
        metrics = {}
        if self.actor.env_steps >= self.loop_cfg.warmup_env_steps:
            with self.timers.phase("insert+update", sync=self.device):
                metrics = self.learn(chunk, draws)
            self._chunks_trained += 1
            if (self.pool is not None and self._chunks_trained
                    % self.loop_cfg.publish_interval == 0):
                # a copy on this stream, after the replay
                self.pool.set_params(self.train_state.model)
        else:  # warmup: fill replay without updating
            with self.timers.phase("insert", sync=self.device):
                self.warm_insert(chunk)
        if self.transcript is not None:
            self.transcript.record_chunk(self.actor.env_steps,
                                         chunk["action"], metrics)
        return metrics, act_info

    def train(self):
        cfg = self.loop_cfg
        next_log = self.actor.env_steps + cfg.log_interval
        next_ckpt = self.actor.env_steps + cfg.checkpoint_interval
        with (trace(cfg.profile_dir) if cfg.profile_dir
              else contextlib.nullcontext()):
            while self.actor.env_steps < cfg.total_env_steps:
                metrics, _ = self.train_chunk()
                if self.actor.env_steps >= next_log:
                    next_log = self.actor.env_steps + cfg.log_interval
                    self._log(metrics)
                if self.actor.env_steps >= next_ckpt:
                    next_ckpt = self.actor.env_steps + cfg.checkpoint_interval
                    self.save_checkpoint()
        if self.pool is not None:
            self.pool.close()
        self.save_checkpoint()
        if self.transcript is not None:
            self.transcript.dump(os.path.join(self.result_dir,
                                              "transcript.jsonl"))
        self.logger.close()
        return self

    def _log(self, metrics):
        rets, lens = self.actor.episode_stats()
        now = time.time()
        steps = self.actor.env_steps
        sps = ((steps - self._steps_at_last_log)
               / max(now - self._time_at_last_log, 1e-9))
        self._steps_at_last_log = steps
        self._time_at_last_log = now
        scalars = dict(env_steps=steps, updates=self.updates_done,
                       steps_per_s=sps)
        if rets:
            scalars["episode_return_mean"] = float(np.mean(rets))
            scalars["episode_return_median"] = float(np.median(rets))
            scalars["episode_len_mean"] = float(np.mean(lens))
            self._maybe_save_best(scalars["episode_return_mean"],
                                  len(rets))
        scalars.update(score_scalars(self.env))
        for name, secs in self.timers.pop().items():
            scalars[f"time/{name}_s"] = secs
        for k, v in metrics.items():
            if not k.startswith("debug_"):
                scalars[f"train/{k}"] = float(v)
        self.logger.log_scalars(steps, scalars)
        self.logger.summary(steps, {k: v for k, v in scalars.items()
                                    if k != "env_steps"})

