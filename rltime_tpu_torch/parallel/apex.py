"""Ape-X topology: per-rank host actors -> sharded replay -> data-parallel
learner (port of `rltime_tpu/parallel/apex.py`, config #5).

Each rank of the mesh (`parallel/mesh.py`; one process with one device)
runs:

  * `env.num_envs` lockstep host env lanes, the rank's actor shard, its
    env seeded with `seed + rank * 7919`;
  * an actor that acts with its OWN copy of the learner's weights, a
    second `QPolicy` on the rank's device refreshed every
    `train.publish_interval` chunks (the reference's "publish weights to
    actors" boundary);
  * its replay shard: the chunk goes into the rank's own ring and tree,
    and nothing of it crosses ranks;
  * the data-parallel update of `parallel/mesh.py`: a per-rank batch
    from the rank's shard, gradients averaged over the ranks in one
    all-reduce, so the learner stays identical everywhere;
  * an Ape-X epsilon ladder over the GLOBAL lanes (`_GlobalLadder`: lane
    i of E_global explores with eps^(1 + alpha i / (E_global - 1))).

One rank is the degenerate case (`python -m rltime_tpu_torch.train
apex_multihost_counting`); `python -m rltime_tpu_torch.train_distributed`
starts it on every rank. Each post-warmup chunk's sharded insert and K
data-parallel updates are one step (`mesh.make_sharded_insert_and_
update_step`, where JAX jits the sharded insert and the K-update step):
on a card, after two eager chunks, the third captures it into a CUDA
graph and every later chunk replays it, the NCCL all-reduces of a
one-rank group included (the host `Trainer`'s `ChunkStep`: the replay
cursor and update count on the device). Over gloo (the CPU), and with
`capture=False`, the same body runs op by op. Checkpoints: the lead writes the learner, every
rank its sidecar (actor generator, chunk count, sampling generator and,
with `checkpoint_replay`, its replay shard). Best-checkpoint tracking
pools every rank's episodes.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import rltime_tpu_torch.envs  # noqa: F401  (registers env types)
import rltime_tpu_torch.exploration  # noqa: F401  (registers exploration)
from rltime_tpu_torch.acting.actor import Actor
from rltime_tpu_torch.config.config import build
from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.exploration.epsilon import epsilon_ladder
from rltime_tpu_torch.history.replay import ReplayConfig, replay_init
from rltime_tpu_torch.parallel.mesh import (
    Mesh, load_sidecar, make_mesh, make_sharded_insert,
    make_sharded_insert_and_update_step, pool_process_stats, save_sidecar,
)
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_train_state, use_device_counter,
)
from rltime_tpu_torch.training.r2d2 import r2d2_horizon
from rltime_tpu_torch.training.trainer import (
    ChunkStep, TrainLoopConfig, _mk_model_cfg, model_in_shape,
    replay_fields, score_scalars,
)
from rltime_tpu_torch.utils.loggers import RunLogger
from rltime_tpu_torch.utils.prng import fold_in_str, make_generator
from rltime_tpu_torch.utils.profiling import PhaseTimers

POOL_CAP = 4096     # episodes per rank in the pooled multiset


class _GlobalLadder:
    """Ape-X ladder over the global lane index space, this rank's slice."""

    def __init__(self, e_global: int, offset: int, e_local: int,
                 base_eps: float = 0.4, alpha: float = 7.0):
        full = epsilon_ladder(e_global, base_eps, alpha)
        self._eps = full[offset:offset + e_local]

    def epsilons(self, num_envs: int, env_step: int) -> np.ndarray:
        return self._eps


class ApexTrainer(ChunkStep):
    """One rank of the Ape-X trainer (see the module doc); `capture=False`
    runs the step op by op on a card too (not a config key)."""

    def __init__(self, config: Dict[str, Any], result_dir: str,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None,
                 logger: Optional[RunLogger] = None,
                 capture: bool = True):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(self.device)
        d, rank = self.mesh.size, self.mesh.rank
        self.is_lead = self.mesh.is_lead
        self.config = config
        self.result_dir = result_dir
        seed = int(config.get("seed", 0))

        env_cfg = dict(config["env"])
        e_local = int(env_cfg.pop("num_envs"))
        e_global = e_local * d
        self.env = build({**env_cfg, "num_envs": e_local},
                         seed=seed + rank * 7919)
        spec = self.env.spec
        self.frame_stack = int(config.get("frame_stack", 1))
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        if self.loop_cfg.record_transcript or self.loop_cfg.async_acting:
            raise ValueError("train.record_transcript and train.async_acting "
                             "are options of the default Trainer")
        # one address for this knob: train.publish_interval (the same
        # field the default Trainer's async pool reads)
        self.publish_interval = int(self.loop_cfg.publish_interval)
        r2d2 = self.algo_cfg.algo == "r2d2"
        self.replay_cfg = ReplayConfig(
            num_envs=e_local,
            horizon=(r2d2_horizon(self.algo_cfg) if r2d2
                     else self.algo_cfg.n_step),
            chunk_len=self.loop_cfg.chunk_len,
            lookback=self.frame_stack - 1,
            **config.get("replay", {}))
        prio = self.replay_cfg.use_inserted_priorities
        # this rank's shard: its lanes, their columns, its own tree
        self.replay_state = replay_init(
            self.replay_cfg, replay_fields(spec, self.model_cfg, prio),
            self.device)
        self.replay_state.cursor = torch.zeros((), dtype=torch.int64,
                                               device=self.device)
        graphed = capture and self.device.type == "cuda"
        if graphed and self.mesh.distributed and self.mesh.backend != "nccl":
            raise ValueError(
                f"a CUDA graph captures NCCL collectives only; this mesh "
                f"is {self.mesh.backend}")

        exp_cfg = dict(config.get("exploration", {"type": "epsilon_greedy"}))
        if exp_cfg.get("mode") == "ladder":
            exploration = _GlobalLadder(
                e_global, rank * e_local, e_local,
                exp_cfg.get("base_eps", 0.4), exp_cfg.get("alpha", 7.0))
        else:
            exploration = build(exp_cfg)
        self.actor = Actor(
            self.env, self.model_cfg, self.frame_stack, exploration,
            make_generator(fold_in_str(seed, "actor"), f"proc {rank}",
                           self.device),
            self.loop_cfg.chunk_len, self.device, compute_priorities=prio,
            gamma=self.algo_cfg.gamma, capture=graphed)
        self.flatten = len(spec.obs_shape) == 1

        # identical weights on every rank (made on the CPU from the seed)
        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg,
            model_in_shape(spec, self.frame_stack, self.model_cfg),
            fold_in_str(seed, "learner"), self.device, capturable=graphed)
        self.train_state.generator = self.mesh.shard_generator(
            self.train_state.generator)
        use_device_counter(self.train_state, self.algo_cfg)
        self._insert = make_sharded_insert(self.replay_cfg, self.mesh)
        self._insert_update = make_sharded_insert_and_update_step(
            self.model_cfg, self.algo_cfg, self.replay_cfg, self.frame_stack,
            self.flatten, self.mesh,
            num_updates=self.loop_cfg.updates_per_chunk,
            channels_last=self.model_cfg.channels_last)
        self._make_graph(graphed)
        # the actor's own weights, published from the learner
        self.actor_model = copy.deepcopy(
            self.train_state.model).requires_grad_(False)

        self.updates_done = 0
        self._chunks = 0
        self.last_metrics: Dict[str, torch.Tensor] = {}
        self.logger = logger or (RunLogger(result_dir, config)
                                 if self.is_lead else None)
        self.timers = PhaseTimers()
        self._steps_at_last_log = 0
        self._time_at_last_log = time.time()
        self._best_score = float("-inf")
        self._protected_steps: set = set()
        self.episodes_seen = 0      # this rank's episodes popped by train()
        if self.loop_cfg.resume:
            self.try_resume()

    @property
    def global_env_steps(self) -> int:
        # every rank steps its lanes in lockstep with the others
        return self.actor.env_steps * self.mesh.size

    def _beta(self) -> torch.Tensor:
        """The PER exponent on the pre-update global step counter (the
        chunk just inserted is counted), the point Trainer samples it; a
        0-d float32 tensor on the host, as Trainer's."""
        a = self.algo_cfg
        frac = min(self.global_env_steps
                   / max(self.loop_cfg.total_env_steps, 1), 1.0)
        return torch.tensor(a.per_beta_start + frac * (a.per_beta_end
                                                       - a.per_beta_start),
                            dtype=torch.float32)

    def publish(self) -> None:
        """Copy the learner's weights into the actor's model."""
        self.actor_model.load_state_dict(self.train_state.model.state_dict())

    def train_chunk(self, draws=None):
        """One acting chunk, its insert and (after warmup) K updates.
        `draws`: this rank's K update draws (tests; the eager body)."""
        with self.timers.phase("act"):
            chunk, _ = self.actor.rollout(self.actor_model)
        self._chunks += 1
        metrics = {}
        if self.global_env_steps >= self.loop_cfg.warmup_env_steps:
            with self.timers.phase("insert+update", sync=self.device):
                metrics = self.learn(chunk, draws)
            if self._chunks % self.publish_interval == 0:
                self.publish()
        else:
            with self.timers.phase("insert", sync=self.device):
                self.warm_insert(chunk)
        return metrics

    # ----- checkpointing -----
    def save_checkpoint(self, protect: bool = True):
        """The lead saves the learner; EVERY rank writes its sidecar: its
        actor's generator, the chunk count, its sampling generator and,
        with `checkpoint_replay`, its replay shard. Resume restores the
        whole distributed state with no data crossing ranks."""
        step = self.global_env_steps
        if protect:
            self._protected_steps.add(step)
            if self.is_lead:
                # an interval save at an already-best step clears its
                # best_only flag so a post-resume new best can't reclaim it
                ckpt_lib.unmark_best_only(self.result_dir, step)
        path = None
        if self.is_lead:
            path = ckpt_lib.save(
                self.result_dir, step, self.train_state,
                dict(env_steps=self.actor.env_steps,
                     updates=self.updates_done))
        aux = {"actor_generator": self.actor.generator.get_state(),
               "chunks": self._chunks,
               "generator": self.train_state.generator.get_state()}
        if self.loop_cfg.checkpoint_replay:
            aux["replay_state"] = ckpt_lib.replay_payload(self.replay_state)
        save_sidecar(self.result_dir, step, self.mesh.rank, aux)
        return path

    def try_resume(self) -> bool:
        """Every rank restores the lead's learner checkpoint (a shared
        result dir) and the actor weights from it, then its own sidecar.
        Env instances restart fresh (host env internals are not
        serialisable; the reference's actor processes restart the same
        way)."""
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return False
        restored = ckpt_lib.restore(self.result_dir, step)
        ckpt_lib.load_train_state(self.train_state, restored)
        self.actor.env_steps = int(restored["host_state"]["env_steps"])
        self.updates_done = int(restored["host_state"]["updates"])
        self.publish()
        aux = load_sidecar(self.result_dir, step, self.mesh.rank)
        self.actor.generator.set_state(aux["actor_generator"])
        self.train_state.generator.set_state(aux["generator"])
        self._chunks = int(aux["chunks"])
        if self.loop_cfg.checkpoint_replay and "replay_state" in aux:
            ckpt_lib.load_replay_state(self.replay_state, aux["replay_state"])
        best = ckpt_lib.best_step(self.result_dir) if self.is_lead else None
        # the lead's best score on every rank (no shared view of best.json
        # is assumed): a resumed run must not mark a worse mean as 'best'
        self._best_score = self.mesh.lead_value(
            float(best["score"]) if best is not None else float("-inf"))
        self._protected_steps = ckpt_lib.derive_protected_steps(
            self.result_dir)
        print(f"apex: resumed from checkpoint at step {step}")
        return True

    # ----- training -----
    def train(self):
        cfg = self.loop_cfg
        next_log = self.global_env_steps + cfg.log_interval
        next_ckpt = self.global_env_steps + cfg.checkpoint_interval
        while self.global_env_steps < cfg.total_env_steps:
            metrics = self.train_chunk()
            if self.global_env_steps >= next_log:
                next_log = self.global_env_steps + cfg.log_interval
                # EVERY rank pops and pools its stats at the same chunk
                # (the gather is a rendezvous); the best decision and the
                # sidecar save then run everywhere, best.json and the
                # reclaim on the lead
                rets, lens = self.actor.episode_stats()
                self.episodes_seen += len(rets)
                g_rets, g_sum, g_n = pool_process_stats(rets, POOL_CAP,
                                                        self.mesh)
                if cfg.track_best and g_n > 0:
                    # the EXACT global mean and count decide (the pooled
                    # multiset may truncate past POOL_CAP per rank)
                    self._best_score = ckpt_lib.maybe_record_best(
                        self.result_dir, self._best_score, g_sum / g_n, g_n,
                        cfg.best_min_episodes, self.global_env_steps,
                        lambda: self.save_checkpoint(protect=False),
                        self._protected_steps, lead=self.is_lead)
                if self.logger is not None:
                    self._log(metrics, g_rets, g_sum, g_n, lens)
            if self.global_env_steps >= next_ckpt:
                next_ckpt = self.global_env_steps + cfg.checkpoint_interval
                self.save_checkpoint()
        self.save_checkpoint()
        if self.logger is not None:
            self.logger.close()
        return self

    def _log(self, metrics, rets, g_sum, g_n, lens):
        """Trainer._log's scalars: the episode mean is the exact global one
        (the one the best decision used), the median that of the pooled
        multiset; lengths are the lead's own episodes."""
        now = time.time()
        steps = self.global_env_steps
        sps = ((steps - self._steps_at_last_log)
               / max(now - self._time_at_last_log, 1e-9))
        self._steps_at_last_log = steps
        self._time_at_last_log = now
        scalars = dict(env_steps=steps, updates=self.updates_done,
                       steps_per_s=sps)
        if g_n:
            scalars["episode_return_mean"] = g_sum / g_n
            scalars["episode_count"] = g_n
        if rets:
            scalars["episode_return_median"] = float(np.median(rets))
        if lens:
            scalars["episode_len_mean"] = float(np.mean(lens))
        # the lead's own env: other ranks' games do not reach the log
        scalars.update(score_scalars(self.env))
        for name, secs in self.timers.pop().items():
            scalars[f"time/{name}_s"] = secs
        for k, v in metrics.items():
            if not k.startswith("debug_"):
                scalars[f"train/{k}"] = float(v)
        self.logger.log_scalars(steps, scalars)
        self.logger.summary(steps, {k: v for k, v in scalars.items()
                                    if k != "env_steps"})
