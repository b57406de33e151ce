"""Fused on-device superstep: the whole training iteration with the host
only dispatching.

Port of `rltime_tpu/parallel/fused.py`. For device-resident envs
(`envs/device.py`, `envs/minatar*.py`) nothing in the train loop needs
the host, so one superstep is, all on the device of each rank:

  1. `chunk_len` env+policy steps over the rank's lanes (the ONE rollout
     core of `acting/device_actor.py`),
  2. the chunk's insert into the rank's replay shard,
  3. K learner updates (DQN/IQN feed-forward or R2D2 sequence), the
     gradients averaged over the ranks (`parallel/mesh.py`).

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
paths agree bit for bit (tests/test_torch_fused.py).

The mesh (`parallel/mesh.py:Mesh`; the identity mesh of one rank unless
a process group is initialised) takes the place of JAX's `shard_map`:
each rank holds `env.num_envs` lanes of its own with their own env and
actor generators, acts with the epsilons of its slice of the global
lanes, inserts into its own shard (then a MAX of `max_priority`), and
runs updates whose gradients and metrics are averaged over the ranks.
Per-rank state goes to per-rank sidecars in the checkpoints
(`checkpoints_aux/<step>/proc<rank>.pt`), beside the lead's learner
checkpoint; best-checkpoint tracking pools every rank's episodes.

Options: actor-side initial priorities
(`replay.use_inserted_priorities`: the rollout core emits each
transition's 1-step |TD|), `train.interleave_updates` (one loop of L
iterations of {one env step, a one-column insert, K/L updates}, the
replay running with chunk_len 1) and `train.record_transcript` (S = 1,
no warmup, one rank: one record per chunk, `utils/transcript.py`).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import rltime_tpu_torch.envs  # noqa: F401  (registers env types)
import rltime_tpu_torch.exploration  # noqa: F401  (registers exploration)
from rltime_tpu_torch.acting.device_actor import (
    STATS_RING, eps_schedule, init_device_actor_state, make_rollout_core,
    pop_episode_stats,
)
from rltime_tpu_torch.config.config import build
from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.history.replay import (
    ReplayConfig, replay_init, replay_insert,
)
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.parallel.mesh import (
    Mesh, identity_mesh, load_sidecar, make_mesh, make_sharded_insert,
    pool_process_stats, save_sidecar, shard_update,
)
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_insert_and_update_step, make_train_state,
    make_update_step,
)
from rltime_tpu_torch.training.r2d2 import (
    make_r2d2_update_step, r2d2_horizon,
)
from rltime_tpu_torch.training.trainer import (
    TrainLoopConfig, _mk_model_cfg, model_in_shape, replay_fields,
)
from rltime_tpu_torch.utils.loggers import RunLogger
from rltime_tpu_torch.utils.prng import fold_in_str
from rltime_tpu_torch.utils.transcript import Transcript


def make_superstep(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                   replay_cfg: ReplayConfig, chunk_len: int,
                   num_updates: int, frame_stack: int = 1,
                   flatten: bool = True, compute_priorities: bool = False,
                   interleave: bool = False, mesh: Optional[Mesh] = None):
    """Build superstep(tstate, astate, rstate, eps (L, E), beta,
    draws=None) -> (tstate, astate, rstate, metrics): act L steps,
    insert the chunk, run `num_updates` learner updates. All three
    states are updated in place. `draws` = {"act": [L rollout-step
    draws], "update": [K update draws]} injects the random numbers
    (tests).

    `interleave` (train.interleave_updates): ONE loop of chunk_len
    iterations, each {1 env step over all lanes + a 1-column insert +
    num_updates / chunk_len learner updates}; `replay_cfg` then has
    chunk_len 1. The same work per superstep as the act-then-update
    shape at a per-STEP cadence: updates sample data at most one step
    old, priorities and the acting weights refresh every step, and the
    1-column insert frees chunk_len from the ring-safety bound
    steps_per_env >= 2*(chunk_len + horizon).

    `mesh`: the rank's insert is followed by a MAX of `max_priority`, and
    its updates average gradients and metrics over the ranks."""
    mesh = mesh or identity_mesh()
    if algo_cfg.algo == "r2d2":
        update = make_r2d2_update_step(model_cfg, algo_cfg, replay_cfg,
                                       frame_stack, flatten, mesh=mesh)
    else:
        update = make_update_step(algo_cfg, replay_cfg, frame_stack, flatten,
                                  mesh=mesh)
    act = make_rollout_core(env, model_cfg, 1 if interleave else chunk_len,
                            compute_priorities, algo_cfg.gamma)
    if interleave:
        if num_updates % chunk_len != 0:
            raise ValueError(
                "interleave_updates needs updates_per_chunk to be a "
                f"multiple of chunk_len (got {num_updates} per "
                f"{chunk_len})")
        if algo_cfg.debug_outputs:
            raise ValueError("debug_outputs/transcripts are not "
                             "supported with interleave_updates")
        num_updates //= chunk_len       # per env step
    insert_update = make_insert_and_update_step(
        replay_cfg, shard_update(update, mesh), num_updates,
        insert=make_sharded_insert(replay_cfg, mesh))

    def superstep(tstate, astate, rstate, eps, beta, draws=None):
        draws = draws or {}
        astate, chunk = act(tstate.model, astate, eps, draws.get("act"))
        tstate, rstate, metrics = insert_update(tstate, rstate, chunk, beta,
                                                draws.get("update"))
        if algo_cfg.debug_outputs:
            # the chunk's actions ride out for the transcript's actions
            # digest (Trainer records the same)
            metrics["debug_chunk_action"] = chunk["action"]
        return tstate, astate, rstate, metrics

    def superstep_interleaved(tstate, astate, rstate, eps, beta, draws=None):
        draws = draws or {}
        a, u, k = draws.get("act"), draws.get("update"), num_updates
        metrics = {}
        for t in range(chunk_len):
            astate, col = act(tstate.model, astate, eps[t:t + 1],
                              a[t:t + 1] if a else None)
            tstate, rstate, metrics = insert_update(
                tstate, rstate, col, beta, u[t * k:(t + 1) * k] if u else None)
        return tstate, astate, rstate, metrics

    return superstep_interleaved if interleave else superstep


def make_warm_superstep(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                        replay_cfg: ReplayConfig, chunk_len: int,
                        compute_priorities: bool = False,
                        mesh: Optional[Mesh] = None):
    """Warmup program: act + insert, NO learner updates (the learner's
    generator is untouched), as `Trainer`'s warmup chunks. Under
    `interleave_updates` the replay has chunk_len 1 while this program
    still ACTS chunk_len steps per dispatch: it then inserts the chunk
    column by column. `mesh`: a MAX of `max_priority` follows."""
    mesh = mesh or identity_mesh()
    act = make_rollout_core(env, model_cfg, chunk_len, compute_priorities,
                            algo_cfg.gamma)
    per_col = replay_cfg.chunk_len == 1 and chunk_len > 1

    def warm(model, astate, rstate, eps, draws=None):
        astate, chunk = act(model, astate, eps, (draws or {}).get("act"))
        if per_col:
            for t in range(chunk_len):
                replay_insert(replay_cfg, rstate,
                              {k: v[:, t:t + 1] for k, v in chunk.items()})
        else:
            replay_insert(replay_cfg, rstate, chunk)
        mesh.max_(rstate.max_priority, "max_priority")
        return astate, rstate

    return warm


class FusedApexTrainer:
    """Runs the fused superstep loop (device envs only) on each rank of a
    mesh.

    The config is the `Trainer`'s ("env": {"type": "minatar_breakout" |
    "cartpole_device" | ..., "num_envs": lanes PER RANK}); select it with
    {"train": {"trainer": "fused"}} from the CLI. Supports warmup, image
    observations (uint8 replay rings), DQN/IQN/R2D2 updates, actor-side
    initial priorities, interleaved updates, transcripts (one rank),
    checkpoints and resume. `mesh` defaults to `make_mesh(device)`: the
    process group's ranks when one is initialised, else one rank."""

    def __init__(self, config: Dict[str, Any], result_dir: str,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None,
                 logger: Optional[RunLogger] = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(self.device)
        d, rank = self.mesh.size, self.mesh.rank
        self.is_lead = self.mesh.is_lead
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
        self.e_global = E * d
        self._lanes = slice(rank * E, (rank + 1) * E)
        self.model_cfg = _mk_model_cfg(config.get("model", {}),
                                       spec.num_actions)
        self.algo_cfg = AlgoConfig(**config.get("algo", {}))
        self.loop_cfg = TrainLoopConfig(**config.get("train", {}))
        self.supersteps = max(1, int(self.loop_cfg.supersteps_per_dispatch))
        self.transcript = None
        if self.loop_cfg.record_transcript:
            self.algo_cfg = dataclasses.replace(self.algo_cfg,
                                                debug_outputs=True)
            self.transcript = Transcript()
        if self.algo_cfg.debug_outputs:
            if self.loop_cfg.warmup_env_steps > 0:
                raise ValueError(
                    "fused transcripts record post-warmup chunks only — "
                    "set train.warmup_env_steps=0 for the exact-numerics "
                    "harness (Trainer records warmup chunks too, so the "
                    "transcripts would differ)")
            if self.supersteps != 1:
                raise ValueError(
                    "debug_outputs/record_transcript on the fused "
                    "path needs supersteps_per_dispatch=1 (the "
                    "transcript records every chunk; an S-loop only "
                    "surfaces the last)")
            if d > 1:
                raise ValueError(
                    "record_transcript/debug_outputs on the fused path "
                    "requires a single-rank run")
        r2d2 = self.algo_cfg.algo == "r2d2"
        interleave = self.loop_cfg.interleave_updates
        # interleave_updates inserts ONE column at a time, so the replay
        # geometry validates against chunk_len=1: this is what frees
        # chunk_len from the ring-safety bound
        self.replay_cfg = ReplayConfig(
            num_envs=E,
            horizon=r2d2_horizon(self.algo_cfg) if r2d2
            else self.algo_cfg.n_step,
            chunk_len=1 if interleave else self.loop_cfg.chunk_len,
            **config.get("replay", {}))
        self.flatten = len(spec.obs_shape) == 1
        prio = self.replay_cfg.use_inserted_priorities
        self.replay_state = replay_init(
            self.replay_cfg, replay_fields(spec, self.model_cfg, prio),
            self.device)
        # the rank's env and actor streams; one rank keeps the seed's own
        actor_seed = fold_in_str(seed, "actor")
        if d > 1:
            actor_seed = fold_in_str(actor_seed, f"shard {rank}")
        self.actor_state = init_device_actor_state(
            self.env, self.model_cfg, E, actor_seed, self.device)
        # identical weights on every rank (made on the CPU from the seed)
        self.train_state = make_train_state(
            self.model_cfg, self.algo_cfg,
            model_in_shape(spec, 1, self.model_cfg),
            fold_in_str(seed, "learner"), self.device)
        self.train_state.generator = self.mesh.shard_generator(
            self.train_state.generator)
        L = self.loop_cfg.chunk_len
        self._super = make_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg, L,
            self.loop_cfg.updates_per_chunk, frame_stack=1,
            flatten=self.flatten, compute_priorities=prio,
            interleave=interleave, mesh=self.mesh)
        self._warm_super = make_warm_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg, L,
            compute_priorities=prio, mesh=self.mesh)
        self.exploration = build(config.get(
            "exploration", {"type": "epsilon_greedy"}))
        self.logger = logger or (RunLogger(result_dir, config)
                                 if self.is_lead else None)
        self.env_steps = 0              # global: every rank's lanes
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

    def _eps(self, num_steps: int) -> torch.Tensor:
        """(num_steps, E_local): this rank's slice of the schedule over
        the global lanes."""
        return eps_schedule(self.exploration, self.e_global, self.env_steps,
                            num_steps, self.device, self._lanes)

    def superstep(self, draws=None):
        """One dispatch: S full supersteps, or one warmup act+insert.

        As `Trainer.train_chunk`, a chunk trains iff the post-chunk
        env-step counter has reached `warmup_env_steps`. `draws`: a list
        of S injected draw sets (one dict for a warmup dispatch). Returns
        the last superstep's metrics as device scalars ({} in warmup)."""
        L, S = self.loop_cfg.chunk_len, self.supersteps
        per_chunk = L * self.e_global
        if self.env_steps + per_chunk < self.loop_cfg.warmup_env_steps:
            self.actor_state, self.replay_state = self._warm_super(
                self.train_state.model, self.actor_state, self.replay_state,
                self._eps(L), draws)
            self.env_steps += per_chunk
            return {}
        eps = self._eps(S * L)
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
        if self.transcript is not None:
            metrics = dict(metrics)
            actions = metrics.pop("debug_chunk_action")
            self.transcript.record_chunk(self.env_steps, actions, metrics)
        self.last_metrics = metrics
        return metrics

    def episode_stats(self):
        """This rank's fresh completed returns, oldest first (reads the
        device)."""
        rets, _, self._stats_popped = pop_episode_stats(
            self.actor_state, self._stats_popped)
        return rets

    def global_episode_stats(self):
        """Fresh completed returns pooled over every rank (a rendezvous).
        One rank: `episode_stats()`. Fresh returns per rank are bounded
        by STATS_RING, so the pool truncates nothing."""
        pooled, _, _ = pool_process_stats(self.episode_stats(), STATS_RING,
                                          self.mesh)
        return pooled

    # ----- checkpointing -----
    def _host_state(self):
        return dict(env_steps=self.env_steps, updates=self.updates_done)

    def save_checkpoint(self, protect: bool = True):
        """The lead saves the learner (identical on every rank); EVERY
        rank writes its sidecar: the whole actor state (env state, carry,
        stat rings, both generators), its stats cursor, its sampling
        generator and, with `checkpoint_replay`, its replay shard. A
        resumed run continues bit-identically."""
        step = self.env_steps
        path = None
        if self.is_lead:
            path = ckpt_lib.save(self.result_dir, step, self.train_state,
                                 self._host_state())
        aux = {"actor_state": self.actor_state.state_dict(),
               "stats_popped": self._stats_popped,
               "generator": self.train_state.generator.get_state()}
        if self.loop_cfg.checkpoint_replay:
            aux["replay_state"] = ckpt_lib.replay_payload(self.replay_state)
        save_sidecar(self.result_dir, step, self.mesh.rank, aux)
        if protect:
            self._protected_steps.add(step)
            if self.is_lead:
                # an interval save at an already-best step clears its
                # best_only flag so a post-resume new best can't reclaim it
                ckpt_lib.unmark_best_only(self.result_dir, step)
        return path

    def _try_resume(self):
        """Every rank restores the lead's learner checkpoint (a shared
        result dir) and its own sidecar."""
        step = ckpt_lib.latest_step(self.result_dir)
        if step is None:
            return
        best = ckpt_lib.best_step(self.result_dir) if self.is_lead else None
        # the lead's best score on every rank: a resumed run must not mark
        # a worse mean as 'best', and the ranks' decisions must agree
        self._best_score = self.mesh.lead_value(
            float(best["score"]) if best is not None else float("-inf"))
        restored = ckpt_lib.restore(self.result_dir, step)
        ckpt_lib.load_train_state(self.train_state, restored)
        hs = restored["host_state"]
        self.env_steps = int(hs["env_steps"])
        self.updates_done = int(hs["updates"])
        aux = load_sidecar(self.result_dir, step, self.mesh.rank)
        self.train_state.generator.set_state(aux["generator"])
        self._stats_popped = int(aux["stats_popped"])
        self.actor_state.load_state_dict(aux["actor_state"])
        if self.loop_cfg.checkpoint_replay and "replay_state" in aux:
            ckpt_lib.load_replay_state(self.replay_state, aux["replay_state"])
        # protected (interval/final) steps don't survive the process:
        # rebuild them, so a post-resume new best cannot reclaim one
        self._protected_steps = ckpt_lib.derive_protected_steps(
            self.result_dir)
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
                # every rank pools the same stats at the same superstep,
                # reaches the same decision and writes its sidecar;
                # best.json and the reclaim are the lead's
                rets = self.global_episode_stats()
                if rets and cfg.track_best:
                    self._best_score = ckpt_lib.maybe_record_best(
                        self.result_dir, self._best_score,
                        float(np.mean(rets)), len(rets),
                        cfg.best_min_episodes, self.env_steps,
                        lambda: self.save_checkpoint(protect=False),
                        self._protected_steps, lead=self.is_lead)
                if self.logger is not None:
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
        if self.transcript is not None:
            self.transcript.dump(os.path.join(self.result_dir,
                                              "transcript.jsonl"))
        if self.logger is not None:
            self.logger.close()
        return self
