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

The host enqueues these and reads nothing back: epsilon and the PER
exponent beta (one value per superstep, JAX's `betas`) go down once per
dispatch, and the metrics stay device scalars until the trainer logs.
What the JAX superstep's scan carries is state on the device, updated in
place: the replay's write cursor (`ReplayState.cursor`, inserts and
samples at it), the learner's update count (`TrainState.counter`, the
target sync a `torch.where`), the rollout's carry and the tree.

Where JAX jits the S supersteps into one program with the states
donated, the port captures ONE superstep into a CUDA graph on the card
(`utils/graphs.py:GraphedStep`) and a dispatch of S supersteps is S
replays, each after copying that superstep's epsilons and beta into the
graph's static inputs (device to device). The generators of the learner,
the envs and the actor are registered with the graph, Adam is
`capturable`, and a mesh's NCCL all-reduces are captured with the rest
(the census counts each replay's). The first two supersteps run the
body eagerly (real supersteps: cuDNN, the optimizer's state and NCCL
warm up in them), the third captures it. The CPU runs the same body
eagerly, and so does the transcript harness (`debug_outputs`, S = 1) on
the card; there is no eager fallback otherwise: a capture that fails
raises. S replays equal S sequential supersteps.

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
    ReplayConfig, replay_in_place, replay_init, replay_insert_at_cursor,
)
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.parallel.mesh import (
    Mesh, identity_mesh, load_sidecar, make_mesh, make_sharded_insert,
    pool_process_stats, save_sidecar, shard_update,
)
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_insert_and_update_step, make_train_state,
    make_update_step, use_device_counter,
)
from rltime_tpu_torch.training.r2d2 import (
    make_r2d2_update_step, r2d2_horizon,
)
from rltime_tpu_torch.training.trainer import (
    TrainLoopConfig, _mk_model_cfg, model_in_shape, replay_fields,
)
from rltime_tpu_torch.utils.graphs import GraphedStep
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
    states are updated in place, every tensor they hold kept (the tree
    and max_priority copied back). `beta` is a float or a 0-d tensor.
    `draws` = {"act": [L rollout-step draws], "update": [K update
    draws]} injects the random numbers (tests).

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
        with replay_in_place(rstate):
            astate, chunk = act(tstate.model, astate, eps, draws.get("act"))
            tstate, rstate, metrics = insert_update(
                tstate, rstate, chunk, beta, draws.get("update"))
        if algo_cfg.debug_outputs:
            # the chunk's actions ride out for the transcript's actions
            # digest (Trainer records the same)
            metrics["debug_chunk_action"] = chunk["action"]
        return tstate, astate, rstate, metrics

    def superstep_interleaved(tstate, astate, rstate, eps, beta, draws=None):
        draws = draws or {}
        a, u, k = draws.get("act"), draws.get("update"), num_updates
        metrics = {}
        with replay_in_place(rstate):
            for t in range(chunk_len):
                astate, col = act(tstate.model, astate, eps[t:t + 1],
                                  a[t:t + 1] if a else None)
                tstate, rstate, metrics = insert_update(
                    tstate, rstate, col, beta,
                    u[t * k:(t + 1) * k] if u else None)
        return tstate, astate, rstate, metrics

    return superstep_interleaved if interleave else superstep


def make_warm_superstep(env, model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                        replay_cfg: ReplayConfig, chunk_len: int,
                        compute_priorities: bool = False,
                        mesh: Optional[Mesh] = None):
    """Warmup program: act + insert, NO learner updates (the learner's
    generator is untouched), as `Trainer`'s warmup chunks; in place, as
    the superstep. Under `interleave_updates` the replay has chunk_len 1
    while this program still ACTS chunk_len steps per dispatch: it then
    inserts the chunk column by column. `mesh`: a MAX of `max_priority`
    follows."""
    mesh = mesh or identity_mesh()
    act = make_rollout_core(env, model_cfg, chunk_len, compute_priorities,
                            algo_cfg.gamma)
    per_col = replay_cfg.chunk_len == 1 and chunk_len > 1

    def warm(model, astate, rstate, eps, draws=None):
        with replay_in_place(rstate):
            astate, chunk = act(model, astate, eps,
                                (draws or {}).get("act"))
            cols = ([{k: v[:, t:t + 1] for k, v in chunk.items()}
                     for t in range(chunk_len)] if per_col else [chunk])
            for col in cols:
                replay_insert_at_cursor(replay_cfg, rstate, col)
            mesh.max_(rstate.max_priority, "max_priority")
        return astate, rstate

    return warm


def state_diffs(a, b) -> Dict[str, float]:
    """Max abs difference of every tensor and generator state of two
    (train_state, actor_state, replay_state) triples of one shape: the
    parameters and target, the optimizer's state (its lr tensors too),
    the learner's update counter and generator, the rings, tree,
    max_priority and cursor, and, where the actor state is not None (the
    host trainers keep theirs off the graph), the actor's env state,
    carry, running returns, stat rings (the spill slot left out), ring
    cursor and the envs' and actor's generators. For the checks that hold
    a graph replay against the eager body."""
    def pairs(ts, ast, rs):
        out = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
        out.update({f"target.{k}": v
                    for k, v in ts.target.state_dict().items()})
        for i, st in enumerate(ts.optimizer.state.values()):
            out.update({f"optimizer.{i}.{k}": v for k, v in st.items()
                        if isinstance(v, torch.Tensor)})
        for i, g in enumerate(ts.optimizer.param_groups):
            if isinstance(g["lr"], torch.Tensor):
                out[f"optimizer.lr.{i}"] = g["lr"]
        out.update({f"ring.{k}": v for k, v in rs.storage.items()})
        out.update(tree=rs.tree, max_priority=rs.max_priority,
                   cursor=rs.cursor, counter=ts.counter,
                   generator=ts.generator.get_state())
        if ast is not None:
            out.update({f"actor.{k}": v for k, v in ast.tensors().items()})
        return out

    pa, pb = pairs(*a), pairs(*b)
    return {k: (x.double().cpu() - pb[k].double().cpu()).abs().max().item()
            if x.numel() else 0.0 for k, x in pa.items()}


class FusedApexTrainer:
    """Runs the fused superstep loop (device envs only) on each rank of a
    mesh.

    The config is the `Trainer`'s ("env": {"type": "minatar_breakout" |
    "cartpole_device" | ..., "num_envs": lanes PER RANK}); select it with
    {"train": {"trainer": "fused"}} from the CLI. Supports warmup, image
    observations (uint8 replay rings), DQN/IQN/R2D2 updates, actor-side
    initial priorities, interleaved updates, transcripts (one rank),
    checkpoints and resume. `mesh` defaults to `make_mesh(device)`: the
    process group's ranks when one is initialised, else one rank.

    On a card each superstep is a replay of the CUDA graph `self.graph`
    (see the module doc) but for the transcript harness's; `capture=False`
    runs the same body op by op instead, for the bench's eager rate and
    for tests that inject draws (not a config key)."""

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
        self.replay_state.cursor = torch.zeros((), dtype=torch.int64,
                                               device=self.device)
        graphed = (capture and self.device.type == "cuda"
                   and not self.algo_cfg.debug_outputs)
        if graphed and self.mesh.distributed and self.mesh.backend != "nccl":
            raise ValueError(
                f"a CUDA graph captures NCCL collectives only; this mesh "
                f"is {self.mesh.backend}")
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
            fold_in_str(seed, "learner"), self.device, capturable=graphed)
        self.train_state.generator = self.mesh.shard_generator(
            self.train_state.generator)
        use_device_counter(self.train_state, self.algo_cfg)
        L = self.loop_cfg.chunk_len
        self._super = make_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg, L,
            self.loop_cfg.updates_per_chunk, frame_stack=1,
            flatten=self.flatten, compute_priorities=prio,
            interleave=interleave, mesh=self.mesh)
        self._warm_super = make_warm_superstep(
            self.env, self.model_cfg, self.algo_cfg, self.replay_cfg, L,
            compute_priorities=prio, mesh=self.mesh)
        self.graph = None
        if graphed:
            self.graph = GraphedStep(
                self._body,
                [torch.empty((L, E), device=self.device),
                 torch.empty((), device=self.device)],
                generators=[self.train_state.generator,
                            *self.actor_state.generators()])
            self._graph_states = None
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

    def _betas(self, num: int) -> torch.Tensor:
        """(num,) float32: beta of each of the next `num` supersteps,
        annealed on its POST-chunk step counter (the point Trainer
        samples it), sent down in one copy as the epsilons are."""
        per_chunk = self.loop_cfg.chunk_len * self.e_global
        betas = torch.tensor([self._beta_at(self.env_steps
                                            + (i + 1) * per_chunk)
                              for i in range(num)], dtype=torch.float32)
        if self.device.type == "cuda":
            return betas.pin_memory().to(self.device, non_blocking=True)
        return betas

    def eager_superstep(self, tstate, astate, rstate, eps: torch.Tensor,
                        beta, draws=None):
        """The superstep's body run op by op on any states of this
        trainer's shapes, in place (what a replay is held against).
        Returns the metrics; the host counts are the caller's."""
        *_, metrics = self._super(tstate, astate, rstate, eps, beta, draws)
        return metrics

    def _body(self, eps: torch.Tensor, beta: torch.Tensor, draws=None):
        """One superstep of the trainer's own states: what the graph
        captures."""
        return self.eager_superstep(self.train_state, self.actor_state,
                                    self.replay_state, eps, beta, draws)

    def _replay(self, eps: torch.Tensor, beta: torch.Tensor):
        """One superstep through the graph: the first WARMUP calls run the
        body eagerly, the next captures it, every later one replays it."""
        g = self.graph
        states = (self.train_state, self.actor_state, self.replay_state)
        if g.graph is None:
            out = g(eps, beta)
            if g.graph is not None:         # this call captured
                self._graph_states = states
            return out
        if any(a is not b for a, b in zip(states, self._graph_states)):
            raise RuntimeError("the graph holds the states it captured; "
                               "this trainer's were replaced since")
        return g(eps, beta)

    def superstep(self, draws=None):
        """One dispatch: S full supersteps, or one warmup act+insert.

        As `Trainer.train_chunk`, a chunk trains iff the post-chunk
        env-step counter has reached `warmup_env_steps`. `draws`: a list
        of S injected draw sets (one dict for a warmup dispatch; the
        eager body only). Returns the last superstep's metrics as device
        scalars ({} in warmup)."""
        L, S, K = (self.loop_cfg.chunk_len, self.supersteps,
                   self.loop_cfg.updates_per_chunk)
        per_chunk = L * self.e_global
        if self.env_steps + per_chunk < self.loop_cfg.warmup_env_steps:
            self._warm_super(self.train_state.model, self.actor_state,
                             self.replay_state, self._eps(L), draws)
            self.env_steps += per_chunk
            self.replay_state.t += L
            return {}
        if draws and self.graph is not None:
            raise ValueError("injected draws need the eager body: build the "
                             "trainer with capture=False")
        eps, betas = self._eps(S * L), self._betas(S)
        metrics = {}
        for i in range(S):
            step_eps = eps[i * L:(i + 1) * L]
            if self.graph is None:
                metrics = self._body(step_eps, betas[i],
                                     draws[i] if draws else None)
            else:
                metrics = self._replay(step_eps, betas[i])
        self.env_steps += S * per_chunk
        self.updates_done += S * K
        self.train_state.updates += S * K
        self.replay_state.t += S * L
        if self.graph is not None:      # the next replay overwrites them
            metrics = {k: v.clone() for k, v in metrics.items()}
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
