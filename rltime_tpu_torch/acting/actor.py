"""Acting: the on-device act step + host rollout loop.

Port of `rltime_tpu/acting/actor.py`. The act step runs on the device
over ALL env lanes at once:

  raw obs (host) --H2D--> act_step (frame-stack update, obs-chunk
  accumulator write, LSTM carry reset + step, eps-greedy) --> actions
  (host)

Per step the host sends one raw obs batch and reads back the actions.
The raw frames accumulate in a device chunk buffer and go to the replay
from there, so they cross to the device once. For a recurrent policy
the carry CONSUMED by each step (after the `done_prev` reset: what R2D2
burn-in resumes from) is written to device chunk buffers `rnn_c` and
`rnn_h`; the carry never crosses to the host. Exploration draws
(and the IQN acting taus) come from the actor's own generator and enter
the act step as tensors.

With `compute_priorities` (Ape-X actor-side initial priorities) each
transition is emitted one policy step late, so that its 1-step TD
estimate |r + gamma*(1-done)*max_a Q(s') - Q(s,a)| can ride along as the
chunk's "priority" field; the chunk's obs then accumulate on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rltime_tpu_torch.models.policy import (
    ModelConfig, QPolicy, RnnState, initial_rnn_state, q_values,
)


@dataclasses.dataclass
class ActorDeviceState:
    """On-device acting state for E lockstep env lanes."""
    frames: torch.Tensor      # (E, F, ...) rolling frame stack
    obs_chunk: torch.Tensor   # (E, L, ...) chunk obs accumulator
    rnn: Optional[RnnState] = None          # LSTM carry (c, h), (E, H)
    rnn_chunk: Optional[RnnState] = None    # stored carries, (E, L, H)


def init_actor_state(cfg: ModelConfig, num_envs: int, frame_stack: int,
                     obs_shape, obs_dtype, chunk_len: int,
                     device) -> ActorDeviceState:
    state = ActorDeviceState(
        frames=torch.zeros((num_envs, frame_stack) + tuple(obs_shape),
                           dtype=obs_dtype, device=device),
        obs_chunk=torch.zeros((num_envs, chunk_len) + tuple(obs_shape),
                              dtype=obs_dtype, device=device))
    if cfg.recurrent:
        state.rnn = initial_rnn_state(cfg, num_envs, device)
        state.rnn_chunk = tuple(
            torch.zeros((num_envs, chunk_len, cfg.lstm_size), device=device)
            for _ in range(2))
    return state


def make_act_step(cfg: ModelConfig, frame_stack: int, flatten_stack: bool):
    """Build the act step for a model config.

    flatten_stack: vector obs feed the model as (E, F*D); image obs keep
    (E, F, H, W), the CNN taking F as channels."""

    @torch.no_grad()
    def act_step(model: QPolicy, state: ActorDeviceState,
                 obs: torch.Tensor, done_prev: torch.Tensor,
                 eps: torch.Tensor, t_in_chunk: int,
                 explore_u: torch.Tensor, random_a: torch.Tensor,
                 taus: Optional[torch.Tensor] = None):
        """One lockstep policy step.

        Args:
          obs: (E, ...) raw obs AFTER the previous env step (auto-reset:
            the first obs of a new episode where done_prev).
          done_prev: (E,) bool — the previous step ended the episode.
          eps: (E,) per-lane exploration epsilon.
          t_in_chunk: column of the chunk accumulators to fill, or None
            to leave them alone (the caller keeps `info["rnn"]`).
          explore_u: (E,) uniforms in [0, 1); a lane explores iff u < eps.
          random_a: (E,) int actions taken where a lane explores.
          taus: (E, num_tau_policy) acting quantile fractions (IQN).
        Returns (actions (E,) int32, state, info dict: q_mean, the
        chosen and the best action's value q_sa, q_best (E,), and for a
        recurrent policy the carry this step consumed as "rnn").
        """
        E = obs.shape[0]
        # frame stack: zero pre-reset frames, append the new obs
        keep = (~done_prev).reshape((E,) + (1,) * (state.frames.ndim - 1))
        frames = state.frames * keep.to(state.frames.dtype)
        frames = torch.cat([frames[:, 1:], obs[:, None].to(frames.dtype)],
                           dim=1)
        state.frames = frames
        if t_in_chunk is not None:
            state.obs_chunk[:, t_in_chunk] = obs

        net_in = frames.reshape(E, -1) if flatten_stack else frames
        if cfg.channels_last and net_in.ndim == 4:
            # NHWC model contract: the rolling stack stays (E, F, H, W);
            # only this per-step view is transposed (as the JAX version,
            # every 4-D input is taken to be (E, F, H, W))
            net_in = torch.movedim(net_in, 1, -1)
        head_kw = {"taus": taus} if cfg.is_iqn else {}
        info = {}
        if cfg.recurrent:
            # reset on the episode boundary; store the carry THIS step
            # consumes (R2D2 storage)
            rmask = (1.0 - done_prev.to(torch.float32))[:, None]
            rnn = (state.rnn[0] * rmask, state.rnn[1] * rmask)
            if t_in_chunk is not None:
                state.rnn_chunk[0][:, t_in_chunk] = rnn[0]
                state.rnn_chunk[1][:, t_in_chunk] = rnn[1]
            info["rnn"] = rnn
            q, state.rnn = model(net_in, rnn, **head_kw)
        else:
            q = model(net_in, **head_kw)
        qv = q_values(cfg, q)
        greedy = torch.argmax(qv, dim=-1).to(torch.int32)
        actions = torch.where(explore_u < eps, random_a.to(torch.int32),
                              greedy)
        info.update(
            q_mean=torch.mean(qv),
            q_sa=torch.gather(qv, -1, actions.long()[:, None])[:, 0],
            q_best=torch.max(qv, dim=-1).values)
        return actions, state, info

    return act_step


class Actor:
    """Host-side rollout loop over one VecEnv.

    Produces fixed-shape transition chunks: obs (E, L, ...) raw single
    frames on the device, action/reward/terminated/done (E, L) numpy.
    Tracks per-env episode returns/lengths host-side.

    `compute_priorities`: the chunk also carries "priority" (E, L), the
    raw 1-step |TD| of each transition (bootstrap masked by done, not
    terminated: at a done step s' is the next episode's reset obs, which
    no target bootstraps from). Transitions are then emitted one policy
    step late, and the obs accumulate in a host buffer instead of the
    device chunk accumulator."""

    def __init__(self, env, cfg: ModelConfig, frame_stack: int,
                 exploration, generator: torch.Generator, chunk_len: int,
                 device: torch.device, compute_priorities: bool = False,
                 gamma: float = 0.99):
        self.env = env
        self.cfg = cfg
        self.exploration = exploration
        self.generator = generator
        self.chunk_len = chunk_len
        self.device = device
        self.compute_priorities = compute_priorities
        self.gamma = gamma
        self._pending = None
        spec = env.spec
        self._act_step = make_act_step(cfg, frame_stack,
                                       len(spec.obs_shape) == 1)
        obs_dtype = (torch.uint8 if spec.obs_dtype == np.uint8
                     else torch.float32)
        self.state = init_actor_state(cfg, env.num_envs, frame_stack,
                                      spec.obs_shape, obs_dtype, chunk_len,
                                      device)
        self.obs = env.reset()
        self.done_prev = np.ones((env.num_envs,), bool)  # stack starts empty
        self.env_steps = 0
        self._ep_ret = np.zeros((env.num_envs,), np.float64)
        self._ep_len = np.zeros((env.num_envs,), np.int64)
        self.completed_returns: list = []
        self.completed_lengths: list = []

    def rollout(self, model: QPolicy):
        """Collect one chunk of `chunk_len` lockstep transitions.

        Returns (chunk dict, each field (E, L, ...), info dict); `obs`
        (a host array with `compute_priorities`) and, for a recurrent
        policy, `rnn_c`/`rnn_h` are device tensors."""
        L, E = self.chunk_len, self.env.num_envs
        dev, gen = self.device, self.generator
        spec = self.env.spec
        late = self.compute_priorities
        obs_buf = (np.empty((E, L) + tuple(spec.obs_shape), spec.obs_dtype)
                   if late else None)
        act_buf = np.empty((E, L), np.int32)
        rew_buf = np.empty((E, L), np.float32)
        term_buf = np.empty((E, L), bool)
        done_buf = np.empty((E, L), bool)
        prio_buf = np.empty((E, L), np.float32) if late else None
        rnn_steps = []
        q_mean = None
        emitted = 0

        def emit(tr, prio=None):
            nonlocal emitted
            i = emitted
            if late:
                obs_buf[:, i] = tr["obs"]
                prio_buf[:, i] = prio
                if self.cfg.recurrent:
                    rnn_steps.append(tr["rnn"])
            act_buf[:, i] = tr["action"]
            rew_buf[:, i] = tr["reward"]
            term_buf[:, i] = tr["terminated"]
            done_buf[:, i] = tr["done"]
            emitted += 1

        while emitted < L:
            eps = self.exploration.epsilons(E, self.env_steps)
            explore_u = torch.rand((E,), generator=gen, device=dev)
            random_a = torch.randint(0, self.cfg.num_actions, (E,),
                                     generator=gen, device=dev)
            taus = (torch.rand((E, self.cfg.num_tau_policy), generator=gen,
                               device=dev) if self.cfg.is_iqn else None)
            actions, self.state, info = self._act_step(
                model, self.state,
                torch.from_numpy(np.ascontiguousarray(self.obs)).to(dev),
                torch.from_numpy(self.done_prev).to(dev),
                torch.from_numpy(eps).to(dev), None if late else emitted,
                explore_u, random_a, taus)
            if late and self._pending is not None:
                p = self._pending
                emit(p, np.abs(
                    p["reward"] + self.gamma
                    * (1.0 - p["done"].astype(np.float32))
                    * info["q_best"].cpu().numpy() - p["q_sa"]))
            actions_np = actions.cpu().numpy()
            obs_cur = self.obs
            next_obs, rew, term, trunc = self.env.step(actions_np)
            done = term | trunc
            tr = dict(action=actions_np, reward=rew, terminated=term,
                      done=done)
            if late:
                tr.update(obs=obs_cur, q_sa=info["q_sa"].cpu().numpy(),
                          rnn=info.get("rnn"))
                self._pending = tr
            else:
                emit(tr)
            self._ep_ret += rew
            self._ep_len += 1
            for j in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_ret[j]))
                self.completed_lengths.append(int(self._ep_len[j]))
            self._ep_ret[done] = 0.0
            self._ep_len[done] = 0
            self.obs = next_obs
            self.done_prev = done
            self.env_steps += E
            q_mean = info["q_mean"]
        # Clone out of the accumulator: the next chunk overwrites it.
        chunk = dict(obs=obs_buf if late else self.state.obs_chunk.clone(),
                     action=act_buf, reward=rew_buf, terminated=term_buf,
                     done=done_buf)
        if late:
            chunk["priority"] = prio_buf
        if self.cfg.recurrent and late:
            chunk["rnn_c"] = torch.stack([r[0] for r in rnn_steps], dim=1)
            chunk["rnn_h"] = torch.stack([r[1] for r in rnn_steps], dim=1)
        elif self.cfg.recurrent:
            chunk["rnn_c"] = self.state.rnn_chunk[0].clone()
            chunk["rnn_h"] = self.state.rnn_chunk[1].clone()
        return chunk, dict(env_steps=self.env_steps, q_mean=float(q_mean))

    def episode_stats(self, clear: bool = True):
        rets, lens = self.completed_returns, self.completed_lengths
        if clear:
            self.completed_returns, self.completed_lengths = [], []
        return rets, lens
