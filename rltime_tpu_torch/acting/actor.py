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

On a card the act step is one CUDA-graph replay per env step, the
port's counterpart of the JAX package's jitted, state-donating act step
(`Actor(..., capture=True)`, the default; `utils/graphs.py`). The step
keeps what it carries in place (the frame stack, the LSTM carry, the
chunk accumulators at a device column `state.col` that it advances and
wraps to 0 after a chunk's last step), draws from the actor's generator
inside (registered with the graph, in the op-by-op order: explore
uniforms, random actions, IQN taus), and reads its inputs from static
buffers: the obs, `done_prev` and eps go down from pinned host buffers
without a sync, and the actions (with actor-side priorities also
Q(s, a) and max_a Q) come back in ONE copy to pinned memory and one
event wait a step. The graph records the model's addresses, so a
captured actor acts with one model object for its life. The CPU and
`capture=False` run the step op by op; a test injects draws by
replacing `_act_step`, which that route calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from rltime_tpu_torch.models.policy import (
    ModelConfig, QPolicy, RnnState, initial_rnn_state, q_values,
)
from rltime_tpu_torch.utils.graphs import GraphedStep


@dataclasses.dataclass
class ActorDeviceState:
    """On-device acting state for E lockstep env lanes."""
    frames: torch.Tensor      # (E, F, ...) rolling frame stack
    obs_chunk: torch.Tensor   # (E, L, ...) chunk obs accumulator
    rnn: Optional[RnnState] = None          # LSTM carry (c, h), (E, H)
    rnn_chunk: Optional[RnnState] = None    # stored carries, (E, L, H)
    col: Optional[torch.Tensor] = None      # () int64: the chunk column
                                            # the captured step writes

    def clone(self) -> "ActorDeviceState":
        """An independent copy (what a replay is held against)."""
        pair = (lambda r: None if r is None else tuple(x.clone() for x in r))
        return ActorDeviceState(
            frames=self.frames.clone(), obs_chunk=self.obs_chunk.clone(),
            rnn=pair(self.rnn), rnn_chunk=pair(self.rnn_chunk),
            col=None if self.col is None else self.col.clone())

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor by name (what a replay is held against)."""
        out = dict(frames=self.frames, obs_chunk=self.obs_chunk,
                   col=self.col)
        for name in ("rnn", "rnn_chunk"):
            for i, x in enumerate(getattr(self, name) or ()):
                out[f"{name}[{i}]"] = x
        return out


def init_actor_state(cfg: ModelConfig, num_envs: int, frame_stack: int,
                     obs_shape, obs_dtype, chunk_len: int,
                     device) -> ActorDeviceState:
    state = ActorDeviceState(
        frames=torch.zeros((num_envs, frame_stack) + tuple(obs_shape),
                           dtype=obs_dtype, device=device),
        obs_chunk=torch.zeros((num_envs, chunk_len) + tuple(obs_shape),
                              dtype=obs_dtype, device=device),
        col=torch.zeros((), dtype=torch.int64, device=device))
    if cfg.recurrent:
        state.rnn = initial_rnn_state(cfg, num_envs, device)
        state.rnn_chunk = tuple(
            torch.zeros((num_envs, chunk_len, cfg.lstm_size), device=device)
            for _ in range(2))
    return state


def _write_column(buf: torch.Tensor, t, x: torch.Tensor) -> None:
    """buf[:, t] = x, where `t` is a host int or a 0-d device index (the
    captured step's column: no host value enters the graph)."""
    if isinstance(t, torch.Tensor):
        buf.index_copy_(1, t.reshape(1), x[:, None].to(buf.dtype))
    else:
        buf[:, t] = x


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
          t_in_chunk: column of the chunk accumulators to fill (a host
            int, or a 0-d int64 device tensor), or None to leave them
            alone (the caller keeps `info["rnn"]`).
          explore_u: (E,) uniforms in [0, 1); a lane explores iff u < eps.
          random_a: (E,) int actions taken where a lane explores.
          taus: (E, num_tau_policy) acting quantile fractions (IQN).
        Returns (actions (E,) int32, state, info dict: q_mean, the
        chosen and the best action's value q_sa, q_best (E,), and for a
        recurrent policy the carry this step consumed as "rnn"). The
        frame stack and the carry are written into the state's own
        tensors.
        """
        E = obs.shape[0]
        # frame stack: zero pre-reset frames, append the new obs
        keep = (~done_prev).reshape((E,) + (1,) * (state.frames.ndim - 1))
        frames = state.frames * keep.to(state.frames.dtype)
        frames = torch.cat([frames[:, 1:], obs[:, None].to(frames.dtype)],
                           dim=1)
        state.frames.copy_(frames)
        if t_in_chunk is not None:
            _write_column(state.obs_chunk, t_in_chunk, obs)

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
                _write_column(state.rnn_chunk[0], t_in_chunk, rnn[0])
                _write_column(state.rnn_chunk[1], t_in_chunk, rnn[1])
            info["rnn"] = rnn
            q, carry = model(net_in, rnn, **head_kw)
            for mine, new in zip(state.rnn, carry):
                mine.copy_(new)
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
    device chunk accumulator.

    `capture` (on a card): each act step is a replay of a CUDA graph
    (`self.graph`; the module doc), acting with the model of the first
    rollout for the actor's life. `capture=False` and the CPU run the
    step op by op."""

    def __init__(self, env, cfg: ModelConfig, frame_stack: int,
                 exploration, generator: torch.Generator, chunk_len: int,
                 device: torch.device, compute_priorities: bool = False,
                 gamma: float = 0.99, capture: bool = True):
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
        self.graph = None
        self._static = None
        if capture and device.type == "cuda":
            self.use_static_buffers(graphed=True)

    def _draws(self, gen: torch.Generator):
        """One step's draws from `gen`: explore uniforms (E,), random
        actions (E,) and, for IQN, the acting taus."""
        E, dev = self.env.num_envs, self.device
        explore_u = torch.rand((E,), generator=gen, device=dev)
        random_a = torch.randint(0, self.cfg.num_actions, (E,),
                                 generator=gen, device=dev)
        taus = (torch.rand((E, self.cfg.num_tau_policy), generator=gen,
                           device=dev) if self.cfg.is_iqn else None)
        return explore_u, random_a, taus

    def use_static_buffers(self, graphed: bool) -> None:
        """Act through the captured route's body: static input buffers
        (pinned on the host, their device copies), the draws inside and
        the chunk column on the device; one packed output read back a
        step. `graphed` runs the body as a CUDA graph (a card only);
        without it the body runs op by op (what the graph captures, and
        what the CPU tests hold against the op-by-op route)."""
        E, spec = self.env.num_envs, self.env.spec
        pin = self.device.type == "cuda"

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self._host_in = (
            host((E,) + tuple(spec.obs_shape), self.state.frames.dtype),
            host((E,), torch.bool), host((E,), torch.float32))
        dev_in = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                  for h in self._host_in]
        self._host_out = host(((3 if self.compute_priorities else 1) * E,),
                              torch.float32)
        self._event = torch.cuda.Event() if pin else None
        self._model = None
        self._static = dev_in
        self.graph = (GraphedStep(self._body, dev_in, [self.generator])
                      if graphed else None)

    def eager_body(self, state: ActorDeviceState, gen: torch.Generator,
                   obs: torch.Tensor, done_prev: torch.Tensor,
                   eps: torch.Tensor):
        """One act step of the captured route op by op, on any state and
        generator of this actor's shapes, in place (what the graph
        captures, and what a replay is held against). Returns (packed
        (k*E,) float32: the actions' int32 bits, then with actor-side
        priorities Q(s, a) and max_a Q; the step's info)."""
        late = self.compute_priorities
        explore_u, random_a, taus = self._draws(gen)
        actions, _, info = self._act_step(
            self._model, state, obs, done_prev, eps,
            None if late else state.col, explore_u, random_a, taus)
        parts = [actions.view(torch.float32)]
        if late:
            parts += [info["q_sa"], info["q_best"]]
        else:   # the next column, back to 0 after the chunk's last
            state.col.copy_(torch.remainder(state.col + 1, self.chunk_len))
        return torch.cat(parts), info

    def _body(self, obs: torch.Tensor, done_prev: torch.Tensor,
              eps: torch.Tensor):
        """The act step on the actor's own state: what the graph
        captures."""
        return self.eager_body(self.state, self.generator, obs, done_prev,
                               eps)

    def _static_step(self, model: QPolicy, eps: np.ndarray):
        """One act step through the static buffers (a graph replay on the
        card): the inputs down, the body, ONE packed read back. Returns
        (actions, q_sa, q_best: numpy (E,), the last two None without
        actor-side priorities; info)."""
        if model is not self._model:
            if self.graph is not None and self.graph.calls:
                raise RuntimeError(
                    "the captured act step acts with the model of its "
                    "first rollout; update that model in place instead")
            self._model = model
        h_obs, h_done, h_eps = self._host_in
        h_obs.numpy()[...] = self.obs
        h_done.numpy()[...] = self.done_prev
        h_eps.numpy()[...] = eps
        for d, h in zip(self._static, self._host_in):
            d.copy_(h, non_blocking=True)
        run = self.graph if self.graph is not None else self._body
        packed, info = run(*self._static)
        self._host_out.copy_(packed, non_blocking=True)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        E = self.env.num_envs
        flat = self._host_out.numpy()
        actions = flat[:E].view(np.int32).copy()
        if not self.compute_priorities:
            return actions, None, None, info
        return actions, flat[E:2 * E].copy(), flat[2 * E:].copy(), info

    def rollout(self, model: QPolicy):
        """Collect one chunk of `chunk_len` lockstep transitions.

        Returns (chunk dict, each field (E, L, ...), info dict); `obs`
        (a host array with `compute_priorities`) and, for a recurrent
        policy, `rnn_c`/`rnn_h` are device tensors."""
        L, E = self.chunk_len, self.env.num_envs
        dev = self.device
        spec = self.env.spec
        late = self.compute_priorities
        static = self._static is not None
        obs_buf = (np.empty((E, L) + tuple(spec.obs_shape), spec.obs_dtype)
                   if late else None)
        act_buf = np.empty((E, L), np.int32)
        rew_buf = np.empty((E, L), np.float32)
        term_buf = np.empty((E, L), bool)
        done_buf = np.empty((E, L), bool)
        prio_buf = np.empty((E, L), np.float32) if late else None
        rnn_steps = []
        info = None
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
            if static:
                actions_np, q_sa, q_best, info = self._static_step(model, eps)
            else:
                explore_u, random_a, taus = self._draws(self.generator)
                actions, self.state, info = self._act_step(
                    model, self.state,
                    torch.from_numpy(np.ascontiguousarray(self.obs)).to(dev),
                    torch.from_numpy(self.done_prev).to(dev),
                    torch.from_numpy(eps).to(dev), None if late else emitted,
                    explore_u, random_a, taus)
                actions_np = actions.cpu().numpy()
                if late:
                    q_sa = info["q_sa"].cpu().numpy()
                    q_best = info["q_best"].cpu().numpy()
            if late and self._pending is not None:
                p = self._pending
                emit(p, np.abs(
                    p["reward"] + self.gamma
                    * (1.0 - p["done"].astype(np.float32))
                    * q_best - p["q_sa"]))
            obs_cur = self.obs
            next_obs, rew, term, trunc = self.env.step(actions_np)
            done = term | trunc
            tr = dict(action=actions_np, reward=rew, terminated=term,
                      done=done)
            if late:
                # a graph's outputs are overwritten by the next replay
                rnn = info.get("rnn")
                tr.update(obs=obs_cur, q_sa=q_sa, rnn=(
                    tuple(x.clone() for x in rnn)
                    if static and rnn is not None else rnn))
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
        # the last step's (after its replay, before the next)
        q_mean = float(info["q_mean"])
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
        return chunk, dict(env_steps=self.env_steps, q_mean=q_mean)

    def episode_stats(self, clear: bool = True):
        rets, lens = self.completed_returns, self.completed_lengths
        if clear:
            self.completed_returns, self.completed_lengths = [], []
        return rets, lens


class ActGraphShadow:
    """Holds every replay of an actor's act graph against its eager body:
    attached to a captured `Actor`, it runs `Actor.eager_body` after each
    replay, on the same static inputs, on clones of the state and the
    generator taken when it was attached (the checks on the card).
    `max_diff`: the largest abs difference of a step's outputs (the
    actions' bits, Q(s, a) and max_a Q where read back, q_mean, the
    stored carry); `state_diffs()` those of the carried tensors and the
    generator. `detach()` gives the actor its graph back."""

    def __init__(self, actor: Actor):
        if actor.graph is None or actor.graph.graph is None:
            raise RuntimeError("the actor has no captured act step")
        self.actor, self.graph = actor, actor.graph
        self.state = actor.state.clone()
        self.generator = torch.Generator(device=actor.device)
        self.generator.set_state(actor.generator.get_state())
        self.max_diff = 0.0
        self.steps = 0
        actor.graph = self

    def __getattr__(self, name):
        return getattr(self.graph, name)

    def __call__(self, *inputs):
        packed, info = self.graph(*inputs)
        want, want_info = self.actor.eager_body(self.state, self.generator,
                                                *inputs)
        pairs = [(packed.view(torch.int32), want.view(torch.int32)),
                 (info["q_mean"], want_info["q_mean"]),
                 *zip(info.get("rnn", ()), want_info.get("rnn", ()))]
        self.max_diff = max([self.max_diff] + [
            (a.double() - b.double()).abs().max().item() for a, b in pairs])
        self.steps += 1
        return packed, info

    def state_diffs(self) -> Dict[str, float]:
        mine = self.actor.state.tensors()
        out = {k: (v.double() - mine[k].double()).abs().max().item()
               for k, v in self.state.tensors().items()}
        out["generator"] = float(not torch.equal(
            self.generator.get_state(), self.actor.generator.get_state()))
        return out

    def detach(self) -> None:
        self.actor.graph = self.graph
