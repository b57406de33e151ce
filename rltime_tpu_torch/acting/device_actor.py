"""On-device acting: policy + env dynamics + recording with no per-step
host I/O.

Port of `rltime_tpu/acting/device_actor.py`. For device-resident envs
(`envs/device.py`) a whole acting chunk is L steps of {recurrent reset
-> policy -> eps-greedy -> env.step -> record} on device tensors,
emitting the (E, L, ...) transition chunk where the replay insert
consumes it. The host only enqueues work: epsilon goes down once per
rollout as an (L, E) tensor, the argmax stays on the device, and nothing
is read back until `episode_stats`.

`make_rollout_core` is the ONE act-phase definition, shared by
`DeviceActor` (the host `Trainer`'s two-dispatch path) and the fused
superstep (`parallel/fused.py`); both start from
`init_device_actor_state`, so the two paths agree bit for bit.

Randomness: the state carries generators where the JAX state carries
keys: one for the env's draws, one for the actor's (explore uniforms,
random actions, IQN acting taus) and one for the IQN taus of the extra
post-chunk forward that actor-side priorities need. `rollout(...,
draws=...)` takes the same draws as tensors instead (tests).

The rollout updates the state IN PLACE: what a step rebinds (env state,
`done_prev`, the LSTM carry, running returns and lengths, the ring
cursor) is copied back into the state's own tensors at the end of the
chunk, so a CUDA graph that captured the rollout reads and writes the
same tensors on every replay (`parallel/fused.py`), and the eager
callers see the same state objects.

Episode bookkeeping stays on the device: completed returns land in a
fixed ring through a cumsum-offset scatter. Lanes that did not finish
write to a spare slot past the ring's end (what JAX's `mode="drop"`
does), so the scatter needs no boolean mask and no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rltime_tpu_torch.models.policy import (
    ModelConfig, QPolicy, RnnState, initial_rnn_state, q_values,
)
from rltime_tpu_torch.utils.prng import make_generator

STATS_RING = 256  # last-K completed episode returns kept on the device


@dataclasses.dataclass
class DeviceActorState:
    """Mutated in place by the rollout."""
    env_state: Dict[str, torch.Tensor]  # obs derives from it (env.observe)
    done_prev: torch.Tensor             # (E,) bool
    rnn: Optional[RnnState]             # LSTM carry (c, h), or None
    ep_ret: torch.Tensor                # (E,) f32 running returns
    ep_len: torch.Tensor                # (E,) int32 running lengths
    ret_ring: torch.Tensor              # (STATS_RING + 1,) f32, last = spill
    len_ring: torch.Tensor              # (STATS_RING + 1,) f32, last = spill
    ring_cursor: torch.Tensor           # () int32: completions ever
    env_generator: torch.Generator      # the env's reset/step draws
    generator: torch.Generator          # the actor's draws
    final_generator: torch.Generator    # IQN taus of the post-chunk
                                        # forward (actor-side priorities)

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit-identically."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["rnn"] = list(self.rnn) if self.rnn is not None else None
        for name in _GENERATORS:
            d[name] = getattr(self, name).get_state()
        return d

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        for name, cur in self.env_state.items():
            cur.copy_(d["env_state"][name])
        for name in _TENSORS:
            getattr(self, name).copy_(d[name])
        if self.rnn is not None:
            for cur, saved in zip(self.rnn, d["rnn"]):
                cur.copy_(saved)
        for name in _GENERATORS:
            getattr(self, name).set_state(d[name])

    def clone(self) -> "DeviceActorState":
        """An independent copy: the tensors cloned, the generators new
        ones at the same states."""
        def gen(g):
            out = torch.Generator(device=g.device)
            out.set_state(g.get_state())
            return out

        return DeviceActorState(
            env_state={k: v.clone() for k, v in self.env_state.items()},
            rnn=None if self.rnn is None else tuple(
                x.clone() for x in self.rnn),
            **{name: getattr(self, name).clone() for name in _TENSORS},
            **{name: gen(getattr(self, name)) for name in _GENERATORS})

    def generators(self):
        """Every generator the rollout draws from."""
        return [getattr(self, name) for name in _GENERATORS]


_TENSORS = ("done_prev", "ep_ret", "ep_len", "ret_ring", "len_ring",
            "ring_cursor")
# what a rollout step rebinds, and is copied back at the end of a chunk
_CARRY = ("env_state", "done_prev", "rnn", "ep_ret", "ep_len", "ring_cursor")
_GENERATORS = ("env_generator", "generator", "final_generator")


def init_device_actor_state(env, cfg: ModelConfig, num_envs: int, seed: int,
                            device: torch.device,
                            reset_draws=None) -> DeviceActorState:
    """Fresh envs and zeroed bookkeeping. `seed` names the generators
    (the env's first, as the JAX version splits its key); `reset_draws`
    injects the env's reset draws instead."""
    env_gen = make_generator(seed, "env", device)
    if reset_draws is None:
        reset_draws = env.reset_draws(num_envs, env_gen, device)
    E = num_envs
    return DeviceActorState(
        env_state=env.reset(E, reset_draws, device),
        done_prev=torch.ones((E,), dtype=torch.bool, device=device),
        rnn=initial_rnn_state(cfg, E, device),
        ep_ret=torch.zeros((E,), dtype=torch.float32, device=device),
        ep_len=torch.zeros((E,), dtype=torch.int32, device=device),
        ret_ring=torch.zeros((STATS_RING + 1,), device=device),
        len_ring=torch.zeros((STATS_RING + 1,), device=device),
        ring_cursor=torch.zeros((), dtype=torch.int32, device=device),
        env_generator=env_gen,
        generator=make_generator(seed, "act", device),
        final_generator=make_generator(seed, "final_qbest", device))


def act_draws(cfg: ModelConfig, num_envs: int, generator: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """One step's actor draws: `explore_u` (E,) uniforms (a lane explores
    iff u < eps), `random_a` (E,) int32 actions and, for IQN, the acting
    `taus` (E, num_tau_policy)."""
    d = dict(
        explore_u=torch.rand((num_envs,), generator=generator, device=device),
        random_a=torch.randint(0, cfg.num_actions, (num_envs,),
                               generator=generator, device=device,
                               dtype=torch.int32))
    if cfg.is_iqn:
        d["taus"] = torch.rand((num_envs, cfg.num_tau_policy),
                               generator=generator, device=device)
    return d


def eps_schedule(exploration, num_envs: int, env_steps: int, num_steps: int,
                 device: torch.device, lanes: slice = slice(None)
                 ) -> torch.Tensor:
    """(num_steps, E) epsilons for the next `num_steps` lockstep act
    steps, computed on the host and sent down in ONE copy (pinned and
    asynchronous on a card, so the dispatch does not wait for it).
    `num_envs` counts every lane of the schedule (all ranks' on a mesh);
    `lanes` picks this rank's columns of it."""
    eps = torch.from_numpy(np.ascontiguousarray(np.stack([
        exploration.epsilons(num_envs, env_steps + t * num_envs)
        for t in range(num_steps)])[:, lanes]))
    if device.type == "cuda":
        return eps.pin_memory().to(device, non_blocking=True)
    return eps


def make_rollout_core(env, cfg: ModelConfig, chunk_len: int,
                      compute_priorities: bool = False, gamma: float = 0.99):
    """Build rollout(model, state, eps (L, E), draws=None) ->
    (state, chunk) for a device env.

    `draws`: a list of L dicts {"act": act_draws(...), "env":
    env.step_draws(...)} replacing the generators' draws. The chunk's
    fields are (E, L, ...): obs, action int32, reward f32, terminated,
    done and, for a recurrent policy, the carry each step CONSUMED
    (after the `done_prev` reset) as rnn_c/rnn_h.

    With `compute_priorities` the chunk carries a "priority" field: the
    Ape-X actor-side 1-step TD estimate |r_t + gamma*(1-done_t)*
    max_a Q(s_{t+1}) - Q(s_t, a_t)|, from the values each step computed
    anyway; only the last column needs one extra forward on the
    post-chunk observation. The IQN taus of that forward come from a
    generator DERIVED from the actor's, not from the actor's own, so the
    actor's stream is the same with and without priorities (a test
    injects them as an (L+1)-th `draws` entry {"taus": ...})."""
    L = chunk_len

    def body(model: QPolicy, state: DeviceActorState, eps: torch.Tensor,
             draws: Optional[Dict[str, Dict[str, torch.Tensor]]]):
        obs = env.observe(state.env_state)
        E, dev = obs.shape[0], obs.device
        if draws is None:
            draws = dict(act=act_draws(cfg, E, state.generator, dev),
                         env=env.step_draws(E, state.env_generator, dev))
        act = draws["act"]
        rnn = state.rnn
        if cfg.recurrent:
            m = (1.0 - state.done_prev.to(torch.float32))[:, None]
            rnn = (rnn[0] * m, rnn[1] * m)
        stored_rnn = rnn
        out = model(obs, rnn, act.get("taus"))
        q, rnn = out if cfg.recurrent else (out, None)
        qv = q_values(cfg, q)
        greedy = torch.argmax(qv, dim=-1).to(torch.int32)
        actions = torch.where(act["explore_u"] < eps,
                              act["random_a"].to(torch.int32), greedy)

        env_state, rew, term, trunc = env.step(state.env_state, actions,
                                               draws["env"])
        done = term | trunc

        ep_ret = state.ep_ret + rew
        ep_len = state.ep_len + 1
        # completed episodes -> stat rings (scatter via cumsum offsets;
        # lanes still running write the spill slot STATS_RING)
        offs = torch.cumsum(done.to(torch.int32), dim=0, dtype=torch.int32)
        idx = torch.where(
            done, torch.remainder(state.ring_cursor + offs - 1, STATS_RING),
            STATS_RING).long()
        state.ret_ring[idx] = ep_ret
        state.len_ring[idx] = ep_len.to(torch.float32)
        state.ring_cursor = state.ring_cursor + offs[-1]
        state.ep_ret = torch.where(done, 0.0, ep_ret)
        state.ep_len = torch.where(done, 0, ep_len)
        state.env_state, state.done_prev, state.rnn = env_state, done, rnn

        rec = dict(obs=obs, action=actions, reward=rew, terminated=term,
                   done=done)
        if compute_priorities:
            rec["q_sa"] = torch.gather(qv, -1, actions.long()[:, None])[:, 0]
            rec["q_best"] = torch.max(qv, dim=-1).values
        if cfg.recurrent:
            rec["rnn_c"], rec["rnn_h"] = stored_rnn
        return rec

    def final_qbest(model: QPolicy, state: DeviceActorState,
                    taus: Optional[torch.Tensor]):
        """max_a Q of the post-chunk observation, (E,)."""
        obs = env.observe(state.env_state)
        rnn = state.rnn
        if cfg.recurrent:
            m = (1.0 - state.done_prev.to(torch.float32))[:, None]
            rnn = (rnn[0] * m, rnn[1] * m)
        if cfg.is_iqn and taus is None:
            taus = torch.rand(
                (obs.shape[0], cfg.num_tau_policy), device=obs.device,
                generator=state.final_generator)
        out = model(obs, rnn, taus)
        q = out[0] if cfg.recurrent else out
        return torch.max(q_values(cfg, q), dim=-1).values

    @torch.no_grad()
    def rollout(model: QPolicy, state: DeviceActorState, eps: torch.Tensor,
                draws: Optional[List[Dict]] = None):
        own = {name: getattr(state, name) for name in _CARRY}
        recs = [body(model, state, eps[i], draws[i] if draws else None)
                for i in range(L)]
        chunk = {k: torch.stack([r[k] for r in recs], dim=1)
                 for k in recs[0]}
        if compute_priorities:
            q_sa, q_best = chunk.pop("q_sa"), chunk.pop("q_best")   # (E, L)
            q_last = final_qbest(
                model, state,
                draws[L].get("taus") if draws and len(draws) > L else None)
            q_next = torch.cat([q_best[:, 1:], q_last[:, None]], dim=1)
            # bootstrap masked by done (terminated OR truncated): at a
            # done step q_next is Q of the NEXT episode's reset obs, an
            # unrelated state, and the learner's own targets never
            # bootstrap through a done boundary either
            nondone = 1.0 - chunk["done"].to(torch.float32)
            chunk["priority"] = torch.abs(
                chunk["reward"] + gamma * nondone * q_next - q_sa)
        _write_back(state, own)
        return state, chunk

    return rollout


def _write_back(state: DeviceActorState, own: Dict[str, Any]) -> None:
    """Copy what the chunk's steps rebound into the tensors the state
    held before them (`own`), and rebind the state to those."""
    for name, mine in own.items():
        cur = getattr(state, name)
        if isinstance(mine, dict):
            for k, x in mine.items():
                x.copy_(cur[k])
        elif isinstance(mine, tuple):
            for x, c in zip(mine, cur):
                x.copy_(c)
        elif mine is not None:
            mine.copy_(cur)
        setattr(state, name, mine)


def pop_episode_stats(state: DeviceActorState, popped: int):
    """Completed (returns, lengths) since the `popped`-th completion,
    OLDEST FIRST, and the new pop cursor. Reads the device (a sync)."""
    cursor = int(state.ring_cursor)
    fresh = min(cursor - popped, STATS_RING)
    if fresh <= 0:
        return [], [], cursor
    ring_r = state.ret_ring.cpu().numpy()
    ring_l = state.len_ring.cpu().numpy()
    idxs = [(cursor - fresh + i) % STATS_RING for i in range(fresh)]
    return ([float(ring_r[i]) for i in idxs],
            [float(ring_l[i]) for i in idxs], cursor)


class DeviceActor:
    """Actor-interface adapter over the device rollout (what the host
    `Trainer` drives when the env handle has `is_device`)."""

    def __init__(self, env, num_envs: int, cfg: ModelConfig, exploration,
                 seed: int, chunk_len: int, device: torch.device,
                 reset_draws=None, compute_priorities: bool = False,
                 gamma: float = 0.99):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.exploration = exploration
        self.chunk_len = chunk_len
        self.device = device
        self.state = init_device_actor_state(env, cfg, num_envs, seed,
                                             device, reset_draws)
        self._rollout = make_rollout_core(env, cfg, chunk_len,
                                          compute_priorities, gamma)
        self.env_steps = 0
        self._stats_popped = 0

    def rollout(self, model: QPolicy, draws=None):
        eps = eps_schedule(self.exploration, self.num_envs, self.env_steps,
                           self.chunk_len, self.device)
        self.state, chunk = self._rollout(model, self.state, eps, draws)
        self.env_steps += self.chunk_len * self.num_envs
        return chunk, dict(env_steps=self.env_steps)

    def episode_stats(self, clear: bool = True):
        """Fresh completed (returns, lengths), oldest first (the host
        Actor's append order)."""
        rets, lens, cursor = pop_episode_stats(self.state,
                                               self._stats_popped)
        if clear:
            self._stats_popped = cursor
        return rets, lens

