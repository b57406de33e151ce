"""Device-resident environments: dynamics as tensor ops, zero host I/O.

Port of `rltime_tpu/envs/device.py`. A device env is a set of pure
functions over a batch of E lanes whose state lives on the device as a
dict of tensors, so a whole acting chunk runs without the host seeing
an observation or an action (`acting/device_actor.py`).

Randomness is an explicit input. Where the JAX envs split a key that
rides in the state, every env here has

    reset(num_envs, draws, device)         -> state
    step(state, actions, draws)            -> (state, reward, term, trunc)
    reset_draws(num_envs, generator, device) / step_draws(...)  -> draws

with `draws` a small dict of named tensors: the comparisons already
made (`bernoulli(k, p)` crosses as the bool `uniform < p`), the integers
already drawn. The `*_draws` functions fill it from a `torch.Generator`
on the device; tests fill it with the JAX side's own draws. After that
point both routes are the same code.

State dtypes are the JAX ones (int32, bool, float32). `DeviceCartPole`
reproduces gymnasium CartPole-v1 (same Euler integration and constants)
with auto-reset and time-limit truncation.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import EnvSpec

State = Dict[str, torch.Tensor]
Draws = Dict[str, torch.Tensor]

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * math.pi / 360
X_THRESHOLD = 2.4


def coin(shape, p: float, generator: torch.Generator, device) -> torch.Tensor:
    """Bernoulli(p) as `uniform < p` (what `jax.random.bernoulli` is)."""
    return torch.rand(shape, generator=generator, device=device) < p


def randint(low: int, high: int, shape, generator: torch.Generator,
            device) -> torch.Tensor:
    """int32 draws in [low, high)."""
    return torch.randint(low, high, shape, generator=generator,
                         device=device, dtype=torch.int32)


def i32(x: torch.Tensor) -> torch.Tensor:
    """Cast to the state's integer dtype (a where() of two Python ints
    and a sum over bools come out int64)."""
    return x.to(torch.int32)


def full_i32(num_envs: int, value: int, device) -> torch.Tensor:
    return torch.full((num_envs,), value, dtype=torch.int32, device=device)


def cell_plane(y, x) -> torch.Tensor:
    """(E, 10, 10) bool plane with cell (y[e], x[e]) set per lane; `y`
    and `x` are (E,) tensors or, one of them, a fixed int. Built from
    comparisons: a scatter of a Python scalar through index tensors
    would make the host wait for the device."""
    ref = y if isinstance(y, torch.Tensor) else x
    cells = torch.arange(10, device=ref.device)

    def axis(v, shape):
        if isinstance(v, torch.Tensor):
            return cells.reshape(shape) == v[:, None, None]
        return (cells == v).reshape(shape)

    return axis(y, (1, 10, 1)) & axis(x, (1, 1, 10))


def pick(done: torch.Tensor, fresh: State, cur: State) -> State:
    """Per lane: the fresh (reset) value where `done`, else the current."""
    out = {}
    for name, c in cur.items():
        m = done.reshape((-1,) + (1,) * (c.ndim - 1))
        out[name] = torch.where(m, fresh[name], c)
    return out


class DeviceCartPole:
    """CartPole batch; state: s (E, 4) float32, steps (E,) int32."""

    num_actions = 2
    obs_shape = (4,)
    obs_dtype = np.float32

    def __init__(self, time_limit: int = 500):
        self.time_limit = time_limit

    @staticmethod
    def _start(num_envs: int, generator, device) -> torch.Tensor:
        return torch.rand((num_envs, 4), generator=generator,
                          device=device) * 0.1 - 0.05

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return dict(s=self._start(num_envs, generator, device))

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        return dict(fresh=self._start(num_envs, generator, device))

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        return dict(s=draws["s"].to(device),
                    steps=full_i32(num_envs, 0, device))

    def observe(self, state: State) -> torch.Tensor:
        return state["s"]

    def step(self, state: State, actions: torch.Tensor, draws: Draws
             ) -> Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor]:
        x, x_dot, th, th_dot = state["s"].unbind(dim=1)
        force = torch.where(actions == 1, FORCE_MAG, -FORCE_MAG)
        cos, sin = torch.cos(th), torch.sin(th)
        temp = (force + POLEMASS_LENGTH * th_dot ** 2 * sin) / TOTAL_MASS
        th_acc = (GRAVITY * sin - cos * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * cos ** 2 / TOTAL_MASS))
        x_acc = temp - POLEMASS_LENGTH * th_acc * cos / TOTAL_MASS
        x = x + TAU * x_dot
        x_dot = x_dot + TAU * x_acc
        th = th + TAU * th_dot
        th_dot = th_dot + TAU * th_acc
        s = torch.stack([x, x_dot, th, th_dot], dim=1)
        steps = state["steps"] + 1

        terminated = ((torch.abs(x) > X_THRESHOLD)
                      | (torch.abs(th) > THETA_THRESHOLD))
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated
        reward = torch.ones_like(x)

        # auto-reset finished lanes
        new_state = pick(done, dict(s=draws["fresh"],
                                    steps=torch.zeros_like(steps)),
                         dict(s=s, steps=steps))
        return new_state, reward, terminated, truncated


DEVICE_ENVS = {"cartpole": DeviceCartPole}


def make_device_env(name: str, **kwargs):
    try:
        return DEVICE_ENVS[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown device env {name!r}; "
                       f"available: {sorted(DEVICE_ENVS)}") from None


@register("cartpole_device")
class CartPoleDeviceHandle:
    """Config-registry handle: {"type": "cartpole_device", ...}."""
    is_device = True

    def __init__(self, num_envs: int, time_limit: int = 500, seed: int = 0):
        del seed  # draws come from the actor's generators
        self.num_envs = num_envs
        self.inner = DeviceCartPole(time_limit)
        self.spec = EnvSpec((4,), np.float32, 2)

    def close(self):
        pass
