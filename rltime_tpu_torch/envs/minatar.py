"""MinAtar-style device-resident games: image-obs RL fully on the device.

Port of `rltime_tpu/envs/minatar.py` (the published MinAtar dynamics,
Young & Tian 2019, arXiv:1903.03176, as vectorized tensor ops): the
image pipeline (CNN torso, replay, PER, IQN/R2D2) trains with no host
involvement in the loop. Observations are (10, 10, C) binary planes,
uint8 NHWC, no frame stack (a trail channel carries one-step motion
memory). Sticky actions (p=0.1) follow the MinAtar evaluation protocol;
the time-limit truncation is a framework addition, reported through
`truncated` so targets bootstrap correctly across it.

Every game follows the `envs/device.py` contract: state is a dict of
(E, ...) tensors with the JAX dtypes, random draws enter `reset`/`step`
as a dict of named tensors. tests/test_torch_envs.py holds each game
bit-exact against the JAX one under the JAX side's own draws.

Breakout: paddle row 9, ball direction in {0: up-left, 1: up-right,
2: down-right, 3: down-left}, 3 brick rows that refill when cleared, a
strike flag preventing double-scoring, paddle edge-hit sideways
deflection. The JAX version's direction lookup tables are arithmetic
here: dx = +1 for d in {1, 2}, dy = +1 for d >= 2, a bounce off the top
or the paddle maps d to 3 - d, off a side wall to d xor 1, and an
edge-hit to (d + 2) mod 4.
"""
from __future__ import annotations

import numpy as np
import torch

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import EnvSpec
from rltime_tpu_torch.envs.device import (
    Draws, State, cell_plane, coin, full_i32, i32, pick,
)


def _breakout_fresh(side: torch.Tensor) -> State:
    """Initial lane state given per-lane ball side (bool, (E,))."""
    E, dev = side.shape[0], side.device
    brick = torch.zeros((E, 10, 10), dtype=torch.bool, device=dev)
    brick[:, 1:4, :] = True
    ball_x = i32(torch.where(side, 9, 0))
    return dict(
        ball_y=full_i32(E, 3, dev),
        ball_x=ball_x,
        ball_dir=i32(torch.where(side, 3, 2)),
        pos=full_i32(E, 4, dev),
        last_y=full_i32(E, 3, dev),
        last_x=ball_x.clone(),
        brick_map=brick,
        strike=torch.zeros((E,), dtype=torch.bool, device=dev),
        last_action=full_i32(E, 0, dev),
        steps=full_i32(E, 0, dev),
    )


class DeviceBreakout:
    """Vectorized MinAtar Breakout.

    Actions: 0 = no-op, 1 = left, 2 = right (the game's minimal set).
    Draws: reset `side` (E,) bool; step `stick` (E,) bool (only when
    sticky_prob > 0) and `side` (E,) bool for the auto-reset.
    """

    num_actions = 3
    obs_shape = (10, 10, 4)
    obs_dtype = np.uint8

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return dict(side=coin((num_envs,), 0.5, generator, device))

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        d = {}
        if self.sticky_prob > 0:
            d["stick"] = coin((num_envs,), self.sticky_prob, generator,
                              device)
        d["side"] = coin((num_envs,), 0.5, generator, device)
        return d

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        return _breakout_fresh(draws["side"].to(device))

    def observe(self, state: State) -> torch.Tensor:
        """(E, 10, 10, 4) uint8: paddle, ball, trail, bricks planes."""
        return torch.stack([
            cell_plane(9, state["pos"]),
            cell_plane(state["ball_y"], state["ball_x"]),
            cell_plane(state["last_y"], state["last_x"]),
            state["brick_map"]], dim=-1).to(torch.uint8)

    def step(self, state: State, actions: torch.Tensor, draws: Draws):
        """(state, reward (E,), terminated (E,), truncated (E,))."""
        E, dev = actions.shape[0], actions.device
        lanes = torch.arange(E, device=dev)
        cells = torch.arange(10, device=dev)

        a = i32(actions)
        if self.sticky_prob > 0:
            a = torch.where(draws["stick"], state["last_action"], a)
        pos = torch.clamp(state["pos"] - i32(a == 1) + i32(a == 2), 0, 9)

        # ball move
        last_y, last_x = state["ball_y"], state["ball_x"]
        d = state["ball_dir"]
        new_x = state["ball_x"] + i32(
            torch.where((d == 1) | (d == 2), 1, -1))
        new_y = state["ball_y"] + i32(torch.where(d >= 2, 1, -1))
        # side-wall bounce (x first, matching the scalar game's order)
        hit_wall = (new_x < 0) | (new_x > 9)
        new_x = torch.clamp(new_x, 0, 9)
        d = torch.where(hit_wall, d ^ 1, d)

        # mutually exclusive y outcomes (if/elif chain in the game)
        at_top = new_y < 0
        yc = torch.clamp(new_y, 0, 9)
        in_brick = (~at_top) & state["brick_map"][lanes, yc.long(),
                                                  new_x.long()]
        at_bottom = (~at_top) & (~in_brick) & (new_y == 9)

        # brick: score + clear + revert y only on a FRESH strike; an
        # already-striking ball passes through (published behavior)
        fresh_strike = in_brick & (~state["strike"])
        reward = fresh_strike.to(torch.float32)
        clear = fresh_strike[:, None, None] & (
            (cells[None, :, None] == yc[:, None, None])
            & (cells[None, None, :] == new_x[:, None, None]))
        brick_map = state["brick_map"] & (~clear)
        # bottom: refill if board cleared, then paddle checks
        empty = ~brick_map.flatten(1).any(dim=1)
        refill = (at_bottom & empty)[:, None, None] & (
            (cells >= 1) & (cells <= 3))[None, :, None]
        brick_map = brick_map | refill
        caught_flat = at_bottom & (state["ball_x"] == pos)   # full bounce
        caught_edge = at_bottom & (~caught_flat) & (new_x == pos)
        terminated = at_bottom & ~caught_flat & ~caught_edge

        bounce_y = at_top | fresh_strike | caught_flat
        new_d = torch.where(bounce_y, 3 - d,
                            torch.where(caught_edge, (d + 2) & 3, d))
        new_y = torch.where(at_top, 0,
                            torch.where(fresh_strike | caught_flat
                                        | caught_edge, last_y, new_y))

        steps = state["steps"] + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        # auto-reset finished lanes
        cur = dict(ball_y=new_y, ball_x=new_x, ball_dir=new_d, pos=pos,
                   last_y=last_y, last_x=last_x, brick_map=brick_map,
                   strike=in_brick, last_action=a, steps=steps)
        return (pick(done, _breakout_fresh(draws["side"]), cur), reward,
                terminated, truncated)


from rltime_tpu_torch.envs.minatar_games import (  # noqa: E402
    DeviceAsterix, DeviceFreeway, DeviceSpaceInvaders,
)
from rltime_tpu_torch.envs.minatar_seaquest import (  # noqa: E402
    DeviceSeaquest,
)

MINATAR_ENVS = {
    "breakout": DeviceBreakout,
    "asterix": DeviceAsterix,
    "freeway": DeviceFreeway,
    "space_invaders": DeviceSpaceInvaders,
    "seaquest": DeviceSeaquest,
}


def _register_handle(game: str, cls):
    """Config-registry handle {"type": "minatar_<game>", ...}; extra
    config keys (e.g. `ramping`, `time_limit`) pass to the game's
    constructor."""

    @register(f"minatar_{game}")
    class MinAtarHandle:
        is_device = True

        def __init__(self, num_envs: int, seed: int = 0, **kwargs):
            del seed  # draws come from the actor's generators
            self.num_envs = num_envs
            self.inner = cls(**kwargs)
            self.spec = EnvSpec(tuple(cls.obs_shape), np.uint8,
                                cls.num_actions)

        def close(self):
            pass

    return MinAtarHandle


for _game, _cls in MINATAR_ENVS.items():
    _register_handle(_game, _cls)
