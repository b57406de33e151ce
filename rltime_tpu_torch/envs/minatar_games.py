"""MinAtar-style device-resident games: Asterix, Freeway, Space Invaders.

Port of `rltime_tpu/envs/minatar_games.py`; companions to
`envs/minatar.py`'s DeviceBreakout (see that module for the shared
conventions and `envs/device.py` for the state/draws contract).

  * obs: (10, 10, C) binary planes, uint8 NHWC; no frame stack.
  * sticky actions (p=0.1); every game's step takes a `stick` (E,) bool
    draw when sticky_prob > 0.
  * lanes auto-reset on done; time-limit lanes report `truncated`
    EXCEPT Freeway, whose 2500-step limit is part of the published game
    and therefore reports `terminated`.
  * minimal action sets (Asterix 5: n/l/u/r/d; Freeway 3: n/u/d; Space
    Invaders 4: n/l/r/f).
"""
from __future__ import annotations

import numpy as np
import torch

from rltime_tpu_torch.envs.device import (
    Draws, State, cell_plane, coin, full_i32, i32, pick, randint,
)


def _sticky(sticky_prob: float, actions: torch.Tensor, state: State,
            draws: Draws) -> torch.Tensor:
    a = i32(actions)
    if sticky_prob > 0:
        a = torch.where(draws["stick"], state["last_action"], a)
    return a


def _stick_draw(sticky_prob: float, num_envs: int, generator,
                device) -> Draws:
    if sticky_prob > 0:
        return dict(stick=coin((num_envs,), sticky_prob, generator, device))
    return {}


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Asterix
# ---------------------------------------------------------------------------

def _asterix_fresh(E: int, ramp_interval: int, dev) -> State:
    return dict(
        px=full_i32(E, 5, dev), py=full_i32(E, 5, dev),
        ent_x=_zeros((E, 8), torch.int32, dev),
        ent_lr=_zeros((E, 8), torch.bool, dev),
        ent_gold=_zeros((E, 8), torch.bool, dev),
        ent_alive=_zeros((E, 8), torch.bool, dev),
        spawn_speed=full_i32(E, 10, dev), spawn_timer=full_i32(E, 10, dev),
        move_speed=full_i32(E, 5, dev), move_timer=full_i32(E, 5, dev),
        ramp_timer=full_i32(E, ramp_interval, dev),
        ramp_index=full_i32(E, 0, dev),
        last_action=full_i32(E, 0, dev), steps=full_i32(E, 0, dev),
    )


class DeviceAsterix:
    """Vectorized MinAtar-style Asterix.

    Actions: 0 no-op, 1 left, 2 up, 3 right, 4 down. Collect gold (+1),
    dodge enemies (terminal). Spawn/move intervals ramp down every 100
    steps (`ramping=True`, the published default). Channels: player,
    enemy, trail, gold. Slot i lives on row i + 1.

    Step draws: `stick`; `slot_u` (E, 8) float32 uniforms (the spawn
    slot is the free slot with the largest one); `lr` (E,) bool (moving
    right); `gold` (E,) bool (`uniform < 1/3`). The state's `dbg_*`
    fields hold the spawn decision taken this step, as the JAX state's
    do.
    """

    num_actions = 5
    obs_shape = (10, 10, 4)
    obs_dtype = np.uint8

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000,
                 ramping: bool = True, ramp_interval: int = 100):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit
        self.ramping = ramping
        self.ramp_interval = ramp_interval

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return {}

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        E = num_envs
        d = _stick_draw(self.sticky_prob, E, generator, device)
        d["slot_u"] = torch.rand((E, 8), generator=generator, device=device)
        d["lr"] = coin((E,), 0.5, generator, device)
        d["gold"] = coin((E,), 1.0 / 3.0, generator, device)
        return d

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        E = num_envs
        return dict(dbg_spawned=_zeros((E,), torch.bool, device),
                    dbg_slot=full_i32(E, 0, device),
                    dbg_lr=_zeros((E,), torch.bool, device),
                    dbg_gold=_zeros((E,), torch.bool, device),
                    **_asterix_fresh(E, self.ramp_interval, device))

    def observe(self, state: State) -> torch.Tensor:
        E, dev = state["px"].shape[0], state["px"].device
        cols = torch.arange(10, device=dev)
        ent_x, ent_gold = state["ent_x"], state["ent_gold"][:, :, None]
        onehot = ent_x[:, :, None] == cols[None, None, :]        # (E, 8, 10)
        alive = state["ent_alive"][:, :, None]
        enemy = onehot & alive & ~ent_gold
        gold = onehot & alive & ent_gold
        back_x = torch.where(state["ent_lr"], ent_x - 1, ent_x + 1)
        tr_ok = alive & ((back_x >= 0) & (back_x <= 9))[:, :, None]
        trail = (back_x[:, :, None] == cols[None, None, :]) & tr_ok

        obs = torch.zeros((E, 10, 10, 4), dtype=torch.uint8, device=dev)
        obs[:, :, :, 0] = cell_plane(state["py"], state["px"])
        obs[:, 1:9, :, 1] = enemy.to(torch.uint8)
        obs[:, 1:9, :, 2] = trail.to(torch.uint8)
        obs[:, 1:9, :, 3] = gold.to(torch.uint8)
        return obs

    def step(self, state: State, actions: torch.Tensor, draws: Draws):
        E, dev = actions.shape[0], actions.device
        a = _sticky(self.sticky_prob, actions, state, draws)

        # 1) spawn if timer expired and a slot is free (uniform slot,
        #    side ~ U{L,R}, gold with p=1/3: published parameters)
        free = ~state["ent_alive"]                              # (E, 8)
        do_spawn = (state["spawn_timer"] == 0) & free.any(dim=1)
        slot = i32(torch.argmax(torch.where(free, draws["slot_u"], -1.0),
                                dim=1))
        lr, gold = draws["lr"], draws["gold"]
        sx = i32(torch.where(lr, 0, 9))
        sl1 = ((torch.arange(8, device=dev)[None, :] == slot[:, None])
               & do_spawn[:, None])
        ent_x = torch.where(sl1, sx[:, None], state["ent_x"])
        ent_lr = torch.where(sl1, lr[:, None], state["ent_lr"])
        ent_gold = torch.where(sl1, gold[:, None], state["ent_gold"])
        ent_alive = state["ent_alive"] | sl1
        spawn_timer = torch.where(state["spawn_timer"] == 0,
                                  state["spawn_speed"], state["spawn_timer"])

        # 2) player movement (y clamped to the entity band [1, 8])
        px = torch.clamp(state["px"] - i32(a == 1) + i32(a == 3), 0, 9)
        py = torch.clamp(state["py"] - i32(a == 2) + i32(a == 4), 1, 8)

        # 3) collision pass over slots (only slot py-1 can match)
        rows = torch.arange(1, 9, dtype=torch.int32, device=dev)

        def collide(ent_x, ent_alive):
            hit = (ent_alive & (ent_x == px[:, None])
                   & (rows[None, :] == py[:, None]))
            got_gold = hit & ent_gold
            died = (hit & ~ent_gold).any(dim=1)
            r = got_gold.sum(dim=1).to(torch.float32)
            return ent_alive & ~got_gold, r, died

        ent_alive, r1, died1 = collide(ent_x, ent_alive)

        # 4) entity movement on move_timer expiry (+ second collision)
        do_move = state["move_timer"] == 0
        moved_x = ent_x + i32(torch.where(ent_lr, 1, -1))
        ent_x = torch.where(do_move[:, None], moved_x, ent_x)
        oob = (ent_x < 0) | (ent_x > 9)
        ent_alive = ent_alive & ~(oob & do_move[:, None])
        alive2, r2, died2 = collide(ent_x, ent_alive)
        ent_alive = torch.where(do_move[:, None], alive2, ent_alive)
        r2 = torch.where(do_move, r2, 0.0)
        died2 = died2 & do_move
        move_timer = torch.where(do_move, state["move_speed"],
                                 state["move_timer"])

        reward = r1 + r2
        terminated = died1 | died2

        # 5) timer decrements (unconditional, including the step the
        #    timer was just reset)
        spawn_timer = spawn_timer - 1
        move_timer = move_timer - 1

        # 6) difficulty ramp every ramp_interval steps: spawn interval
        #    shrinks each ramp, move interval every other ramp
        spawn_speed, move_speed = state["spawn_speed"], state["move_speed"]
        ramp_timer, ramp_index = state["ramp_timer"], state["ramp_index"]
        if self.ramping:
            can_ramp = (spawn_speed > 1) | (move_speed > 1)
            tick = can_ramp & (ramp_timer >= 0)
            fire = can_ramp & (ramp_timer < 0)
            move_speed = torch.where(
                fire & (move_speed > 1)
                & (torch.remainder(ramp_index, 2) == 1),
                move_speed - 1, move_speed)
            spawn_speed = torch.where(fire & (spawn_speed > 1),
                                      spawn_speed - 1, spawn_speed)
            ramp_index = ramp_index + i32(fire)
            ramp_timer = torch.where(fire, self.ramp_interval,
                                     ramp_timer - i32(tick))

        steps = state["steps"] + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        cur = dict(px=px, py=py, ent_x=ent_x, ent_lr=ent_lr,
                   ent_gold=ent_gold, ent_alive=ent_alive,
                   spawn_speed=spawn_speed, spawn_timer=spawn_timer,
                   move_speed=move_speed, move_timer=move_timer,
                   ramp_timer=ramp_timer, ramp_index=ramp_index,
                   last_action=a, steps=steps)
        new_state = dict(
            dbg_spawned=do_spawn, dbg_slot=slot, dbg_lr=lr, dbg_gold=gold,
            **pick(done, _asterix_fresh(E, self.ramp_interval, dev), cur))
        return new_state, reward, terminated, truncated


# ---------------------------------------------------------------------------
# Freeway
# ---------------------------------------------------------------------------

def _freeway_car_draws(num_envs: int, generator, device, prefix: str
                       ) -> Draws:
    return {f"{prefix}_speed": randint(1, 6, (num_envs, 8), generator,
                                       device),
            f"{prefix}_sign": coin((num_envs, 8), 0.5, generator, device)}


def _freeway_cars(draws: Draws, prefix: str) -> State:
    """Fresh cars from `<prefix>_speed` (E, 8) int32 in [1, 6) and
    `<prefix>_sign` (E, 8) bool (True = moving right)."""
    speed = i32(draws[f"{prefix}_speed"])
    speed = torch.where(draws[f"{prefix}_sign"], speed, -speed)
    return dict(car_x=torch.zeros_like(speed), car_timer=torch.abs(speed),
                car_speed=speed)


class DeviceFreeway:
    """Vectorized MinAtar-style Freeway.

    Actions: 0 no-op, 1 up, 2 down. +1 for crossing (cars then
    re-randomized, chicken back to start); a car hit knocks the chicken
    back to the start row. The fixed 2500-step episode end is part of
    the published game and reported as TERMINATED. Channels: chicken,
    car, speed1..speed5 (the trail cell encodes the car's period).

    Draws: reset `cars_speed`/`cars_sign` (E, 8); step `stick`,
    `cars_speed`/`cars_sign` (after a crossing) and `reset_speed`/
    `reset_sign` (the auto-reset).
    """

    num_actions = 3
    obs_shape = (10, 10, 7)
    obs_dtype = np.uint8
    PLAYER_SPEED = 3

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2500):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return _freeway_car_draws(num_envs, generator, device, "cars")

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        d = _stick_draw(self.sticky_prob, num_envs, generator, device)
        d.update(_freeway_car_draws(num_envs, generator, device, "cars"))
        d.update(_freeway_car_draws(num_envs, generator, device, "reset"))
        return d

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        E = num_envs
        draws = {k: v.to(device) for k, v in draws.items()}
        return dict(pos=full_i32(E, 9, device),
                    move_timer=full_i32(E, self.PLAYER_SPEED, device),
                    last_action=full_i32(E, 0, device),
                    steps=full_i32(E, 0, device),
                    **_freeway_cars(draws, "cars"))

    def observe(self, state: State) -> torch.Tensor:
        E, dev = state["pos"].shape[0], state["pos"].device
        cols = torch.arange(10, device=dev)
        car_x, car_speed = state["car_x"], state["car_speed"]
        car = car_x[:, :, None] == cols[None, None, :]          # (E, 8, 10)
        back_x = torch.where(car_speed > 0, car_x - 1, car_x + 1)
        back_x = torch.remainder(back_x, 10)      # wraps at both edges
        period = torch.abs(car_speed)             # (E, 8) in [1, 5]
        # trail plane per period channel: (E, 8, 10, 5)
        trail = ((back_x[:, :, None] == cols[None, None, :])[..., None]
                 & (period[:, :, None, None]
                    == torch.arange(1, 6, device=dev)))

        obs = torch.zeros((E, 10, 10, 7), dtype=torch.uint8, device=dev)
        obs[:, :, :, 0] = cell_plane(state["pos"], 4)
        obs[:, 1:9, :, 1] = car.to(torch.uint8)
        obs[:, 1:9, :, 2:7] = trail.to(torch.uint8)
        return obs

    def step(self, state: State, actions: torch.Tensor, draws: Draws):
        dev = actions.device
        a = _sticky(self.sticky_prob, actions, state, draws)

        # player move on cooldown expiry
        can = (state["move_timer"] == 0) & (a != 0)
        pos = torch.where(can & (a == 1),
                          torch.clamp(state["pos"] - 1, min=0), state["pos"])
        pos = torch.where(can & (a == 2),
                          torch.clamp(state["pos"] + 1, max=9), pos)
        move_timer = torch.where(can, self.PLAYER_SPEED, state["move_timer"])

        # crossing: +1, re-randomize cars, restart at the bottom
        scored = pos == 0
        reward = scored.to(torch.float32)
        rand = _freeway_cars(draws, "cars")
        car_x = torch.where(scored[:, None], rand["car_x"], state["car_x"])
        car_timer = torch.where(scored[:, None], rand["car_timer"],
                                state["car_timer"])
        car_speed = torch.where(scored[:, None], rand["car_speed"],
                                state["car_speed"])
        pos = torch.where(scored, 9, pos)

        # car updates: hit check, then move-on-timer + second hit check.
        # Cars occupy distinct rows, so per-row checks are independent
        # (a hit sets pos=9, where no car row lives).
        rows = torch.arange(1, 9, dtype=torch.int32, device=dev)
        hit1 = (car_x == 4) & (rows[None, :] == pos[:, None])
        pos = torch.where(hit1.any(dim=1), 9, pos)
        do_move = car_timer == 0
        moved = car_x + i32(torch.where(car_speed > 0, 1, -1))
        moved = torch.remainder(moved, 10)        # wraps at both edges
        car_x = torch.where(do_move, moved, car_x)
        car_timer = torch.where(do_move, torch.abs(car_speed), car_timer - 1)
        hit2 = do_move & (car_x == 4) & (rows[None, :] == pos[:, None])
        pos = torch.where(hit2.any(dim=1), 9, pos)

        move_timer = torch.clamp(move_timer - 1, min=0)
        steps = state["steps"] + 1
        # the fixed episode length is the published game's own end
        terminated = steps >= self.time_limit
        truncated = torch.zeros_like(terminated)

        fresh = dict(pos=torch.full_like(pos, 9),
                     move_timer=torch.full_like(pos, self.PLAYER_SPEED),
                     last_action=torch.zeros_like(a),
                     steps=torch.zeros_like(steps),
                     **_freeway_cars(draws, "reset"))
        cur = dict(pos=pos, move_timer=move_timer, car_x=car_x,
                   car_timer=car_timer, car_speed=car_speed, last_action=a,
                   steps=steps)
        return pick(terminated, fresh, cur), reward, terminated, truncated


# ---------------------------------------------------------------------------
# Space Invaders
# ---------------------------------------------------------------------------

def _si_wave(E: int, dev) -> torch.Tensor:
    """Fresh 4x6 alien block on rows 0-3, cols 2-7."""
    a = _zeros((E, 10, 10), torch.bool, dev)
    a[:, 0:4, 2:8] = True
    return a


def _si_fresh(E: int, dev) -> State:
    return dict(
        pos=full_i32(E, 5, dev),
        f_bullets=_zeros((E, 10, 10), torch.bool, dev),
        e_bullets=_zeros((E, 10, 10), torch.bool, dev),
        aliens=_si_wave(E, dev),
        alien_dir=full_i32(E, -1, dev),
        enemy_move_interval=full_i32(E, 12, dev),
        alien_move_timer=full_i32(E, 12, dev),
        alien_shot_timer=full_i32(E, 10, dev),
        shot_timer=full_i32(E, 0, dev),
        last_action=full_i32(E, 0, dev),
        steps=full_i32(E, 0, dev),
    )


class DeviceSpaceInvaders:
    """Vectorized MinAtar-style Space Invaders.

    Actions: 0 no-op, 1 left, 2 right, 3 fire. Shoot the marching alien
    block (+1 per kill); terminal when an alien bullet or the block
    reaches the cannon. The block speeds up as it thins (move timer =
    min(#aliens, interval)) and each cleared wave ramps the interval
    down (`ramping=True`, published default). The game itself is
    deterministic: the only draw is `stick`. Channels: cannon, alien,
    alien_left, alien_right, friendly_bullet, enemy_bullet.
    """

    num_actions = 4
    obs_shape = (10, 10, 6)
    obs_dtype = np.uint8
    SHOT_COOL_DOWN = 5
    ENEMY_SHOT_INTERVAL = 10

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000,
                 ramping: bool = True):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit
        self.ramping = ramping

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return {}

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        return _stick_draw(self.sticky_prob, num_envs, generator, device)

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        return _si_fresh(num_envs, device)

    def observe(self, state: State) -> torch.Tensor:
        E, dev = state["pos"].shape[0], state["pos"].device
        al = state["aliens"].to(torch.uint8)
        left = (state["alien_dir"] < 0)[:, None, None]
        obs = torch.zeros((E, 10, 10, 6), dtype=torch.uint8, device=dev)
        obs[:, :, :, 0] = cell_plane(9, state["pos"])
        obs[:, :, :, 1] = al
        obs[:, :, :, 2] = al * left
        obs[:, :, :, 3] = al * ~left
        obs[:, :, :, 4] = state["f_bullets"].to(torch.uint8)
        obs[:, :, :, 5] = state["e_bullets"].to(torch.uint8)
        return obs

    def step(self, state: State, actions: torch.Tensor, draws: Draws):
        E, dev = actions.shape[0], actions.device
        lanes = torch.arange(E, device=dev)
        a = _sticky(self.sticky_prob, actions, state, draws)

        # player: fire (on cooldown) or move
        fire = (a == 3) & (state["shot_timer"] == 0)
        p0 = state["pos"].long()
        f_bullets = state["f_bullets"].clone()
        f_bullets[lanes, 9, p0] = f_bullets[lanes, 9, p0] | fire
        shot_timer = torch.where(fire, self.SHOT_COOL_DOWN,
                                 state["shot_timer"])
        pos = torch.clamp(state["pos"] - i32(a == 1) + i32(a == 2), 0, 9)
        p1 = pos.long()

        # bullets march one row (friendly up, enemy down)
        f_bullets = torch.roll(f_bullets, -1, dims=1)
        f_bullets[:, 9, :] = False
        e_bullets = torch.roll(state["e_bullets"], 1, dims=1)
        e_bullets[:, 0, :] = False
        shot_down = e_bullets[lanes, 9, p1]

        # alien block march on timer expiry
        aliens, alien_dir = state["aliens"], state["alien_dir"]
        do_move = state["alien_move_timer"] == 0
        n_alive = i32(aliens.flatten(1).sum(dim=1))
        at_edge = ((aliens[:, :, 0].any(dim=1) & (alien_dir < 0))
                   | (aliens[:, :, 9].any(dim=1) & (alien_dir > 0)))
        drop = do_move & at_edge
        landed = drop & aliens[:, 9, :].any(dim=1)
        dropped = torch.roll(aliens, 1, dims=1)
        shifted = torch.where((alien_dir > 0)[:, None, None],
                              torch.roll(aliens, 1, dims=2),
                              torch.roll(aliens, -1, dims=2))
        aliens = torch.where(drop[:, None, None], dropped,
                             torch.where(do_move[:, None, None], shifted,
                                         aliens))
        alien_dir = torch.where(drop, -alien_dir, alien_dir)
        alien_move_timer = torch.where(
            do_move, torch.minimum(n_alive, state["enemy_move_interval"]),
            state["alien_move_timer"])
        # checked only on move steps, as in the published game (the
        # cannon sliding under a parked bottom-row alien is not terminal
        # until the block next marches)
        overrun = do_move & aliens[lanes, 9, p1]

        # alien shot: lowest alien in the column nearest the cannon
        cols = torch.arange(10, dtype=torch.int32, device=dev)
        col_has = aliens.any(dim=1)                              # (E, 10)
        near_key = (2 * torch.abs(cols[None, :] - pos[:, None])
                    + i32(cols[None, :] > pos[:, None]))
        near_key = torch.where(col_has, near_key, 99)
        shot_col = torch.argmin(near_key, dim=1)
        col_cells = aliens[lanes, :, shot_col]                   # (E, 10)
        # -1 (no alien in the column) indexes row 9, as in the JAX
        # version; do_shoot is False there, so nothing is written
        shot_row = torch.where(col_cells, cols, -1).max(dim=1).values.long()
        do_shoot = (state["alien_shot_timer"] == 0) & col_has.any(dim=1)
        e_bullets[lanes, shot_row, shot_col] = (
            e_bullets[lanes, shot_row, shot_col] | do_shoot)
        alien_shot_timer = torch.where(
            state["alien_shot_timer"] == 0, self.ENEMY_SHOT_INTERVAL,
            state["alien_shot_timer"])

        # friendly bullet <-> alien collisions
        kills = aliens & f_bullets
        reward = kills.flatten(1).sum(dim=1).to(torch.float32)
        aliens = aliens & ~kills
        f_bullets = f_bullets & ~kills

        shot_timer = torch.clamp(shot_timer - 1, min=0)
        alien_move_timer = alien_move_timer - 1
        alien_shot_timer = alien_shot_timer - 1

        # wave cleared: refill (and ramp the march interval down)
        cleared = ~aliens.flatten(1).any(dim=1)
        enemy_move_interval = state["enemy_move_interval"]
        if self.ramping:
            enemy_move_interval = torch.where(
                cleared & (enemy_move_interval > 6),
                enemy_move_interval - 1, enemy_move_interval)
        aliens = torch.where(cleared[:, None, None], _si_wave(E, dev), aliens)

        terminated = shot_down | landed | overrun
        steps = state["steps"] + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        cur = dict(pos=pos, f_bullets=f_bullets, e_bullets=e_bullets,
                   aliens=aliens, alien_dir=alien_dir,
                   enemy_move_interval=enemy_move_interval,
                   alien_move_timer=alien_move_timer,
                   alien_shot_timer=alien_shot_timer,
                   shot_timer=shot_timer, last_action=a, steps=steps)
        return (pick(done, _si_fresh(E, dev), cur), reward, terminated,
                truncated)
