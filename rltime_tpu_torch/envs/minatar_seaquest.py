"""MinAtar-style device-resident Seaquest.

Port of `rltime_tpu/envs/minatar_seaquest.py`, the fifth and most
complex game of the MinAtar suite (Young & Tian 2019, arXiv:1903.03176),
beside `envs/minatar.py` and `envs/minatar_games.py`; the state/draws
contract is `envs/device.py`'s.

Game: the player submarine (6 actions: noop/left/up/right/down/fire)
shoots enemy fish and enemy submarines (+1 each), collects divers, and
must resurface before oxygen runs out. Surfacing with no divers is
death; with 1-5 divers costs one diver and refills oxygen; with all 6
cashes in a bonus of `oxygen * 10 // 200` and ramps difficulty (enemy
spawn interval down every cash-in, enemy move interval every other).
Enemy submarines fire bullets; contact with any enemy or bullet is
terminal. Row 9 is the instrument row (oxygen + diver gauges); the sub
moves in rows 0-8, row 0 being the surface.

As in the JAX version: entity lists are fixed slot arrays (16 fish, 16
enemy subs, 24 enemy bullets, 8 divers, 4 friendly bullets; a spawn or
shot is skipped when its family is full), a friendly bullet kills every
enemy on its landing cell, and diver pickups resolve in slot order under
the 6-diver cap.

Channels: 0 sub_front, 1 sub_back, 2 friendly_bullet, 3 trail (fish +
enemy subs), 4 enemy_bullet, 5 enemy_fish, 6 enemy_sub, 7 oxygen_gauge,
8 diver_gauge, 9 diver.

Step draws, each (E,): `stick` bool; `e_lr` bool (an enemy spawns on
the left and moves right), `e_row` int32 in [1, 9), `e_is_sub` bool
(`uniform < 1/3`); `d_lr` bool, `d_row` int32 in [1, 9) for divers. The
state's `dbg_*` fields hold this step's spawn draws, as the JAX state's
do.
"""
from __future__ import annotations

import numpy as np
import torch

from rltime_tpu_torch.envs.device import (
    Draws, State, coin, full_i32, i32, pick, randint,
)

MAX_OXYGEN = 200
INIT_SPAWN_SPEED = 20
DIVER_SPAWN_SPEED = 30
INIT_MOVE_INTERVAL = 5
SHOT_COOL_DOWN = 5
ENEMY_SHOT_INTERVAL = 10
DIVER_MOVE_INTERVAL = 5

N_FISH = 16
N_ESUB = 16
N_EBUL = 24
N_FBUL = 4
N_DIV = 8


def _seaquest_fresh(E: int, dev) -> State:
    def slots(n, dtype=torch.int32):
        return torch.zeros((E, n), dtype=dtype, device=dev)

    b = torch.bool
    return dict(
        sub_x=full_i32(E, 5, dev), sub_y=full_i32(E, 0, dev),
        sub_or=torch.zeros((E,), dtype=b, device=dev),
        shot_timer=full_i32(E, 0, dev), oxygen=full_i32(E, MAX_OXYGEN, dev),
        diver_count=full_i32(E, 0, dev),
        surface=torch.ones((E,), dtype=b, device=dev),
        fb_x=slots(N_FBUL), fb_y=slots(N_FBUL),
        fb_right=slots(N_FBUL, b), fb_alive=slots(N_FBUL, b),
        fish_x=slots(N_FISH), fish_y=slots(N_FISH),
        fish_right=slots(N_FISH, b), fish_t=slots(N_FISH),
        fish_alive=slots(N_FISH, b),
        es_x=slots(N_ESUB), es_y=slots(N_ESUB),
        es_right=slots(N_ESUB, b), es_t=slots(N_ESUB),
        es_shot_t=slots(N_ESUB), es_alive=slots(N_ESUB, b),
        eb_x=slots(N_EBUL), eb_y=slots(N_EBUL),
        eb_right=slots(N_EBUL, b), eb_alive=slots(N_EBUL, b),
        div_x=slots(N_DIV), div_y=slots(N_DIV),
        div_right=slots(N_DIV, b), div_t=slots(N_DIV),
        div_alive=slots(N_DIV, b),
        e_spawn_speed=full_i32(E, INIT_SPAWN_SPEED, dev),
        e_spawn_timer=full_i32(E, INIT_SPAWN_SPEED, dev),
        d_spawn_timer=full_i32(E, DIVER_SPAWN_SPEED, dev),
        move_speed=full_i32(E, INIT_MOVE_INTERVAL, dev),
        ramp_index=full_i32(E, 0, dev),
        last_action=full_i32(E, 0, dev), steps=full_i32(E, 0, dev),
    )


def _put_first_free(free: torch.Tensor, go: torch.Tensor) -> torch.Tensor:
    """(E, N) bool one-hot of each lane's first free slot, where `go`
    (slot 0 if none is free: callers fold "any free" into `go`).
    argmax returns the first maximum; it does not take bool input."""
    first = torch.argmax(free.to(torch.uint8), dim=1)
    slots = torch.arange(free.shape[1], device=free.device)
    return (slots[None, :] == first[:, None]) & go[:, None]


def _step_x(x: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return x + i32(torch.where(right, 1, -1))


class DeviceSeaquest:
    """Vectorized MinAtar-style Seaquest.

    Actions: 0 no-op, 1 left, 2 up, 3 right, 4 down, 5 fire (the game's
    full MinAtar action set; all six are meaningful here).
    """

    num_actions = 6
    obs_shape = (10, 10, 10)
    obs_dtype = np.uint8

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000,
                 ramping: bool = True):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit
        self.ramping = ramping

    def reset_draws(self, num_envs: int, generator, device) -> Draws:
        return {}

    def step_draws(self, num_envs: int, generator, device) -> Draws:
        E = num_envs
        d = {}
        if self.sticky_prob > 0:
            d["stick"] = coin((E,), self.sticky_prob, generator, device)
        d["e_lr"] = coin((E,), 0.5, generator, device)
        d["e_row"] = randint(1, 9, (E,), generator, device)
        d["e_is_sub"] = coin((E,), 1.0 / 3.0, generator, device)
        d["d_lr"] = coin((E,), 0.5, generator, device)
        d["d_row"] = randint(1, 9, (E,), generator, device)
        return d

    def reset(self, num_envs: int, draws: Draws, device="cpu") -> State:
        E = num_envs

        def flag():
            return torch.zeros((E,), dtype=torch.bool, device=device)

        return dict(dbg_e_spawned=flag(), dbg_e_lr=flag(),
                    dbg_e_row=full_i32(E, 1, device), dbg_e_sub=flag(),
                    dbg_d_spawned=flag(), dbg_d_lr=flag(),
                    dbg_d_row=full_i32(E, 1, device),
                    **_seaquest_fresh(E, device))

    def observe(self, state: State) -> torch.Tensor:
        s = state
        E, dev = s["sub_x"].shape[0], s["sub_x"].device
        lanes = torch.arange(E, device=dev)
        l2 = lanes[:, None]
        cols = torch.arange(10, device=dev)
        obs = torch.zeros((E, 10, 10, 10), dtype=torch.uint8, device=dev)

        def mark(y, x, ch, on):
            """obs[lane, y, x, ch] |= on, per slot (duplicates agree:
            the accumulate is a max over 0/1)."""
            lane = l2.expand_as(x) if x.ndim == 2 else lanes
            obs[..., ch].index_put_((lane, y.long(), x.long()),
                                    on.to(torch.uint8), accumulate=True)

        def trail(x, right, alive):
            bx = torch.where(right, x - 1, x + 1)
            ok = alive & (bx >= 0) & (bx <= 9)
            return torch.clamp(bx, 0, 9), ok

        mark(s["sub_y"], s["sub_x"], 0, torch.ones_like(s["sub_or"]))
        # back cell dropped when off-board (same rule as trail())
        back_x, back_ok = trail(s["sub_x"], s["sub_or"],
                                torch.ones_like(s["sub_or"]))
        mark(s["sub_y"], back_x, 1, back_ok)
        mark(s["fb_y"], s["fb_x"], 2, s["fb_alive"])
        fbx, fok = trail(s["fish_x"], s["fish_right"], s["fish_alive"])
        mark(s["fish_y"], fbx, 3, fok)
        sbx, sok = trail(s["es_x"], s["es_right"], s["es_alive"])
        mark(s["es_y"], sbx, 3, sok)
        mark(s["eb_y"], s["eb_x"], 4, s["eb_alive"])
        mark(s["fish_y"], s["fish_x"], 5, s["fish_alive"])
        mark(s["es_y"], s["es_x"], 6, s["es_alive"])
        mark(s["div_y"], s["div_x"], 9, s["div_alive"])
        obs.clamp_(max=1)           # the slot sums back to binary planes
        oxy_cells = torch.div(s["oxygen"] * 10, MAX_OXYGEN,
                              rounding_mode="floor")             # (E,)
        obs[:, 9, :, 7] = (cols[None, :] < oxy_cells[:, None]).to(
            torch.uint8)
        obs[:, 9, :, 8] = ((cols[None, :] >= 9 - s["diver_count"][:, None])
                           & (cols[None, :] < 9)).to(torch.uint8)
        return obs

    def step(self, state: State, actions: torch.Tensor, draws: Draws):
        s = state
        E, dev = actions.shape[0], actions.device

        a = i32(actions)
        if self.sticky_prob > 0:
            a = torch.where(draws["stick"], s["last_action"], a)

        # 1) enemy spawn on timer expiry: side ~ U{L,R}, row ~ U[1,8],
        #    enemy sub with p=1/3; first free slot of the family
        e_lr, e_row = draws["e_lr"], i32(draws["e_row"])
        e_is_sub = draws["e_is_sub"]
        timer_up = s["e_spawn_timer"] == 0
        free_fish = ~s["fish_alive"]
        free_es = ~s["es_alive"]
        fam_free = torch.where(e_is_sub, free_es.any(dim=1),
                               free_fish.any(dim=1))
        e_spawned = timer_up & fam_free
        sx = i32(torch.where(e_lr, 0, 9))
        move_speed0 = s["move_speed"][:, None]

        put_f = _put_first_free(free_fish, e_spawned & ~e_is_sub)
        fish_x = torch.where(put_f, sx[:, None], s["fish_x"])
        fish_y = torch.where(put_f, e_row[:, None], s["fish_y"])
        fish_right = torch.where(put_f, e_lr[:, None], s["fish_right"])
        fish_t = torch.where(put_f, move_speed0, s["fish_t"])
        fish_alive = s["fish_alive"] | put_f

        put_s = _put_first_free(free_es, e_spawned & e_is_sub)
        es_x = torch.where(put_s, sx[:, None], s["es_x"])
        es_y = torch.where(put_s, e_row[:, None], s["es_y"])
        es_right = torch.where(put_s, e_lr[:, None], s["es_right"])
        es_t = torch.where(put_s, move_speed0, s["es_t"])
        es_shot_t = torch.where(put_s, ENEMY_SHOT_INTERVAL, s["es_shot_t"])
        es_alive = s["es_alive"] | put_s
        e_spawn_timer = torch.where(timer_up, s["e_spawn_speed"],
                                    s["e_spawn_timer"])

        # 2) diver spawn on timer expiry: side ~ U{L,R}, row ~ U[1,8]
        d_lr, d_row = draws["d_lr"], i32(draws["d_row"])
        d_up = s["d_spawn_timer"] == 0
        free_d = ~s["div_alive"]
        d_spawned = d_up & free_d.any(dim=1)
        put_d = _put_first_free(free_d, d_spawned)
        div_x = torch.where(put_d, i32(torch.where(d_lr, 0, 9))[:, None],
                            s["div_x"])
        div_y = torch.where(put_d, d_row[:, None], s["div_y"])
        div_right = torch.where(put_d, d_lr[:, None], s["div_right"])
        div_t = torch.where(put_d, DIVER_MOVE_INTERVAL, s["div_t"])
        div_alive = s["div_alive"] | put_d
        d_spawn_timer = torch.where(d_up, DIVER_SPAWN_SPEED,
                                    s["d_spawn_timer"])

        # 3) action: fire (on cooldown) from the CURRENT cell, else move
        fire = (a == 5) & (s["shot_timer"] == 0)
        free_fb = ~s["fb_alive"]
        put_b = _put_first_free(free_fb, fire & free_fb.any(dim=1))
        fb_x = torch.where(put_b, s["sub_x"][:, None], s["fb_x"])
        fb_y = torch.where(put_b, s["sub_y"][:, None], s["fb_y"])
        fb_right = torch.where(put_b, s["sub_or"][:, None], s["fb_right"])
        fb_alive = s["fb_alive"] | put_b
        shot_timer = torch.where(fire, SHOT_COOL_DOWN, s["shot_timer"])
        sub_x = torch.clamp(s["sub_x"] - i32(a == 1) + i32(a == 3), 0, 9)
        sub_y = torch.clamp(s["sub_y"] - i32(a == 2) + i32(a == 4), 0, 8)
        sub_or = torch.where(a == 1, False,
                             torch.where(a == 3, True, s["sub_or"]))

        # 4) friendly bullets: move, die off-board, kill every enemy on
        #    the landing cell (+1 each)
        fbx2 = _step_x(fb_x, fb_right)
        fb_off = (fbx2 < 0) | (fbx2 > 9)
        fb_live = fb_alive & ~fb_off
        hit_f = (fb_live[:, :, None] & fish_alive[:, None, :]
                 & (fbx2[:, :, None] == fish_x[:, None, :])
                 & (fb_y[:, :, None] == fish_y[:, None, :]))
        hit_s = (fb_live[:, :, None] & es_alive[:, None, :]
                 & (fbx2[:, :, None] == es_x[:, None, :])
                 & (fb_y[:, :, None] == es_y[:, None, :]))
        fish_killed = hit_f.any(dim=1)
        es_killed = hit_s.any(dim=1)
        bullet_hit = hit_f.any(dim=2) | hit_s.any(dim=2)
        reward = (fish_killed.sum(dim=1)
                  + es_killed.sum(dim=1)).to(torch.float32)
        fb_alive = fb_live & ~bullet_hit
        fb_x = torch.clamp(fbx2, 0, 9)
        fish_alive = fish_alive & ~fish_killed
        es_alive = es_alive & ~es_killed

        # 5) divers: pickup-if-on-sub, else move on timer (+pickup),
        #    slot order under the 6-diver cap (sequential capacity)
        count = s["diver_count"]
        dx_cols, dt_cols, da_cols = [], [], []
        for i in range(N_DIV):
            al = div_alive[:, i]
            x, y = div_x[:, i], div_y[:, i]
            rgt, tm = div_right[:, i], div_t[:, i]
            on_pre = al & (x == sub_x) & (y == sub_y) & (count < 6)
            t0 = tm == 0
            mv = al & ~on_pre & t0
            x2 = _step_x(x, rgt)
            off = (x2 < 0) | (x2 > 9)
            on_post = (mv & ~off & (x2 == sub_x) & (y == sub_y)
                       & (count < 6))
            picked = on_pre | on_post
            count = count + i32(picked)
            da_cols.append(al & ~picked & ~(mv & off))
            dx_cols.append(torch.where(mv, torch.clamp(x2, 0, 9), x))
            dt_cols.append(torch.where(mv, DIVER_MOVE_INTERVAL,
                                       torch.where(al & ~on_pre & ~t0,
                                                   tm - 1, tm)))
        div_x = torch.stack(dx_cols, dim=1)
        div_t = torch.stack(dt_cols, dim=1)
        div_alive = torch.stack(da_cols, dim=1)
        diver_count = count

        # 6) enemy fish: contact kills the player (checked every step
        #    AND after their own move on timer expiry)
        def march(x, y, right, t, alive):
            pre = alive & (x == sub_x[:, None]) & (y == sub_y[:, None])
            t0 = t == 0
            mv = alive & t0
            x2 = _step_x(x, right)
            off = (x2 < 0) | (x2 > 9)
            post = (mv & ~off & (x2 == sub_x[:, None])
                    & (y == sub_y[:, None]))
            alive2 = alive & ~(mv & off)
            x_new = torch.where(mv, torch.clamp(x2, 0, 9), x)
            t_new = torch.where(mv, move_speed0,
                                torch.where(alive & ~t0, t - 1, t))
            died = (pre | post).any(dim=1)
            return x_new, t_new, alive2, died

        fish_x, fish_t, fish_alive, die_f = march(
            fish_x, fish_y, fish_right, fish_t, fish_alive)

        # 7) enemy subs: march like fish, then fire on their own timer
        #    from the post-move cell (first free bullet slot)
        es_x, es_t, es_alive, die_s = march(
            es_x, es_y, es_right, es_t, es_alive)
        eb_x, eb_y = s["eb_x"], s["eb_y"]
        eb_right, eb_alive = s["eb_right"], s["eb_alive"]
        eb_free = ~eb_alive
        shot_cols = []
        for j in range(N_ESUB):
            shoot = es_alive[:, j] & (es_shot_t[:, j] == 0)
            oh = _put_first_free(eb_free, shoot & eb_free.any(dim=1))
            eb_x = torch.where(oh, es_x[:, j, None], eb_x)
            eb_y = torch.where(oh, es_y[:, j, None], eb_y)
            eb_right = torch.where(oh, es_right[:, j, None], eb_right)
            eb_alive = eb_alive | oh
            eb_free = eb_free & ~oh
            shot_cols.append(torch.where(
                shoot, ENEMY_SHOT_INTERVAL,
                torch.where(es_alive[:, j], es_shot_t[:, j] - 1,
                            es_shot_t[:, j])))
        es_shot_t = torch.stack(shot_cols, dim=1)

        # 8) enemy bullets (incl. ones just fired): contact pre- and
        #    post-move is terminal; move every step
        pre_hit = (eb_alive & (eb_x == sub_x[:, None])
                   & (eb_y == sub_y[:, None]))
        ebx2 = _step_x(eb_x, eb_right)
        eb_off = (ebx2 < 0) | (ebx2 > 9)
        post_hit = (eb_alive & ~eb_off & (ebx2 == sub_x[:, None])
                    & (eb_y == sub_y[:, None]))
        die_b = (pre_hit | post_hit).any(dim=1)
        eb_alive = eb_alive & ~eb_off
        eb_x = torch.clamp(ebx2, 0, 9)

        # 9) guarded timer decrements
        e_spawn_timer = e_spawn_timer - i32(e_spawn_timer > 0)
        d_spawn_timer = d_spawn_timer - i32(d_spawn_timer > 0)
        shot_timer = shot_timer - i32(shot_timer > 0)

        # 10) oxygen / surfacing
        submerged = sub_y > 0
        oxygen = s["oxygen"] - i32(submerged)
        oxy_dead = submerged & (oxygen < 0)
        surfacing = (~submerged) & (~s["surface"])
        surf_dead = surfacing & (diver_count == 0)
        cash = surfacing & (diver_count == 6)
        partial = surfacing & (diver_count > 0) & (diver_count < 6)
        bonus = torch.div(oxygen * 10, MAX_OXYGEN, rounding_mode="floor")
        reward = reward + torch.where(cash, bonus, 0).to(torch.float32)
        e_spawn_speed, move_speed = s["e_spawn_speed"], s["move_speed"]
        ramp_index = s["ramp_index"]
        if self.ramping:
            do_ramp = cash & ((e_spawn_speed > 1) | (move_speed > 2))
            move_speed = torch.where(
                do_ramp & (move_speed > 2)
                & (torch.remainder(ramp_index, 2) == 1),
                move_speed - 1, move_speed)
            e_spawn_speed = torch.where(do_ramp & (e_spawn_speed > 1),
                                        e_spawn_speed - 1, e_spawn_speed)
            ramp_index = ramp_index + i32(do_ramp)
        diver_count = torch.where(cash, 0,
                                  torch.where(partial, diver_count - 1,
                                              diver_count))
        oxygen = torch.where(surfacing & ~surf_dead, MAX_OXYGEN, oxygen)
        surface = ~submerged

        terminated = die_f | die_s | die_b | oxy_dead | surf_dead
        steps = s["steps"] + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        cur = dict(sub_x=sub_x, sub_y=sub_y, sub_or=sub_or,
                   shot_timer=shot_timer, oxygen=oxygen,
                   diver_count=diver_count, surface=surface,
                   fb_x=fb_x, fb_y=fb_y, fb_right=fb_right,
                   fb_alive=fb_alive,
                   fish_x=fish_x, fish_y=fish_y, fish_right=fish_right,
                   fish_t=fish_t, fish_alive=fish_alive,
                   es_x=es_x, es_y=es_y, es_right=es_right, es_t=es_t,
                   es_shot_t=es_shot_t, es_alive=es_alive,
                   eb_x=eb_x, eb_y=eb_y, eb_right=eb_right,
                   eb_alive=eb_alive,
                   div_x=div_x, div_y=div_y, div_right=div_right,
                   div_t=div_t, div_alive=div_alive,
                   e_spawn_speed=e_spawn_speed,
                   e_spawn_timer=e_spawn_timer,
                   d_spawn_timer=d_spawn_timer, move_speed=move_speed,
                   ramp_index=ramp_index, last_action=a, steps=steps)
        new_state = dict(
            dbg_e_spawned=e_spawned, dbg_e_lr=e_lr, dbg_e_row=e_row,
            dbg_e_sub=e_is_sub,
            dbg_d_spawned=d_spawned, dbg_d_lr=d_lr, dbg_d_row=d_row,
            **pick(done, _seaquest_fresh(E, dev), cur))
        return new_state, reward, terminated, truncated
