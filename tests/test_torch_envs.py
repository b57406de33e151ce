"""Port parity: the device envs against the JAX ones, step by step.

Each of the five MinAtar games runs a few hundred random-action steps
beside its JAX version on the same actions and the JAX side's own
random draws (`torch_port_draws` replays each split): every state
field, the observation bytes, reward, terminated and truncated must be
bit-equal at every step. A short `time_limit` makes truncations (for
Freeway: terminations) and auto-resets occur. DeviceCartPole is float
math and is held to 1e-5 with equal done flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu_torch.config.config import build
import rltime_tpu_torch.envs  # noqa: F401  (registers env types)

E = 8
GAMES = ["breakout", "asterix", "freeway", "space_invaders", "seaquest"]
# short limits so the time limit fires many times; Asterix also ramps
KWARGS = {"breakout": dict(time_limit=40), "asterix": dict(
    time_limit=40, ramp_interval=10), "freeway": dict(time_limit=70),
    "space_invaders": dict(time_limit=120), "seaquest": dict(time_limit=90),
    "cartpole": dict(time_limit=25)}


def _assert_state_equal(tstate, jstate, step, exact=True):
    want = draws_lib.state_to_numpy(jstate)
    assert set(tstate) == set(want)
    for k, v in want.items():
        got = tstate[k].numpy()
        assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
        if exact:
            np.testing.assert_array_equal(got, v, err_msg=f"{k} @ {step}")
        else:
            np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} @ {step}")


def _run(name, steps, seed):
    jcls, tcls = draws_lib.ENVS[name]
    jenv, tenv = jcls(**KWARGS[name]), tcls(**KWARGS[name])
    exact = name != "cartpole"
    key = jax.random.key(seed)
    jstate = jenv.reset(key, E)
    tstate = tenv.reset(E, draws_lib.to_torch(
        draws_lib.reset_draws(name, key, E)))
    _assert_state_equal(tstate, jstate, "reset", exact)
    jstep, jobserve = jax.jit(jenv.step), jax.jit(jenv.observe)
    jdraws = jax.jit(lambda k: draws_lib.step_draws(name, k, E))
    rng = np.random.default_rng(seed)
    n_term = n_trunc = 0
    total_reward = 0.0
    for t in range(steps):
        actions = rng.integers(0, jenv.num_actions, E).astype(np.int32)
        if name == "breakout":
            # random play never returns the ball: most lanes track it,
            # so bricks are hit and episodes reach the time limit
            bx, px = np.asarray(jstate.ball_x), np.asarray(jstate.pos)
            track = np.where(bx < px, 1, np.where(bx > px, 2, 0))
            actions = np.where(rng.random(E) < 0.8, track,
                               actions).astype(np.int32)
        d = draws_lib.to_torch(jdraws(jstate.key))
        jstate, jr, jterm, jtrunc = jstep(jstate, jnp.asarray(actions))
        tstate, tr, tterm, ttrunc = tenv.step(
            tstate, torch.from_numpy(actions), d)
        _assert_state_equal(tstate, jstate, t, exact)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        assert tr.dtype == torch.float32
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        tobs, jobs = tenv.observe(tstate).numpy(), np.asarray(jobserve(jstate))
        assert tobs.dtype == jobs.dtype and tobs.shape == jobs.shape
        if exact:
            np.testing.assert_array_equal(tobs, jobs, err_msg=f"obs @ {t}")
        else:
            np.testing.assert_allclose(tobs, jobs, rtol=1e-5, atol=1e-5)
        n_term += int(tterm.sum())
        n_trunc += int(ttrunc.sum())
        total_reward += float(tr.sum())
    return n_term, n_trunc, total_reward


@pytest.mark.parametrize("name", GAMES)
def test_minatar_game_is_bit_exact(name):
    n_term, n_trunc, reward = _run(name, 320, seed=3)
    assert n_term > 0, "no lane terminated: the run exercised no reset"
    if name != "freeway":       # Freeway's limit is a termination
        assert n_trunc > 0, "no lane hit the time limit"
    if name != "freeway":       # random play almost never crosses
        assert reward > 0


def test_freeway_crossing_is_bit_exact():
    """Always-up play crosses the road, so the cars re-randomize."""
    jcls, tcls = draws_lib.ENVS["freeway"]
    jenv, tenv = jcls(sticky_prob=0.0), tcls(sticky_prob=0.0)
    key = jax.random.key(0)
    jstate = jenv.reset(key, E)
    tstate = tenv.reset(E, draws_lib.to_torch(
        draws_lib.reset_draws("freeway", key, E)))
    jstep = jax.jit(jenv.step)
    up = np.ones(E, np.int32)
    scored = 0.0
    for t in range(200):
        d = draws_lib.to_torch(draws_lib.step_draws(
            "freeway", jstate.key, E, sticky_prob=0.0))
        jstate, jr, _, _ = jstep(jstate, jnp.asarray(up))
        tstate, tr, _, _ = tenv.step(tstate, torch.from_numpy(up), d)
        _assert_state_equal(tstate, jstate, t)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        scored += float(tr.sum())
    assert scored > 0


def test_device_cartpole_matches_jax():
    n_term, n_trunc, _ = _run("cartpole", 300, seed=1)
    assert n_term > 0 and n_trunc > 0


@pytest.mark.parametrize("name", GAMES + ["cartpole"])
def test_generator_draws_fit_the_contract(name):
    """The generator route feeds `reset`/`step` the same names, shapes
    and dtypes as the injected route, and is reproducible."""
    _, tcls = draws_lib.ENVS[name]
    env = tcls(**KWARGS[name])
    key = jax.random.key(0)
    want_reset = draws_lib.to_torch(draws_lib.reset_draws(name, key, E))
    want_step = draws_lib.to_torch(draws_lib.step_draws(name, key, E))

    def rollout(seed):
        g = torch.Generator().manual_seed(seed)
        rd = env.reset_draws(E, g, "cpu")
        assert {k: (v.shape, v.dtype) for k, v in rd.items()} == {
            k: (v.shape, v.dtype) for k, v in want_reset.items()}
        state = env.reset(E, rd)
        obs = []
        for t in range(40):
            sd = env.step_draws(E, g, "cpu")
            assert {k: (v.shape, v.dtype) for k, v in sd.items()} == {
                k: (v.shape, v.dtype) for k, v in want_step.items()}
            a = torch.full((E,), t % env.num_actions, dtype=torch.int32)
            state, r, term, trunc = env.step(state, a, sd)
            obs.append(env.observe(state))
        return torch.stack(obs)

    a, b, c = rollout(5), rollout(5), rollout(6)
    assert torch.equal(a, b)
    assert a.shape[1:] == (E,) + tuple(env.obs_shape)
    if name != "space_invaders":     # its only draw is the sticky coin
        assert not torch.equal(a, c)


def test_registry_handles():
    for game, (_, tcls) in draws_lib.ENVS.items():
        if game == "cartpole":
            h = build({"type": "cartpole_device", "num_envs": 4,
                       "time_limit": 9}, seed=0)
        else:
            h = build({"type": f"minatar_{game}", "num_envs": 4,
                       "time_limit": 9}, seed=0)
        assert h.is_device and h.num_envs == 4
        assert isinstance(h.inner, tcls) and h.inner.time_limit == 9
        assert h.spec.obs_shape == tuple(tcls.obs_shape)
        assert h.spec.num_actions == tcls.num_actions
