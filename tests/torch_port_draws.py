"""The JAX device envs' and actor's random draws, as numpy arrays.

The JAX package draws inside `reset`/`step`/the rollout body from a key
that rides in the state; the port takes the same draws as named
tensors. Each function here replays one split of the JAX code (the line
it mirrors is cited) and returns what the port's counterpart takes, so
the parity tests can feed both sides the same randomness.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.envs import device as jdevice
from rltime_tpu.envs import minatar as jminatar
from rltime_tpu.envs import minatar_games as jgames
from rltime_tpu.envs import minatar_seaquest as jseaquest
from rltime_tpu_torch.envs import device as tdevice
from rltime_tpu_torch.envs import minatar as tminatar


@pytest.fixture
def one_intra_op_thread():
    """One PyTorch intra-op thread for the test. A module asks for it
    with `pytestmark = pytest.mark.usefixtures("one_intra_op_thread")`
    after importing it.

    The port's CPU tests run at tiny sizes, several files at once under
    pytest-xdist. With PyTorch's default of one thread per core the
    workers' OpenMP pools spin against each other: a trainer run of
    0.6 s took 54 s, thirteen port files 315 s against 83 s."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# name -> (JAX class, port class)
ENVS = {
    "breakout": (jminatar.DeviceBreakout, tminatar.DeviceBreakout),
    "asterix": (jgames.DeviceAsterix, tminatar.DeviceAsterix),
    "freeway": (jgames.DeviceFreeway, tminatar.DeviceFreeway),
    "space_invaders": (jgames.DeviceSpaceInvaders,
                       tminatar.DeviceSpaceInvaders),
    "seaquest": (jseaquest.DeviceSeaquest, tminatar.DeviceSeaquest),
    "cartpole": (jdevice.DeviceCartPole, tdevice.DeviceCartPole),
}


def _coin(key, p, shape):
    return jax.random.bernoulli(key, p, shape)


def _cars(key, E, prefix):
    """minatar_games.py:_freeway_cars."""
    k1, k2 = jax.random.split(key)
    return {f"{prefix}_speed": jax.random.randint(k1, (E, 8), 1, 6),
            f"{prefix}_sign": _coin(k2, 0.5, (E, 8))}


def _cartpole_start(key, E):
    return jax.random.uniform(key, (E, 4), jnp.float32, minval=-0.05,
                              maxval=0.05)


def reset_draws(name, key, E):
    """What `reset(key, E)` of the JAX env `name` draws."""
    if name == "breakout":                       # minatar.py:99-100
        return dict(side=_coin(jax.random.split(key)[1], 0.5, (E,)))
    if name == "freeway":                        # minatar_games.py:287
        return _cars(jax.random.split(key)[1], E, "cars")
    if name == "cartpole":                       # device.py:54-55
        return dict(s=_cartpole_start(jax.random.split(key)[1], E))
    return {}


def step_draws(name, key, E, sticky_prob=0.1):
    """What `step(state, actions)` of the JAX env `name` draws from
    `state.key == key`."""
    d = {}
    if name == "breakout":                       # minatar.py:118
        _, k_sticky, k_reset = jax.random.split(key, 3)
        d["side"] = _coin(k_reset, 0.5, (E,))
    elif name == "asterix":                      # minatar_games.py:137
        _, k_sticky, k_lr, k_gold, k_slot = jax.random.split(key, 5)
        d["slot_u"] = jax.random.uniform(k_slot, (E, 8))
        d["lr"] = _coin(k_lr, 0.5, (E,))
        d["gold"] = jax.random.uniform(k_gold, (E,)) < (1.0 / 3.0)
    elif name == "freeway":                      # minatar_games.py:314
        _, k_sticky, k_cars, k_reset = jax.random.split(key, 4)
        d.update(_cars(k_cars, E, "cars"))
        d.update(_cars(k_reset, E, "reset"))
    elif name == "space_invaders":               # minatar_games.py:461
        _, k_sticky = jax.random.split(key)
    elif name == "seaquest":                     # minatar_seaquest.py:238
        (_, k_sticky, k_elr, k_erow, k_esub, k_dlr,
         k_drow) = jax.random.split(key, 7)
        d["e_lr"] = _coin(k_elr, 0.5, (E,))
        d["e_row"] = jax.random.randint(k_erow, (E,), 1, 9)
        d["e_is_sub"] = jax.random.uniform(k_esub, (E,)) < (1.0 / 3.0)
        d["d_lr"] = _coin(k_dlr, 0.5, (E,))
        d["d_row"] = jax.random.randint(k_drow, (E,), 1, 9)
    elif name == "cartpole":                     # device.py:90-92
        return dict(fresh=_cartpole_start(jax.random.split(key)[1], E))
    else:
        raise KeyError(name)
    if sticky_prob > 0:
        d["stick"] = _coin(k_sticky, sticky_prob, (E,))
    return d


def act_draws(key, E, num_actions, num_tau_policy=0):
    """One rollout step's actor draws (acting/device_actor.py:66-83).
    Returns (the next actor key, draws)."""
    key, ekey, akey, tkey = jax.random.split(key, 4)
    d = dict(explore_u=jax.random.uniform(ekey, (E,)),
             random_a=jax.random.randint(akey, (E,), 0, num_actions,
                                         dtype=jnp.int32))
    if num_tau_policy:
        d["taus"] = jax.random.uniform(tkey, (E, num_tau_policy))
    return key, d


# how many keys each env's step splits its key into (the first is kept)
_STEP_SPLITS = {"breakout": 3, "asterix": 5, "freeway": 4,
                "space_invaders": 2, "seaquest": 7, "cartpole": 2}


def rollout_draws(name, env_key, act_key, E, L, num_actions,
                  num_tau_policy=0, sticky_prob=0.1):
    """The draws of L rollout steps, as the port's `rollout(draws=...)`
    takes them, from the env state's key and the actor's key. Returns
    (env_key, act_key, draws) with both keys advanced as L steps do."""
    out = []
    for _ in range(L):
        act_key, a = act_draws(act_key, E, num_actions, num_tau_policy)
        e = step_draws(name, env_key, E, sticky_prob)
        env_key = jax.random.split(env_key, _STEP_SPLITS[name])[0]
        out.append(dict(act=to_torch(a), env=to_torch(e)))
    return env_key, act_key, out


def update_draws(key, B, num_tau=0, num_tau_prime=0, num_tau_policy=0):
    """One learner update's draws from the key `update_step` receives
    (training/learner.py:374, :289-297): the PER uniforms `u` and, for
    IQN (num_tau > 0), the three tau sets."""
    _, skey, tkey = jax.random.split(key, 3)
    d = dict(u=torch.from_numpy(np.array(jax.random.uniform(skey, (B,)))))
    if num_tau:
        k1, k2, k3 = jax.random.split(tkey, 3)
        d["taus"] = to_torch(dict(
            taus=jax.random.uniform(k1, (B, num_tau)),
            taus_prime=jax.random.uniform(k2, (B, num_tau_prime)),
            taus_policy=jax.random.uniform(k3, (B, num_tau_policy))))
    return d


def uniform_update_draws(key, B, span, E):
    """One learner update's sampler draws under uniform replay, from the
    key `update_step` receives (training/learner.py:374,
    history/replay.py:230-232): column offsets in [0, span) with
    span = max(hi - lo, 1) of the valid range, and env lanes in [0, E),
    as the port's `u` pair."""
    _, skey, _ = jax.random.split(key, 3)
    ukey, ekey = jax.random.split(skey)
    return dict(u=(
        torch.from_numpy(np.array(jax.random.randint(ukey, (B,), 0, span))),
        torch.from_numpy(np.array(jax.random.randint(ekey, (B,), 0, E)))))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def to_torch(draws):
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def state_to_numpy(jstate):
    """A JAX env state as {field: numpy}, without its key."""
    return {k: np.asarray(v) for k, v in jstate._asdict().items()
            if k != "key"}
