"""Port parity: the device rollout core and `DeviceActor`.

The port's rollout against `rltime_tpu.acting.device_actor.DeviceActor`
on MinAtar Breakout, with the JAX side's weights (through the bridge)
and its own random draws (`torch_port_draws` replays the env's and the
actor's key chains). At eps = 1 nothing depends on float math, so every
chunk field, the episode-stat rings and the running returns are
bit-equal over several chunks. At eps = 0 the greedy actions are equal
and the Q values the two policies give the chunk's observations agree
to 1e-5 (feed-forward, LSTM with its stored carry, IQN with its acting
taus). `episode_stats` pops the same returns, oldest first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.acting.device_actor import DeviceActor as JDeviceActor
from rltime_tpu.exploration.epsilon import EpsilonGreedy as JEpsilonGreedy
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params, make_model as jmake_model
from rltime_tpu_torch.acting.device_actor import STATS_RING, DeviceActor
from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy

E, L = 8, 16
GAME = "breakout"
BASE = dict(num_actions=3, torso="minatar_cnn", cnn_channels=(6,), cnn_fc=16)
MODELS = {
    "dueling": dict(head="dueling", dueling_hidden=8, **BASE),
    "lstm": dict(head="dueling", dueling_hidden=8, lstm_size=10, **BASE),
    "iqn": dict(head="iqn", iqn_embed_dim=8, dueling_hidden=12,
                num_tau_policy=6, **BASE),
}


def _pair(model_name, eps, time_limit=12, seed=0):
    """(JAX actor, its params, port actor, port model, draws state)."""
    kw = MODELS[model_name]
    jcls, tcls = draws_lib.ENVS[GAME]
    jcfg = JModelConfig(**kw)
    key = jax.random.key(seed)
    jactor = JDeviceActor(jcls(time_limit=time_limit), E, jcfg,
                          JEpsilonGreedy(eps_start=eps, eps_end=eps), key, L)
    params = init_params(jcfg, jax.random.key(seed + 1),
                         jnp.zeros((1, 10, 10, 4), jnp.uint8))
    k_env, k_act = jax.random.split(key)       # device_actor.py:181
    tcfg = ModelConfig(**kw)
    tactor = DeviceActor(
        tcls(time_limit=time_limit), E, tcfg,
        EpsilonGreedy(eps_start=eps, eps_end=eps), seed, L,
        torch.device("cpu"),
        reset_draws=draws_lib.to_torch(draws_lib.reset_draws(GAME, k_env, E)))
    model = QPolicy(tcfg, (1, 10, 10, 4))
    model.load_state_dict(bridge.flax_to_state_dict(
        tcfg, draws_lib.np_tree(params)))
    keys = dict(env=jactor.state.env_state.key, act=k_act)
    return jactor, params, tactor, model, keys


def _both_rollouts(jactor, params, tactor, model, keys):
    cfg = tactor.cfg
    keys["env"], keys["act"], draws = draws_lib.rollout_draws(
        GAME, keys["env"], keys["act"], E, L, cfg.num_actions,
        cfg.num_tau_policy if cfg.is_iqn else 0)
    jchunk, _ = jactor.rollout(params)
    tchunk, info = tactor.rollout(model, draws)
    assert info["env_steps"] == jactor.env_steps
    assert set(tchunk) == set(jchunk)
    return jchunk, tchunk


def test_rollout_at_eps_1_is_bit_exact():
    jactor, params, tactor, model, keys = _pair("dueling", eps=1.0)
    for c in range(4):
        jchunk, tchunk = _both_rollouts(jactor, params, tactor, model, keys)
        for k, v in jchunk.items():
            got = tchunk[k].numpy()
            assert got.dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got, np.asarray(v),
                                          err_msg=f"{k} chunk {c}")
        js, ts = jactor.state, tactor.state
        assert ts.ret_ring.shape == (STATS_RING + 1,)
        for name in ("ret_ring", "len_ring"):
            np.testing.assert_array_equal(
                getattr(ts, name)[:STATS_RING].numpy(),
                np.asarray(getattr(js, name)), err_msg=name)
        for name in ("ring_cursor", "ep_ret", "ep_len", "done_prev"):
            got, want = getattr(ts, name).numpy(), np.asarray(
                getattr(js, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert int(tactor.state.ring_cursor) > E       # many episodes ended
    assert tchunk["done"].any() and tchunk["reward"].dtype == torch.float32


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_greedy_rollout_matches_jax(model_name):
    jactor, params, tactor, model, keys = _pair(model_name, eps=0.0)
    jchunk, tchunk = _both_rollouts(jactor, params, tactor, model, keys)
    for k in ("action", "obs", "reward", "done", "terminated"):
        np.testing.assert_array_equal(tchunk[k].numpy(),
                                      np.asarray(jchunk[k]), err_msg=k)
    if tactor.cfg.recurrent:
        assert tchunk["rnn_h"].abs().sum() > 0
        for k in ("rnn_c", "rnn_h"):
            np.testing.assert_allclose(tchunk[k].numpy(),
                                       np.asarray(jchunk[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the Q values both policies give the chunk's last column
    obs = np.array(jchunk["obs"])[:, -1]
    rng = np.random.default_rng(0)
    taus = (rng.random((E, 6)).astype(np.float32) if tactor.cfg.is_iqn
            else None)
    rnn = ()
    if tactor.cfg.recurrent:
        rnn = tuple(jnp.asarray(jchunk[k])[:, -1] for k in ("rnn_c", "rnn_h"))
    q_j, _ = jmake_model(JModelConfig(**MODELS[model_name])).apply(
        params, jnp.asarray(obs), rnn,
        None if taus is None else jnp.asarray(taus))
    with torch.no_grad():
        out = model(torch.from_numpy(obs),
                    tuple(tchunk[k][:, -1] for k in ("rnn_c", "rnn_h"))
                    if tactor.cfg.recurrent else None,
                    None if taus is None else torch.from_numpy(taus))
    q_t = out[0] if tactor.cfg.recurrent else out
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5,
                               atol=1e-5)


def test_episode_stats_oldest_first():
    jactor, params, tactor, model, keys = _pair("dueling", eps=1.0,
                                                time_limit=7)
    popped = 0
    for c in range(3):
        _both_rollouts(jactor, params, tactor, model, keys)
        if c == 1:
            continue        # a pop covers every chunk since the last one
        jr, jl = jactor.episode_stats()
        tr, tl = tactor.episode_stats()
        assert tr == jr and tl == jl and len(tr) > 0
        popped += len(tr)
    assert popped == int(tactor.state.ring_cursor)
    assert tactor.episode_stats() == ([], [])
    # more completions than the ring holds between two pops: the newest
    # STATS_RING survive, still oldest first
    while int(tactor.state.ring_cursor) - popped <= STATS_RING:
        _both_rollouts(jactor, params, tactor, model, keys)
    jr, jl = jactor.episode_stats()
    tr, tl = tactor.episode_stats()
    assert len(tr) == STATS_RING and tr == jr and tl == jl


def test_generator_rollout_is_reproducible():
    """Without injected draws the rollout draws from the state's two
    generators: the same seed gives the same chunk, another seed not."""
    _, tcls = draws_lib.ENVS[GAME]
    cfg = ModelConfig(**MODELS["iqn"])
    model = QPolicy(cfg, (1, 10, 10, 4), torch.Generator().manual_seed(0))

    def chunk(seed):
        actor = DeviceActor(tcls(time_limit=12), E, cfg,
                            EpsilonGreedy(eps_start=0.5, eps_end=0.5), seed,
                            L, torch.device("cpu"))
        return actor.rollout(model)[0]

    a, b, c = chunk(1), chunk(1), chunk(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["action"], c["action"])
    assert a["obs"].shape == (E, L, 10, 10, 4)
    assert a["obs"].dtype == torch.uint8
    assert a["action"].dtype == torch.int32
