"""Port parity: actor-side initial priorities
(`replay.use_inserted_priorities`).

The device rollout core with `compute_priorities` against the JAX
`DeviceActor` on MinAtar Breakout at eps = 1 (nothing but the priorities
depends on float math), from the JAX side's weights and draws: every
other chunk field bit-equal, "priority" = |r + gamma (1 - done) max_a
Q(s') - Q(s, a)| to rtol 1e-5 / atol 1e-6 (f32 Q values), for the
feed-forward, LSTM and IQN policies; the IQN taus of the extra
post-chunk forward come from a key DERIVED from the actor's
(`fold_in(key, 0x9E37)`), replayed here. The actor's stream is
identical with and without priorities. The host `Actor` emits each
transition one step late, against the JAX host `Actor` on
`counting_env` with greedy actions. `replay_insert`'s activation from
the stored priorities is held in tests/test_torch_sum_tree.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.acting.actor import Actor as JActor
from rltime_tpu.acting.device_actor import DeviceActor as JDeviceActor
from rltime_tpu.envs.fake import CountingVecEnv as JCountingVecEnv
from rltime_tpu.exploration.epsilon import EpsilonGreedy as JEpsilonGreedy
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params
from rltime_tpu_torch.acting.actor import Actor
from rltime_tpu_torch.acting.device_actor import DeviceActor
from rltime_tpu_torch.envs.fake import CountingVecEnv
from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.utils.prng import derived_generator
from test_torch_device_actor import E, GAME, L, MODELS
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

GAMMA = 0.9


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_device_rollout_priorities_match_jax(model_name):
    kw = MODELS[model_name]
    jcls, tcls = draws_lib.ENVS[GAME]
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    key = jax.random.key(0)
    jactor = JDeviceActor(jcls(time_limit=12), E, jcfg,
                          JEpsilonGreedy(eps_start=1.0, eps_end=1.0), key, L,
                          compute_priorities=True, gamma=GAMMA)
    params = init_params(jcfg, jax.random.key(1),
                         jnp.zeros((1, 10, 10, 4), jnp.uint8))
    k_env, k_act = jax.random.split(key)
    tactor = DeviceActor(
        tcls(time_limit=12), E, tcfg,
        EpsilonGreedy(eps_start=1.0, eps_end=1.0), 0, L, torch.device("cpu"),
        reset_draws=draws_lib.to_torch(draws_lib.reset_draws(GAME, k_env, E)),
        compute_priorities=True, gamma=GAMMA)
    model = QPolicy(tcfg, (1, 10, 10, 4))
    model.load_state_dict(bridge.flax_to_state_dict(
        tcfg, draws_lib.np_tree(params)))
    env_key = jactor.state.env_state.key
    ntp = tcfg.num_tau_policy if tcfg.is_iqn else 0
    for c in range(3):
        env_key, k_act, draws = draws_lib.rollout_draws(
            GAME, env_key, k_act, E, L, tcfg.num_actions, ntp)
        if ntp:     # device_actor.py:129-131
            draws.append(draws_lib.to_torch(dict(taus=jax.random.uniform(
                jax.random.fold_in(k_act, 0x9E37), (E, ntp)))))
        jchunk, _ = jactor.rollout(params)
        tchunk, _ = tactor.rollout(model, draws)
        assert set(tchunk) == set(jchunk) and "priority" in tchunk
        assert "q_sa" not in tchunk and "q_best" not in tchunk
        for k, v in jchunk.items():
            if k in ("priority", "rnn_c", "rnn_h"):
                np.testing.assert_allclose(tchunk[k].numpy(), np.asarray(v),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} chunk {c}")
            else:
                np.testing.assert_array_equal(tchunk[k].numpy(),
                                              np.asarray(v),
                                              err_msg=f"{k} chunk {c}")
        p = tchunk["priority"]
        assert p.shape == (E, L) and p.dtype == torch.float32
        assert bool((p >= 0).all()) and p.sum() > 0
    assert tchunk["done"].any()


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_actor_stream_is_the_same_with_and_without_priorities(model_name):
    _, tcls = draws_lib.ENVS[GAME]
    cfg = ModelConfig(**MODELS[model_name])
    model = QPolicy(cfg, (1, 10, 10, 4), torch.Generator().manual_seed(0))
    actors = [DeviceActor(tcls(time_limit=12), E, cfg,
                          EpsilonGreedy(eps_start=0.5, eps_end=0.5), 3, L,
                          torch.device("cpu"), compute_priorities=prio)
              for prio in (False, True)]
    for _ in range(3):
        plain, with_prio = (a.rollout(model)[0] for a in actors)
        assert set(with_prio) == set(plain) | {"priority"}
        for k, v in plain.items():
            assert torch.equal(v, with_prio[k]), k
    a, b = (x.state for x in actors)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.env_generator.get_state(),
                       b.env_generator.get_state())


def test_derived_generator_leaves_its_parent_alone():
    g = torch.Generator().manual_seed(5)
    before = g.get_state().clone()
    d1, d2 = derived_generator(g, "x"), derived_generator(g, "x")
    other = derived_generator(g, "y")
    assert torch.equal(g.get_state(), before)
    a, b, c = (torch.rand(4, generator=x) for x in (d1, d2, other))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.rand(1, generator=g)          # the parent moved on: a new child
    assert not torch.equal(torch.rand(4, generator=derived_generator(g, "x")),
                           a)


MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(16,), head="linear")


@pytest.mark.parametrize("lstm", [0, 6])
def test_host_actor_emits_one_step_late_as_jax(lstm):
    """Greedy actions on `counting_env` (obs, rewards and dones do not
    depend on the actions): two chunks from both host actors."""
    kw = dict(MLP, lstm_size=lstm)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    E_, L_, F_ = 3, 8, 2
    greedy = dict(eps_start=0.0, eps_end=0.0)
    jactor = JActor(JCountingVecEnv(E_, episode_len=5), jcfg, F_,
                    JEpsilonGreedy(**greedy), jax.random.key(0), L_,
                    compute_priorities=True, gamma=GAMMA)
    params = init_params(jcfg, jax.random.key(1),
                         jnp.zeros((1, 4 * F_), jnp.float32))
    tactor = Actor(CountingVecEnv(E_, episode_len=5), tcfg, F_,
                   EpsilonGreedy(**greedy), torch.Generator().manual_seed(0),
                   L_, torch.device("cpu"), compute_priorities=True,
                   gamma=GAMMA)
    model = QPolicy(tcfg, (4 * F_,))
    model.load_state_dict(bridge.flax_to_state_dict(
        tcfg, draws_lib.np_tree(params)))
    for c in range(2):
        jchunk, jinfo = jactor.rollout(params)
        tchunk, tinfo = tactor.rollout(model)
        # the first rollout steps the env L + 1 times to emit L
        assert tinfo["env_steps"] == jinfo["env_steps"] == (
            (c + 1) * L_ + 1) * E_
        assert set(tchunk) == set(jchunk)
        assert isinstance(tchunk["obs"], np.ndarray)    # host-side obs
        for k in ("obs", "action", "reward", "terminated", "done"):
            np.testing.assert_array_equal(np.asarray(tchunk[k]),
                                          np.asarray(jchunk[k]), err_msg=k)
        for k in ("priority",) + (("rnn_c", "rnn_h") if lstm else ()):
            np.testing.assert_allclose(np.asarray(tchunk[k]),
                                       np.asarray(jchunk[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert tchunk["priority"].shape == (E_, L_)
        assert tchunk["priority"].sum() > 0
    assert tchunk["done"].any()


def test_host_trainer_with_inserted_priorities(tmp_path):
    from rltime_tpu_torch.training.trainer import Trainer
    from test_torch_trainer import _img_cfg
    cfg = _img_cfg()
    cfg["replay"]["use_inserted_priorities"] = True
    t = Trainer(cfg, str(tmp_path / "run"), device="cpu").train()
    rs = t.replay_state
    assert t.updates_done > 0 and "priority" in rs.storage
    assert rs.storage["priority"][:, :rs.t].sum() > 0
    # one step late: the actor has stepped the env once more than it
    # has emitted, and the ring holds the emitted columns
    assert t.actor.env_steps == (rs.t + 1) * 2
    for k in ("loss", "grad_norm", "td_abs"):
        assert np.isfinite(t.last_metrics[k].item()), k
