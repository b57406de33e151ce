"""Port parity: weight bridge, Q-network, returns/losses, one update step.

The port's float plane against the JAX package on the CPU at float32
(conftest sets JAX's matmul precision to "highest"; torch's CPU convs
and matmuls are full float32): forwards to rtol 1e-5, returns/losses to
1e-6, and one whole learner update — PER sample on JAX's uniforms,
union gather, double-Q n-step loss, backward, optax-rule clip, Adam,
target sync, priority write-back — with the sampled leaves bit-exact,
loss / |TD| / grad norm / new priorities to rtol 1e-5 and params after
Adam to atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params, make_model as jmake_model
from rltime_tpu.ops import losses as jlosses
from rltime_tpu.ops import returns as jreturns
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.ops import losses as tlosses
from rltime_tpu_torch.ops import returns as treturns
from rltime_tpu_torch.training import learner as tlearner

CNN = dict(num_actions=5, torso="nature_cnn", cnn_channels=(4, 4, 4),
           cnn_fc=16, head="dueling", dueling_hidden=8)
MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(16, 8), head="linear")
F, N_STEP = 4, 3


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _torch_policy(kw, flax_params, in_shape):
    model = QPolicy(ModelConfig(**kw), in_shape)
    model.load_state_dict(bridge.flax_to_state_dict(ModelConfig(**kw),
                                                    _np_tree(flax_params)))
    return model


@pytest.mark.parametrize("kw,ex_shape", [(CNN, (1, F, 84, 84)),
                                         (MLP, (1, 12))])
def test_bridge_round_trip_is_exact(kw, ex_shape):
    dtype = jnp.uint8 if len(ex_shape) == 4 else jnp.float32
    params = _np_tree(init_params(JModelConfig(**kw), jax.random.key(1),
                                  jnp.zeros(ex_shape, dtype)))
    cfg = ModelConfig(**kw)
    model = QPolicy(cfg, ex_shape[1:])
    sd = bridge.flax_to_state_dict(cfg, params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)       # shapes line up with the port's modules
    back = bridge.state_dict_to_flax(cfg, model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("kw,ex_shape", [(CNN, (6, F, 84, 84)),
                                         (MLP, (6, 12))])
def test_qpolicy_forward_matches_flax(kw, ex_shape):
    rng = np.random.default_rng(0)
    if len(ex_shape) == 4:
        obs = rng.integers(0, 256, ex_shape, dtype=np.uint8)
    else:
        obs = rng.normal(size=ex_shape).astype(np.float32)
    jcfg = JModelConfig(**kw)
    params = init_params(jcfg, jax.random.key(2), jnp.asarray(obs[:1]))
    q_j, _ = jmake_model(jcfg).apply(params, jnp.asarray(obs), ())
    model = _torch_policy(kw, params, ex_shape[1:])
    with torch.no_grad():
        q_t = model(torch.from_numpy(obs))
    # atol: Q values near 0 have no meaningful relative error
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5,
                               atol=1e-6)


def test_returns_and_losses_match_jax():
    rng = np.random.default_rng(3)
    B, n, A = 64, 3, 5
    rew = rng.normal(size=(B, n)).astype(np.float32)
    done = rng.random((B, n)) < 0.3
    term = done & (rng.random((B, n)) < 0.5)
    for jf, tf in ((jreturns.nstep_return, treturns.nstep_return),):
        for a, b in zip(jf(jnp.asarray(rew), jnp.asarray(done), 0.97),
                        tf(torch.from_numpy(rew), torch.from_numpy(done),
                           0.97)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    m_j = jreturns.truncation_mask(jnp.asarray(term), jnp.asarray(done))
    m_t = treturns.truncation_mask(torch.from_numpy(term),
                                   torch.from_numpy(done))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < m_t.sum() < B

    x = (rng.normal(size=B) * 3).astype(np.float32)
    np.testing.assert_allclose(tlosses.huber(torch.from_numpy(x), 1.5),
                               jlosses.huber(jnp.asarray(x), 1.5), rtol=1e-6)
    q_on, q_tg, q = (rng.normal(size=(B, A)).astype(np.float32)
                     for _ in range(3))
    r, d = (rng.normal(size=B).astype(np.float32) for _ in range(2))
    y_j = jlosses.double_q_target(*map(jnp.asarray, (q_on, q_tg, r, d)))
    y_t = tlosses.double_q_target(*map(torch.from_numpy, (q_on, q_tg, r, d)))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)
    act = rng.integers(0, A, B).astype(np.int32)
    w = rng.random(B).astype(np.float32)
    l_j, td_j = jlosses.q_learning_loss(jnp.asarray(q), jnp.asarray(act),
                                        y_j, jnp.asarray(w))
    l_t, td_t = tlosses.q_learning_loss(torch.from_numpy(q),
                                        torch.from_numpy(act), y_t,
                                        torch.from_numpy(w))
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-6)
    np.testing.assert_allclose(td_t.numpy(), np.asarray(td_j), rtol=1e-6)


def test_linear_lr_decay_matches_optax():
    cfg = tlearner.AlgoConfig(lr=1e-3, lr_end=1e-4, lr_decay_updates=10)
    sched = optax.linear_schedule(1e-3, 1e-4, 10)
    for count in (0, 1, 5, 10, 25):
        np.testing.assert_allclose(tlearner.learning_rate(cfg, count),
                                   float(sched(count)), rtol=1e-6)
    assert tlearner.learning_rate(tlearner.AlgoConfig(lr=3e-4), 99) == 3e-4


# ----- one full update step ------------------------------------------------

E, T, L = 2, 64, 8


def _replays():
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L,
              lookback=F - 1)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    jstate = jreplay.replay_init(jcfg, {
        "obs": ((84, 84), jnp.uint8), "action": ((), jnp.int32),
        "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
        "done": ((), jnp.bool_)})
    tstate = treplay.replay_init(tcfg, {
        "obs": ((84, 84), torch.uint8), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, torch.device("cpu"))
    rng = np.random.default_rng(4)
    for _ in range(6):
        done = rng.random((E, L)) < 0.1
        chunk = dict(
            obs=rng.integers(0, 256, (E, L, 84, 84), dtype=np.uint8),
            action=rng.integers(0, CNN["num_actions"], (E, L)).astype(
                np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=done & (rng.random((E, L)) < 0.5), done=done)
        jstate = jreplay.replay_insert(
            jcfg, jstate, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, tstate, chunk)
    return jcfg, jstate, tcfg, tstate


@pytest.mark.parametrize("grad_clip,target_update_freq",
                         [(0.05, 1), (0.0, 100)])
def test_update_step_matches_jax(grad_clip, target_update_freq):
    algo_kw = dict(batch_size=16, n_step=N_STEP, gamma=0.97, lr=1e-3,
                   adam_eps=1e-6, grad_clip=grad_clip,
                   target_update_freq=target_update_freq,
                   debug_outputs=True)
    jcfg, jrs, tcfg, trs = _replays()
    jmodel_cfg = JModelConfig(**CNN)
    jalgo = jlearner.AlgoConfig(**algo_kw)
    ex = jnp.zeros((1, F, 84, 84), jnp.uint8)
    js = jlearner.make_train_state(jmodel_cfg, jalgo, jax.random.key(7), ex)
    # a target net that differs from the online one, so double-Q matters
    js = js.replace(target_params=init_params(jmodel_cfg, jax.random.key(8),
                                              ex))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (16,))))
    beta = 0.6

    tcfg_model = ModelConfig(**CNN)
    talgo = tlearner.AlgoConfig(**algo_kw)
    ts = tlearner.make_train_state(tcfg_model, talgo, (F, 84, 84), seed=0,
                                   device=torch.device("cpu"))
    ts.model.load_state_dict(bridge.flax_to_state_dict(
        tcfg_model, _np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        tcfg_model, _np_tree(js.target_params)))

    jupd = jax.jit(jlearner.make_update_step(jmodel_cfg, jalgo, jcfg, F,
                                             flatten=False))
    js2, jrs2, jm = jupd(js, jrs, jnp.float32(beta))
    tupd = tlearner.make_update_step(talgo, tcfg, F, flatten=False)
    ts2, trs2, tm = tupd(ts, trs, beta, u=u)

    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    # atol: a per-sample |TD| near 0 has no meaningful relative error
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    if grad_clip > 0:
        assert tm["grad_norm"].item() > grad_clip     # the clip engaged
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5)
    np.testing.assert_allclose(trs2.max_priority.item(),
                               float(jrs2.max_priority), rtol=1e-5)
    assert ts2.updates == int(js2.updates) == 1
    for sd, jp in ((ts2.model.state_dict(), js2.params),
                   (ts2.target.state_dict(), js2.target_params)):
        back = bridge.state_dict_to_flax(tcfg_model, sd)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-6), back, _np_tree(jp))
    # Adam moved every parameter
    moved = bridge.state_dict_to_flax(tcfg_model, ts2.model.state_dict())
    assert not np.array_equal(moved["params"]["torso_mod"]["Dense_0"]
                              ["kernel"], np.asarray(
                                  js.params["params"]["torso_mod"]
                                  ["Dense_0"]["kernel"]))
