"""Port parity: the MinAtar CNN torso, the IQN head and the IQN update.

Against the JAX package on the CPU at float32: the weight bridge round
trip is exact; forwards (4-D planes from a device env, 5-D stacks from
the replay gather with F = 1 and F = 2, IQN with and without the
dueling aggregation, the LSTM in between) agree to rtol 1e-5;
`quantile_huber_loss` to 1e-6; and one whole IQN update on JAX's PER
uniforms and its three tau sets: sampled leaves bit-exact, loss / |TD| /
grad norm / priorities to rtol 1e-5, params after Adam to atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import (
    init_params, initial_rnn_state as j_initial_rnn_state,
    make_model as jmake_model,
)
from rltime_tpu.ops import losses as jlosses
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.ops import losses as tlosses
from rltime_tpu_torch.training import learner as tlearner

A, C = 5, 4
MINATAR = dict(num_actions=A, torso="minatar_cnn", cnn_channels=(6,),
               cnn_fc=16)
MODELS = {
    "dueling": dict(head="dueling", dueling_hidden=8, **MINATAR),
    "two_convs": dict(head="linear", **{**MINATAR,
                                        "cnn_channels": (6, 4)}),
    "iqn": dict(head="iqn", iqn_embed_dim=8, dueling_hidden=12,
                num_tau_policy=6, **MINATAR),
    "iqn_dueling": dict(head="iqn", iqn_embed_dim=8, iqn_dueling=True,
                        dueling_hidden=12, **MINATAR),
    "lstm": dict(head="dueling", dueling_hidden=8, lstm_size=10,
                 **MINATAR),
    "mlp_iqn": dict(num_actions=3, torso="mlp", mlp_hidden=(16, 8),
                    head="iqn", iqn_embed_dim=8, dueling_hidden=12),
}


def _example(kw, B, F=1, five_d=True, seed=0):
    rng = np.random.default_rng(seed)
    if kw["torso"] == "mlp":
        return rng.normal(size=(B, 12)).astype(np.float32), (12,)
    shape = (B, F, 10, 10, C) if five_d else (B, 10, 10, C)
    return rng.integers(0, 2, shape, dtype=np.uint8), (F, 10, 10, C)


def _torch_policy(kw, flax_params, in_shape):
    cfg = ModelConfig(**kw)
    model = QPolicy(cfg, in_shape)
    model.load_state_dict(bridge.flax_to_state_dict(
        cfg, draws_lib.np_tree(flax_params)))
    return model


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bridge_round_trip_is_exact(name):
    kw = MODELS[name]
    obs, in_shape = _example(kw, 1, F=2)
    params = draws_lib.np_tree(init_params(JModelConfig(**kw),
                                           jax.random.key(1),
                                           jnp.asarray(obs)))
    cfg = ModelConfig(**kw)
    model = QPolicy(cfg, in_shape)
    sd = bridge.flax_to_state_dict(cfg, params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)       # shapes line up with the port's modules
    back = bridge.state_dict_to_flax(cfg, model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("name,F,five_d", [
    ("dueling", 1, False), ("dueling", 1, True), ("dueling", 2, True),
    ("two_convs", 1, True), ("iqn", 1, False), ("iqn_dueling", 1, True),
    ("lstm", 1, False), ("mlp_iqn", 1, True)])
def test_forward_matches_flax(name, F, five_d):
    kw = MODELS[name]
    B = 6
    obs, in_shape = _example(kw, B, F, five_d, seed=2)
    jcfg = JModelConfig(**kw)
    params = init_params(jcfg, jax.random.key(2), jnp.asarray(obs[:1]))
    rng = np.random.default_rng(3)
    taus = (rng.random((B, 7)).astype(np.float32) if jcfg.is_iqn else None)
    rnn = j_initial_rnn_state(jcfg, B)
    if jcfg.recurrent:
        rnn = tuple(jnp.asarray(rng.normal(size=s.shape).astype(np.float32))
                    for s in rnn)
    q_j, rnn_j = jmake_model(jcfg).apply(
        params, jnp.asarray(obs), rnn,
        None if taus is None else jnp.asarray(taus))
    model = _torch_policy(kw, params, in_shape)
    with torch.no_grad():
        out = model(torch.from_numpy(obs),
                    tuple(torch.from_numpy(np.array(s)) for s in rnn)
                    if jcfg.recurrent else None,
                    None if taus is None else torch.from_numpy(taus))
    q_t = out[0] if jcfg.recurrent else out
    assert q_t.shape == q_j.shape
    # atol: Q values near 0 have no meaningful relative error
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5,
                               atol=1e-6)
    if jcfg.recurrent:
        for a, b in zip(out[1], rnn_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    if jcfg.is_iqn:
        with pytest.raises(ValueError, match="taus"):
            model(torch.from_numpy(obs))


@pytest.mark.parametrize("kappa,weighted", [(1.0, True), (0.5, False)])
def test_quantile_huber_loss_matches_jax(kappa, weighted):
    rng = np.random.default_rng(4)
    B, N, Np = 16, 7, 5
    quant = rng.normal(size=(B, N)).astype(np.float32)
    taus = rng.random((B, N)).astype(np.float32)
    target = (rng.normal(size=(B, Np)) * 2).astype(np.float32)
    w = rng.random(B).astype(np.float32) if weighted else None
    l_j, td_j = jlosses.quantile_huber_loss(
        jnp.asarray(quant), jnp.asarray(taus), jnp.asarray(target),
        None if w is None else jnp.asarray(w), kappa)
    l_t, td_t = tlosses.quantile_huber_loss(
        torch.from_numpy(quant), torch.from_numpy(taus),
        torch.from_numpy(target), None if w is None else torch.from_numpy(w),
        kappa)
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-6)
    np.testing.assert_allclose(td_t.numpy(), np.asarray(td_j), rtol=1e-6)


# ----- one full IQN update -------------------------------------------------

E, T, L, N_STEP, B = 4, 64, 8, 3, 16


def _replays():
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    jstate = jreplay.replay_init(jcfg, {
        "obs": ((10, 10, C), jnp.uint8), "action": ((), jnp.int32),
        "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
        "done": ((), jnp.bool_)})
    tstate = treplay.replay_init(tcfg, {
        "obs": ((10, 10, C), torch.uint8), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, torch.device("cpu"))
    rng = np.random.default_rng(5)
    for _ in range(5):
        done = rng.random((E, L)) < 0.1
        chunk = dict(
            obs=rng.integers(0, 2, (E, L, 10, 10, C), dtype=np.uint8),
            action=rng.integers(0, A, (E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=done & (rng.random((E, L)) < 0.5), done=done)
        jstate = jreplay.replay_insert(
            jcfg, jstate, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, tstate, chunk)
    return jcfg, jstate, tcfg, tstate


@pytest.mark.parametrize("double_q", [True, False])
def test_iqn_update_step_matches_jax(double_q):
    kw = MODELS["iqn"]
    algo_kw = dict(algo="iqn", batch_size=B, n_step=N_STEP, gamma=0.97,
                   lr=1e-3, adam_eps=1e-6, grad_clip=0.5,
                   target_update_freq=100, double_q=double_q, num_tau=7,
                   num_tau_prime=5, debug_outputs=True)
    jcfg, jrs, tcfg, trs = _replays()
    jmodel_cfg = JModelConfig(**kw)
    jalgo = jlearner.AlgoConfig(**algo_kw)
    ex = jnp.zeros((1, 1, 10, 10, C), jnp.uint8)
    js = jlearner.make_train_state(jmodel_cfg, jalgo, jax.random.key(7), ex)
    # a target net that differs from the online one, so double-Q matters
    js = js.replace(target_params=init_params(jmodel_cfg, jax.random.key(8),
                                              ex))
    draws = draws_lib.update_draws(js.key, B, 7, 5, kw["num_tau_policy"])
    beta = 0.6

    tmodel_cfg = ModelConfig(**kw)
    talgo = tlearner.AlgoConfig(**algo_kw)
    ts = tlearner.make_train_state(tmodel_cfg, talgo, (1, 10, 10, C), seed=0,
                                   device=torch.device("cpu"))
    ts.model.load_state_dict(bridge.flax_to_state_dict(
        tmodel_cfg, draws_lib.np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        tmodel_cfg, draws_lib.np_tree(js.target_params)))

    jupd = jax.jit(jlearner.make_update_step(jmodel_cfg, jalgo, jcfg, 1,
                                             flatten=False))
    js2, jrs2, jm = jupd(js, jrs, jnp.float32(beta))
    tupd = tlearner.make_update_step(talgo, tcfg, 1, flatten=False)
    ts2, trs2, tm = tupd(ts, trs, beta, **draws)

    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    assert tm["grad_norm"].item() > 0.5               # the clip engaged
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5)
    back = bridge.state_dict_to_flax(tmodel_cfg, ts2.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-6), back,
        draws_lib.np_tree(js2.params))
    assert not np.array_equal(
        back["params"]["head_mod"]["tau_embed"]["kernel"],
        np.asarray(js.params["params"]["head_mod"]["tau_embed"]["kernel"]))


def test_iqn_update_draws_from_its_generator():
    """Without injected draws the update takes the PER uniforms and the
    three tau sets from `TrainState.generator`, reproducibly."""
    kw = MODELS["iqn"]
    talgo = tlearner.AlgoConfig(algo="iqn", batch_size=B, n_step=N_STEP,
                                num_tau=7, num_tau_prime=5)
    losses = []
    for _ in range(2):
        _, _, tcfg, trs = _replays()
        ts = tlearner.make_train_state(ModelConfig(**kw), talgo,
                                       (1, 10, 10, C), seed=3,
                                       device=torch.device("cpu"))
        upd = tlearner.make_update_step(talgo, tcfg, 1, flatten=False)
        _, _, m = upd(ts, trs, 0.5)
        losses.append(m["loss"].item())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
