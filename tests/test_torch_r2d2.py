"""Port parity: one R2D2 update against `make_r2d2_update_step`.

One whole update — PER sample on JAX's uniforms, sequence stacks from
one window gather, burn-in from the stored carry, n-step or lambda
double-Q targets through value rescaling, masked Huber loss, optax-rule
clip, Adam, target sync, eta-mix priority write-back — against the JAX
package on the CPU at float32 (conftest sets JAX's matmul precision to
"highest"), on replays filled with the same chunks. Sampled leaves are
bit-exact; loss / |TD| / grad norm / priorities agree to rtol 1e-5 and
params after Adam to atol 1e-6. Adam's eps is config #4's 1e-3: with
an eps far below |grad| a step divides float noise in a tiny gradient
by that eps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.models import policy as jpolicy
from rltime_tpu.training import learner as jlearner
from rltime_tpu.training import r2d2 as jr2d2
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models import policy as tpolicy
from rltime_tpu_torch.training import learner as tlearner
from rltime_tpu_torch.training import r2d2 as tr2d2

MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(12,), head="linear",
           lstm_size=8)
CNN = dict(num_actions=5, torso="nature_cnn", cnn_channels=(8, 8, 8),
           cnn_fc=32, head="dueling", dueling_hidden=8, lstm_size=16)

_replay_insert = jax.jit(jreplay.replay_insert, static_argnums=0)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _example(kw, batch, frame_stack):
    """A (batch, *in_shape) example input for the model config."""
    if kw["torso"] == "mlp":
        return np.zeros((batch, 4), np.float32)
    return np.zeros((batch, frame_stack, 84, 84), np.uint8)


E, T, L_CHUNK = 2, 256, 16
BURN, SEQ, N = 4, 8, 2


def _replays(kw, frame_stack, horizon, seed=0, chunks=6):
    """The same chunks inserted into both packages' replays: random
    obs, actions, rewards, frequent episode ends, stored carries."""
    H = kw["lstm_size"]
    image = kw["torso"] != "mlp"
    obs_shape = (84, 84) if image else (4,)
    rcfg_kw = dict(num_envs=E, steps_per_env=T, horizon=horizon,
                   chunk_len=L_CHUNK, lookback=frame_stack - 1)
    jcfg, tcfg = (jreplay.ReplayConfig(**rcfg_kw),
                  treplay.ReplayConfig(**rcfg_kw))
    obs_j, obs_t = ((jnp.uint8, torch.uint8) if image
                    else (jnp.float32, torch.float32))
    spec = {"obs": (obs_shape, 0), "action": ((), 1), "reward": ((), 2),
            "terminated": ((), 3), "done": ((), 3), "rnn_c": ((H,), 2),
            "rnn_h": ((H,), 2)}
    jdt = (obs_j, jnp.int32, jnp.float32, jnp.bool_)
    tdt = (obs_t, torch.int32, torch.float32, torch.bool)
    jst = jreplay.replay_init(jcfg, {k: (s, jdt[i])
                                     for k, (s, i) in spec.items()})
    tst = treplay.replay_init(tcfg, {k: (s, tdt[i])
                                     for k, (s, i) in spec.items()},
                              torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(chunks):
        done = rng.random((E, L_CHUNK)) < 0.08
        if image:
            obs = rng.integers(0, 256, (E, L_CHUNK) + obs_shape,
                               dtype=np.uint8)
        else:
            obs = rng.normal(size=(E, L_CHUNK) + obs_shape).astype(
                np.float32)
        chunk = dict(
            obs=obs,
            action=rng.integers(0, kw["num_actions"], (E, L_CHUNK)).astype(
                np.int32),
            reward=rng.normal(size=(E, L_CHUNK)).astype(np.float32),
            terminated=done & (rng.random((E, L_CHUNK)) < 0.5), done=done,
            rnn_c=rng.normal(size=(E, L_CHUNK, H)).astype(np.float32) * 0.1,
            rnn_h=rng.normal(size=(E, L_CHUNK, H)).astype(np.float32) * 0.1)
        jst = _replay_insert(jcfg, jst, {k: jnp.asarray(v)
                                         for k, v in chunk.items()})
        treplay.replay_insert(tcfg, tst, chunk)
    return jcfg, jst, tcfg, tst


@pytest.mark.parametrize("kw,frame_stack,algo_over", [
    (MLP, 1, dict(value_rescale=True, grad_clip=0.05,
                  target_update_freq=1)),
    (MLP, 1, dict(value_rescale=False)),
    (MLP, 1, dict(use_lambda=True, lambda_=0.8)),
    (CNN, 4, dict(value_rescale=True)),
], ids=["mlp-rescale-clip-sync", "mlp-plain", "mlp-lambda", "cnn-f4"])
def test_r2d2_update_matches_jax(kw, frame_stack, algo_over):
    B = 4
    algo_kw = dict(dict(algo="r2d2", batch_size=B, n_step=N, burn_in=BURN,
                        seq_len=SEQ, gamma=0.97, lr=1e-3, adam_eps=1e-3,
                        target_update_freq=100, debug_outputs=True),
                   **algo_over)
    jalgo = jlearner.AlgoConfig(**algo_kw)
    talgo = tlearner.AlgoConfig(**algo_kw)
    jcfg, jrs, tcfg, trs = _replays(kw, frame_stack,
                                    jr2d2.r2d2_horizon(jalgo))
    flatten = kw["torso"] == "mlp"
    jmodel_cfg = jpolicy.ModelConfig(**kw)
    tmodel_cfg = tpolicy.ModelConfig(**kw)
    in_shape = _example(kw, 1, frame_stack).shape[1:]
    # Both packages start from the port's init, carried to flax by the
    # bridge (flax's own init would compile op by op for seconds); the
    # target net differs from the online one, so double-Q matters.
    ts = tlearner.make_train_state(tmodel_cfg, talgo, in_shape, seed=0,
                                   device=torch.device("cpu"))
    ts.target.load_state_dict(tpolicy.QPolicy(
        tmodel_cfg, in_shape, torch.Generator().manual_seed(1)).state_dict())
    params = bridge.state_dict_to_flax(tmodel_cfg, ts.model.state_dict())
    js = jlearner.TrainState(
        params=params,
        target_params=bridge.state_dict_to_flax(tmodel_cfg,
                                                ts.target.state_dict()),
        opt_state=jlearner.make_optimizer(jalgo).init(params),
        key=jax.random.key(7), updates=jnp.zeros((), jnp.int32))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (B,))))
    beta = 0.6

    jupd = jax.jit(jr2d2.make_r2d2_update_step(jmodel_cfg, jalgo, jcfg,
                                               frame_stack, flatten))
    js2, jrs2, jm = jupd(js, jrs, jnp.float32(beta))
    tupd = tr2d2.make_r2d2_update_step(tmodel_cfg, talgo, tcfg, frame_stack,
                                       flatten)
    ts2, trs2, tm = tupd(ts, trs, beta, u=u)

    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    if algo_over.get("grad_clip"):
        assert tm["grad_norm"].item() > algo_over["grad_clip"]  # clip engaged
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5)
    assert ts2.updates == int(js2.updates) == 1
    for sd, jp in ((ts2.model.state_dict(), js2.params),
                   (ts2.target.state_dict(), js2.target_params)):
        back = bridge.state_dict_to_flax(tmodel_cfg, sd)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-6), back, _np_tree(jp))
    moved = bridge.state_dict_to_flax(tmodel_cfg, ts2.model.state_dict())
    assert not np.array_equal(moved["params"]["lstm"]["hi"]["kernel"],
                              params["params"]["lstm"]["hi"]["kernel"])


def test_r2d2_config_checks():
    kw = dict(MLP, lstm_size=0)
    acfg = tlearner.AlgoConfig(algo="r2d2", batch_size=4, n_step=N,
                               burn_in=BURN, seq_len=SEQ)
    rcfg = treplay.ReplayConfig(num_envs=E, steps_per_env=T,
                                horizon=tr2d2.r2d2_horizon(acfg),
                                chunk_len=L_CHUNK)
    with pytest.raises(ValueError, match="lstm_size"):
        tr2d2.make_r2d2_update_step(tpolicy.ModelConfig(**kw), acfg, rcfg,
                                    1, True)
    assert tr2d2.r2d2_horizon(acfg) == jr2d2.r2d2_horizon(
        dataclasses.replace(jlearner.AlgoConfig(), burn_in=BURN,
                            seq_len=SEQ, n_step=N)) == BURN + SEQ + N


def test_state_dict_to_flax_shares_no_memory():
    """Every flax leaf is a copy: the (1, 8) value-stream weight's
    transpose is contiguous already, and a view of it let the JAX
    update (dispatched asynchronously) read the port's Adam step."""
    cfg = tpolicy.ModelConfig(**CNN)
    net = tpolicy.QPolicy(cfg, (4, 84, 84), torch.Generator().manual_seed(0))
    flat = jax.tree.leaves(bridge.state_dict_to_flax(cfg, net.state_dict()))
    for p in net.state_dict().values():
        base = p.numpy()
        assert not any(np.shares_memory(base, leaf) for leaf in flat)
