"""Config #1 (`cartpole_dqn`) end to end: the port against the JAX
package chunk by chunk, and the learning run.

`test_chunks_match_jax_from_a_shared_state` runs both host trainers on
config #1 as written, on the JAX side's own draws (actor and learner key
chains replayed). Before every chunk the port's learner is set to the
JAX one's (params, target, Adam moments, counters), so each chunk is
compared on its own and f32 drift cannot compound: every action the port
chooses equals the JAX actor's, the rings stay bit-equal, and the params
after the chunk's 8 updates agree to atol 1e-5. Tier-1 runs 12 chunks;
the `slow` variant 300 (153,600 env steps: through the epsilon anneal,
seven target syncs and the first ring wrap).

`test_cartpole_dqn_reaches_the_bar` (`slow`) is the learning run as
written (seed 0, 400k env steps on the CPU, about 45 s), then
`eval --best` over 10 episodes against the reference's bar of 475.

`tests/torch_port_cartpole_spread.py` prints the spread of that score
over seeds (PERF.md quotes it).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch import eval as teval
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.config.config import load_config
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.training.trainer import Trainer
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _config():
    cfg = load_config("cartpole_dqn")
    cfg["train"].update(log_interval=10**9, checkpoint_interval=10**9)
    return cfg


def _copy_key(key):
    """A copy that survives the JAX trainer donating its state."""
    return jax.random.wrap_key_data(np.array(jax.random.key_data(key)))


def _adam_state(opt_state):
    is_adam = lambda x: hasattr(x, "mu") and hasattr(x, "nu")  # noqa: E731
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=is_adam)
                if is_adam(s))


def _set_learner(tt, js):
    """The port's learner := the JAX train state `js`."""
    mc, ts = tt.model_cfg, tt.train_state
    ts.model.load_state_dict(bridge.flax_to_state_dict(
        mc, draws_lib.np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        mc, draws_lib.np_tree(js.target_params)))
    adam = _adam_state(js.opt_state)
    mu = bridge.flax_to_state_dict(mc, draws_lib.np_tree(adam.mu))
    nu = bridge.flax_to_state_dict(mc, draws_lib.np_tree(adam.nu))
    for name, p in ts.model.named_parameters():
        ts.optimizer.state[p] = dict(
            step=torch.tensor(float(adam.count)), exp_avg=mu[name].clone(),
            exp_avg_sq=nu[name].clone())
    ts.updates = int(js.updates)
    if ts.counter is not None:
        ts.counter.fill_(ts.updates)


def _max_dev(mc, net, jparams):
    back = bridge.state_dict_to_flax(mc, net.state_dict())
    return max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), back,
        draws_lib.np_tree(jparams))))


@pytest.mark.parametrize("chunks", [
    12, pytest.param(300, marks=pytest.mark.slow)])
def test_chunks_match_jax_from_a_shared_state(tmp_path, chunks):
    cfg = _config()
    jt = JTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"))
    tt = Trainer(copy.deepcopy(cfg), str(tmp_path / "torch"), device="cpu")
    E, L = tt.env.num_envs, tt.loop_cfg.chunk_len
    B, K = tt.algo_cfg.batch_size, tt.loop_cfg.updates_per_chunk
    T = tt.replay_cfg.steps_per_env
    act_key = [_copy_key(jt.actor.state.key)]
    jax_actions = {}
    mismatches = []
    port_act_step = tt.actor._act_step

    def act_step(model, state, obs, done_prev, eps, t, explore_u, random_a,
                 taus=None):
        # the JAX actor's draws (acting/actor.py:118-127), then its action
        act_key[0], _, ekey, akey = jax.random.split(act_key[0], 4)
        explore_u = torch.from_numpy(np.array(jax.random.uniform(ekey, (E,))))
        random_a = torch.from_numpy(np.array(jax.random.randint(
            akey, (E,), 0, tt.model_cfg.num_actions, dtype=jnp.int32)))
        chosen, state, info = port_act_step(
            model, state, obs, done_prev, eps, t, explore_u, random_a, taus)
        want = torch.from_numpy(jax_actions["chunk"][:, t].copy())
        mismatches.append(int((chosen != want).sum()))
        return want, state, info

    tt.actor._act_step = act_step
    worst = 0.0
    for c in range(chunks):
        _set_learner(tt, jt.train_state)
        key = _copy_key(jt.train_state.key)
        jt.train_chunk()
        cols = [(c * L + i) % T for i in range(L)]
        jax_actions["chunk"] = np.asarray(
            jt.replay_state.storage["action"])[:, cols]
        draws = None
        if (c + 1) * L * E >= cfg["train"]["warmup_env_steps"]:
            lo, hi = treplay.valid_range(tt.replay_cfg, (c + 1) * L)
            draws = []
            for _ in range(K):          # training/learner.py:374
                draws.append(draws_lib.uniform_update_draws(
                    key, B, max(hi - lo, 1), E))
                key = jax.random.split(key, 3)[0]
        tt.train_chunk(draws)
        for name, ring in tt.replay_state.storage.items():
            np.testing.assert_array_equal(
                ring.numpy(), np.asarray(jt.replay_state.storage[name]),
                err_msg=f"{name} after chunk {c}")
        assert tt.train_state.updates == int(jt.train_state.updates)
        worst = max(worst,
                    _max_dev(tt.model_cfg, tt.train_state.model,
                             jt.train_state.params),
                    _max_dev(tt.model_cfg, tt.train_state.target,
                             jt.train_state.target_params))
        assert worst <= 1e-5, f"chunk {c}: params deviate by {worst}"
    assert sum(mismatches) == 0 and len(mismatches) == chunks * L
    print(f"{chunks} chunks, {len(mismatches) * E} action choices, 0 "
          f"mismatches; worst per-chunk parameter deviation {worst:.3g}")
    assert tt.updates_done == jt.updates_done > 0
    assert tt.actor.episode_stats()[0] == jt.actor.episode_stats()[0] != []


@pytest.mark.slow
def test_cartpole_dqn_reaches_the_bar(tmp_path):
    rd = str(tmp_path / "run")
    t = ttrain.run(["cartpole_dqn", "--device", "cpu", "--result-dir", rd])
    assert t.actor.env_steps >= 400_000
    report = teval.evaluate(rd, episodes=10, best=True, device="cpu")
    assert report["episodes"] == 10
    assert report["return_mean"] >= 475, report
