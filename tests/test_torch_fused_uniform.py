"""Port parity: the fused trainer on uniform replay with the lr schedule.

`rltime_tpu_torch.parallel.fused.FusedApexTrainer` keeps the replay's
write cursor and the update count on the device, so uniform replay
draws its columns below a device bound
(`history/replay.py:replay_sample_indices_device`) and the linear lr
decay is written from the device counter (`training/learner.py:
apply_gradients`). On `cartpole_device` with `replay.prioritized=false`
and `algo.lr_decay_updates` (config #1's device variant, cut to a few
lanes), against the JAX package's FusedApexTrainer at d=1 on the JAX
side's weights and draws, dispatch after dispatch past the end of the
decay: the replay rings and the cursor bit-equal (the float obs to
1e-6: CartPole's physics in float32), every update's sampled leaves
bit-equal, loss, |TD| and grad norm to rtol 1e-4, the parameters to
atol 1e-5, and the lr of the last step optax's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_port_draws as draws_lib
from rltime_tpu.parallel.fused import FusedApexTrainer as JFused
from rltime_tpu.parallel.mesh import make_mesh
from rltime_tpu.utils.prng import fold_in_str as j_fold_in_str
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.acting.device_actor import init_device_actor_state
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E, L, B, K, N = 4, 8, 8, 2, 5


def _cfg():
    return {
        "seed": 3,
        "env": {"type": "cartpole_device", "num_envs": E},
        "model": {"torso": "mlp", "mlp_hidden": [16, 16], "head": "linear"},
        "replay": {"steps_per_env": 64, "prioritized": False},
        "algo": {"algo": "dqn", "batch_size": B, "n_step": 1, "lr": 1e-2,
                 "lr_end": 1e-3, "lr_decay_updates": N, "adam_eps": 1e-6,
                 "target_update_freq": 3, "debug_outputs": True},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 1.0},
        "train": {"total_env_steps": 4096, "warmup_env_steps": 0,
                  "chunk_len": L, "updates_per_chunk": K,
                  "log_interval": 10**9, "trainer": "fused",
                  "supersteps_per_dispatch": 1},
    }


def test_fused_uniform_replay_with_lr_decay_matches_jax(tmp_path):
    cfg = _cfg()
    jt = JFused(copy.deepcopy(cfg), str(tmp_path / "jax"),
                mesh=make_mesh(jax.devices()[:1]))
    tt = FusedApexTrainer(copy.deepcopy(cfg), str(tmp_path / "torch"),
                          device="cpu")
    assert tt.replay_state.tree.shape == (1,)
    root = jax.random.key(cfg["seed"])
    k_env, k_act = jax.random.split(j_fold_in_str(root, "actor"), 2)
    mc = tt.model_cfg
    for net, params in ((tt.train_state.model, jt.train_state.params),
                        (tt.train_state.target,
                         jt.train_state.target_params)):
        net.load_state_dict(bridge.flax_to_state_dict(
            mc, draws_lib.np_tree(params)))
    tt.actor_state = init_device_actor_state(
        tt.env, mc, E, 0, tt.device, reset_draws=draws_lib.to_torch(
            draws_lib.reset_draws("cartpole", k_env, E)))
    env_key = jt.actor_state.env_state.key[0]
    learner_key = jt.train_state.key
    rcfg = tt.replay_cfg
    sched = optax.linear_schedule(cfg["algo"]["lr"], cfg["algo"]["lr_end"], N)
    dispatches = 4
    for d in range(dispatches):
        env_key, k_act, act = draws_lib.rollout_draws(
            "cartpole", env_key, k_act, E, L, 2)
        lo, hi = treplay.valid_range(rcfg, (d + 1) * L)
        updates = []
        for _ in range(K):          # fused.py:248-251
            updates.append(draws_lib.uniform_update_draws(
                jax.random.fold_in(learner_key, 0), B, max(hi - lo, 1), E))
            learner_key = jax.random.split(learner_key, 3)[0]
        jm = jt.superstep()
        tm = tt.superstep([dict(act=act, update=updates)])

        jrs, trs = jt.replay_state, tt.replay_state
        assert trs.t == int(jrs.t) == trs.cursor.item() == (d + 1) * L
        assert (tt.train_state.counter.item() == tt.train_state.updates
                == int(jt.train_state.updates) == (d + 1) * K)
        for name, ring in trs.storage.items():
            want = np.asarray(jrs.storage[name])
            assert ring.numpy().dtype == want.dtype, name
            if name == "obs":
                np.testing.assert_allclose(ring.numpy(), want, rtol=1e-6,
                                           atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(ring.numpy(), want,
                                              err_msg=f"{name} at {d}")
        np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                      np.asarray(jm["debug_leaf"]))
        for k in ("loss", "grad_norm", "td_abs", "q"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
        back = bridge.state_dict_to_flax(mc,
                                         tt.train_state.model.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-5), back,
            draws_lib.np_tree(jt.train_state.params))
    # past the end of the decay; the last step's lr is optax's
    assert dispatches * K > N
    lr = tt.train_state.optimizer.param_groups[0]["lr"]
    assert lr.item() == float(np.float32(sched(jnp.asarray(
        dispatches * K - 1, jnp.int32))))


def test_cartpole_dqn_device_fused_trains_on_the_cpu(tmp_path):
    """`python -m rltime_tpu_torch.train cartpole_dqn_device
    --train.trainer=fused --device cpu`, cut short: uniform replay and
    the lr decay train to the end (both raised before the device cursor
    drew uniformly and the device counter carried the schedule)."""
    t = ttrain.run(["cartpole_dqn_device", "--train.trainer=fused",
                    "--device", "cpu", "--result-dir", str(tmp_path / "r"),
                    "--train.total_env_steps=4096",
                    "--train.log_interval=2048"])
    assert isinstance(t, FusedApexTrainer) and t.env_steps == 4096
    assert not t.replay_cfg.prioritized and t.algo_cfg.lr_decay_updates > 0
    assert t.updates_done == t.train_state.counter.item() > 0
    assert t.last_metrics["loss"].isfinite()
