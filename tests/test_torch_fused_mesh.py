"""The fused trainer over a mesh of gloo ranks.

  * d=2 against the JAX package's `FusedApexTrainer` on a 2-device mesh
    (MinAtar Breakout, DQN and R2D2), from the JAX side's weights and
    each shard's own draws (env keys first, actor streams second, the
    learner's `fold_in(key, shard)`; parallel/fused.py:102-113,
    :248-251): after a warm chunk and one superstep every shard's ring
    is bit-equal (the R2D2 carry rings, floats, to 1e-5), its cursors
    and stat rings too, and metrics, trees and parameters agree to 1e-5;
    the parameters are bit-identical across the ranks.
  * Transcripts need a single rank. (The 2- and 4-rank runs end to end:
    tests/test_torch_fused_ranks.py.)
"""
import copy
import json

import jax
import numpy as np
import pytest

import torch_port_draws as draws_lib
import torch_port_mp
from rltime_tpu.parallel.fused import FusedApexTrainer as JFused
from rltime_tpu.parallel.mesh import make_mesh
from rltime_tpu.utils.prng import fold_in_str as j_fold_in_str
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig

D, E, L, B, K = 2, 4, 8, 8, 2


def _cfg(algo):
    cfg = {
        "seed": 3,
        "env": {"type": "minatar_breakout", "num_envs": E, "time_limit": 12},
        "model": {"torso": "minatar_cnn", "cnn_channels": [6], "cnn_fc": 16,
                  "head": "dueling", "dueling_hidden": 8},
        "replay": {"steps_per_env": 64, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": B, "n_step": 3, "lr": 1e-3,
                 "adam_eps": 1e-6, "target_update_freq": 3,
                 "per_beta_start": 0.4, "per_beta_end": 1.0},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.3, "anneal_steps": 300},
        "train": {"total_env_steps": 4096, "warmup_env_steps": 2 * L * E * D,
                  "chunk_len": L, "updates_per_chunk": K,
                  "log_interval": 10**9, "trainer": "fused"},
    }
    if algo == "r2d2":
        cfg["model"]["lstm_size"] = 8
        cfg["algo"].update({"algo": "r2d2", "n_step": 2, "burn_in": 2,
                            "seq_len": 4})
    return cfg


@pytest.mark.parametrize("algo", ["dqn", "r2d2"])
def test_two_rank_superstep_matches_the_jax_two_device_mesh(tmp_path, algo):
    cfg = _cfg(algo)
    jt = JFused(copy.deepcopy(cfg), str(tmp_path / "jax"),
                mesh=make_mesh(jax.devices()[:D]))
    mc = ModelConfig(num_actions=3, torso="minatar_cnn", cnn_channels=(6,),
                     cnn_fc=16, head="dueling", dueling_hidden=8,
                     lstm_size=8 if algo == "r2d2" else 0)
    root = jax.random.key(cfg["seed"])
    keys = jax.random.split(j_fold_in_str(root, "actor"), 2 * D)
    ranks = []
    for s in range(D):
        env_key, act_key = jt.actor_state.env_state.key[s], keys[D + s]

        def act_draws():
            nonlocal env_key, act_key
            env_key, act_key, d = draws_lib.rollout_draws(
                "breakout", env_key, act_key, E, L, 3)
            return [{g: {k: v.numpy() for k, v in x[g].items()} for g in x}
                    for x in d]
        ranks.append(dict(
            reset={k: np.asarray(v) for k, v in draws_lib.reset_draws(
                "breakout", keys[s], E).items()},
            warm=act_draws(), act=act_draws()))
    learner_key = jt.train_state.key
    for _ in range(K):
        for s in range(D):
            d = draws_lib.update_draws(jax.random.fold_in(learner_key, s), B)
            ranks[s].setdefault("update", []).append(
                {k: v.numpy() for k, v in d.items()})
        learner_key = jax.random.split(learner_key, 3)[0]
    inp = dict(ranks=ranks, model=bridge.flax_to_state_dict(
        mc, draws_lib.np_tree(jt.train_state.params)),
        target=bridge.flax_to_state_dict(
            mc, draws_lib.np_tree(jt.train_state.target_params)))
    torch_port_mp.save_tree(str(tmp_path / "in.npz"), inp)
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(dict(config=cfg, result_dir=str(tmp_path / "torch")), f)
    assert jt.superstep() == {}
    jm = jt.superstep()
    outs = torch_port_mp.run_ranks("fused_parity", D, str(tmp_path))

    jrs, ja = jt.replay_state, jt.actor_state
    want_params = bridge.flax_to_state_dict(
        mc, draws_lib.np_tree(jt.train_state.params))
    for s, o in enumerate(outs):
        assert int(o["env_steps"]) == jt.env_steps == 2 * L * E * D
        assert int(o["updates_done"]) == jt.updates_done == K
        assert int(o["t"]) == int(jrs.t)
        lanes = slice(s * E, (s + 1) * E)
        for name, ring in o["storage"].items():
            want = np.asarray(jrs.storage[name])[lanes]
            if name in ("rnn_c", "rnn_h"):    # the actor's carry: floats
                np.testing.assert_allclose(ring, want, rtol=1e-5, atol=1e-6,
                                           err_msg=name)
                continue
            np.testing.assert_array_equal(ring, want, err_msg=name)
        assert int(o["ring_cursor"]) == int(ja.ring_cursor[s])
        np.testing.assert_array_equal(
            o["ret_ring"][:-1],
            np.asarray(ja.ret_ring).reshape(D, -1)[s])
        for k, v in draws_lib.state_to_numpy(ja.env_state).items():
            np.testing.assert_array_equal(o["env_state"][k], v[lanes],
                                          err_msg=k)
        np.testing.assert_allclose(
            o["tree"], np.asarray(jrs.tree).reshape(D, -1)[s], rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(float(o["max_priority"]),
                                   float(jrs.max_priority), rtol=1e-5)
        for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
            np.testing.assert_allclose(float(o["metrics"][k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        for k, v in want_params.items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert int(outs[0]["ring_cursor"]) + int(outs[1]["ring_cursor"]) > 0
    for k, v in outs[0]["params"].items():
        np.testing.assert_array_equal(outs[1]["params"][k], v, err_msg=k)


def test_transcripts_need_a_single_rank(tmp_path):
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.parallel.mesh import Mesh
    cfg = _cfg("dqn")
    cfg["train"].update(record_transcript=True, warmup_env_steps=0)
    with pytest.raises(ValueError, match="single-rank"):
        FusedApexTrainer(cfg, str(tmp_path / "t"), device="cpu",
                         mesh=Mesh(0, 2, "cpu"))
