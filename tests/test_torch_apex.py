"""The Ape-X trainer of the port (`rltime_tpu_torch/parallel/apex.py`).

  * One rank, in process, end to end (tests/test_parallel.py's
    test_apex_trainer_end_to_end): updates run, a best checkpoint is
    recorded and kept, the ladder decreases over the lanes.
  * The ladder slices equal JAX's `_GlobalLadder`.
  * One rank against the JAX package's ApexTrainer on a one-device mesh,
    chunk by chunk from a shared learner, on the JAX side's draws (actor
    key chain, and each update's `fold_in(key, shard 0)`): every action
    equals JAX's, the rings stay bit-equal, the updates start at the same
    chunk, and the learner and the actor's published weights agree to
    1e-5 after every chunk (the warmup gate, beta on the global step
    counter and the publish cadence all feed these).
  * Two gloo ranks end to end (tests/test_multiprocess.py's
    test_apex_two_process_end_to_end): the learner is bit-identical on
    both ranks after training, both ranks see one best.json and each
    wrote its sidecar, and two resumes of the last checkpoint (learner,
    each rank's actor generator and replay shard) evolve identically.
  * The CLIs: `train apex_multihost_counting` on one rank and
    `train_distributed` on two gloo processes, cut short.
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
import torch_port_mp
from rltime_tpu.parallel.apex import ApexTrainer as JApexTrainer
from rltime_tpu.parallel.apex import _GlobalLadder as JGlobalLadder
from rltime_tpu.parallel.mesh import make_mesh as jmake_mesh
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.parallel.apex import ApexTrainer, _GlobalLadder
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from test_torch_cartpole_learns import _copy_key, _max_dev, _set_learner
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CFG = {
    "seed": 0,
    "env": {"type": "counting_env", "num_envs": 2, "episode_len": 7},
    "frame_stack": 1,
    "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
    "replay": {"steps_per_env": 128, "prioritized": True},
    "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2, "lr": 1e-3,
             "target_update_freq": 10},
    "exploration": {"type": "epsilon_greedy", "mode": "ladder"},
    "train": {"total_env_steps": 1600, "warmup_env_steps": 400,
              "chunk_len": 8, "updates_per_chunk": 1, "log_interval": 512,
              "track_best": True, "best_min_episodes": 1,
              "checkpoint_interval": 10**9, "checkpoint_replay": True,
              "trainer": "apex"},
}
CUT = ["--device", "cpu", "--env.num_envs=4", "--replay.steps_per_env=128",
       "--algo.batch_size=8", "--train.chunk_len=8",
       "--train.warmup_env_steps=256", "--train.total_env_steps=768",
       "--train.log_interval=256", "--model.cnn_channels=[4,4,4]",
       "--model.cnn_fc=16", "--model.dueling_hidden=16"]


def test_apex_trainer_end_to_end_on_one_rank(tmp_path):
    cfg = copy.deepcopy(CFG)
    cfg["env"]["num_envs"] = 8
    cfg["train"]["total_env_steps"] = 1024
    rd = str(tmp_path / "apex")
    t = ApexTrainer(cfg, rd, device="cpu").train()
    assert t.mesh.size == 1 and t.global_env_steps == 1024
    assert t.updates_done == (1024 - 400) // 64 + 1
    best = ckpt_lib.best_step(rd)
    assert best is not None and best["score"] > 0
    assert (tmp_path / "apex" / "checkpoints" / str(best["step"])).is_dir()
    assert os.path.isfile(os.path.join(ckpt_lib.aux_dir(rd, best["step"]),
                                       "proc0.pt"))
    eps = t.actor.exploration.epsilons(8, 0)
    assert eps.shape == (8,) and np.all(np.diff(eps) < 0)
    # the actor acts with its own copy, refreshed at every chunk
    for a, b in zip(t.actor_model.parameters(),
                    t.train_state.model.parameters()):
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert np.array_equal(a.detach().numpy(), b.detach().numpy())


@pytest.mark.parametrize("e_global,offset,e_local",
                         [(64, 0, 32), (64, 32, 32), (8, 2, 2), (1, 0, 1)])
def test_ladder_equals_the_jax_global_ladder(e_global, offset, e_local):
    want = JGlobalLadder(e_global, offset, e_local, 0.4, 7.0).epsilons(0, 0)
    got = _GlobalLadder(e_global, offset, e_local, 0.4, 7.0).epsilons(0, 0)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_apex_chunks_match_jax_on_one_rank(tmp_path, monkeypatch):
    # the JAX trainer drives num_envs lanes per LOCAL device: one device
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    cfg = copy.deepcopy(CFG)
    cfg["env"]["num_envs"] = 4
    cfg["train"].update(total_env_steps=320, warmup_env_steps=64,
                        updates_per_chunk=2, publish_interval=2,
                        log_interval=10**9, track_best=False)
    jt = JApexTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"),
                      mesh=jmake_mesh(jax.devices()[:1]))
    tt = ApexTrainer(copy.deepcopy(cfg), str(tmp_path / "torch"),
                     device="cpu")
    E, L = tt.env.num_envs, tt.loop_cfg.chunk_len
    B, K = tt.algo_cfg.batch_size, tt.loop_cfg.updates_per_chunk
    T, mc = tt.replay_cfg.steps_per_env, tt.model_cfg
    # the actor starts from JAX's published weights, then follows its own
    tt.actor_model.load_state_dict(bridge.flax_to_state_dict(
        mc, draws_lib.np_tree(jt._actor_params)))
    act_key = [_copy_key(jt.actor.state.key)]
    jax_actions, mismatches = {}, []
    port_act_step = tt.actor._act_step

    def act_step(model, state, obs, done_prev, eps, t, explore_u, random_a,
                 taus=None):
        # the JAX actor's draws (acting/actor.py:118-127), then its action
        act_key[0], _, ekey, akey = jax.random.split(act_key[0], 4)
        explore_u = torch.from_numpy(np.array(jax.random.uniform(ekey, (E,))))
        random_a = torch.from_numpy(np.array(jax.random.randint(
            akey, (E,), 0, mc.num_actions, dtype=jnp.int32)))
        chosen, state, info = port_act_step(
            model, state, obs, done_prev, eps, t, explore_u, random_a, taus)
        want = torch.from_numpy(jax_actions["chunk"][:, t].copy())
        mismatches.append(int((chosen != want).sum()))
        return want, state, info

    tt.actor._act_step = act_step
    trained = []
    for c in range(10):
        _set_learner(tt, jt.train_state)
        key = _copy_key(jt.train_state.key)
        before = jt.updates_done
        jt.train_chunk()
        cols = [(c * L + i) % T for i in range(L)]
        jax_actions["chunk"] = np.asarray(
            jt.replay_state.storage["action"])[:, cols]
        draws = None
        if jt.updates_done > before:
            draws = []
            for _ in range(K):      # parallel/mesh.py:221-231, shard 0
                draws.append(draws_lib.update_draws(
                    jax.random.fold_in(key, 0), B))
                key = jax.random.split(key, 3)[0]
        tt.train_chunk(draws)
        trained.append(draws is not None)
        assert tt.updates_done == jt.updates_done, c
        assert tt.global_env_steps == jt.global_env_steps, c
        for name, ring in tt.replay_state.storage.items():
            np.testing.assert_array_equal(
                ring.numpy(), np.asarray(jt.replay_state.storage[name]),
                err_msg=f"{name} after chunk {c}")
        np.testing.assert_allclose(
            tt.replay_state.tree.numpy(), np.asarray(jt.replay_state.tree),
            rtol=1e-5, atol=1e-6, err_msg=f"tree after chunk {c}")
        assert tt.train_state.updates == int(jt.train_state.updates)
        for net, jparams in ((tt.train_state.model, jt.train_state.params),
                             (tt.train_state.target,
                              jt.train_state.target_params),
                             (tt.actor_model, jt._actor_params)):
            dev = _max_dev(mc, net, jparams)
            assert dev <= 1e-5, f"chunk {c}: params deviate by {dev}"
    # warmup gated the first chunk (64 env steps reach it), then every
    # chunk trained
    assert trained == [False] + [True] * 9
    assert sum(mismatches) == 0 and len(mismatches) == 10 * L


def test_apex_preset_runs_through_the_cli(tmp_path):
    t = ttrain.run(["apex_multihost_counting", "--result-dir",
                    str(tmp_path / "run"), *CUT])
    assert isinstance(t, ApexTrainer) and t.device.type == "cpu"
    assert t.global_env_steps == 768 and t.updates_done == 2 * 17
    mc, ac = t.model_cfg, t.algo_cfg
    assert (mc.torso, mc.head, mc.compute_dtype) == (
        "nature_cnn", "dueling", "bfloat16")
    assert (ac.n_step, ac.target_update_freq, t.frame_stack) == (3, 2000, 4)
    assert t.replay_state.storage["obs"].shape == (4, 128, 84, 84)
    assert ckpt_lib.latest_step(str(tmp_path / "run")) == 768
    for k in ("loss", "grad_norm", "td_abs", "q"):
        assert np.isfinite(t.last_metrics[k].item()), k


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("apex2")
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(dict(config=CFG, result_dir=str(work / "res")), f)
    return work, torch_port_mp.run_ranks("apex", 2, str(work))


def test_apex_two_ranks_end_to_end(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert int(r["updates_done"]) > 0
        assert int(r["global_env_steps"]) >= 1600
        assert int(r["num_episodes"]) > 0
    # each rank's ladder is its slice of the 4 global lanes
    full = _GlobalLadder(4, 0, 4).epsilons(0, 0)
    np.testing.assert_array_equal(ranks[0]["eps"], full[:2])
    np.testing.assert_array_equal(ranks[1]["eps"], full[2:])


def test_apex_learner_is_bit_identical_across_ranks(two_ranks):
    _, ranks = two_ranks
    assert float(ranks[0]["checksum"]) == float(ranks[1]["checksum"]) != 0.0
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)


def test_apex_two_resumes_evolve_identically(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        a, b = r["resumed"]
        assert a == b and a != float(r["checksum"])
    assert ranks[0]["resumed"][0] == ranks[1]["resumed"][0]


def test_apex_global_best_checkpoint(two_ranks):
    work, ranks = two_ranks
    best = [json.loads(str(r["best"])) for r in ranks]
    assert best[0] is not None and best[0] == best[1]
    assert float(ranks[0]["best_score"]) == float(ranks[1]["best_score"])
    aux = ckpt_lib.aux_dir(str(work / "res"), best[0]["step"])
    assert sorted(os.listdir(aux)) == ["proc0.pt", "proc1.pt"]


@pytest.mark.parametrize("given_dir", [True, False])
def test_train_distributed_on_two_gloo_processes(tmp_path, given_dir):
    """Without --result-dir every rank writes into the lead's default
    directory (one `results/<config>-torch-<time>` for all)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    work = tmp_path / "cwd"
    work.mkdir()
    dir_args = ["--result-dir", str(tmp_path / "dist")] if given_dir else []
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rltime_tpu_torch.train_distributed",
         "apex_multihost_counting", "--init-method",
         f"file://{tmp_path}/rdv", "--num-processes", "2", "--process-id",
         str(r), *dir_args, *CUT], env=env, cwd=str(work),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "done: 18 updates on each of 2 ranks" in logs[0], logs[0]
    if given_dir:
        rd = tmp_path / "dist"
    else:
        runs = os.listdir(work / "results")
        assert len(runs) == 1 and runs[0].startswith(
            "apex_multihost_counting-torch-"), runs
        rd = work / "results" / runs[0]
    assert ckpt_lib.latest_step(str(rd)) == 768
    assert sorted(os.listdir(ckpt_lib.aux_dir(str(rd), 768))) == [
        "proc0.pt", "proc1.pt"]


def test_train_distributed_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    import torch
    from rltime_tpu_torch import train_distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_distributed.main(["apex_multihost_counting", "--init-method",
                                f"file://{tmp_path}/rdv", "--result-dir",
                                str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()
