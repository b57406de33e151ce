"""Port parity: the fused on-device trainer as a whole.

`rltime_tpu_torch.parallel.fused.FusedApexTrainer` on the CPU against
`rltime_tpu.parallel.fused.FusedApexTrainer` at d=1, S=1 on MinAtar
Breakout, from the JAX side's weights and its own random draws (env,
actor and learner key chains replayed by `torch_port_draws`): after a
warm chunk and one superstep the replay ring's bytes, the cursors and
the first update's sampled leaves are bit-equal, and loss, |TD|, grad
norm, priorities and the params after Adam agree to 1e-5.

Within the port, bit for bit: one S=4 dispatch equals four S=1
dispatches, the fused trainer equals `Trainer` + `DeviceActor`, and a
run resumed from a checkpoint continues as the run that wrote it. All
seven `configs/minatar_*.json` presets (DQN, IQN, R2D2) run to the end
through the CLI at a cut size.
"""
import copy
import glob
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.parallel.fused import FusedApexTrainer as JFused
from rltime_tpu.parallel.mesh import make_mesh
from rltime_tpu.utils.prng import fold_in_str as j_fold_in_str
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.acting.device_actor import (
    STATS_RING, init_device_actor_state,
)
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from rltime_tpu_torch.parallel.mesh import make_mesh as make_torch_mesh
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer
from rltime_tpu_torch.utils.prng import fold_in_str
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E, L, B, K = 4, 8, 8, 2
PRESETS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(
    os.path.dirname(__file__), "..", "configs", "minatar_*.json")))


def _cfg(algo="dqn", warmup=2 * L * E, supersteps=1, replay=None, **train):
    cfg = {
        "seed": 3,
        "env": {"type": "minatar_breakout", "num_envs": E, "time_limit": 12},
        "model": {"torso": "minatar_cnn", "cnn_channels": [6], "cnn_fc": 16,
                  "head": "dueling", "dueling_hidden": 8},
        "replay": {"steps_per_env": 64, "prioritized": True,
                   **(replay or {})},
        "algo": {"algo": "dqn", "batch_size": B, "n_step": 3, "lr": 1e-3,
                 "adam_eps": 1e-6, "target_update_freq": 3,
                 "per_beta_start": 0.4, "per_beta_end": 1.0},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.3, "anneal_steps": 300},
        "train": {"total_env_steps": 4096, "warmup_env_steps": warmup,
                  "chunk_len": L, "updates_per_chunk": K,
                  "log_interval": 10**9, "trainer": "fused",
                  "supersteps_per_dispatch": supersteps, **train},
    }
    if algo == "iqn":
        cfg["model"].update({"head": "iqn", "iqn_embed_dim": 8,
                             "num_tau_policy": 6})
        cfg["algo"].update({"algo": "iqn", "num_tau": 7, "num_tau_prime": 5})
    elif algo == "r2d2":
        cfg["model"]["lstm_size"] = 8
        cfg["algo"].update({"algo": "r2d2", "n_step": 2, "burn_in": 2,
                            "seq_len": 4})
    return cfg


@pytest.mark.parametrize("algo,warmup", [("dqn", 0), ("dqn", 2 * L * E),
                                         ("iqn", 2 * L * E)])
def test_superstep_matches_jax(tmp_path, algo, warmup):
    superstep_parity(tmp_path, algo, warmup)


def superstep_parity(tmp_path, algo, warmup, replay=None, rtol=1e-5,
                     **train):
    """A warm chunk (if `warmup`) and one superstep of both fused
    trainers from the JAX side's weights and draws; `replay` and `train`
    override those config blocks (chunk_len and updates_per_chunk
    included). Integer plane bit-equal; float plane to `rtol` (params to
    atol = `rtol`)."""
    cfg = _cfg(algo, warmup, replay=replay, **train)
    L, K = cfg["train"]["chunk_len"], cfg["train"]["updates_per_chunk"]
    jcfg = copy.deepcopy(cfg)
    # the JAX fused path has debug leaves only without warmup, and never
    # under interleave_updates
    debug = warmup == 0 and not train.get("interleave_updates")
    jcfg["algo"]["debug_outputs"] = cfg["algo"]["debug_outputs"] = debug
    jt = JFused(jcfg, str(tmp_path / "jax"),
                mesh=make_mesh(jax.devices()[:1]))
    tt = FusedApexTrainer(cfg, str(tmp_path / "torch"), device="cpu")

    # the JAX side's weights, env reset draws and key chains
    # (fused.py:102-118: env keys first, actor streams second)
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
            draws_lib.reset_draws("breakout", k_env, E)))
    env_key = jt.actor_state.env_state.key[0]
    learner_key = jt.train_state.key
    iqn = dict(num_tau=7, num_tau_prime=5, num_tau_policy=6) \
        if algo == "iqn" else {}

    def act_draws():
        nonlocal env_key, k_act
        env_key, k_act, d = draws_lib.rollout_draws(
            "breakout", env_key, k_act, E, L, 3, iqn.get("num_tau_policy", 0))
        if iqn and cfg["replay"].get("use_inserted_priorities"):
            # the taus of the post-chunk forward, from a key DERIVED
            # from the advanced actor key (acting/device_actor.py:129)
            d.append(draws_lib.to_torch(dict(taus=jax.random.uniform(
                jax.random.fold_in(k_act, 0x9E37),
                (E, iqn["num_tau_policy"])))))
        return d

    if warmup:
        assert jt.superstep() == {}
        assert tt.superstep(dict(act=act_draws())) == {}
        assert tt.updates_done == 0
    updates = []
    for _ in range(K):      # fused.py:248-251
        updates.append(draws_lib.update_draws(
            jax.random.fold_in(learner_key, 0), B, **iqn))
        learner_key = jax.random.split(learner_key, 3)[0]
    jm = jt.superstep()
    tm = tt.superstep([dict(act=act_draws(), update=updates)])

    assert tt.env_steps == jt.env_steps == (2 if warmup else 1) * L * E
    assert tt.updates_done == jt.updates_done == K
    jrs, trs = jt.replay_state, tt.replay_state
    assert trs.t == int(jrs.t)
    for name, ring in trs.storage.items():
        want = np.asarray(jrs.storage[name])
        assert ring.numpy().dtype == want.dtype, name
        if name == "priority":      # the actor's |TD|: float plane
            assert np.abs(want).sum() > 0
            np.testing.assert_allclose(ring.numpy(), want, rtol=rtol,
                                       atol=1e-6, err_msg=name)
            continue
        np.testing.assert_array_equal(ring.numpy(), want, err_msg=name)
    assert trs.storage["action"][:, :trs.t].unique().numel() == 3
    ja, ta = jt.actor_state, tt.actor_state
    assert int(ta.ring_cursor) == int(ja.ring_cursor[0]) > 0
    np.testing.assert_array_equal(ta.ret_ring[:STATS_RING].numpy(),
                                  np.asarray(ja.ret_ring))
    for k, v in draws_lib.state_to_numpy(ja.env_state).items():
        np.testing.assert_array_equal(ta.env_state[k].numpy(), v, err_msg=k)
    if debug:
        for k in ("debug_leaf", "debug_action"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                          err_msg=k)
        np.testing.assert_allclose(tm["debug_td"].numpy(),
                                   np.asarray(jm["debug_td"]), rtol=rtol,
                                   atol=1e-6)
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    # atol: the priority of a |TD| near 0 has no meaningful relative error
    # (|TD|^0.6 turns an absolute 1e-6 at |TD| = 1e-3 into 1e-5)
    np.testing.assert_allclose(trs.tree.numpy(), np.asarray(jrs.tree),
                               rtol=rtol, atol=max(1e-6, 0.1 * rtol))
    np.testing.assert_allclose(trs.max_priority.item(),
                               float(jrs.max_priority), rtol=rtol)
    back = bridge.state_dict_to_flax(mc, tt.train_state.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=rtol), back,
        draws_lib.np_tree(jt.train_state.params))


# ----- within the port, bit for bit ----------------------------------------

def _assert_same_tensors(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same_tensors(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tensors(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _assert_same_run(a_train, a_replay, a_actor, b_train, b_replay, b_actor):
    """Learner, replay and actor state of two runs are bit-equal."""
    assert a_train.updates == b_train.updates
    _assert_same_tensors(dict(a_train.model.state_dict()),
                         dict(b_train.model.state_dict()), "model")
    _assert_same_tensors(dict(a_train.target.state_dict()),
                         dict(b_train.target.state_dict()), "target")
    _assert_same_tensors(a_train.optimizer.state_dict()["state"],
                         b_train.optimizer.state_dict()["state"], "adam")
    assert torch.equal(a_train.generator.get_state(),
                       b_train.generator.get_state())
    assert a_replay.t == b_replay.t
    _assert_same_tensors(a_replay.storage, b_replay.storage, "ring")
    assert torch.equal(a_replay.tree, b_replay.tree)
    assert torch.equal(a_replay.max_priority, b_replay.max_priority)
    _assert_same_tensors(a_actor.state_dict(), b_actor.state_dict(), "actor")


def _fused_parts(t):
    return t.train_state, t.replay_state, t.actor_state


@pytest.mark.parametrize("algo", ["dqn", "iqn", "r2d2"])
def test_s4_dispatch_equals_four_s1_dispatches(tmp_path, algo):
    one = FusedApexTrainer(_cfg(algo, supersteps=1), str(tmp_path / "a"),
                           device="cpu")
    four = FusedApexTrainer(_cfg(algo, supersteps=4), str(tmp_path / "b"),
                            device="cpu")
    for t in (one, four):       # the warm chunk (one per dispatch)
        assert t.superstep() == {}
    for _ in range(4):
        m1 = one.superstep()
    m4 = four.superstep()
    assert one.env_steps == four.env_steps == 5 * L * E
    assert one.updates_done == four.updates_done == 4 * K
    _assert_same_run(*_fused_parts(one), *_fused_parts(four))
    _assert_same_tensors(m1, m4, "metrics")     # a moving beta included
    assert np.isfinite(m4["loss"].item())


@pytest.mark.parametrize("algo", ["dqn", "iqn", "r2d2"])
def test_fused_equals_trainer_with_device_actor(tmp_path, algo):
    cfg = _cfg(algo)
    fused = FusedApexTrainer(cfg, str(tmp_path / "f"), device="cpu")
    host = Trainer(cfg, str(tmp_path / "h"), device="cpu")
    for _ in range(5):
        fused.superstep()
        host.train_chunk()
    assert host.updates_done == fused.updates_done == 4 * K
    assert host.actor.env_steps == fused.env_steps
    _assert_same_run(*_fused_parts(fused), host.train_state,
                     host.replay_state, host.actor.state)
    _assert_same_tensors(fused.last_metrics, host.last_metrics, "metrics")
    assert fused.episode_stats() == host.actor.episode_stats()[0] != []


@pytest.mark.parametrize("algo", ["dqn", "r2d2"])
def test_resume_continues_bit_identically(tmp_path, algo):
    cfg = _cfg(algo, supersteps=2, checkpoint_replay=True)
    rd = str(tmp_path / "run")
    a = FusedApexTrainer(cfg, rd, device="cpu")
    for _ in range(3):
        a.superstep()
    first = a.episode_stats()
    assert first
    a.save_checkpoint()
    assert ckpt_lib.latest_step(rd) == a.env_steps == 5 * L * E
    cfg_r = copy.deepcopy(cfg)
    cfg_r["train"]["resume"] = True
    b = FusedApexTrainer(cfg_r, rd, device="cpu")
    assert (b.env_steps, b.updates_done) == (a.env_steps, a.updates_done)
    _assert_same_run(*_fused_parts(a), *_fused_parts(b))
    for t in (a, b):
        t.superstep()
    _assert_same_run(*_fused_parts(a), *_fused_parts(b))
    _assert_same_tensors(a.last_metrics, b.last_metrics, "metrics")
    # the resumed run pops only episodes completed since the save
    assert a.episode_stats() == b.episode_stats() != []


@pytest.mark.parametrize("preset", PRESETS)
def test_minatar_preset_runs_through_the_cli(tmp_path, preset):
    r2d2 = preset.endswith("r2d2")
    # R2D2 samples 65-column sequences: five 16-step chunks fill them
    t = ttrain.run([
        preset, "--device", "cpu", "--result-dir", str(tmp_path / "run"),
        "--env.num_envs=4", "--algo.batch_size=4",
        "--train.updates_per_chunk=2", "--train.supersteps_per_dispatch=2",
        f"--train.warmup_env_steps={400 if r2d2 else 256}",
        f"--train.total_env_steps={650 if r2d2 else 500}",
        "--train.log_interval=128"])
    assert isinstance(t, FusedApexTrainer) and t.device.type == "cpu"
    assert t.env_steps >= (650 if r2d2 else 500) and t.updates_done >= 2
    assert t.replay_state.storage["obs"].shape[:2] == (4, 512)
    for k in ("loss", "grad_norm", "td_abs", "q"):
        assert np.isfinite(t.last_metrics[k].item()), k
    assert ckpt_lib.latest_step(str(tmp_path / "run")) == t.env_steps
    lines = (tmp_path / "run" / "scalars.jsonl").read_text().splitlines()
    assert any("train/loss" in x for x in lines)


def test_presets_found():
    assert len(PRESETS) == 7


def test_fused_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    # a mesh of one rank runs; d > 1 without a process group raises
    one = FusedApexTrainer(_cfg(), str(tmp_path / "m"), device="cpu",
                           mesh=make_torch_mesh("cpu", size=1))
    assert one.mesh.size == 1 and one.superstep() == {}
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_torch_mesh("cpu", size=2)
    host_env = _cfg()
    host_env["env"] = {"type": "counting_env", "num_envs": 2}
    with pytest.raises(ValueError, match="device-resident"):
        FusedApexTrainer(host_env, str(tmp_path / "e"), device="cpu")
    stacked = _cfg()
    stacked["frame_stack"] = 2
    with pytest.raises(ValueError, match="frame_stack"):
        Trainer(stacked, str(tmp_path / "s"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["minatar_breakout_dqn", "--result-dir",
                     str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def test_actor_generators_are_named_after_the_seed():
    """Both paths seed the actor's generators from the config seed's
    "actor" stream, the env's apart from the actor's."""
    cfg = _cfg()
    t = FusedApexTrainer(cfg, "unused", device="cpu",
                         logger=type("L", (), {"close": lambda s: None})())
    ref = init_device_actor_state(t.env, t.model_cfg, E,
                                  fold_in_str(cfg["seed"], "actor"),
                                  torch.device("cpu"))
    _assert_same_tensors(t.actor_state.state_dict(), ref.state_dict(),
                         "actor")
    assert not torch.equal(ref.generator.get_state(),
                           ref.env_generator.get_state())
