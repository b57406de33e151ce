"""Port parity: the host Trainer end to end on the CPU.

The port's `Trainer(device="cpu")` against the JAX `Trainer` on the same
Atari-shaped config (uint8 84x84 frames, frame stack 4, Nature CNN +
dueling, n-step PER) at the tests/test_image_pipeline.py sizes.
`counting_env`'s obs, rewards and dones do not depend on the actions,
so the obs/reward/done/terminated rings and the write cursor must be
bit-equal; the rest (actions, priorities, params) follows different
random streams. Also: checkpoint save/restore, the CLI on the CPU, and
that `--device cuda` without a card raises.
"""
import copy
import json
import os
import socket
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.ops import gather
from rltime_tpu_torch.parallel.apex import ApexTrainer
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer
from test_torch_cartpole_learns import _copy_key, _set_learner
from torch_port_draws import one_intra_op_thread  # noqa: F401
from torch_port_native import jax_native_lib  # noqa: F401  (fixture)


def _img_cfg():
    return {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 2,
                "episode_len": 11, "image_obs": True},
        "frame_stack": 4,
        "model": {"torso": "nature_cnn", "cnn_channels": [4, 4, 4],
                  "cnn_fc": 16, "head": "dueling", "dueling_hidden": 8},
        "replay": {"steps_per_env": 128, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 4, "n_step": 3,
                 "double_q": True, "lr": 1e-3, "target_update_freq": 10},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.1, "anneal_steps": 200},
        "train": {"total_env_steps": 288, "warmup_env_steps": 150,
                  "chunk_len": 8, "updates_per_chunk": 1,
                  "log_interval": 10_000, "checkpoint_interval": 10_000},
    }


def test_trainer_rings_match_jax(tmp_path, replay=None):
    cfg = _img_cfg()
    cfg["replay"].update(replay or {})
    jt = JTrainer(cfg, str(tmp_path / "jax")).train()
    plain_before = dict(gather.PLAIN_CALLS)
    tt = Trainer(cfg, str(tmp_path / "torch"), device="cpu").train()
    assert tt.updates_done == jt.updates_done > 0
    # every update went through the (CPU) wrappers twice: the fused
    # frame-stack gather, and one multi-field gather for its three
    # n-step strips (reward, done, terminated) and the action
    plain = {k: v - plain_before[k] for k, v in gather.PLAIN_CALLS.items()}
    assert plain == {"union_gather": tt.updates_done,
                     "window_gather": tt.updates_done}
    assert tt.replay_state.t == int(jt.replay_state.t) == 288 // 2
    for name in ("obs", "reward", "done", "terminated"):
        np.testing.assert_array_equal(
            tt.replay_state.storage[name].numpy(),
            np.asarray(jt.replay_state.storage[name]), err_msg=name)
    assert tt.replay_state.storage["obs"].dtype == torch.uint8
    for k in ("loss", "grad_norm", "td_abs"):
        assert np.isfinite(tt.last_metrics[k].item()), k
    assert tt.actor.env_steps == jt.actor.env_steps


def test_actor_stack_matches_replay_reconstruction():
    """The stack the policy saw when ACTING at column c equals the stack
    the learner rebuilds for c from the replay ring, and a lane explores
    exactly where its injected uniform is below eps."""
    from rltime_tpu_torch.acting.actor import Actor
    from rltime_tpu_torch.envs.fake import CountingVecEnv
    from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
    from rltime_tpu_torch.history import replay
    from rltime_tpu_torch.models.policy import ModelConfig

    seen = []

    class Recorder(torch.nn.Module):
        def forward(self, x):
            seen.append(x.clone())
            return torch.zeros((x.shape[0], 3))

    env = CountingVecEnv(2, episode_len=6, image_obs=True)
    L, F = 16, 4
    actor = Actor(env, ModelConfig(num_actions=3, torso="nature_cnn"), F,
                  EpsilonGreedy(eps_start=0.5, eps_end=0.5),
                  torch.Generator().manual_seed(0), L, torch.device("cpu"))
    chunk, _ = actor.rollout(Recorder())
    rcfg = replay.ReplayConfig(num_envs=2, steps_per_env=64, horizon=1,
                               chunk_len=L, lookback=F - 1)
    rs = replay.replay_init(rcfg, {"obs": ((84, 84), torch.uint8),
                                   "done": ((), torch.bool)},
                            torch.device("cpu"))
    replay.replay_insert(rcfg, rs, {"obs": chunk["obs"],
                                    "done": chunk["done"]})
    for col in range(L):
        stk = replay.frame_stack_gather(
            rcfg, rs, torch.tensor([0, 1]), torch.tensor([col, col]), F)
        assert torch.equal(stk, seen[col]), col
    # greedy action is 0 (all-zero Q); exploring lanes take random_a
    g = torch.Generator().manual_seed(0)
    for col in range(L):
        u = torch.rand((2,), generator=g)
        ra = torch.randint(0, 3, (2,), generator=g)
        want = torch.where(u < 0.5, ra, torch.zeros_like(ra))
        assert chunk["action"][:, col].tolist() == want.tolist()


def test_checkpoint_save_and_restore(tmp_path):
    cfg = _img_cfg()
    cfg["train"]["total_env_steps"] = 176
    cfg["train"]["checkpoint_replay"] = True
    rd = str(tmp_path / "run")
    t = Trainer(cfg, rd, device="cpu").train()
    assert ckpt_lib.latest_step(rd) == 176
    cfg["train"]["resume"] = True
    r = Trainer(cfg, rd, device="cpu")
    assert r.actor.env_steps == 176
    assert r.updates_done == t.updates_done > 0
    assert r.train_state.updates == t.train_state.updates
    for a, b in ((t.train_state.model, r.train_state.model),
                 (t.train_state.target, r.train_state.target)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    rt, rr = t.replay_state, r.replay_state
    assert rr.t == rt.t and torch.equal(rr.tree, rt.tree)
    assert torch.equal(rr.max_priority, rt.max_priority)
    for name, arr in rt.storage.items():
        assert torch.equal(rr.storage[name], arr), name
    # same PER draws after the restore as the saved generator would give
    assert torch.equal(torch.rand(4, generator=t.train_state.generator),
                       torch.rand(4, generator=r.train_state.generator))


def test_cli_runs_on_cpu(tmp_path):
    cfg = _img_cfg()
    cfg["train"]["total_env_steps"] = 176
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    rd = tmp_path / "cli"
    assert ttrain.main([str(path), "--device", "cpu", "--result-dir",
                        str(rd), "--train.log_interval=16"]) == 0
    assert ckpt_lib.latest_step(str(rd)) == 176
    lines = (rd / "scalars.jsonl").read_text().splitlines()
    assert any("train/loss" in json.loads(x) for x in lines)


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_img_cfg()))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main([str(path), "--device", "cuda", "--result-dir",
                     str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def _trace_events(trace_dir):
    """The events of the one torch.profiler trace file in `trace_dir`."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(trace_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("section,key,value", [
    ("train", "profile_dir", "trace"), ("train", "profile_port", 0),
    ("train", "trainer", "apex"), ("train", "async_acting", True),
])
@pytest.mark.usefixtures("one_intra_op_thread")
def test_late_ported_options_run(tmp_path, section, key, value):
    """The options ported after the first slices run: `train.trainer=
    "apex"` and `train.async_acting` (distribution), and the profiler's
    `train.profile_dir` (a trace of the whole loop) and
    `train.profile_port` (a capture of one chunk, armed over HTTP)."""
    cfg = _img_cfg()
    cfg[section][key] = value
    cfg["train"]["total_env_steps"] = 176
    if key == "profile_dir":
        cfg["train"]["profile_dir"] = str(tmp_path / "trace")
    if key == "profile_port":
        port = socket.socket()
        port.bind(("127.0.0.1", 0))
        cfg["train"]["profile_port"] = port.getsockname()[1]
        port.close()
        t = Trainer(cfg, str(tmp_path / "u"), device="cpu")
        url = f"http://127.0.0.1:{t.profile_server.port}/trace?chunks=1"
        with urllib.request.urlopen(url, timeout=30) as r:
            armed = json.loads(r.read())
        t.train()
        t.profile_server.close()
        assert t.profile_server.captures == [armed["dir"]]
        assert any(e.get("name", "").startswith("aten::")
                   for e in _trace_events(armed["dir"]))
        return
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    t = ttrain.run([str(path), "--device", "cpu", "--result-dir",
                    str(tmp_path / "u")])
    assert t.updates_done > 0
    if key == "profile_dir":
        assert any(e.get("name", "").startswith("aten::")
                   for e in _trace_events(str(tmp_path / "trace")))
    elif key == "trainer":
        assert isinstance(t, ApexTrainer) and t.mesh.size == 1
    else:
        assert t.pool is not None and not t.pool.alive


@pytest.mark.usefixtures("one_intra_op_thread")
def test_trainer_rings_match_jax_on_atari_native(tmp_path, jax_native_lib):
    """The host trainers over the C++ synthetic Atari lanes (2-D uint8
    frames, life-loss `terminated`, game-over resets inside `step`),
    chunk by chunk on the JAX actor's draws with the port's learner set
    to the JAX one's before every chunk: every action the port chooses
    equals the JAX actor's, the rings stay bit-equal, and the logged
    true game scores (`episode_score_*`) are equal."""
    cfg = _img_cfg()
    cfg["env"] = {"type": "atari_native", "num_envs": 4, "num_threads": 1}
    cfg["model"]["compute_dtype"] = "float32"
    cfg["replay"]["steps_per_env"] = 256
    cfg["train"].update(warmup_env_steps=256, chunk_len=16, log_interval=10**9,
                        checkpoint_interval=10**9, track_best=False)
    E, L, chunks = 4, 16, 40
    jt = JTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"))
    tt = Trainer(copy.deepcopy(cfg), str(tmp_path / "torch"), device="cpu")
    act_key = [_copy_key(jt.actor.state.key)]
    jax_actions = {}
    mismatches = []
    port_act_step = tt.actor._act_step

    def act_step(model, state, obs, done_prev, eps, t, explore_u, random_a,
                 taus=None):
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
    T = tt.replay_cfg.steps_per_env
    for c in range(chunks):
        _set_learner(tt, jt.train_state)
        jm, _ = jt.train_chunk()
        cols = [(c * L + i) % T for i in range(L)]
        jax_actions["chunk"] = np.asarray(
            jt.replay_state.storage["action"])[:, cols]
        tm, _ = tt.train_chunk()
        if c % 10 == 9:
            jt._log(jm)
            tt._log(tm)
    for name, ring in tt.replay_state.storage.items():
        np.testing.assert_array_equal(
            ring.numpy(), np.asarray(jt.replay_state.storage[name]),
            err_msg=name)
    assert sum(mismatches) == 0 and len(mismatches) == chunks * L
    assert tt.updates_done == jt.updates_done > 0
    assert tt.replay_state.storage["terminated"].any()
    assert np.isfinite(tt.last_metrics["loss"].item())
    keys = ("episode_score_mean", "episode_score_median")
    logs = [[{k: s[k] for k in keys if k in s} for s in map(
        json.loads, (tmp_path / d / "scalars.jsonl").read_text().splitlines())]
        for d in ("torch", "jax")]
    assert logs[0] == logs[1] and any(logs[0])
