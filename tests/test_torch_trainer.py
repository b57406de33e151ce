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
import json

import numpy as np
import pytest
import torch

from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.ops import gather
from rltime_tpu_torch.parallel.apex import ApexTrainer
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer
from torch_port_draws import one_intra_op_thread  # noqa: F401


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


@pytest.mark.parametrize("section,key,value", [
    ("train", "profile_dir", "x"), ("train", "profile_port", 9999),
    ("train", "trainer", "apex"), ("train", "async_acting", True),
])
@pytest.mark.usefixtures("one_intra_op_thread")
def test_unported_options_raise(tmp_path, section, key, value):
    """The profiler options still raise; `train.trainer="apex"` and
    `train.async_acting` run since the distribution slice."""
    cfg = _img_cfg()
    cfg[section][key] = value
    cfg["train"]["total_env_steps"] = 176
    if key.startswith("profile"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Trainer(cfg, str(tmp_path / "u"), device="cpu")
        return
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    t = ttrain.run([str(path), "--device", "cpu", "--result-dir",
                    str(tmp_path / "u")])
    assert t.updates_done > 0
    if key == "trainer":
        assert isinstance(t, ApexTrainer) and t.mesh.size == 1
    else:
        assert t.pool is not None and not t.pool.alive
